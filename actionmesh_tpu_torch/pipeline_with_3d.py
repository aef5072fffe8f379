"""{Video + 3D mesh} -> 4D pipeline: animate a mesh the user supplies.

Counterpart of ``actionmesh_tpu/pipeline_with_3d.py``. It replaces Stage 0:
the anchor latent is the TripoSG VAE's encoding of the user's mesh surface
(merged, normalised, 16,384 area-weighted samples with normals), not one
generated from the anchor frame. After Stage II the vertices are
de-normalised and re-expanded through the vertex merge map onto the
pre-merge faces, so the mesh's UV and texture topology survive.
"""

from __future__ import annotations

import logging
from typing import Optional

from actionmesh_tpu_torch.io.mesh import Mesh
from actionmesh_tpu_torch.io.video_input import ActionMeshInput
from actionmesh_tpu_torch.pipeline import ActionMeshPipeline
from actionmesh_tpu_torch.preprocessing.mesh import (
    denormalize_mesh,
    merge_and_clean_mesh,
    normalize_mesh,
    sample_surface,
)
from actionmesh_tpu_torch.utils.banks import LatentBank, MeshBank
from actionmesh_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


class ActionMeshPipelineWithMeshInput(ActionMeshPipeline):
    """Pipeline variant: the user's anchor mesh encoded by the VAE (topology kept)."""

    def __init__(self, *args, surface_samples: int = 16384, vae=None, **kwargs):
        """``vae``: the encode path to use (anything with
        ``encode_to_latent(surface, seed)``) instead of the default one."""
        super().__init__(*args, **kwargs)
        self.surface_samples = surface_samples
        self.vae = vae
        if vae is None:
            self._load_vae()

    def _load_vae(self) -> None:
        """The VAE encode path: the Stage-0 backend's own (TripoSG from its
        checkpoint, or ``DevTripoSG``, built at first use), else, behind the
        stub, a random-weight TripoSG at its default widths."""
        from actionmesh_tpu_torch.models.triposg.pipeline import TripoSGPipeline

        if hasattr(self.image_to_3d, "encode_to_latent"):
            self.vae = self.image_to_3d
        else:
            self.vae = TripoSGPipeline.from_random(
                seed=0, dtype=self._dtype, image_encoder=self.image_encoder, device=self.device
            )

    def init_banks_from_anchor(self, input: ActionMeshInput, anchor_mesh: Mesh, seed: int = 44):
        """Encode the user's mesh: merge map -> normalise -> sample -> VAE.

        Returns (latent_bank, mesh_bank, (center, factor), vertex_merge_map,
        pre_merge_faces); the sampling (merge, normalise, sample) runs in
        the span ``sample``, the encode in ``vae_encode`` (``stage0_seconds``
        reads them).
        """
        with span("sample"):
            merged, vertex_merge_map, pre_merge_faces = merge_and_clean_mesh(anchor_mesh)
            normalized, center, factor = normalize_mesh(merged)
            surface = sample_surface(
                normalized, n_points=self.surface_samples, seed=seed, with_normals=True
            )
        with span("vae_encode"):
            anchor_latent = self.vae.encode_to_latent(surface[None], seed=seed)
            self._sync()

        latent_bank = LatentBank(empty_dims=self.cfg.denoiser_latent_shape, device=self.device, verbose=True)
        mesh_bank = MeshBank(verbose=True)
        anchor_timestep = input.timesteps[[self.cfg.anchor_idx]]
        latent_bank.update(timesteps=anchor_timestep, latents=anchor_latent)
        mesh_bank.update(meshes=[normalized], timesteps=anchor_timestep)
        return latent_bank, mesh_bank, (center, factor), vertex_merge_map, pre_merge_faces

    def __call__(
        self,
        input: ActionMeshInput,
        anchor_mesh: Mesh,
        seed: int = 44,
        stage_0_steps: Optional[int] = None,
        face_decimation: Optional[int] = None,
        floaters_threshold: Optional[float] = None,
        stage_1_steps: Optional[int] = None,
        guidance_scales: Optional[list[float]] = None,
        anchor_idx: Optional[int] = None,
    ) -> list[Mesh]:
        """Run {video + 3D} -> 4D. The meshes keep the input's topology, uv
        and visual. The overrides hold for this call only. Per-phase seconds
        are read from ``self.phase_seconds`` (preprocess, stage0 = sampling +
        VAE encode, encode, stage1, stage2)."""
        with self.call_overrides(
            stage_0_steps=stage_0_steps, face_decimation=face_decimation,
            floaters_threshold=floaters_threshold, stage_1_steps=stage_1_steps,
            guidance_scales=guidance_scales, anchor_idx=anchor_idx,
        ):
            return self._run_3d(input, anchor_mesh, seed)

    def _run_3d(self, input: ActionMeshInput, anchor_mesh: Mesh, seed: int) -> list[Mesh]:
        with span("pipeline") as self.last_call:
            with self._phase("preprocess"):
                input = self.preprocess(input)
            with self._phase("stage0"):
                latent_bank, mesh_bank, (center, factor), vertex_merge_map, pre_merge_faces = (
                    self.init_banks_from_anchor(input, anchor_mesh, seed)
                )
            with self._phase("encode"):
                context = self.encode_all_frames(input)
            with self._phase("stage1"):
                latent_bank = self.generate_3d_latents(input, context, latent_bank, seed=seed)
            with self._phase("stage2"):
                mesh_bank = self.generate_mesh_animation(latent_bank, mesh_bank)
        meshes = [denormalize_mesh(m, center, factor) for m in mesh_bank.get_ordered()[0]]
        return [
            Mesh(
                vertices=m.vertices[vertex_merge_map],
                faces=pre_merge_faces,
                uv=anchor_mesh.uv,
                visual=anchor_mesh.visual,
            )
            for m in meshes
        ]
