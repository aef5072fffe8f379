"""ActionMesh pipeline in PyTorch: video -> animated 3D mesh (4D).

Counterpart of ``actionmesh_tpu/pipeline.py``, with the same phases:
background matting (RMBG, for frames without a valid alpha) + crop ->
Stage 0 (anchor latent + mesh) -> DINOv2 encode -> Stage I over AR windows
-> Stage II -> meshes. The weights come from ``weights_dir`` (default
``pretrained_weights``), one directory per checkpoint family:
``ActionMesh/{denoiser,autoencoder}``, ``TripoSG/{transformer,vae}``,
``dinov2`` and ``RMBG``, each in the reference's safetensors layout. A
family whose directory is absent runs on seeded random weights
(development mode; without TripoSG, Stage 0 is the real TripoSG path with
random weights, ``models/stage0.py:DevTripoSG``); one that is present but
malformed raises. The per-call overrides of ``__call__`` hold for that
call only.

Every call is one span tree (``utils/profiling.py``): the root ``pipeline``,
the five phases (``preprocess``, ``stage0``, ``encode``, ``stage1``,
``stage2``), and below them the layer boundaries: ``matting`` and ``crop``;
``image_to_3d`` (TripoSG's ``encode``, ``dit_sample``, ``decode``) and
``process_mesh`` (``clean``, ``decimate``, ``floaters``); each Stage-I
window ``stage1_window_<i>`` with a ``stage1_step`` span a step; each
Stage-II window ``stage2_window_<i>`` with ``vertex_features``, an
``autoencoder_chunk`` a target chunk, ``to_host`` and ``target_meshes``.
``phase_seconds`` and ``stage0_seconds`` are views of the last call's tree.

``device_mesh`` (``parallel/mesh.py``) runs the pipeline as one SPMD program
over ``torch.distributed``, one rank per card: Stage I/II and the TripoSG
DiT weights are cut over tp, and Stage 0's sampling and SDF decode, Stage I
and Stage II split as their ``mesh=`` functions say. Every rank runs the
same call; the preprocessed frames and Stage 0's anchor are rank 0's,
broadcast, so every rank agrees on the shapes that follow. Not ported:
segmented launches, the download of missing checkpoints (the card has no
network: the missing families are logged) and the static-shape vertex
bucketing (padded query rows are independent, so dropping it changes no
result).
"""

from __future__ import annotations

import contextlib
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from actionmesh_tpu_torch.config import PipelineConfig, load_config
from actionmesh_tpu_torch.io.mesh import Mesh
from actionmesh_tpu_torch.io.video_input import ActionMeshInput
from actionmesh_tpu_torch.models.autoencoder import (
    AutoencoderConfig,
    apply_displacement,
    autoencoder_forward,
    init_autoencoder,
)
from actionmesh_tpu_torch.models.denoiser import DenoiserConfig, init_denoiser
from actionmesh_tpu_torch.models.image_encoder import ImageEncoder
from actionmesh_tpu_torch.models.stage0 import STAGE0_MODELS, make_image_to_3d
from actionmesh_tpu_torch.ops.chunking import chunk_from
from actionmesh_tpu_torch.ops.embeddings import (
    apply_scaling,
    get_scaling,
    interpolate_timesteps,
)
from actionmesh_tpu_torch.parallel.mesh import (
    autoencoder_param_shardings,
    broadcast_object,
    default_mesh,
    denoiser_param_shardings,
    shard_params,
)
from actionmesh_tpu_torch.preprocessing.background import BackgroundRemover
from actionmesh_tpu_torch.preprocessing.image import ImagePreprocessor
from actionmesh_tpu_torch.preprocessing.mesh import MeshPostprocessor, get_mesh_features
from actionmesh_tpu_torch.sampling.denoise_loop import denoise_window, get_noise
from actionmesh_tpu_torch.sampling.flow_schedule import get_schedule
from actionmesh_tpu_torch.sampling.guidance import make_guidance
from actionmesh_tpu_torch.utils.banks import LatentBank, MeshBank
from actionmesh_tpu_torch.utils.profiling import Span, span, tree_seconds

logger = logging.getLogger(__name__)

# checkpoint family -> (Hugging Face repository, directory under weights_dir)
WEIGHT_FAMILIES = {
    "ActionMesh": "facebook/ActionMesh",
    "TripoSG": "VAST-AI/TripoSG",
    "dinov2": "facebook/dinov2-large",
    "RMBG": "briaai/RMBG-1.4",
}


class ActionMeshPipeline:
    """Video -> 4D pipeline (three-stage cascade) on one device, or on a
    device mesh with one rank per card."""

    def __init__(
        self,
        config_name: str = "actionmesh",
        weights_dir: Optional[str | Path] = "pretrained_weights",
        device: torch.device = torch.device("cuda"),
        dtype: torch.dtype = torch.bfloat16,
        init_seed: int = 0,
        config_updates: Optional[dict] = None,
        lazy_loading: bool = False,
        image_encoder: Optional[ImageEncoder] = None,
        image_to_3d=None,
        device_mesh="auto",
        stage_0_model: str = "triposg",
    ):
        """``config_name``: one of ``config.PRESETS``; ``dtype``: bf16, fp16 or
        fp32 compute (the fp32 islands stay fp32). ``lazy_loading`` (the
        low-RAM presets' CPU/GPU weight residency in the reference) is
        accepted and does nothing, as in the JAX package: the weights stay
        on the device. ``image_encoder`` and ``image_to_3d``: the DINOv2
        encoder and the Stage-0 backend to use instead of those built from
        ``weights_dir`` (the closed loop's frozen conditioning stack).

        ``device_mesh``: a ``parallel/mesh.py`` DeviceMesh, None (one
        device), or "auto": ``make_mesh()``'s default mesh when
        ``torch.distributed`` is initialised with more than one rank, else
        None. With a mesh on cuda, ``device`` must be this rank's card, the
        current device (``init_distributed`` sets it).

        ``stage_0_model``: the image-to-3D model of Stage 0, "triposg" or
        "hunyuan3d-2.1" (``models/stage0.py:make_image_to_3d``; its
        checkpoint under ``weights_dir/Hunyuan3D-2.1``)."""
        del lazy_loading
        self.stage_0_model = stage_0_model
        self.cfg: PipelineConfig = load_config(config_name, updates=config_updates)
        self.device_mesh = default_mesh() if device_mesh == "auto" else device_mesh
        self.device = torch.device(device)
        if self.device_mesh is not None and self.device.type == "cuda":
            current = torch.cuda.current_device()
            if self.device.index is None:
                self.device = torch.device("cuda", current)
            elif self.device.index != current:
                raise ValueError(
                    f"device {self.device} is not this rank's card cuda:{current} "
                    "(torch.cuda.set_device(local_rank) before building the pipeline)"
                )
        self._dtype = dtype
        self._weights_dir = Path(weights_dir) if weights_dir else None

        dc = self.cfg.temporal_3D_denoiser
        self.denoiser_config = DenoiserConfig(
            num_tokens_nominal=dc.num_tokens_nominal,
            temporal_context_size=dc.temporal_context_size,
            in_channels=dc.in_channels,
            num_layers=dc.num_layers,
            num_attention_heads=dc.num_attention_heads,
            width=dc.width,
            mlp_ratio=dc.mlp_ratio,
            cross_attention_dim=dc.cross_attention_dim,
            inflated_layers=tuple(dc.inflated_layers),
            gelu_approx=dc.gelu_approx,
        )
        ac = self.cfg.temporal_3D_vae
        self.autoencoder_config = AutoencoderConfig(
            temporal_context_size=ac.temporal_context_size,
            in_channels=ac.in_channels,
            in_extra_channels=ac.in_extra_channels,
            out_dim=ac.out_dim,
            latent_channels=ac.latent_channels,
            width=ac.width,
            num_layers=ac.num_layers,
            num_attention_heads=ac.num_attention_heads,
            embed_frequency=ac.embed_frequency,
            embed_include_pi=ac.embed_include_pi,
            prediction_mode=ac.prediction_mode,
            gelu_approx=ac.gelu_approx,
        )
        self.image_process = ImagePreprocessor()
        self.mesh_process = MeshPostprocessor(
            face_decimation=self.cfg.mesh_process.face_decimation,
            floaters_threshold=self.cfg.mesh_process.floaters_threshold,
        )

        self._init_seed = init_seed
        self._load_actionmesh_weights()
        self._shard_model_params()
        self._load_backends(image_encoder, image_to_3d)
        self.last_call: Optional[Span] = None  # the root span of the last call

    # -- weights ---------------------------------------------------------

    def _family_dir(self, family: str) -> Optional[Path]:
        return self._weights_dir / family if self._weights_dir is not None else None

    def _load_actionmesh_weights(self) -> None:
        """Stage I/II from ``weights_dir/ActionMesh`` if it exists, else
        seeded random weights (development mode)."""
        if self._weights_dir is not None:
            missing = [f"{sub} ({repo})" for sub, repo in WEIGHT_FAMILIES.items()
                       if not (self._weights_dir / sub).exists()]
            if missing:
                logger.warning(
                    "Checkpoint families missing under %s, running on random weights: %s",
                    self._weights_dir, ", ".join(missing),
                )
        am_dir = self._family_dir("ActionMesh")
        if am_dir is not None and am_dir.exists():
            from actionmesh_tpu_torch.utils import weights as weights_util

            logger.info("Loading ActionMesh weights from %s", am_dir)
            self.denoiser_params = weights_util.load_denoiser(
                am_dir / "denoiser", self.denoiser_config, self._dtype, self.device
            )
            self.autoencoder_params = weights_util.load_autoencoder(
                am_dir / "autoencoder", self.autoencoder_config, self._dtype, self.device
            )
            return
        logger.warning(
            "ActionMesh weights not found under %s — using seeded random "
            "initialization (development mode).",
            self._weights_dir,
        )
        gen = torch.Generator(device=self.device).manual_seed(self._init_seed)
        self.denoiser_params = init_denoiser(gen, self.denoiser_config, self._dtype, self.device)
        self.autoencoder_params = init_autoencoder(
            gen, self.autoencoder_config, self._dtype, self.device
        )

    def _shard_model_params(self) -> None:
        """Keep this rank's slices of the Stage I/II params (Megatron col ->
        row for attention and feed-forward, replicated elsewhere); every
        rank built or loaded the same full trees. No-op without a mesh."""
        mesh = self.device_mesh
        if mesh is None:
            return
        self.denoiser_params = shard_params(
            self.denoiser_params,
            denoiser_param_shardings(
                self.denoiser_params, mesh, self.denoiser_config.num_attention_heads
            ),
            mesh,
        )
        self.autoencoder_params = shard_params(
            self.autoencoder_params,
            autoencoder_param_shardings(
                self.autoencoder_params, mesh, self.autoencoder_config.num_attention_heads
            ),
            mesh,
        )

    def _load_backends(self, image_encoder=None, image_to_3d=None) -> None:
        """DINOv2, the Stage-0 backend and RMBG, each the one given or else
        from its family's directory when present."""
        self.image_encoder = image_encoder or ImageEncoder(
            device=self.device, dtype=self._dtype, weights_dir=self._family_dir("dinov2")
        )
        # TripoSG conditions on this same encoder (the JAX package builds a
        # second one from the same weights)
        self.image_to_3d = image_to_3d or make_image_to_3d(
            self._family_dir(STAGE0_MODELS.get(self.stage_0_model, "TripoSG")),
            latent_shape=self.cfg.denoiser_latent_shape,
            device=self.device,
            dtype=self._dtype,
            image_encoder=self.image_encoder,
            device_mesh=self.device_mesh,
            model=self.stage_0_model,
            handoff_dir=self._family_dir("TripoSG"),
        )
        self.background_removal = BackgroundRemover(self._family_dir("RMBG"), self.device)

    def save_pretrained(self, path: str | Path) -> None:
        """Write the Stage I/II params as ``path/denoiser.npz`` and
        ``path/autoencoder.npz`` in the layout JAX's ``load_params`` reads."""
        from actionmesh_tpu_torch.utils.weights import save_npz

        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        save_npz(self.denoiser_params, path / "denoiser.npz")
        save_npz(self.autoencoder_params, path / "autoencoder.npz")
        logger.info("Saved pipeline weights to %s", path)

    def load_native(self, path: str | Path) -> "ActionMeshPipeline":
        """Load the Stage I/II params from ``path/denoiser.npz`` and
        ``path/autoencoder.npz`` (``save_pretrained``, ``export_for_inference``
        or JAX's ``save_params``), in their stored dtypes, onto the device."""
        from actionmesh_tpu_torch.utils.weights import load_npz

        path = Path(path)
        self.denoiser_params = load_npz(path / "denoiser.npz", self.device)
        self.autoencoder_params = load_npz(path / "autoencoder.npz", self.device)
        self._shard_model_params()
        logger.info("Loaded pipeline weights from %s", path)
        return self

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the last call's seconds ------------------------------------------

    def _call_tree(self) -> dict[str, tuple[float, float]]:
        return tree_seconds(self.last_call) if self.last_call is not None else {}

    @property
    def phase_seconds(self) -> dict[str, float]:
        """The last call's seconds of each phase (preprocess, stage0,
        encode, stage1, stage2), host clock, each ending in a device
        synchronisation."""
        return {k: total for k, (total, _) in self._call_tree().items() if "." not in k}

    @property
    def stage0_seconds(self) -> dict[str, float]:
        """The last call's Stage-0 seconds by span below ``stage0``: each
        child's seconds (the backend's own spans, TripoSG's ``encode``,
        ``dit_sample``, ``decode``, stand for ``image_to_3d`` where it has
        them; ``process_mesh``; {video + 3D}: ``sample``, ``vae_encode``),
        and under a dotted path each deeper span's own seconds, outside its
        child spans (``decode.extract``: the extraction's host work outside
        its field queries; ``process_mesh.clean``, ``.decimate``,
        ``.floaters``). Spans of one path add up."""
        tree = {path[len("stage0."):]: secs for path, secs in self._call_tree().items()
                if path.startswith("stage0.")}
        if any(path.startswith("image_to_3d.") for path in tree):
            tree = {path.removeprefix("image_to_3d."): secs for path, secs in tree.items()
                    if path != "image_to_3d"}
        return {path: own if "." in path else total for path, (total, own) in tree.items()}

    @contextlib.contextmanager
    def _phase(self, name: str):
        """One phase of a call: a span that ends in a device
        synchronisation, logged."""
        with span(name) as sp:
            yield
            self._sync()
        logger.info("phase %s: %.2fs", name, sp.seconds)

    # -- Stage 0 ---------------------------------------------------------

    def init_banks_from_anchor(
        self, input: ActionMeshInput, seed: int = 44
    ) -> tuple[LatentBank, MeshBank]:
        """Anchor frame -> 3D latent + mesh via the image-to-3D backend.

        The backend runs in the span ``image_to_3d``, the mesh processing
        in ``process_mesh`` (``stage0_seconds`` reads them).
        """
        s0 = self.cfg.stage_0
        decode_kwargs = {}
        if s0.prefilter_octree_depth is not None:
            decode_kwargs["prefilter_octree_depth"] = s0.prefilter_octree_depth
        if s0.coarse_decode_dtype is not None:
            decode_kwargs["coarse_decode_dtype"] = s0.coarse_decode_dtype
        with span("image_to_3d"):
            anchor_latent, anchor_mesh = self.image_to_3d(
                image=input.frames[self.cfg.anchor_idx],
                seed=seed,
                num_inference_steps=s0.num_inference_steps,
                guidance_scale=s0.guidance_scale,
                **decode_kwargs,
            )
            self._sync()
        with span("process_mesh"):
            anchor_mesh = self.mesh_process.process_mesh(anchor_mesh, seed=seed)
            if self.device_mesh is not None:
                # rank 0's anchor on every rank: its vertex count sets Stage II's shapes
                latent_np, anchor_mesh = broadcast_object((anchor_latent.cpu().numpy(), anchor_mesh))
                anchor_latent = torch.as_tensor(latent_np, device=self.device)
        latent_bank = LatentBank(
            empty_dims=self.cfg.denoiser_latent_shape, device=self.device, verbose=True
        )
        mesh_bank = MeshBank(verbose=True)
        anchor_timestep = input.timesteps[[self.cfg.anchor_idx]]
        latent_bank.update(timesteps=anchor_timestep, latents=anchor_latent)
        mesh_bank.update(meshes=[anchor_mesh], timesteps=anchor_timestep)
        return latent_bank, mesh_bank

    # -- Stage I ---------------------------------------------------------

    def encode_all_frames(self, input: ActionMeshInput) -> torch.Tensor:
        """(T, S, D_ctx) conditioning features for all frames."""
        return self.image_encoder.encode_images(input.frames)

    def _denoise_latents(
        self,
        input: ActionMeshInput,
        context: torch.Tensor,
        latent_bank: LatentBank,
        seed: int = 44,
    ) -> torch.Tensor:
        """Denoise one AR window."""
        cond_latents, cond_mask = latent_bank.get(timesteps=input.timesteps, add_batch_dim=True)
        # a CPU generator: the same seed gives the same noise on any device
        init_noise = get_noise(
            torch.Generator().manual_seed(seed), self.cfg.denoiser_latent_shape,
            batch_size=1, n_timesteps=input.n_frames, device=self.device,
        )
        mask_f = cond_mask.float()[..., None, None]
        init_latent = (
            cond_latents.float() * mask_f + init_noise * (1.0 - mask_f)
        ).to(self._dtype)
        timesteps, distances = get_schedule(
            self.cfg.scheduler.num_inference_steps,
            self.cfg.scheduler.num_train_timesteps,
            self.cfg.scheduler.shift,
        )
        guidance = make_guidance(
            self.cfg.cf_guidance.guidance_at_inference,
            self.cfg.cf_guidance.guidance_scales,
            self.cfg.cf_guidance.inference_enabled,
        )
        return denoise_window(
            self.denoiser_params,
            self.denoiser_config,
            guidance,
            init_latent,
            context[None].to(self._dtype),
            cond_mask,
            torch.as_tensor(input.timesteps, device=self.device)[None],
            torch.as_tensor(timesteps, device=self.device),
            torch.as_tensor(distances, device=self.device),
            is_additive=self.cfg.scheduler.is_additive,
            split_cfg_batch=self.cfg.scheduler.split_cfg_batch,
            mesh=self.device_mesh,
        )

    def generate_3d_latents(
        self,
        input: ActionMeshInput,
        context: torch.Tensor,
        latent_bank: LatentBank,
        seed: int = 44,
    ) -> LatentBank:
        """Stage I over AR windows, conditioning on previously banked latents."""
        ar_windows = chunk_from(
            start=self.cfg.anchor_idx,
            total=input.n_frames,
            size=self.cfg.temporal_3D_denoiser.temporal_context_size,
            slide=self.cfg.sliding_window_denoiser,
        )
        for i, window_indices in enumerate(ar_windows):
            window_input = input.get(window_indices)
            with span(f"stage1_window_{i}") as window:
                window_latents = self._denoise_latents(
                    input=window_input,
                    context=context[torch.as_tensor(window_indices, device=context.device)],
                    latent_bank=latent_bank,
                    seed=seed + i,
                )
                self._sync()
            logger.info("Stage I window %d/%d: %.2fs", i + 1, len(ar_windows), window.seconds)
            latent_bank.update(latents=window_latents.float(), timesteps=window_input.timesteps)
        return latent_bank

    # -- Stage II --------------------------------------------------------

    def _decode_displacement(
        self,
        latents: torch.Tensor,
        window_timesteps: np.ndarray,
        source_alpha: np.ndarray,
        target_alphas: np.ndarray,
        anchor_mesh: Mesh,
    ) -> list[Mesh]:
        """Decode one window of latents into deformed meshes."""
        n_targets = target_alphas.shape[1]
        if anchor_mesh.n_vertices == 0 or anchor_mesh.n_faces == 0:
            raise ValueError(
                "Anchor mesh is empty — Stage 0 produced no surface (check "
                "the image-to-3D backend / SDF extraction level)."
            )
        with span("vertex_features"):
            vertex_features = torch.as_tensor(
                get_mesh_features(anchor_mesh, with_normals=True), device=self.device
            )[None]
        chunk = self.cfg.decode_target_chunk or n_targets
        dev = self.device
        outs = []
        for start in range(0, n_targets, chunk):
            with span("autoencoder_chunk"):
                outs.append(autoencoder_forward(
                    self.autoencoder_params,
                    self.autoencoder_config,
                    latents.to(self._dtype),
                    torch.as_tensor(window_timesteps, device=dev),
                    torch.as_tensor(source_alpha, device=dev),
                    torch.as_tensor(target_alphas[:, start : start + chunk], device=dev),
                    vertex_features,
                    compute_dtype=self._dtype,
                    mesh=self.device_mesh,
                ))
        with span("to_host"):
            deformed = apply_displacement(
                self.autoencoder_config, vertex_features[..., :3], torch.cat(outs, dim=1)
            )
            deformed_np = deformed.float().cpu().numpy()
        with span("target_meshes"):
            return [
                Mesh(vertices=deformed_np[0, i], faces=anchor_mesh.faces)
                for i in range(n_targets)
            ]

    def generate_mesh_animation(
        self, latent_bank: LatentBank, mesh_bank: MeshBank
    ) -> MeshBank:
        """Stage II over AR windows: latents -> deformed meshes.

        As in the JAX package (and the reference): interpolate_timesteps
        spans min->max and ``drop_first`` drops the minimum, so for
        anchor_idx > 0 the left windows drop their earliest frame.
        """
        ar_windows = chunk_from(
            start=self.cfg.anchor_idx,
            total=latent_bank.n_timesteps,
            size=self.cfg.temporal_3D_vae.temporal_context_size,
            slide=self.cfg.sliding_window_autoencoder,
        )
        all_timesteps = latent_bank.get_ordered_timesteps()
        for window_idx, window_indices in enumerate(ar_windows):
            window_timesteps = all_timesteps[np.asarray(window_indices)][None]
            window_latents, _ = latent_bank.get(
                timesteps=window_timesteps[0], add_batch_dim=True
            )
            anchor_mesh = mesh_bank.get(timesteps=window_timesteps[:, 0])[0]
            if anchor_mesh is None:
                raise RuntimeError("the window's anchor mesh is missing from the mesh bank")
            output_timesteps = interpolate_timesteps(
                window_timesteps, subsampling_level=self.cfg.subsampling_level,
                drop_first=True,
            )
            t_min, t_range = get_scaling(window_timesteps)
            source_alpha = apply_scaling(window_timesteps[:, 0], t_min, t_range)
            target_alphas = apply_scaling(output_timesteps, t_min, t_range)
            with span(f"stage2_window_{window_idx}") as window:
                window_meshes = self._decode_displacement(
                    latents=window_latents,
                    window_timesteps=window_timesteps,
                    source_alpha=source_alpha,
                    target_alphas=target_alphas,
                    anchor_mesh=anchor_mesh,
                )
            logger.info(
                "Stage II window %d/%d: %.2fs", window_idx + 1, len(ar_windows), window.seconds
            )
            mesh_bank.update(meshes=window_meshes, timesteps=output_timesteps[0])
        return mesh_bank

    # -- Full pipeline -----------------------------------------------------

    @contextlib.contextmanager
    def call_overrides(
        self,
        stage_0_steps: Optional[int] = None,
        face_decimation: Optional[int] = None,
        floaters_threshold: Optional[float] = None,
        stage_1_steps: Optional[int] = None,
        guidance_scales: Optional[list[float]] = None,
        anchor_idx: Optional[int] = None,
    ):
        """Apply a call's overrides (those not None) for the ``with`` block
        only, restoring the configuration after it, also when it raises. (JAX
        ``pipeline.py:581-590`` keeps them after the call, so a served
        request inherits the previous request's; not ported.)"""
        targets = {
            "stage_0_steps": (self.cfg.stage_0, "num_inference_steps"),
            "stage_1_steps": (self.cfg.scheduler, "num_inference_steps"),
            "guidance_scales": (self.cfg.cf_guidance, "guidance_scales"),
            "face_decimation": (self.mesh_process, "face_decimation"),
            "floaters_threshold": (self.mesh_process, "floaters_threshold"),
            "anchor_idx": (self.cfg, "anchor_idx"),
        }
        given = {
            "stage_0_steps": stage_0_steps, "stage_1_steps": stage_1_steps,
            "guidance_scales": guidance_scales, "face_decimation": face_decimation,
            "floaters_threshold": floaters_threshold, "anchor_idx": anchor_idx,
        }
        saved = {name: getattr(*targets[name]) for name in targets}
        try:
            for name, value in given.items():
                if value is not None:
                    setattr(*targets[name], value)
            yield
        finally:
            for name, value in saved.items():
                setattr(*targets[name], value)

    def preprocess(self, input: ActionMeshInput) -> ActionMeshInput:
        """Matting (frames without a valid alpha) and crop, on a copy: the
        caller's frames keep their alpha. Under a mesh every rank takes rank
        0's frames."""
        input = ActionMeshInput(frames=list(input.frames), timesteps=input.timesteps.copy())
        with span("matting"):
            input.frames = self.background_removal.process_images(input.frames)
        with span("crop"):
            input.frames = self.image_process.process_images(input.frames)
        if self.device_mesh is not None:
            input.frames = broadcast_object(input.frames)
        return input

    @torch.no_grad()
    def __call__(
        self,
        input: ActionMeshInput,
        seed: int = 44,
        stage_0_steps: Optional[int] = None,
        face_decimation: Optional[int] = None,
        floaters_threshold: Optional[float] = None,
        stage_1_steps: Optional[int] = None,
        guidance_scales: Optional[list[float]] = None,
        anchor_idx: Optional[int] = None,
    ) -> list[Mesh]:
        """Run the video -> 4D pipeline. Returns meshes ordered by timestep.

        The overrides hold for this call only (``call_overrides``).
        Per-phase wall times (device work synchronised) are logged and read
        from ``self.phase_seconds``.
        """
        with self.call_overrides(
            stage_0_steps=stage_0_steps, face_decimation=face_decimation,
            floaters_threshold=floaters_threshold, stage_1_steps=stage_1_steps,
            guidance_scales=guidance_scales, anchor_idx=anchor_idx,
        ):
            return self._run(input, seed)

    def _run(self, input: ActionMeshInput, seed: int) -> list[Mesh]:
        with span("pipeline") as self.last_call:
            with self._phase("preprocess"):
                input = self.preprocess(input)
            with self._phase("stage0"):
                latent_bank, mesh_bank = self.init_banks_from_anchor(input, seed)
            with self._phase("encode"):
                context = self.encode_all_frames(input)
            with self._phase("stage1"):
                latent_bank = self.generate_3d_latents(input, context, latent_bank, seed=seed)
            with self._phase("stage2"):
                mesh_bank = self.generate_mesh_animation(latent_bank, mesh_bank)
        return mesh_bank.get_ordered()[0]
