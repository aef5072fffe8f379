"""TripoSG image -> 3D pipeline: DiT flow sampling, VAE decode, extraction.

Counterpart of ``actionmesh_tpu/models/triposg/pipeline.py``. ``__call__``
returns (latents (1, 2048, 64) fp32, mesh) for one image: DINOv2 context,
a rectified-flow Euler loop with two-branch classifier-free guidance
(``flow_sample``), the VAE's decoded set, and hierarchical SDF extraction
with marching cubes (``decode_latents``).

Loading a TripoSG checkpoint (``from_pretrained``, the config.json mapping
and the safetensors converters) waits until the checkpoint is in the
repository; the development path builds random weights (``from_random``).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

import numpy as np
import torch

from actionmesh_tpu_torch.io.mesh import Mesh
from actionmesh_tpu_torch.models.denoiser import DenoiserConfig
from actionmesh_tpu_torch.models.image_encoder import ImageEncoder
from actionmesh_tpu_torch.models.layers import Params
from actionmesh_tpu_torch.models.triposg.dit import (
    init_triposg_dit,
    triposg_dit_config,
    triposg_dit_forward,
)
from actionmesh_tpu_torch.models.triposg.vae import (
    QUERY_CHUNK,
    TripoSGVAEConfig,
    decode_kv,
    init_triposg_vae,
    query_sdf,
    query_sdf_at_ids,
    query_sdf_grid_inside,
)
from actionmesh_tpu_torch.ops.isosurface import hierarchical_extract_geometry
from actionmesh_tpu_torch.sampling.flow_schedule import get_schedule

logger = logging.getLogger(__name__)

DEFAULT_BOUNDS = (-1.005, -1.005, -1.005, 1.005, 1.005, 1.005)


@torch.no_grad()
def flow_sample(
    dit_params: Params,
    dit_cfg: DenoiserConfig,
    init_noise: torch.Tensor,
    context: torch.Tensor,
    timesteps: np.ndarray,
    distances: np.ndarray,
    guidance_scale: Optional[float],
) -> torch.Tensor:
    """Euler rectified-flow loop from ``init_noise`` (B, N, C).

    The schedule (timesteps (steps+1,), distances (steps,)) is fp32; each
    Euler step is taken in fp32 and rounded once to the latents' dtype.
    With a ``guidance_scale`` each step runs the unconditional branch (zeroed
    context, cross-attention skipped) and the conditional one in one batch
    and mixes them; ``None`` is the guidance-free path of a distilled
    checkpoint, one conditional forward per step.
    """
    B = init_noise.shape[0]
    latents = init_noise
    ts = np.asarray(timesteps, np.float32)[:-1]
    ds = np.asarray(distances, np.float32)
    if guidance_scale is not None:
        context = torch.cat([torch.zeros_like(context), context], dim=0)
    for t, dist in zip(ts.tolist(), ds.tolist()):
        if guidance_scale is None:
            dt = torch.full((B,), t, dtype=torch.float32, device=latents.device)
            v = triposg_dit_forward(dit_params, dit_cfg, latents, context, dt).float()
        else:
            dt = torch.full((2 * B,), t, dtype=torch.float32, device=latents.device)
            pred = triposg_dit_forward(
                dit_params, dit_cfg, torch.cat([latents, latents], dim=0), context, dt,
                uncond_batch=B,
            ).float()
            uncond, cond = pred[:B], pred[B:]
            v = uncond + guidance_scale * (cond - uncond)
        latents = (latents.float() + dist * v).to(latents.dtype)
    return latents


def initial_noise(seed: int, shape: tuple[int, ...], dtype: torch.dtype, device) -> torch.Tensor:
    """The sampler's starting noise, drawn in fp32 from a CPU generator so
    that a seed gives the same noise on every device."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(device=device, dtype=dtype)


def _refuse_coarse_decode_dtype(coarse_decode_dtype: Optional[str]) -> None:
    """The JAX package's reduced-precision coarse pass is not ported: no
    preset sets it, and every query here runs in fp32."""
    if coarse_decode_dtype is not None:
        raise NotImplementedError(
            f"coarse_decode_dtype={coarse_decode_dtype!r}: the reduced-precision "
            "coarse SDF pass is not ported; leave it None (fp32 queries)"
        )


class TripoSGPipeline:
    """Image -> (3D latent, mesh) backend for Stage 0.

    ``sdf_regularizer(pts, vals)`` (numpy) and its torch mirror
    ``sdf_regularizer_torch`` may reshape the decoded field before the
    extraction; only the development Stage 0 sets them
    (``models/stage0.py:DevTripoSG``). Without a torch mirror a host
    regularizer forces the host-callback extraction.
    """

    def __init__(
        self,
        dit_params: Params,
        vae_params: Params,
        image_encoder: ImageEncoder,
        dit_cfg: Optional[DenoiserConfig] = None,
        vae_cfg: Optional[TripoSGVAEConfig] = None,
        dtype: torch.dtype = torch.bfloat16,
        device: torch.device = torch.device("cuda"),
        num_train_timesteps: int = 1000,
        shift: float = 3.0,
    ):
        self.dit_cfg = dit_cfg or triposg_dit_config()
        self.vae_cfg = vae_cfg or TripoSGVAEConfig()
        self.dit_params = dit_params
        self.vae_params = vae_params
        self.image_encoder = image_encoder
        self.device = torch.device(device)
        self._dtype = dtype
        self._num_train_timesteps = num_train_timesteps
        self._shift = shift
        self.sdf_regularizer: Optional[Callable] = None
        self.sdf_regularizer_torch: Optional[Callable] = None
        # seconds of the last __call__'s sub-phases, and SDF query chunks
        # per extraction pass of the last decode
        self.phase_seconds: dict[str, float] = {}
        self.extract_stats: dict[str, int] = {}

    @classmethod
    def from_pretrained(cls, *_, **__) -> "TripoSGPipeline":
        raise NotImplementedError(
            "loading TripoSG checkpoints is not ported yet: it waits until the "
            "VAST-AI/TripoSG weights are in the repository"
        )

    @classmethod
    def from_random(
        cls,
        seed: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        dit_cfg: Optional[DenoiserConfig] = None,
        vae_cfg: Optional[TripoSGVAEConfig] = None,
        image_encoder: Optional[ImageEncoder] = None,
        device: torch.device = torch.device("cuda"),
    ) -> "TripoSGPipeline":
        """Random weights: the DiT from generator ``seed``, the VAE from
        generator ``seed + 1``, both on ``device``."""
        device = torch.device(device)
        dit_cfg = dit_cfg or triposg_dit_config()
        vae_cfg = vae_cfg or TripoSGVAEConfig()
        dit_gen = torch.Generator(device=device).manual_seed(seed)
        vae_gen = torch.Generator(device=device).manual_seed(seed + 1)
        return cls(
            dit_params=init_triposg_dit(dit_gen, dit_cfg, dtype=dtype, device=device),
            vae_params=init_triposg_vae(vae_gen, vae_cfg, dtype=dtype, device=device),
            image_encoder=image_encoder or ImageEncoder(device=device, dtype=dtype),
            dit_cfg=dit_cfg,
            vae_cfg=vae_cfg,
            dtype=dtype,
            device=device,
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def __call__(
        self,
        image: np.ndarray,
        seed: int = 44,
        num_inference_steps: int = 100,
        guidance_scale: float = 7.5,
        bounds=DEFAULT_BOUNDS,
        dense_octree_depth: int = 8,
        hierarchical_octree_depth: int = 9,
        prefilter_octree_depth: Optional[int] = None,
        coarse_decode_dtype: Optional[str] = None,
    ) -> tuple[torch.Tensor, Mesh]:
        """(latents (1, K, C) fp32, mesh) from one (H, W, 3|4) uint8 image.

        ``guidance_scale <= 0`` selects guidance-free sampling.
        """
        _refuse_coarse_decode_dtype(coarse_decode_dtype)
        t0 = time.perf_counter()
        context = self.image_encoder.encode_images([image])  # (1, S, Dc)
        self._sync()
        t1 = time.perf_counter()
        noise = initial_noise(
            seed, (1, self.vae_cfg.num_tokens, self.vae_cfg.latent_channels),
            self._dtype, self.device,
        )
        ts, dist = get_schedule(num_inference_steps, self._num_train_timesteps, self._shift)
        latents = flow_sample(
            self.dit_params, self.dit_cfg, noise, context.to(self._dtype), ts, dist,
            guidance_scale=None if guidance_scale <= 0 else float(guidance_scale),
        )
        self._sync()
        t2 = time.perf_counter()
        meshes = self.decode_latents(
            latents,
            bounds=bounds,
            dense_octree_depth=dense_octree_depth,
            hierarchical_octree_depth=hierarchical_octree_depth,
            prefilter_octree_depth=prefilter_octree_depth,
            coarse_decode_dtype=coarse_decode_dtype,
        )
        t3 = time.perf_counter()
        self.phase_seconds = {"encode": t1 - t0, "dit_sample": t2 - t1, "decode": t3 - t2}
        logger.info(
            "stage0 encode %.2fs, dit_sample (%d steps) %.2fs, decode %.2fs",
            t1 - t0, num_inference_steps, t2 - t1, t3 - t2,
        )
        return latents.float(), meshes[0]

    def encode_to_latent(self, surface, seed: Optional[int] = None) -> torch.Tensor:
        raise NotImplementedError(
            "the TripoSG VAE encoder is not ported yet; it comes with the {video + 3D} mode"
        )

    @torch.no_grad()
    def decode_latents(
        self,
        latents: torch.Tensor,
        bounds=DEFAULT_BOUNDS,
        dense_octree_depth: int = 8,
        hierarchical_octree_depth: int = 9,
        prefilter_octree_depth: Optional[int] = None,
        coarse_decode_dtype: Optional[str] = None,
    ) -> list[Mesh]:
        """Latents (B, K, C) -> one mesh each, by hierarchical SDF extraction.

        ``prefilter_octree_depth``: the two-level coarse pass (only the
        surface band of a depth-P sign grid is queried at the dense depth).
        ``coarse_decode_dtype`` (the JAX package's reduced-precision coarse
        pass) is not ported: any value but None raises.
        """
        _refuse_coarse_decode_dtype(coarse_decode_dtype)
        latents = latents.to(device=self.device, dtype=self._dtype)
        reg_host, reg_torch = self.sdf_regularizer, self.sdf_regularizer_torch
        params, cfg = self.vae_params, self.vae_cfg
        meshes = []
        for b in range(latents.shape[0]):
            kv = decode_kv(params, cfg, latents[b : b + 1])

            def sdf_fn(pts: np.ndarray) -> np.ndarray:
                pts_t = torch.as_tensor(pts, dtype=torch.float32, device=self.device)
                out = query_sdf(params, cfg, kv, pts_t[None])[0].cpu().numpy()
                if reg_host is not None:
                    out = reg_host(pts, out)
                return out

            # Device fast paths (points generated on the device, one copy
            # back per call), usable unless a host regularizer lacks its
            # torch mirror.
            grid_inside_fn = ids_val_fn = None
            if reg_host is None or reg_torch is not None:

                def grid_inside_fn(lo, step, Rc, level):
                    return query_sdf_grid_inside(
                        params, cfg, kv, lo, step, level, Rc, regularizer=reg_torch
                    )

                def ids_val_fn(ijk, lo, step):
                    return query_sdf_at_ids(params, cfg, kv, ijk, lo, step, regularizer=reg_torch)

            self.extract_stats = {}
            v, f = hierarchical_extract_geometry(
                sdf_fn,
                bounds=bounds,
                dense_octree_depth=dense_octree_depth,
                hierarchical_octree_depth=hierarchical_octree_depth,
                grid_inside_fn=grid_inside_fn,
                ids_val_fn=ids_val_fn,
                chunk=QUERY_CHUNK,  # the fast paths' chunk: ids are padded to it
                prefilter_octree_depth=prefilter_octree_depth,
                stats=self.extract_stats,
            )
            if len(f) == 0:
                logger.warning(
                    "SDF field has no zero crossing in bounds: an empty mesh (latent %d).", b
                )
            meshes.append(Mesh(vertices=v, faces=f))
        return meshes
