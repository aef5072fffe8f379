"""TripoSG image -> 3D pipeline: DiT flow sampling, VAE decode, extraction.

Counterpart of ``actionmesh_tpu/models/triposg/pipeline.py``. ``__call__``
returns (latents (1, 2048, 64) fp32, mesh) for one image: DINOv2 context,
a rectified-flow Euler loop with two-branch classifier-free guidance
(``flow_sample``), the VAE's decoded set, and hierarchical SDF extraction
with marching cubes (``decode_latents``).

``from_pretrained`` loads a VAST-AI/TripoSG checkpoint (``transformer/`` and
``vae/``, each with its config.json, which maps to the configs failing on
any key it does not know), the development path random weights
(``from_random``). ``encode_to_latent`` maps a surface (B, N, 6) to a latent
through the VAE's encoder (the {video + 3D} mode's Stage 0).

``device_mesh`` (``parallel/mesh.py``): the DiT's weights are cut as the
Stage-I denoiser's (heads and MLP columns over tp), the CFG pair of each
sampling step splits over dp, and each SDF query chunk splits over every
rank; the VAE stays whole on every rank.
"""

from __future__ import annotations

import logging
from pathlib import Path
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
    encode_surface,
    init_triposg_vae,
    presample_size,
    _query_chunk,
    query_sdf_at_ids,
    query_sdf_grid_inside,
)
from actionmesh_tpu_torch.ops.isosurface import hierarchical_extract_geometry
from actionmesh_tpu_torch.sampling.flow_schedule import get_schedule
from actionmesh_tpu_torch.utils.profiling import Span, span
from actionmesh_tpu_torch.utils.weights import check_config_keys, read_config

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
    mesh=None,
) -> torch.Tensor:
    """Euler rectified-flow loop from ``init_noise`` (B, N, C).

    The schedule (timesteps (steps+1,), distances (steps,)) is fp32; each
    Euler step is taken in fp32 and rounded once to the latents' dtype.
    With a ``guidance_scale`` each step runs the unconditional branch (zeroed
    context, cross-attention skipped) and the conditional one in one batch
    and mixes them; ``None`` is the guidance-free path of a distilled
    checkpoint, one conditional forward per step.

    ``mesh``: ``dit_params`` are this rank's ``shard_params`` slices and the
    inputs the whole tensors, the same on every rank; the CFG pair splits
    over dp (the guidance-free batch of 1 runs whole on every dp rank),
    the heads over tp, and every rank's latents stay the same.

    Each step runs in a ``dit_step`` span.
    """
    B = init_noise.shape[0]
    latents = init_noise
    ts = np.asarray(timesteps, np.float32)[:-1]
    ds = np.asarray(distances, np.float32)
    if guidance_scale is not None:
        context = torch.cat([torch.zeros_like(context), context], dim=0)
    for t, dist in zip(ts.tolist(), ds.tolist()):
        with span("dit_step"):
            if guidance_scale is None:
                dt = torch.full((B,), t, dtype=torch.float32, device=latents.device)
                v = triposg_dit_forward(dit_params, dit_cfg, latents, context, dt, mesh=mesh).float()
            else:
                dt = torch.full((2 * B,), t, dtype=torch.float32, device=latents.device)
                pred = triposg_dit_forward(
                    dit_params, dit_cfg, torch.cat([latents, latents], dim=0), context, dt,
                    uncond_batch=B, mesh=mesh,
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


def encode_draws(seed: int, batch: int, n_points: int, n_presample: int, latent_shape) -> dict:
    """The seeded encode's random draws, from one CPU generator (the same on
    every device): ``pre_idx`` (the presample, without replacement; None
    when it would keep every point), ``start`` (FPS's first pick per batch
    entry) and the posterior ``noise`` (fp32)."""
    gen = torch.Generator().manual_seed(seed)
    pre_idx = torch.randperm(n_points, generator=gen)[:n_presample] if n_presample < n_points else None
    start = torch.randint(0, n_presample, (batch,), generator=gen)
    noise = torch.randn(tuple(latent_shape), generator=gen, dtype=torch.float32)
    return {"pre_idx": pre_idx, "start": start, "noise": noise}


def coarse_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """The torch dtype ``stage_0.coarse_decode_dtype`` names ("bfloat16",
    "float16", ...), None for None or ""; a name that is no dtype raises,
    as JAX's ``jnp.dtype`` does."""
    if not name:
        return None
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"coarse_decode_dtype: data type {name!r} not understood")
    return dtype


def triposg_configs(path: Path):
    """(DiT config, VAE config) of a TripoSG checkpoint: its
    ``transformer/config.json`` and ``vae/config.json`` (an absent one
    gives the defaults) through ``triposg_configs_from``."""
    return triposg_configs_from(read_config(path / "transformer"), read_config(path / "vae"))


def triposg_configs_from(dit_raw: dict, vae_raw: dict):
    """(DiT config, VAE config) from the two config.json contents, mapped
    as the JAX package maps them; a key the mapping does not know raises,
    metadata keys are ignored."""

    def make_picker(raw: dict, which: str):
        recognized: set = set()

        def pick(default, *keys):
            recognized.update(keys)
            for k in keys:
                if k in raw:
                    return raw[k]
            return default

        return pick, lambda: check_config_keys(raw, recognized, f"TripoSG {which}")

    pick, dit_finish = make_picker(dit_raw, "transformer")
    dit_cfg = triposg_dit_config(
        num_tokens=pick(2048, "num_tokens", "width_latent"),
        in_channels=pick(64, "in_channels", "latent_channels"),
        num_layers=pick(21, "num_layers", "num_hidden_layers", "num_attention_layers"),
        width=pick(2048, "width", "hidden_size", "inner_dim"),
        num_attention_heads=pick(16, "num_attention_heads", "num_heads"),
        cross_attention_dim=pick(1024, "cross_attention_dim", "context_dim", "encoder_hid_dim"),
    )
    pick(64, "out_channels")  # == in_channels for a flow model
    dit_finish()

    pick, vae_finish = make_picker(vae_raw, "vae")
    vae_cfg = TripoSGVAEConfig(
        latent_channels=pick(64, "latent_channels", "embed_dim"),
        num_tokens=pick(2048, "num_tokens", "num_latents"),
        embed_frequency=pick(8, "embed_frequency", "num_freqs"),
        encoder_width=pick(512, "width_encoder", "encoder_width"),
        encoder_layers=pick(8, "num_layers_encoder", "encoder_layers"),
        decoder_width=pick(1024, "width_decoder", "decoder_width", "width"),
        decoder_layers=pick(16, "num_layers_decoder", "decoder_layers", "num_layers"),
    )
    vae_finish()
    return dit_cfg, vae_cfg


class TripoSGPipeline:
    """Image -> (3D latent, mesh) backend for Stage 0.

    ``sdf_regularizer(pts, vals)`` (numpy) and its torch mirror
    ``sdf_regularizer_torch`` may reshape the decoded field before the
    extraction; only the development Stage 0 sets them
    (``models/stage0.py:DevTripoSG``). Without a torch mirror a host
    regularizer forces the host-callback extraction.

    A call runs in the spans ``encode``, ``dit_sample`` and ``decode``
    (``utils/profiling.py``), each ending in a device synchronisation;
    ``phase_seconds`` reads the last call's. A decode runs each latent's
    ``decode_kv`` and ``extract`` spans, the field queries inside the
    latter; ``extract_stats`` reads the last extraction's counters, the SDF
    chunks each pass queried.
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
        device_mesh=None,
    ):
        self.dit_cfg = dit_cfg or triposg_dit_config()
        self.device_mesh = device_mesh
        if device_mesh is not None:
            from actionmesh_tpu_torch.parallel.mesh import denoiser_param_shardings, shard_params

            dit_params = shard_params(
                dit_params,
                denoiser_param_shardings(dit_params, device_mesh, self.dit_cfg.num_attention_heads),
                device_mesh,
            )
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
        self._phase_spans: list[Span] = []  # the last __call__'s
        self._extract_span: Optional[Span] = None  # the last decode's last extraction

    @property
    def phase_seconds(self) -> dict[str, float]:
        """Seconds of the last call's encode, dit_sample and decode."""
        return {sp.name: sp.seconds for sp in self._phase_spans}

    @property
    def extract_stats(self) -> dict[str, int]:
        """SDF query chunks per pass of the last extraction: ``{"prefilter":
        n, "band": n, "dense": n, "fine": n}``."""
        return dict(self._extract_span.counters) if self._extract_span is not None else {}

    @classmethod
    def from_pretrained(
        cls,
        path: str | Path,
        dtype: torch.dtype = torch.bfloat16,
        image_encoder: Optional[ImageEncoder] = None,
        device: torch.device = torch.device("cuda"),
        device_mesh=None,
    ) -> "TripoSGPipeline":
        """Load a VAST-AI/TripoSG checkpoint (``transformer/`` + ``vae/``).

        The architecture comes from each subfolder's config.json, mapped as
        the JAX package maps it. A key the mapping does not know raises: a
        defaulted hyperparameter
        would build a wrong model that converts cleanly. Hugging Face
        metadata keys are ignored. The converted trees are shape-checked
        against the configured architecture. The DINOv2 encoder is loaded
        from ``path.parent / "dinov2"`` unless one is given.
        """
        from actionmesh_tpu_torch.utils import weights as weights_util

        path = Path(path)
        device = torch.device(device)
        dit_cfg, vae_cfg = triposg_configs(path)
        dit_state = weights_util.load_safetensors_dir(path / "transformer")
        vae_state = weights_util.load_safetensors_dir(path / "vae")
        dit_params = weights_util.convert_triposg_dit(dit_state, dit_cfg, dtype)
        vae_params = weights_util.convert_triposg_vae(vae_state, vae_cfg, dtype)
        return cls(
            dit_params=weights_util.params_from_jax(dit_params, device),
            vae_params=weights_util.params_from_jax(vae_params, device),
            image_encoder=image_encoder
            or ImageEncoder(device=device, dtype=dtype, weights_dir=path.parent / "dinov2"),
            dit_cfg=dit_cfg,
            vae_cfg=vae_cfg,
            dtype=dtype,
            device=device,
            device_mesh=device_mesh,
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
        device_mesh=None,
    ) -> "TripoSGPipeline":
        """Random weights: the DiT from generator ``seed``, the VAE from
        generator ``seed + 1``, both on ``device`` (the same on every rank,
        which then keeps its slices)."""
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
            device_mesh=device_mesh,
        )

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def schedule(self, num_inference_steps: int) -> tuple[np.ndarray, np.ndarray]:
        """(the DiT's diffusion time at each of the steps + 1 points, the
        Euler distances (steps,)): the shifted rectified-flow schedule."""
        return get_schedule(num_inference_steps, self._num_train_timesteps, self._shift)

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
        coarse_dtype(coarse_decode_dtype)  # a bad name raises before the DiT loop
        with span("encode") as encode:
            context = self.image_encoder.encode_images([image])  # (1, S, Dc)
            self._sync()
        with span("dit_sample") as dit_sample:
            noise = initial_noise(
                seed, (1, self.vae_cfg.num_tokens, self.vae_cfg.latent_channels),
                self._dtype, self.device,
            )
            ts, dist = self.schedule(num_inference_steps)
            latents = flow_sample(
                self.dit_params, self.dit_cfg, noise, context.to(self._dtype), ts, dist,
                guidance_scale=None if guidance_scale <= 0 else float(guidance_scale),
                mesh=self.device_mesh,
            )
            self._sync()
        with span("decode") as decode:
            meshes = self.decode_latents(
                latents,
                bounds=bounds,
                dense_octree_depth=dense_octree_depth,
                hierarchical_octree_depth=hierarchical_octree_depth,
                prefilter_octree_depth=prefilter_octree_depth,
                coarse_decode_dtype=coarse_decode_dtype,
            )
        self._phase_spans = [encode, dit_sample, decode]
        logger.info(
            "stage0 encode %.2fs, dit_sample (%d steps) %.2fs, decode %.2fs",
            encode.seconds, num_inference_steps, dit_sample.seconds, decode.seconds,
        )
        return latents.float(), meshes[0]

    @torch.no_grad()
    def encode_to_latent(self, surface, seed: Optional[int] = None) -> torch.Tensor:
        """surface (B, N, 6) -> latent (B, K, C) fp32.

        Without a seed: FPS over all points from index 0, the posterior's
        mean (deterministic). With one: ``encode_draws`` gives the presample,
        FPS's start and the posterior noise, the JAX package's three random
        draws.
        """
        surface = torch.as_tensor(surface, dtype=torch.float32, device=self.device)
        draws = {}
        if seed is not None:
            B, N, _ = surface.shape
            draws = encode_draws(
                seed, B, N, presample_size(self.vae_cfg, N),
                (B, self.vae_cfg.num_tokens, self.vae_cfg.latent_channels),
            )
        return encode_surface(self.vae_params, self.vae_cfg, surface, **draws).float()

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
        ``coarse_decode_dtype`` ("bfloat16"): the coarse passes, which read
        only signs (the prefilter or dense sign grid and the band), query in
        that dtype (kernel A's bf16 path on the card); the fine pass, whose
        values place the vertices, stays fp32. A sign that bf16 flips lies
        next to the surface, where the fine pass decides.
        """
        coarse_cd = coarse_dtype(coarse_decode_dtype)
        latents = latents.to(device=self.device, dtype=self._dtype)
        reg_host, reg_torch = self.sdf_regularizer, self.sdf_regularizer_torch
        params, cfg, mesh = self.vae_params, self.vae_cfg, self.device_mesh
        meshes = []
        for b in range(latents.shape[0]):
            with span("decode_kv"):
                kv = decode_kv(params, cfg, latents[b : b + 1])

            def sdf_fn(pts: np.ndarray) -> np.ndarray:
                pts_t = torch.as_tensor(pts, dtype=torch.float32, device=self.device)
                out = _query_chunk(params, cfg, kv, pts_t, mesh).cpu().numpy()
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
                        params, cfg, kv, lo, step, level, Rc, regularizer=reg_torch,
                        compute_dtype=coarse_cd, mesh=mesh,
                    )

                def ids_val_fn(ijk, lo, step):
                    return query_sdf_at_ids(
                        params, cfg, kv, ijk, lo, step, regularizer=reg_torch, mesh=mesh
                    )

            # the sign-only variant for the prefilter and band passes
            ids_val_coarse_fn = None
            if ids_val_fn is not None and coarse_cd is not None:

                def ids_val_coarse_fn(ijk, lo, step):
                    return query_sdf_at_ids(
                        params, cfg, kv, ijk, lo, step, regularizer=reg_torch,
                        compute_dtype=coarse_cd, mesh=mesh,
                    )

            with span("extract") as self._extract_span:
                v, f = hierarchical_extract_geometry(
                    sdf_fn,
                    bounds=bounds,
                    dense_octree_depth=dense_octree_depth,
                    hierarchical_octree_depth=hierarchical_octree_depth,
                    grid_inside_fn=grid_inside_fn,
                    ids_val_fn=ids_val_fn,
                    chunk=QUERY_CHUNK,  # the fast paths' chunk: ids are padded to it
                    prefilter_octree_depth=prefilter_octree_depth,
                    ids_val_coarse_fn=ids_val_coarse_fn,
                    stats=self._extract_span.counters,
                )
            if len(f) == 0:
                logger.warning(
                    "SDF field has no zero crossing in bounds: an empty mesh (latent %d).", b
                )
            meshes.append(Mesh(vertices=v, faces=f))
        return meshes
