"""Stage 0 backend factory: anchor image -> (3D latent, mesh).

Counterpart of ``actionmesh_tpu/models/stage0.py``. The production backend
is TripoSG (``models/triposg/``: DINOv2 context, 100-step DiT rectified-flow
sampling with CFG, the VAE's SDF decode, marching cubes), loaded from its
checkpoint when there is one. Without weights the pipeline runs ``DevTripoSG``,
the same code path with random weights, at the production latent shape
(2048, 64); at any other shape, or with ``ACTIONMESH_DEV_STAGE0=stub``, it
runs the deterministic stub (a seeded latent and a UV sphere).

``model="hunyuan3d-2.1"`` selects Hunyuan3D-2.1's shape model instead
(``models/hunyuan3d/``), which hands Stage I a TripoSG latent of its mesh;
without its weights ``DevHunyuan3D``, the same path on random weights.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from actionmesh_tpu_torch.io.mesh import Mesh

logger = logging.getLogger(__name__)


def make_uv_sphere(radius: float = 0.8, n_lat: int = 64, n_lon: int = 128) -> Mesh:
    """UV sphere in the [-1, 1]^3 normalised space."""
    lat = np.linspace(0, np.pi, n_lat + 1)[1:-1]
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    t, p = np.meshgrid(lat, lon, indexing="ij")
    ring = radius * np.stack(
        [np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)], axis=-1
    ).reshape(-1, 3)
    vertices = np.concatenate([[[0.0, 0.0, radius]], ring, [[0.0, 0.0, -radius]]])

    j = np.arange(n_lon)
    jn = (j + 1) % n_lon
    faces = [np.stack([np.zeros(n_lon, np.int64), 1 + j, 1 + jn], axis=1)]  # top cap
    for i in range(n_lat - 2):
        r0, r1 = 1 + i * n_lon, 1 + (i + 1) * n_lon
        a, b, c, d = r0 + j, r0 + jn, r1 + j, r1 + jn
        faces.append(np.stack([np.stack([a, c, b], 1), np.stack([b, c, d], 1)], 1).reshape(-1, 3))
    last = len(vertices) - 1
    ring0 = 1 + (n_lat - 2) * n_lon
    faces.append(np.stack([np.full(n_lon, last), ring0 + jn, ring0 + j], axis=1))  # bottom
    return Mesh(vertices=vertices, faces=np.concatenate(faces))


class StubImageTo3D:
    """Deterministic development stand-in for the TripoSG backend."""

    def __init__(self, latent_shape: tuple[int, int], device: torch.device):
        self.latent_shape = tuple(latent_shape)
        self.device = device

    def __call__(self, image: np.ndarray, seed: int = 44, **_) -> tuple[torch.Tensor, Mesh]:
        # Mix the image content into the seed so different inputs diverge
        content_hash = int(image[..., :3].sum(dtype=np.int64)) & 0x7FFFFFFF
        # drawn on the CPU, so the latent is the same on every device
        gen = torch.Generator().manual_seed(seed ^ content_hash)
        latent = torch.randn((1,) + self.latent_shape, generator=gen, dtype=torch.float32)
        return latent.to(self.device), make_uv_sphere()


class DevTripoSG:
    """Development Stage 0: the real TripoSG path with random weights.

    Every Stage-0 cost of the production path runs: DINOv2 conditioning,
    DiT sampling, the hierarchical SDF decode, marching cubes (and, in the
    pipeline, QEM decimation). Two accommodations, neither removing
    compute: the TripoSG pipeline is built at the first call, so a
    pipeline whose Stage 0 a test replaces never builds it; and the decoded
    field is blended into a sphere SDF (``_dev_sdf_regularizer``), since a
    random-weight decoder's noise field has no usable surface.

    ``image_encoder``: the DINOv2 encoder to condition on. The JAX package
    builds a second encoder from the same seed (``init_seed=1``), so the
    same weights; ``ActionMeshPipeline`` hands over its own instead.
    """

    def __init__(
        self,
        device: torch.device,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        image_encoder=None,
        device_mesh=None,
    ):
        self.device = device
        self._device_mesh = device_mesh
        self._dtype = dtype
        self._seed = seed
        self._image_encoder = image_encoder
        self._pipe = None

    @property
    def pipeline(self):
        if self._pipe is None:
            from actionmesh_tpu_torch.models.triposg.pipeline import TripoSGPipeline

            logger.info("Building the random-weight TripoSG pipeline (development mode)")
            self._pipe = TripoSGPipeline.from_random(
                seed=self._seed, dtype=self._dtype, image_encoder=self._image_encoder,
                device=self.device, device_mesh=self._device_mesh,
            )
            self._pipe.sdf_regularizer = _dev_sdf_regularizer
            self._pipe.sdf_regularizer_torch = _dev_sdf_regularizer_torch
        return self._pipe

    def __call__(self, image: np.ndarray, **kwargs) -> tuple[torch.Tensor, Mesh]:
        return self.pipeline(image, **kwargs)

    def encode_to_latent(self, surface, seed: Optional[int] = None) -> torch.Tensor:
        return self.pipeline.encode_to_latent(surface, seed=seed)


def dev_hunyuan3d_configs(latent_shape: tuple[int, int]) -> dict:
    """``Hunyuan3DPipeline.from_random``'s configurations for the
    development path: the published widths, and the handoff's TripoSG VAE
    at Stage I's latent shape."""
    from actionmesh_tpu_torch.models.triposg.vae import TripoSGVAEConfig

    return {"handoff_cfg": TripoSGVAEConfig(num_tokens=latent_shape[0], latent_channels=latent_shape[1])}


class DevHunyuan3D(DevTripoSG):
    """Development Stage 0 with Hunyuan3D-2.1's shape model: its path on
    random weights (``Hunyuan3DPipeline.from_random`` at
    ``dev_hunyuan3d_configs``), built at the first call, with the same SDF
    regulariser as ``DevTripoSG``. ``handoff``: the TripoSG VAE's encode
    path to hand over with (random weights when None)."""

    def __init__(self, device: torch.device, latent_shape: tuple[int, int],
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0, handoff=None):
        super().__init__(device, dtype=dtype, seed=seed)
        self._latent_shape = tuple(latent_shape)
        self._handoff = handoff

    @property
    def pipeline(self):
        if self._pipe is None:
            from actionmesh_tpu_torch.models.hunyuan3d.pipeline import Hunyuan3DPipeline

            logger.info("Building the random-weight Hunyuan3D-2.1 pipeline (development mode)")
            self._pipe = Hunyuan3DPipeline.from_random(
                seed=self._seed, dtype=self._dtype, device=self.device, handoff=self._handoff,
                **dev_hunyuan3d_configs(self._latent_shape),
            )
            self._pipe.sdf_regularizer = _dev_sdf_regularizer
            self._pipe.sdf_regularizer_torch = _dev_sdf_regularizer_torch
        return self._pipe


def _dev_sdf_regularizer(pts: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Noisy-sphere SDF for random-weight runs: the decoded values perturb a
    sphere of radius 0.65 instead of being the field (inside negative)."""
    r = np.linalg.norm(pts, axis=-1)
    return (r - 0.65) + 0.12 * np.tanh(vals.astype(np.float32))


def _dev_sdf_regularizer_torch(pts: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Device mirror of ``_dev_sdf_regularizer`` (same math in torch), for
    the extraction's device fast paths."""
    r = torch.linalg.vector_norm(pts, dim=-1)
    return (r - 0.65) + 0.12 * torch.tanh(vals.float())


# Stage-0 model -> its checkpoint's directory under the pipeline's weights_dir
STAGE0_MODELS = {"triposg": "TripoSG", "hunyuan3d-2.1": "Hunyuan3D-2.1"}


def make_image_to_3d(
    weights_dir: Optional[Path],
    latent_shape: tuple[int, int],
    device: torch.device,
    dtype: torch.dtype = torch.bfloat16,
    image_encoder=None,
    device_mesh=None,
    model: str = "triposg",
    handoff_dir: Optional[Path] = None,
):
    """TripoSG from the checkpoint in ``weights_dir`` if that exists (its
    DINOv2 is ``image_encoder`` if given, else the checkpoint beside it);
    without weights ``DevTripoSG`` at the production latent shape unless
    ``ACTIONMESH_DEV_STAGE0=stub``; the stub otherwise. ``device_mesh``:
    TripoSG's (``TripoSGPipeline``).

    ``model="hunyuan3d-2.1"``: Hunyuan3D-2.1 from ``weights_dir`` if that
    exists, else ``DevHunyuan3D``; its handoff encodes with TripoSG's VAE
    from ``handoff_dir`` (TripoSG's checkpoint) if that exists, else with a
    random one. It runs on one device (no ``device_mesh``)."""
    if model not in STAGE0_MODELS:
        raise ValueError(f"unknown Stage-0 model {model!r}; one of {tuple(STAGE0_MODELS)}")
    if model == "hunyuan3d-2.1":
        return _make_hunyuan3d(weights_dir, latent_shape, device, dtype, device_mesh, handoff_dir)
    if weights_dir is not None and Path(weights_dir).exists():
        from actionmesh_tpu_torch.models.triposg.pipeline import TripoSGPipeline

        logger.info("Loading TripoSG weights from %s", weights_dir)
        return TripoSGPipeline.from_pretrained(
            Path(weights_dir), dtype=dtype, image_encoder=image_encoder, device=device,
            device_mesh=device_mesh,
        )
    if tuple(latent_shape) == (2048, 64) and os.environ.get("ACTIONMESH_DEV_STAGE0", "triposg") != "stub":
        logger.warning(
            "TripoSG weights not found (%s) — running the real TripoSG path with "
            "random weights (development mode, dev SDF regularizer).",
            weights_dir,
        )
        return DevTripoSG(device, dtype=dtype, image_encoder=image_encoder, device_mesh=device_mesh)
    logger.warning(
        "TripoSG weights not found (%s) — using the deterministic Stage-0 stub "
        "(development mode).",
        weights_dir,
    )
    return StubImageTo3D(latent_shape, device)


def _make_hunyuan3d(weights_dir, latent_shape, device, dtype, device_mesh, handoff_dir):
    if device_mesh is not None:
        raise NotImplementedError("the Hunyuan3D-2.1 Stage 0 runs on one device (no device mesh)")
    handoff = None
    if handoff_dir is not None and Path(handoff_dir).exists():
        from actionmesh_tpu_torch.models.triposg.pipeline import TripoSGPipeline, triposg_configs
        from actionmesh_tpu_torch.utils import weights as weights_util

        logger.info("Loading TripoSG's VAE for the handoff from %s", handoff_dir)
        _, vae_cfg = triposg_configs(Path(handoff_dir))
        vae = weights_util.convert_triposg_vae(
            weights_util.load_safetensors_dir(Path(handoff_dir) / "vae"), vae_cfg, dtype)
        handoff = TripoSGPipeline(None, weights_util.params_from_jax(vae, device), None,
                                  vae_cfg=vae_cfg, dtype=dtype, device=device)
    if weights_dir is not None and Path(weights_dir).exists():
        from actionmesh_tpu_torch.models.hunyuan3d.pipeline import Hunyuan3DPipeline

        if handoff is None:
            raise FileNotFoundError(
                f"Hunyuan3D-2.1 weights in {weights_dir} need TripoSG's VAE for the handoff "
                f"({handoff_dir} is missing)")
        logger.info("Loading Hunyuan3D-2.1 weights from %s", weights_dir)
        return Hunyuan3DPipeline.from_pretrained(Path(weights_dir), handoff, dtype=dtype, device=device)
    logger.warning(
        "Hunyuan3D-2.1 weights not found (%s) — running its path with random weights "
        "(development mode, dev SDF regularizer).", weights_dir,
    )
    return DevHunyuan3D(device, latent_shape, dtype=dtype, handoff=handoff)
