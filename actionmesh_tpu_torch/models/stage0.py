"""Stage 0 backend factory: anchor image -> (3D latent, mesh).

Counterpart of ``actionmesh_tpu/models/stage0.py``. The production backend
(TripoSG: DiT, VAE, SDF decode, marching cubes) is not ported yet; without
weights the pipeline runs the development stub, a seeded latent and a UV
sphere, as the JAX package's ``StubImageTo3D`` does.
"""

from __future__ import annotations

import logging
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


def make_image_to_3d(
    weights_dir: Optional[Path], latent_shape: tuple[int, int], device: torch.device
) -> StubImageTo3D:
    if weights_dir is not None and Path(weights_dir).exists():
        raise NotImplementedError("TripoSG Stage 0 is not ported yet")
    logger.warning(
        "TripoSG weights not found (%s) — using the deterministic Stage-0 stub "
        "(development mode).",
        weights_dir,
    )
    return StubImageTo3D(latent_shape, device)
