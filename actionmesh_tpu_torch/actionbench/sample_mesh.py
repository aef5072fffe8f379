"""Mesh surface sampling for evaluation (area-weighted barycentric).

Counterpart of ``actionbench/sample_mesh.py``: host numpy with the same
``RandomState`` streams, so the samples equal the JAX package's bit for
bit. ``synchronized=True`` draws face ids and barycentrics on the root mesh
and replays them on every frame (correspondence-preserving, for the motion
chamfer).
"""

from __future__ import annotations

import numpy as np

from actionmesh_tpu_torch.io.mesh import Mesh


def _rand_barycentric_coords(
    size: int, rng: np.random.RandomState
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    u, v = rng.rand(2, size)
    u_sqrt = np.sqrt(u)
    return 1.0 - u_sqrt, u_sqrt * (1.0 - v), u_sqrt * v


def get_baryc_sampling_mesh(
    mesh: Mesh, num_samples: int, seed: int = 44
) -> tuple[np.ndarray, np.ndarray]:
    """Area-weighted face indices + barycentric coords from one mesh."""
    if mesh.n_faces == 0:
        raise ValueError("Meshes are empty.")
    if not np.isfinite(mesh.vertices).all():
        raise ValueError("Meshes contain nan or inf.")
    rng = np.random.RandomState(seed)
    _, areas = mesh.face_normals_and_areas()
    total_area = areas.sum()
    if total_area <= 0:
        # a collapsed mesh fails its sample (status "error") instead of
        # drawing every point from face 0
        raise ValueError("Meshes are degenerate: total face area is zero.")
    # inverse-CDF sampling of faces by area
    cdf = np.cumsum(areas / total_area)
    cdf[-1] = 1.0
    face_idx = np.searchsorted(cdf, rng.rand(num_samples), side="right")
    face_idx = np.minimum(face_idx, mesh.n_faces - 1)
    w0, w1, w2 = _rand_barycentric_coords(num_samples, rng)
    return face_idx, np.stack([w0, w1, w2], axis=-1)


def apply_baryc_sampling(mesh: Mesh, face_idx: np.ndarray, baryc: np.ndarray) -> np.ndarray:
    tri = mesh.vertices[mesh.faces[face_idx]]  # (S, 3, 3)
    return np.einsum("sc,scd->sd", baryc, tri)


def sample_points(mesh: Mesh, n_pts: int, seed: int = 44) -> np.ndarray:
    """Uniform area-weighted surface sample -> (n_pts, 3) float32."""
    face_idx, baryc = get_baryc_sampling_mesh(mesh, n_pts, seed=seed)
    return apply_baryc_sampling(mesh, face_idx, baryc).astype(np.float32)


def sample_synchronized_points(
    meshes: list[Mesh], n_pts: int, seed: int = 44, root_idx: int = 0
) -> np.ndarray:
    """The root mesh's faces and barycentrics replayed on every frame."""
    face_idx, baryc = get_baryc_sampling_mesh(meshes[root_idx], n_pts, seed=seed)
    ref_faces = meshes[root_idx].faces
    for m in meshes:
        if not np.array_equal(m.faces, ref_faces):
            raise ValueError("synchronized sampling needs one topology on every frame")
    return np.stack([apply_baryc_sampling(m, face_idx, baryc) for m in meshes]).astype(np.float32)


def sample_meshes(
    meshes: list[Mesh], n_pts: int = 100_000, synchronized: bool = False, seed: int = 44
) -> np.ndarray:
    """(T, n_pts, 3) samples; seed + t for frame t unless synchronized."""
    if synchronized:
        return sample_synchronized_points(meshes, n_pts, seed=seed, root_idx=0)
    return np.stack([sample_points(mesh, n_pts, seed=seed + i) for i, mesh in enumerate(meshes)])
