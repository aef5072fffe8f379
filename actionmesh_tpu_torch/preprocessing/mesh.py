"""Mesh features, post-Stage-0 cleanup and the {video + 3D} helpers (host numpy).

Copy of the parts of ``actionmesh_tpu/preprocessing/mesh.py`` the port
runs: vertex features, merge/cleanup, QEM decimation (the native library,
``utils/native.py``, with its grid-clustering pre-pass on large meshes),
floater removal, the seeded ``MeshPostprocessor``, and for a user's mesh
normalisation, area-weighted surface sampling and the vertex merge map
that keeps its UV topology. Unlike the JAX
package there is no vertex-clustering fallback: a missing toolchain raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging

import numpy as np

from actionmesh_tpu_torch.io.mesh import Mesh
from actionmesh_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def scoped_seed(seed: int):
    """Temporarily seed numpy's global RNG, restoring its state after."""
    state = np.random.get_state()
    np.random.seed(seed)
    try:
        yield
    finally:
        np.random.set_state(state)


def get_mesh_features(mesh: Mesh, with_normals: bool) -> np.ndarray:
    """(V, 3|6) float32 vertex positions (+ unit normals)."""
    features = mesh.vertices.astype(np.float32)
    if with_normals:
        normals = mesh.vertex_normals.astype(np.float32)
        norm = np.linalg.norm(normals, axis=-1, keepdims=True)
        features = np.concatenate([features, normals / np.maximum(norm, 1e-12)], axis=-1)
    return features


def merge_vertices(mesh: Mesh, digits: int = 8) -> Mesh:
    """Merge exactly-coincident vertices (rounded to `digits`)."""
    rounded = np.round(mesh.vertices, digits)
    _, first_idx, inverse = np.unique(
        rounded, axis=0, return_index=True, return_inverse=True
    )
    return Mesh(vertices=mesh.vertices[first_idx], faces=inverse.reshape(-1)[mesh.faces])


def remove_degenerate_and_duplicate_faces(mesh: Mesh) -> Mesh:
    f = mesh.faces
    f = f[(f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])]
    # duplicates regardless of winding: sort vertex ids per face
    _, unique_idx = np.unique(np.sort(f, axis=1), axis=0, return_index=True)
    return Mesh(vertices=mesh.vertices, faces=f[np.sort(unique_idx)])


def remove_unreferenced_vertices(mesh: Mesh) -> Mesh:
    referenced = np.zeros(len(mesh.vertices), dtype=bool)
    referenced[mesh.faces.reshape(-1)] = True
    remap = np.cumsum(referenced) - 1
    return Mesh(vertices=mesh.vertices[referenced], faces=remap[mesh.faces])


def connected_components(mesh: Mesh) -> np.ndarray:
    """Face component labels via union-find over shared vertices."""
    parent = np.arange(len(mesh.vertices))

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    for face in mesh.faces:
        a = find(face[0])
        for v in face[1:]:
            b = find(v)
            if a != b:
                parent[b] = a
    roots = np.array([find(v) for v in mesh.faces[:, 0]])
    _, labels = np.unique(roots, return_inverse=True)
    return labels


def remove_floaters(mesh: Mesh, threshold: float = 0.02) -> Mesh:
    """Drop connected components with fewer than threshold * largest faces."""
    labels = connected_components(mesh)
    counts = np.bincount(labels)
    keep_labels = np.nonzero(counts >= threshold * counts.max())[0]
    keep = np.isin(labels, keep_labels)
    n_removed = int((~keep).sum())
    if n_removed:
        logger.info(
            "Removed %d floater faces in %d components",
            n_removed, len(counts) - len(keep_labels),
        )
    return remove_unreferenced_vertices(Mesh(vertices=mesh.vertices, faces=mesh.faces[keep]))


def decimate_mesh(mesh: Mesh, target_faces: int = 40000) -> Mesh:
    """Quadric-error decimation to ~target_faces (native library).

    Above max(16 * target, 400,000) faces a grid-clustering pass first
    brings the mesh to about 8x the target: the greedy QEM heap is serial
    and its time grows with the input, and QEM still does the last 8x.
    """
    from actionmesh_tpu_torch.utils.native import grid_cluster_simplify, quadric_decimate

    if mesh.n_faces <= target_faces:
        return mesh
    verts, faces = mesh.vertices, mesh.faces
    if mesh.n_faces > max(16 * target_faces, 400_000):
        vert_target = 4 * target_faces  # verts ~= faces / 2
        res = 256
        lo = verts.min(0)
        inv = (res - 1e-9) / np.maximum(verts.max(0) - lo, 1e-30)
        cell = np.floor((verts - lo) * inv).astype(np.int64)
        occ = len(np.unique((cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2]))
        res = int(np.clip(res * np.sqrt(vert_target / max(occ, 1)), 48, 1024))
        cv, cf = grid_cluster_simplify(verts, faces, res)
        if len(cf) > target_faces:  # never coarser than the target
            logger.info("Cluster pre-pass (res %d): %d -> %d faces", res, len(faces), len(cf))
            verts, faces = cv, cf
    v, f = quadric_decimate(verts, faces, target_faces)
    out = Mesh(vertices=v, faces=f)
    logger.info("Decimated %d -> %d faces (quadric)", mesh.n_faces, out.n_faces)
    return out


def normalize_mesh(mesh: Mesh, scale: float = 1.0) -> tuple[Mesh, np.ndarray, float]:
    """Centre and uniformly scale the mesh into [-scale, scale]^3; returns
    (normalised mesh, centre, factor), which ``denormalize_mesh`` undoes."""
    lo, hi = mesh.bounds
    center = (lo + hi) / 2.0
    factor = 2.0 * scale / max(float(np.max(hi - lo)), 1e-12)
    out = Mesh(vertices=(mesh.vertices - center) * factor, faces=mesh.faces, uv=mesh.uv, visual=mesh.visual)
    return out, center, factor


def denormalize_mesh(mesh: Mesh, center: np.ndarray, factor: float) -> Mesh:
    return Mesh(vertices=mesh.vertices / factor + center, faces=mesh.faces, uv=mesh.uv, visual=mesh.visual)


def sample_surface(
    mesh: Mesh, n_points: int, seed: int | None = None, with_normals: bool = True
) -> np.ndarray:
    """Uniform area-weighted surface samples -> (n_points, 3|6) float32
    (positions, then the face normals), from ``np.random.default_rng(seed)``
    in the JAX package's order of draws."""
    rng = np.random.default_rng(seed)
    face_normals, areas = mesh.face_normals_and_areas()
    face_idx = rng.choice(len(mesh.faces), size=n_points, p=areas / areas.sum())
    r1 = rng.random(n_points)
    r2 = rng.random(n_points)
    sqrt_r1 = np.sqrt(r1)
    u = 1.0 - sqrt_r1
    v = sqrt_r1 * (1.0 - r2)
    w = sqrt_r1 * r2
    tri = mesh.vertices[mesh.faces[face_idx]]  # (n, 3, 3)
    points = u[:, None] * tri[:, 0] + v[:, None] * tri[:, 1] + w[:, None] * tri[:, 2]
    if with_normals:
        return np.concatenate([points, face_normals[face_idx]], axis=-1).astype(np.float32)
    return points.astype(np.float32)


def merge_and_clean_mesh(mesh: Mesh, merge_tol: float = 1e-6) -> tuple[Mesh, np.ndarray, np.ndarray]:
    """Merge vertices closer than ``merge_tol``, keeping the map back.

    Returns (merged mesh, vertex_merge_map (V_orig,), pre_merge_faces):
    original vertex i is merged vertex ``vertex_merge_map[i]``, so meshes
    on the merged vertices re-expand onto the original (UV) topology.
    """
    from scipy.spatial import cKDTree

    pre_merge_faces = mesh.faces.copy()
    groups = cKDTree(mesh.vertices).query_ball_point(mesh.vertices, r=merge_tol)
    merge_to = np.array([min(grp) for grp in groups], dtype=np.int64)
    unique_ids, vertex_merge_map = np.unique(merge_to, return_inverse=True)
    merged = Mesh(vertices=mesh.vertices[unique_ids], faces=vertex_merge_map[mesh.faces])
    return remove_degenerate_and_duplicate_faces(merged), vertex_merge_map, pre_merge_faces


@dataclasses.dataclass
class MeshPostprocessor:
    """Post-Stage-0 cleanup: merge, clean, decimate, drop floaters, in the
    spans ``clean`` (merge, degenerate and duplicate faces, unreferenced
    vertices), ``decimate`` (the cluster pre-pass and QEM, when the mesh has
    more faces than ``face_decimation``) and ``floaters``."""

    face_decimation: int = 40000
    floaters_threshold: float = 0.02

    def process_mesh(self, mesh: Mesh, seed: int = 44) -> Mesh:
        with scoped_seed(seed):
            with span("clean"):
                mesh = merge_vertices(mesh)
                mesh = remove_degenerate_and_duplicate_faces(mesh)
                mesh = remove_unreferenced_vertices(mesh)
            with span("decimate"):
                if self.face_decimation and mesh.n_faces > self.face_decimation:
                    mesh = decimate_mesh(mesh, self.face_decimation)
            with span("floaters"):
                if self.floaters_threshold > 0:
                    mesh = remove_floaters(mesh, self.floaters_threshold)
        return mesh
