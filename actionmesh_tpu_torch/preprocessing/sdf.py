"""Exact mesh TSDF ground truth (host, numpy, float64).

Counterpart of ``actionmesh_tpu/preprocessing/sdf.py``, the same arithmetic
in the same order, so its results are bit-equal to the JAX package's.
Training data for the vecset VAE's SDF field decoder
(``training/vae_train.py``): the closed loop's Stage-0 phase supervises
``query_sdf`` against the true signed distance of the synthetic scenes'
anchor meshes. Conventions follow the inference contract:
``ops/isosurface`` extracts the ``value < level`` region, so the field is
**negative inside**, in the anchor's [-1, 1]^3 normalized space.

Both parts are exact, vectorized over (query x face) tiles:

  * unsigned distance: Eberly's closest-point-on-triangle case analysis;
  * sign: the generalized winding number (van Oosterom-Strackee solid
    angles), robust for the closed scene meshes (> 1/2 inside).
"""

from __future__ import annotations

import numpy as np

from actionmesh_tpu_torch.io.mesh import Mesh


def _closest_point_sq_dist(
    points: np.ndarray, tri: np.ndarray
) -> np.ndarray:
    """Squared distance from each point to each triangle.

    points (Q, 3), tri (F, 3, 3) -> (Q, F). Eberly's region analysis,
    vectorized with np.where (all regions computed, then selected).
    """
    P = points[:, None, :].astype(np.float64)  # (Q, 1, 3)
    A = tri[None, :, 0].astype(np.float64)  # (1, F, 3)
    E0 = tri[None, :, 1] - tri[None, :, 0]
    E1 = tri[None, :, 2] - tri[None, :, 0]
    D = A - P  # (Q, F, 3)

    # a, b, c are per-face only; d, e per (query, face)
    a = np.einsum("xfc,xfc->xf", E0, E0)  # (1, F)
    b = np.einsum("xfc,xfc->xf", E0, E1)
    c = np.einsum("xfc,xfc->xf", E1, E1)
    d = np.einsum("qfc,xfc->qf", D, E0)
    e = np.einsum("qfc,xfc->qf", D, E1)

    det = np.maximum(a * c - b * b, 1e-30)
    s = b * e - c * d
    t = b * d - a * e
    a = np.maximum(a, 1e-30)
    c = np.maximum(c, 1e-30)
    denom_edge = np.maximum(a - 2 * b + c, 1e-30)

    def clamp01(x):
        return np.clip(x, 0.0, 1.0)

    # region candidates
    s0, t0 = s / det, t / det  # region 0 (interior)
    t3 = clamp01(-e / c)  # region 3: s = 0
    s5 = clamp01(-d / a)  # region 5: t = 0
    s1 = clamp01((c + e - b - d) / denom_edge)  # region 1: s + t = 1
    # region 2: either the s+t=1 edge or the s=0 edge
    r2_edge = (c + e) > (b + d)
    s2 = np.where(r2_edge, clamp01((c + e - b - d) / denom_edge), 0.0)
    t2 = np.where(r2_edge, 1.0 - s2, t3)
    # region 6: either the s+t=1 edge or the t=0 edge
    r6_edge = (a + d) > (b + e)
    t6 = np.where(r6_edge, clamp01((a + d - b - e) / denom_edge), 0.0)
    s6 = np.where(r6_edge, 1.0 - t6, s5)
    # region 4: corner — whichever axis-edge is closer
    s4 = np.where(d < 0, s5, 0.0)
    t4 = np.where(d < 0, 0.0, t3)

    inside_lower = (s + t) <= det
    sel_s = np.where(
        inside_lower,
        np.where(s < 0, np.where(t < 0, s4, 0.0), np.where(t < 0, s5, s0)),
        np.where(s < 0, s2, np.where(t < 0, s6, s1)),
    )
    sel_t = np.where(
        inside_lower,
        np.where(s < 0, np.where(t < 0, t4, t3), np.where(t < 0, 0.0, t0)),
        np.where(s < 0, t2, np.where(t < 0, t6, 1.0 - s1)),
    )
    closest = A + sel_s[..., None] * E0 + sel_t[..., None] * E1
    diff = P - closest
    return np.einsum("qfc,qfc->qf", diff, diff)


def point_mesh_distance(
    points: np.ndarray, mesh: Mesh, chunk: int = 512
) -> np.ndarray:
    """Exact unsigned distance from each point (Q, 3) to the mesh surface."""
    tri = mesh.vertices[mesh.faces]  # (F, 3, 3)
    out = np.empty(len(points), np.float64)
    for lo in range(0, len(points), chunk):
        sq = _closest_point_sq_dist(points[lo : lo + chunk], tri)
        out[lo : lo + chunk] = np.sqrt(sq.min(axis=1))
    return out


def winding_number(
    points: np.ndarray, mesh: Mesh, chunk: int = 512
) -> np.ndarray:
    """Generalized winding number of each point w.r.t. the mesh (~1 inside
    a closed surface, ~0 outside). Van Oosterom-Strackee solid angles."""
    tri = mesh.vertices[mesh.faces].astype(np.float64)  # (F, 3, 3)
    out = np.empty(len(points), np.float64)
    for lo in range(0, len(points), chunk):
        p = points[lo : lo + chunk].astype(np.float64)[:, None, :]  # (q,1,3)
        a = tri[None, :, 0] - p  # (q, F, 3)
        b = tri[None, :, 1] - p
        c = tri[None, :, 2] - p
        la = np.linalg.norm(a, axis=-1)
        lb = np.linalg.norm(b, axis=-1)
        lc = np.linalg.norm(c, axis=-1)
        num = np.einsum("qfc,qfc->qf", a, np.cross(b, c))
        den = (
            la * lb * lc
            + np.einsum("qfc,qfc->qf", a, b) * lc
            + np.einsum("qfc,qfc->qf", b, c) * la
            + np.einsum("qfc,qfc->qf", c, a) * lb
        )
        omega = 2.0 * np.arctan2(num, den)
        out[lo : lo + chunk] = omega.sum(axis=1) / (4.0 * np.pi)
    return out


def mesh_tsdf(
    points: np.ndarray, mesh: Mesh, clamp: float = 0.25
) -> np.ndarray:
    """Truncated signed distance at each point: NEGATIVE inside (the
    ``value < level`` inside convention of ops/isosurface extraction),
    clamped to [-clamp, clamp]."""
    dist = point_mesh_distance(points, mesh)
    sign = np.where(winding_number(points, mesh) > 0.5, -1.0, 1.0)
    return np.clip(sign * dist, -clamp, clamp).astype(np.float32)


def sample_sdf_queries(
    mesh: Mesh,
    n_near: int,
    n_uniform: int,
    seed: int,
    near_sigma: float = 0.05,
    bound: float = 1.1,
) -> np.ndarray:
    """Query-point pool for SDF supervision: near-surface Gaussian
    perturbations of area-weighted surface samples (where the zero
    crossing must be accurate) + uniform points in [-bound, bound]^3
    (so the field has the right sign everywhere the extractor looks)."""
    rng = np.random.default_rng(seed)
    _, areas = mesh.face_normals_and_areas()
    cdf = np.cumsum(areas) / areas.sum()
    fid = np.searchsorted(cdf, rng.random(n_near))
    u, v = rng.random(n_near), rng.random(n_near)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    w = 1 - u - v
    tri = mesh.vertices[mesh.faces[fid]]
    on_surf = (
        u[:, None] * tri[:, 0] + v[:, None] * tri[:, 1] + w[:, None] * tri[:, 2]
    )
    near = on_surf + rng.normal(0.0, near_sigma, (n_near, 3))
    uniform = rng.uniform(-bound, bound, (n_uniform, 3))
    return np.concatenate([near, uniform]).astype(np.float32)
