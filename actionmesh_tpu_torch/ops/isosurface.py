"""SDF iso-surface extraction: dense and hierarchical, marching cubes or tetrahedra.

Counterpart of ``actionmesh_tpu/ops/isosurface.py``. The SDF is evaluated on
the device (the caller's ``sdf_fn`` or its fast paths); the triangulation
runs on the host, in the native C++ library (``utils/native.py``):
  * ``cubes`` (the default): marching cubes with the generated 256-case
    table (``ops/mc_table.py``); vertices only on lattice edges;
  * ``tetrahedra``: six tetrahedra a cube, vertices also on face and body
    diagonals (~2-3x the triangles of ``cubes`` on the same lattice);
  * ``cubes_numpy``: the numpy marching cubes of ``ops/mc_table.py``, the
    native one's semantic reference (the same triangles, welded in another
    vertex order).
Vertices are welded exactly by lattice-edge keys whichever the method.

The one deliberate difference from the JAX package: JAX falls back to its
numpy triangulation when the native build fails (or the lattice ids exceed
the native weld key); the port raises there, and runs the numpy marching
cubes only when ``method="cubes_numpy"`` asks for it. Another triangulation
algorithm would change the anchor mesh without saying so.

``hierarchical_extract_geometry``: a coarse pass finds the lattice cells
whose corners change sign, only those cells are re-evaluated at the fine
depth, and the fine lattices are triangulated, so fine-level SDF queries
stay proportional to surface area, not volume. Three ways to run the
coarse pass:
  * the prefilter path (the default preset's): a depth-P dense sign grid
    locates the surface band; only the dilated band is subdivided to the
    dense depth;
  * the sign-only dense path: ``grid_inside_fn`` returns the inside mask of
    the whole dense lattice;
  * the host-callback path: ``sdf_fn`` evaluates chunks of host points.
With ``hierarchical_octree_depth <= dense_octree_depth`` it is the
single-level extraction: the dense lattice's values through ``sdf_fn``,
triangulated whole (``_triangulate_full_grid``), as ``extract_geometry_dense``.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from actionmesh_tpu_torch.ops.mc_table import CUBE_CORNERS as _CUBE_CORNERS
from actionmesh_tpu_torch.ops.mc_table import marching_cubes_cells_numpy
from actionmesh_tpu_torch.utils import native
from actionmesh_tpu_torch.utils.profiling import span

METHODS = ("cubes", "tetrahedra", "cubes_numpy")
EMPTY = np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)


def _check_method(method: str) -> None:
    if method not in METHODS:
        raise ValueError(f"unknown triangulation method: {method!r} (one of {METHODS})")


def marching_tetrahedra(
    corner_points: np.ndarray,
    corner_values: np.ndarray,
    corner_ids: np.ndarray,
    level: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Triangulate cells given their 8 corner samples, six tetrahedra a
    cube (native). corner_points (C, 8, 3), corner_values (C, 8),
    corner_ids (C, 8) globally unique lattice ids (exact welding). Returns
    (vertices (V, 3) float32, faces (F, 3) int64)."""
    return native.marching_tetrahedra_cells(corner_points, corner_values, corner_ids, level)


def marching_cubes(
    corner_points: np.ndarray,
    corner_values: np.ndarray,
    corner_ids: np.ndarray,
    level: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Marching cubes over pre-filtered cells (native), the contract of
    ``marching_tetrahedra``."""
    return native.marching_cubes_cells(corner_points, corner_values, corner_ids, level)


_CELL_TRIANGULATORS = {
    "cubes": marching_cubes,
    "tetrahedra": marching_tetrahedra,
    "cubes_numpy": marching_cubes_cells_numpy,
}


def triangulate_cells(
    corner_points: np.ndarray,
    corner_values: np.ndarray,
    corner_ids: np.ndarray,
    level: float = 0.0,
    method: str = "cubes",
) -> tuple[np.ndarray, np.ndarray]:
    """Triangulate pre-filtered cells with the chosen method (``METHODS``)."""
    _check_method(method)
    return _CELL_TRIANGULATORS[method](corner_points, corner_values, corner_ids, level)


def _grid_points(lo, hi, resolution: int) -> np.ndarray:
    """(R, R, R, 3) float32 lattice points, each axis a linspace."""
    axes = [np.linspace(lo[i], hi[i], resolution, dtype=np.float32) for i in range(3)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)


def _triangulate_full_grid(pts, vals, level, method="cubes"):
    """Triangulate every sign-crossing cell of a whole (R, R, R) lattice of
    points ``pts`` (R, R, R, 3) and values ``vals``."""
    R = vals.shape[0]
    ci, cj, ck = np.nonzero(_cell_crossing_mask((vals < level).view(np.uint8)))
    corner_idx = np.stack([ci, cj, ck], axis=-1)[:, None, :] + _CUBE_CORNERS[None]  # (C, 8, 3)
    flat = (corner_idx[..., 0] * R + corner_idx[..., 1]) * R + corner_idx[..., 2]
    return triangulate_cells(
        pts.reshape(-1, 3)[flat], vals.reshape(-1)[flat], flat, level, method
    )


def extract_geometry_dense(
    sdf_fn: Callable[[np.ndarray], np.ndarray],
    bounds: tuple[float, ...] = (-1.005, -1.005, -1.005, 1.005, 1.005, 1.005),
    octree_depth: int = 8,
    level: float = 0.0,
    chunk: int = 1 << 18,
    method: str = "cubes",
) -> tuple[np.ndarray, np.ndarray]:
    """Dense-lattice extraction at resolution 2^depth + 1 a side: every
    lattice point through ``sdf_fn``, ``chunk`` points a call."""
    _check_method(method)
    lo, hi = np.array(bounds[:3]), np.array(bounds[3:])
    R = (1 << octree_depth) + 1
    pts = _grid_points(lo, hi, R)
    vals = _eval_chunked(sdf_fn, pts.reshape(-1, 3), chunk, "sdf_fn:dense").reshape(R, R, R)
    return _triangulate_full_grid(pts, vals, level, method)


def _cell_crossing_mask(inside: np.ndarray) -> np.ndarray:
    """(R, R, R) uint8 inside-mask -> (R-1,)*3 bool crossing-cell mask."""
    R = inside.shape[0]
    acc = np.zeros((R - 1,) * 3, np.uint8)
    for dx, dy, dz in _CUBE_CORNERS:
        acc += inside[dx : R - 1 + dx, dy : R - 1 + dy, dz : R - 1 + dz]
    return (acc > 0) & (acc < 8)


def _dilate_cells(mask: np.ndarray) -> np.ndarray:
    """3x3x3 box dilation of a bool cell mask."""
    p = np.pad(mask, 1)
    out = np.zeros_like(mask)
    n = mask.shape[0]
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                out |= p[dx : dx + n, dy : dy + n, dz : dz + n]
    return out


def _eval_chunked(sdf_fn, pts: np.ndarray, chunk: int, name: str) -> np.ndarray:
    """Evaluate sdf_fn in fixed-size chunks, the tail padded with zeros,
    each call in a span ``name``."""
    n = pts.shape[0]
    out = np.empty((n,), np.float32)
    for s in range(0, n, chunk):
        block = pts[s : s + chunk]
        if block.shape[0] < chunk:
            block = np.concatenate([block, np.zeros((chunk - block.shape[0], 3), pts.dtype)])
        with span(name):
            vals = np.asarray(sdf_fn(block), np.float32).reshape(-1)
        out[s : s + chunk] = vals[: min(chunk, n - s)]
    return out


def hierarchical_extract_geometry(
    sdf_fn: Callable[[np.ndarray], np.ndarray],
    bounds: tuple[float, ...] = (-1.005, -1.005, -1.005, 1.005, 1.005, 1.005),
    dense_octree_depth: int = 8,
    hierarchical_octree_depth: int = 9,
    level: float = 0.0,
    chunk: int = 1 << 18,
    method: str = "cubes",
    grid_inside_fn: Optional[Callable] = None,
    ids_val_fn: Optional[Callable] = None,
    prefilter_octree_depth: Optional[int] = None,
    ids_val_coarse_fn: Optional[Callable] = None,
    stats: Optional[dict] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Coarse pass + fine re-evaluation only in surface-crossing cells.

    Dense depth d gives (2^d + 1)^3 coarse samples, hierarchical depth h
    refines each crossing cell 2^(h-d) times per axis; with h <= d the
    dense lattice is triangulated whole (the single-level extraction, which
    takes neither fast path). ``method``: one of ``METHODS``. Returns
    (vertices (V, 3) float32, faces (F, 3) int64).

    Device fast paths, with the JAX package's contracts:
      * ``grid_inside_fn(lo, step, Rc, level) -> int8 (>= Rc**3,)``: inside
        mask of the dense lattice, row-major (i, j, k), entries past Rc**3
        padding;
      * ``ids_val_fn(ijk_int32 (M, 3), lo, step) -> fp32 (>= M,)``: field
        values at lattice ids, M a multiple of ``chunk`` (this function
        pads).
    Without them the passes call ``sdf_fn`` on host points, ``chunk`` at a
    time. ``ids_val_coarse_fn`` (the contract of ``ids_val_fn``) takes the
    prefilter and band passes when given: they read only signs, so it may
    query in a reduced precision; the fine pass, whose values place the
    vertices, always takes ``ids_val_fn``. ``stats``, when given, receives
    the number of SDF chunks each pass queried: ``{"prefilter": n, "band":
    n, "dense": n, "fine": n}``.

    Each field query runs in a span named after the function and its pass,
    ``<fn>:<pass>`` (``grid_inside_fn:prefilter``, ``ids_val_coarse_fn:band``,
    ``ids_val_fn:fine``, ``sdf_fn:dense``, ...; ``utils/profiling.py``), so
    the extraction's own host work is what lies outside them.
    """
    _check_method(method)
    stats = {} if stats is None else stats
    stats.update(prefilter=0, band=0, dense=0, fine=0)
    lo, hi = np.array(bounds[:3]), np.array(bounds[3:])
    Rc = (1 << dense_octree_depth) + 1
    step = (hi - lo) / (Rc - 1)
    n_coarse = Rc ** 3

    def _vals_at_ids(ui, uj, uk, step_arr, fn, fn_name, counter) -> np.ndarray:
        """Field values at integer lattice ids on a grid of step ``step_arr``
        anchored at ``lo``: through ``fn`` (a device fast path, named
        ``fn_name``) when given, else through ``sdf_fn`` on host points."""
        m = len(ui)
        stats[counter] += -(-m // chunk)
        if fn is not None:
            ijk = np.zeros((-(-m // chunk) * chunk, 3), np.int32)
            ijk[:m, 0] = ui
            ijk[:m, 1] = uj
            ijk[:m, 2] = uk
            with span(f"{fn_name}:{counter}"):
                return np.asarray(fn(ijk, lo, step_arr), np.float32)[:m]
        pts = np.empty((m, 3), np.float32)
        pts[:, 0] = lo[0] + np.asarray(ui) * step_arr[0]
        pts[:, 1] = lo[1] + np.asarray(uj) * step_arr[1]
        pts[:, 2] = lo[2] + np.asarray(uk) * step_arr[2]
        return _eval_chunked(sdf_fn, pts, chunk, f"sdf_fn:{counter}")

    refine = hierarchical_octree_depth > dense_octree_depth
    coarse_fn = ids_val_coarse_fn or ids_val_fn
    coarse_name = "ids_val_coarse_fn" if ids_val_coarse_fn is not None else "ids_val_fn"
    if refine and prefilter_octree_depth is not None and prefilter_octree_depth < dense_octree_depth:
        # Two-level coarse pass: depth-P dense signs -> band cells -> dense-
        # depth signs only inside the (dilated) band.
        Rp = (1 << prefilter_octree_depth) + 1
        step_p = (hi - lo) / (Rp - 1)
        if grid_inside_fn is not None:
            stats["prefilter"] = -(-Rp ** 3 // chunk)
            with span("grid_inside_fn:prefilter"):
                inside_p = np.asarray(grid_inside_fn(lo, step_p, Rp, level))
            inside_p = inside_p[: Rp**3].reshape(Rp, Rp, Rp).astype(np.uint8)
        else:
            pvals = _vals_at_ids(
                *np.unravel_index(np.arange(Rp**3), (Rp, Rp, Rp)), step_p,
                fn=coarse_fn, fn_name=coarse_name, counter="prefilter",
            )
            inside_p = (pvals.reshape(Rp, Rp, Rp) < level).view(np.uint8)
        band = _dilate_cells(_cell_crossing_mask(inside_p))
        pi, pj, pk = np.nonzero(band)
        if len(pi) == 0:
            return EMPTY
        s0 = 1 << (dense_octree_depth - prefilter_octree_depth)
        # dense-lattice ids of the band cells' (s0+1)^3 sub-lattices
        bi = pi[:, None, None, None] * s0 + np.arange(s0 + 1)[None, :, None, None]
        bj = pj[:, None, None, None] * s0 + np.arange(s0 + 1)[None, None, :, None]
        bk = pk[:, None, None, None] * s0 + np.arange(s0 + 1)[None, None, None, :]
        band_ids = (bi * Rc + bj) * Rc + bk  # (Cp, s0+1, s0+1, s0+1)
        uniq_b, inv_b = np.unique(band_ids.reshape(-1), return_inverse=True)
        bvals = _vals_at_ids(
            uniq_b // (Rc * Rc), (uniq_b // Rc) % Rc, uniq_b % Rc, step,
            fn=coarse_fn, fn_name=coarse_name, counter="band",
        )
        sub_in = (bvals[inv_b.reshape(-1)] < level).reshape(band_ids.shape)
        acc = np.zeros(sub_in.shape[:1] + (s0, s0, s0), np.uint8)
        for dx, dy, dz in _CUBE_CORNERS:
            acc += sub_in[:, dx : s0 + dx, dy : s0 + dy, dz : s0 + dz]
        w, li, lj, lk = np.nonzero((acc > 0) & (acc < 8))
        ci, cj, ck = pi[w] * s0 + li, pj[w] * s0 + lj, pk[w] * s0 + lk
        # global row-major cell order, as the single-level passes give
        order = np.lexsort((ck, cj, ci))
        ci, cj, ck = ci[order], cj[order], ck[order]
    elif refine and grid_inside_fn is not None:
        stats["dense"] = -(-n_coarse // chunk)
        with span("grid_inside_fn:dense"):
            inside = np.asarray(grid_inside_fn(lo, step, Rc, level))[:n_coarse]
        ci, cj, ck = np.nonzero(_cell_crossing_mask(inside.reshape(Rc, Rc, Rc).astype(np.uint8)))
    else:
        coarse_vals = _vals_at_ids(
            *np.unravel_index(np.arange(n_coarse), (Rc, Rc, Rc)), step,
            fn=None, fn_name="sdf_fn", counter="dense",
        ).reshape(Rc, Rc, Rc)
        if not refine:
            return _triangulate_full_grid(_grid_points(lo, hi, Rc), coarse_vals, level, method)
        ci, cj, ck = np.nonzero(_cell_crossing_mask((coarse_vals < level).view(np.uint8)))

    if len(ci) == 0:
        return EMPTY
    s = 1 << (hierarchical_octree_depth - dense_octree_depth)  # subdivisions per axis
    fine_R = (Rc - 1) * s + 1
    fine_step = step / s

    # global fine ids (welding across neighbouring cells); positions derive
    # from ids, so no (C, (s+1)^3, 3) point array is built
    gi = ci[:, None, None, None] * s + np.arange(s + 1)[None, :, None, None]
    gj = cj[:, None, None, None] * s + np.arange(s + 1)[None, None, :, None]
    gk = ck[:, None, None, None] * s + np.arange(s + 1)[None, None, None, :]
    fine_ids = (gi * fine_R + gj) * fine_R + gk  # (C, s+1, s+1, s+1)
    uniq_ids, inv = np.unique(fine_ids.reshape(-1), return_inverse=True)
    uniq_vals = _vals_at_ids(
        uniq_ids // (fine_R * fine_R), (uniq_ids // fine_R) % fine_R, uniq_ids % fine_R,
        fine_step, fn=ids_val_fn, fn_name="ids_val_fn", counter="fine",
    )
    fine_vals = uniq_vals[inv.reshape(-1)].reshape(fine_ids.shape).astype(np.float32)
    if method != "cubes_numpy":
        grid_fn = native.marching_cubes_grid if method == "cubes" else native.marching_tetrahedra_grid
        return grid_fn(fine_vals, np.stack([ci, cj, ck], axis=-1), lo, step, fine_R, level)
    return _triangulate_fine_cells(fine_vals, fine_ids, ci, cj, ck, lo, step, level)


def _triangulate_fine_cells(fine_vals, fine_ids, ci, cj, ck, lo, cell_size, level):
    """The numpy marching cubes over every sign-crossing fine cell of the
    coarse cells (ci, cj, ck): explicit corner positions, values and weld
    ids, as the JAX package stages them for its numpy triangulation."""
    s = fine_vals.shape[1] - 1
    offs = np.arange(s + 1, dtype=np.float32) / s
    local = np.stack(np.meshgrid(offs, offs, offs, indexing="ij"), axis=-1)  # (s+1,)*3 + (3,)
    base_pos = lo + np.stack([ci, cj, ck], -1).astype(np.float32) * cell_size
    fine_pts = base_pos[:, None, None, None, :] + local[None] * cell_size  # (C, s+1, s+1, s+1, 3)

    def cell_corners(arr):  # (C, s+1, s+1, s+1, ...) -> (C * s^3, 8, ...)
        out = np.stack([arr[:, dx : dx + s, dy : dy + s, dz : dz + s] for dx, dy, dz in _CUBE_CORNERS],
                       axis=4)
        return out.reshape((-1, 8) + arr.shape[4:])

    cp, cv, cids = cell_corners(fine_pts), cell_corners(fine_vals), cell_corners(fine_ids)
    fin = cv < level
    keep = fin.any(axis=1) & ~fin.all(axis=1)
    return marching_cubes_cells_numpy(cp[keep], cv[keep], cids[keep], level)
