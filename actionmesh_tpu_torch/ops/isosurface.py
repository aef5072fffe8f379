"""Hierarchical SDF iso-surface extraction (host numpy + native marching cubes).

Counterpart of ``actionmesh_tpu/ops/isosurface.py:hierarchical_extract_geometry``:
a coarse pass finds the lattice cells whose corners change sign, only those
cells are re-evaluated at the fine depth, and the native marching cubes
(``utils/native.py:marching_cubes_grid``) triangulates the fine lattices.
Fine-level SDF queries stay proportional to surface area, not volume.

Three ways to run the coarse pass:
  * the prefilter path (the default preset's): a depth-P dense sign grid
    locates the surface band; only the dilated band is subdivided to the
    dense depth;
  * the sign-only dense path: ``grid_inside_fn`` returns the inside mask of
    the whole dense lattice;
  * the host-callback path: ``sdf_fn`` evaluates chunks of host points.
The ``tetrahedra`` method and the numpy triangulation of the JAX package are
not ported (ROADMAP).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from actionmesh_tpu_torch.utils import native

# Cube corner order: bit0 = x, bit1 = y, bit2 = z.
_CUBE_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0], [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]],
    dtype=np.int64,
)


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


def _eval_chunked(sdf_fn, pts: np.ndarray, chunk: int) -> np.ndarray:
    """Evaluate sdf_fn in fixed-size chunks, the tail padded with zeros."""
    n = pts.shape[0]
    out = np.empty((n,), np.float32)
    for s in range(0, n, chunk):
        block = pts[s : s + chunk]
        if block.shape[0] < chunk:
            block = np.concatenate([block, np.zeros((chunk - block.shape[0], 3), pts.dtype)])
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
    grid_inside_fn: Optional[Callable] = None,
    ids_val_fn: Optional[Callable] = None,
    prefilter_octree_depth: Optional[int] = None,
    stats: Optional[dict] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Coarse pass + fine re-evaluation only in surface-crossing cells.

    Dense depth d gives (2^d + 1)^3 coarse samples, hierarchical depth h
    refines each crossing cell 2^(h-d) times per axis. Returns (vertices
    (V, 3) float32, faces (F, 3) int64).

    Device fast paths, with the JAX package's contracts:
      * ``grid_inside_fn(lo, step, Rc, level) -> int8 (>= Rc**3,)``: inside
        mask of the dense lattice, row-major (i, j, k), entries past Rc**3
        padding;
      * ``ids_val_fn(ijk_int32 (M, 3), lo, step) -> fp32 (>= M,)``: field
        values at lattice ids, M a multiple of ``chunk`` (this function
        pads).
    Without them the passes call ``sdf_fn`` on host points, ``chunk`` at a
    time. ``stats``, when given, receives the number of SDF chunks each pass
    queried: ``{"prefilter": n, "band": n, "dense": n, "fine": n}``.
    """
    stats = {} if stats is None else stats
    stats.update(prefilter=0, band=0, dense=0, fine=0)
    lo, hi = np.array(bounds[:3]), np.array(bounds[3:])
    Rc = (1 << dense_octree_depth) + 1
    step = (hi - lo) / (Rc - 1)
    n_coarse = Rc ** 3

    def _vals_at_ids(ui, uj, uk, step_arr, fn, counter) -> np.ndarray:
        """Field values at integer lattice ids on a grid of step ``step_arr``
        anchored at ``lo``: through ``fn`` (a device fast path) when given,
        else through ``sdf_fn`` on host points."""
        m = len(ui)
        stats[counter] += -(-m // chunk)
        if fn is not None:
            ijk = np.zeros((-(-m // chunk) * chunk, 3), np.int32)
            ijk[:m, 0] = ui
            ijk[:m, 1] = uj
            ijk[:m, 2] = uk
            return np.asarray(fn(ijk, lo, step_arr), np.float32)[:m]
        pts = np.empty((m, 3), np.float32)
        pts[:, 0] = lo[0] + np.asarray(ui) * step_arr[0]
        pts[:, 1] = lo[1] + np.asarray(uj) * step_arr[1]
        pts[:, 2] = lo[2] + np.asarray(uk) * step_arr[2]
        return _eval_chunked(sdf_fn, pts, chunk)

    empty = np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    if hierarchical_octree_depth <= dense_octree_depth:
        raise ValueError(
            f"hierarchical_octree_depth ({hierarchical_octree_depth}) must exceed "
            f"dense_octree_depth ({dense_octree_depth})"
        )
    if prefilter_octree_depth is not None and prefilter_octree_depth < dense_octree_depth:
        # Two-level coarse pass: depth-P dense signs -> band cells -> dense-
        # depth signs only inside the (dilated) band.
        Rp = (1 << prefilter_octree_depth) + 1
        step_p = (hi - lo) / (Rp - 1)
        if grid_inside_fn is not None:
            stats["prefilter"] = -(-Rp ** 3 // chunk)
            inside_p = (
                np.asarray(grid_inside_fn(lo, step_p, Rp, level))[: Rp**3]
                .reshape(Rp, Rp, Rp).astype(np.uint8)
            )
        else:
            pvals = _vals_at_ids(
                *np.unravel_index(np.arange(Rp**3), (Rp, Rp, Rp)), step_p,
                fn=ids_val_fn, counter="prefilter",
            )
            inside_p = (pvals.reshape(Rp, Rp, Rp) < level).view(np.uint8)
        band = _dilate_cells(_cell_crossing_mask(inside_p))
        pi, pj, pk = np.nonzero(band)
        if len(pi) == 0:
            return empty
        s0 = 1 << (dense_octree_depth - prefilter_octree_depth)
        # dense-lattice ids of the band cells' (s0+1)^3 sub-lattices
        bi = pi[:, None, None, None] * s0 + np.arange(s0 + 1)[None, :, None, None]
        bj = pj[:, None, None, None] * s0 + np.arange(s0 + 1)[None, None, :, None]
        bk = pk[:, None, None, None] * s0 + np.arange(s0 + 1)[None, None, None, :]
        band_ids = (bi * Rc + bj) * Rc + bk  # (Cp, s0+1, s0+1, s0+1)
        uniq_b, inv_b = np.unique(band_ids.reshape(-1), return_inverse=True)
        bvals = _vals_at_ids(
            uniq_b // (Rc * Rc), (uniq_b // Rc) % Rc, uniq_b % Rc, step,
            fn=ids_val_fn, counter="band",
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
    elif grid_inside_fn is not None:
        stats["dense"] = -(-n_coarse // chunk)
        inside = np.asarray(grid_inside_fn(lo, step, Rc, level))[:n_coarse]
        ci, cj, ck = np.nonzero(_cell_crossing_mask(inside.reshape(Rc, Rc, Rc).astype(np.uint8)))
    else:
        coarse_vals = _vals_at_ids(
            *np.unravel_index(np.arange(n_coarse), (Rc, Rc, Rc)), step,
            fn=None, counter="dense",
        )
        inside = (coarse_vals.reshape(Rc, Rc, Rc) < level).view(np.uint8)
        ci, cj, ck = np.nonzero(_cell_crossing_mask(inside))

    if len(ci) == 0:
        return empty
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
        fine_step, fn=ids_val_fn, counter="fine",
    )
    fine_vals = uniq_vals[inv.reshape(-1)].reshape(fine_ids.shape).astype(np.float32)
    return native.marching_cubes_grid(
        fine_vals, np.stack([ci, cj, ck], axis=-1), lo, step, fine_R, level
    )
