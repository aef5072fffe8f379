"""Marching-cubes case table, generated at import, and a numpy marching cubes.

Counterpart of ``actionmesh_tpu/ops/mc_table.py`` (numpy only; the port
keeps its own copy). The table is derived, not transcribed: for each of the
256 corner-sign configurations, the iso-surface boundary on each cube face
is traced with marching-squares arcs (every maximal run of inside corners
along the face's corner cycle, counter-clockwise seen from outside, gives
one directed segment from its entry crossing to its exit crossing), the
segments are chained into closed loops and each loop is fan-triangulated.
The arc rule depends on the four face corners alone, so two cubes sharing
a face trace the same segment: the surface is watertight across cells, the
ambiguous cases included. ``native/mc_table.h``, which the native marching
cubes includes, holds this same table.

``marching_cubes_cells_numpy`` is the vectorized numpy marching cubes over
pre-filtered cells, the native one's semantic reference; the extraction
runs it only when ``method="cubes_numpy"`` asks for it
(``ops/isosurface.py``).
"""

from __future__ import annotations

import numpy as np

# Corner index c = x + 2y + 4z (shared with ops/isosurface.py).
CUBE_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
        [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1],
    ],
    dtype=np.int64,
)

# The 12 cube edges as (corner_a, corner_b), axis-major.
CUBE_EDGES = np.array(
    [
        (0, 1), (2, 3), (4, 5), (6, 7),  # x-axis
        (0, 2), (1, 3), (4, 6), (5, 7),  # y-axis
        (0, 4), (1, 5), (2, 6), (3, 7),  # z-axis
    ],
    dtype=np.int64,
)

_EDGE_OF_PAIR = {
    (int(a), int(b)): e for e, (a, b) in enumerate(CUBE_EDGES)
}
_EDGE_OF_PAIR.update({(b, a): e for (a, b), e in list(_EDGE_OF_PAIR.items())})


def _face_cycles() -> list[list[int]]:
    """Corner cycles of the 6 faces, CCW as seen from outside the cube."""
    faces = [
        (0, 0, [0, 2, 6, 4]),  # x = 0, outward -x
        (0, 1, [1, 3, 7, 5]),  # x = 1, outward +x
        (1, 0, [0, 1, 5, 4]),  # y = 0, outward -y
        (1, 1, [2, 3, 7, 6]),  # y = 1, outward +y
        (2, 0, [0, 1, 3, 2]),  # z = 0, outward -z
        (2, 1, [4, 5, 7, 6]),  # z = 1, outward +z
    ]
    cycles = []
    for axis, side, cyc in faces:
        normal = np.zeros(3)
        normal[axis] = 1.0 if side else -1.0
        p = CUBE_CORNERS[cyc].astype(float)
        # orient the cycle CCW around the outward normal
        cross = np.cross(p[1] - p[0], p[2] - p[0])
        if np.dot(cross, normal) < 0:
            cyc = cyc[::-1]
        cycles.append(cyc)
    return cycles


_FACE_CYCLES = _face_cycles()


def _trace_case(config: int) -> list[list[int]]:
    """Closed, consistently-oriented crossing loops (lists of edge ids)."""
    inside = [(config >> c) & 1 for c in range(8)]
    # directed segments entry_edge -> exit_edge
    nxt: dict[int, int] = {}
    for cyc in _FACE_CYCLES:
        flags = [inside[c] for c in cyc]
        if all(flags) or not any(flags):
            continue
        # maximal arcs of consecutive inside corners along the cycle
        for i in range(4):
            a, b = cyc[i], cyc[(i + 1) % 4]
            if inside[b] and not inside[a]:
                # arc starts at b: entry on edge (a, b); walk to its end
                j = (i + 1) % 4
                while inside[cyc[(j + 1) % 4]]:
                    j = (j + 1) % 4
                c, d = cyc[j], cyc[(j + 1) % 4]
                entry = _EDGE_OF_PAIR[(a, b)]
                exit_ = _EDGE_OF_PAIR[(c, d)]
                assert entry not in nxt
                nxt[entry] = exit_
    # chain into loops
    loops: list[list[int]] = []
    remaining = dict(nxt)
    while remaining:
        start = next(iter(remaining))
        loop = [start]
        cur = remaining.pop(start)
        while cur != start:
            loop.append(cur)
            cur = remaining.pop(cur)
        loops.append(loop)
    return loops


def _build_table() -> list[np.ndarray]:
    """table[config] = (n_tris, 3) int8 array of cube-edge triples."""
    table: list[np.ndarray] = []
    for config in range(256):
        tris: list[tuple[int, int, int]] = []
        for loop in _trace_case(config):
            assert 3 <= len(loop) <= 12
            for i in range(1, len(loop) - 1):
                # fan; winding makes normals point toward outside, i.e.
                # positive signed volume for inside = (value < level)
                # (validated against an analytic sphere's signed volume)
                tris.append((loop[0], loop[i], loop[i + 1]))
        table.append(np.array(tris, dtype=np.int8).reshape(-1, 3))
    return table


MC_TRI_TABLE: list[np.ndarray] = _build_table()
MC_MAX_TRIS: int = max(len(t) for t in MC_TRI_TABLE)


def marching_cubes_cells_numpy(
    corner_points: np.ndarray,
    corner_values: np.ndarray,
    corner_ids: np.ndarray,
    level: float = 0.0,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized numpy marching cubes over pre-filtered cells.

    Same contract as ops/isosurface.marching_tetrahedra: corner_points
    (C, 8, 3), corner_values (C, 8), corner_ids (C, 8) globally unique,
    returns (vertices (V, 3) float32, faces (F, 3) int64) with exact
    edge-key welding. Semantic reference for the C++ fast path.
    """
    C = corner_points.shape[0]
    if C == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    inside = (corner_values < level).astype(np.int64)
    config = np.zeros(C, np.int64)
    for c in range(8):
        config |= inside[:, c] << c

    tri_cells = []
    tri_edges = []
    for cfg in range(1, 255):
        tris = MC_TRI_TABLE[cfg]
        if len(tris) == 0:
            continue
        sel = np.nonzero(config == cfg)[0]
        if len(sel) == 0:
            continue
        for tri in tris:
            tri_cells.append(sel)
            tri_edges.append(np.broadcast_to(tri, (len(sel), 3)))
    if not tri_cells:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    cell_of_face = np.concatenate(tri_cells)  # (F,)
    edge_of_corner = np.concatenate(tri_edges).astype(np.int64)  # (F, 3)

    ea = CUBE_EDGES[edge_of_corner, 0]  # (F, 3) local corner a
    eb = CUBE_EDGES[edge_of_corner, 1]

    va = np.take_along_axis(corner_values[cell_of_face], ea, axis=1)
    vb = np.take_along_axis(corner_values[cell_of_face], eb, axis=1)
    t = (level - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
    t = np.clip(t, 0.0, 1.0)[..., None]
    pa = np.take_along_axis(
        corner_points[cell_of_face], ea[..., None], axis=1
    )
    pb = np.take_along_axis(
        corner_points[cell_of_face], eb[..., None], axis=1
    )
    pts = pa + t * (pb - pa)  # (F, 3, 3)

    ga = np.take_along_axis(corner_ids[cell_of_face], ea, axis=1)
    gb = np.take_along_axis(corner_ids[cell_of_face], eb, axis=1)
    lo = np.minimum(ga, gb)
    hi = np.maximum(ga, gb)
    edge_key = lo.astype(np.int64) * (2**31) + hi.astype(np.int64)

    flat_keys = edge_key.reshape(-1)
    uniq_keys, first_idx, inverse = np.unique(
        flat_keys, return_index=True, return_inverse=True
    )
    vertices = pts.reshape(-1, 3)[first_idx].astype(np.float32)
    faces = inverse.reshape(-1, 3)
    ok = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return vertices, faces[ok]
