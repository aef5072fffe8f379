"""The port's extraction variants vs the JAX package: marching tetrahedra,
the numpy marching cubes (``method="cubes_numpy"``), the dense extraction
and the single-level branch of the hierarchical one.

Both sides triangulate with the same native library, so on the same torus
their arrays are equal bit for bit. JAX's numpy marching cubes is its
fallback when the native build fails; the tests reach it by making JAX's
native entry points raise.
"""

import numpy as np
import pytest
from scipy.spatial import cKDTree

import actionmesh_tpu.utils.native as jnative
from actionmesh_tpu.ops import isosurface as jiso
from actionmesh_tpu_torch.ops import isosurface as tiso
from actionmesh_tpu_torch.ops import mc_table
from tests.test_torch_isosurface import CHUNK, PATHS, grid_inside_fn, ids_val_fn, torus_sdf


def jax_numpy_only(monkeypatch):
    """JAX's extraction as on a host without the native library: its numpy
    triangulation."""

    def unavailable(*args, **kwargs):
        raise RuntimeError("native library unavailable")

    for name in ("marching_cubes_cells", "marching_tetrahedra_cells", "marching_cubes_grid",
                 "marching_tetrahedra_grid"):
        monkeypatch.setattr(jnative, name, unavailable)


def torus_cells(R: int = 24):
    """The sign-crossing cells of an R^3 lattice of the torus: corner points,
    values and lattice ids (C, 8, ...)."""
    pts = tiso._grid_points(np.full(3, -1.0), np.full(3, 1.0), R)
    vals = torus_sdf(pts.reshape(-1, 3)).reshape(R, R, R)
    ci, cj, ck = np.nonzero(tiso._cell_crossing_mask((vals < 0).view(np.uint8)))
    idx = np.stack([ci, cj, ck], -1)[:, None, :] + mc_table.CUBE_CORNERS[None]
    flat = (idx[..., 0] * R + idx[..., 1]) * R + idx[..., 2]
    return pts.reshape(-1, 3)[flat], vals.reshape(-1)[flat], flat


def assert_same(port, jax_out):
    (tv, tf), (jv, jf) = port, jax_out
    assert tv.dtype == np.float32 and tf.dtype == np.int64 and len(tf) > 1000
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("method", ["cubes", "tetrahedra"])
def test_cell_triangulation_matches_jax(method):
    cells = torus_cells()
    assert_same(tiso.triangulate_cells(*cells, method=method), jiso.triangulate_cells(*cells, method=method))


def test_cubes_numpy_matches_jax_numpy_and_the_native_cubes(monkeypatch):
    """The numpy marching cubes is JAX's, bit for bit; against the native
    one it gives the same vertex and face counts, vertices within 1e-4 after
    nearest-point matching and the same set of triangles
    (tests/test_geometry.py's check)."""
    jax_numpy_only(monkeypatch)
    cells = torus_cells()
    port = tiso.triangulate_cells(*cells, method="cubes_numpy")
    assert_same(port, jiso.marching_cubes(*cells))
    (v_np, f_np), (v_nat, f_nat) = port, tiso.marching_cubes(*cells)
    assert v_nat.shape == v_np.shape and f_nat.shape == f_np.shape
    d, perm = cKDTree(v_np).query(v_nat)
    assert d.max() < 1e-4

    def canon(f):
        first = np.argmin(f, axis=1)
        return set(map(tuple, np.stack([np.roll(t, -s) for t, s in zip(f, first)])))

    assert canon(perm[f_nat]) == canon(f_np)


@pytest.mark.parametrize("method", ["cubes", "tetrahedra", "cubes_numpy"])
def test_dense_extraction_matches_jax(method, monkeypatch):
    """``extract_geometry_dense`` at depth 5; JAX's numpy path stands in for
    cubes_numpy, its native one for the other two."""
    if method == "cubes_numpy":
        jax_numpy_only(monkeypatch)
    kw = dict(octree_depth=5, chunk=CHUNK)
    jax_method = "cubes" if method == "cubes_numpy" else method
    assert_same(tiso.extract_geometry_dense(torus_sdf, method=method, **kw),
                jiso.extract_geometry_dense(torus_sdf, method=jax_method, **kw))


@pytest.mark.parametrize("method", ["cubes", "tetrahedra", "cubes_numpy"])
@pytest.mark.parametrize("path", ["sign_only_dense", "prefilter"])
def test_single_level_branch_matches_jax(method, path, monkeypatch):
    """fine depth = dense depth (5): the dense lattice's values through
    sdf_fn, triangulated whole, as JAX does; neither fast path is taken,
    whatever the caller passes."""
    if method == "cubes_numpy":
        jax_numpy_only(monkeypatch)

    def refused(*args):
        raise AssertionError("the single-level branch took a fast path")

    kw = dict(dense_octree_depth=5, hierarchical_octree_depth=5, chunk=CHUNK,
              prefilter_octree_depth=3 if path == "prefilter" else None)
    stats = {}
    port = tiso.hierarchical_extract_geometry(torus_sdf, method=method, grid_inside_fn=refused,
                                              ids_val_fn=refused, ids_val_coarse_fn=refused,
                                              stats=stats, **kw)
    jax_method = "cubes" if method == "cubes_numpy" else method
    assert_same(port, jiso.hierarchical_extract_geometry(torus_sdf, method=jax_method, **kw))
    assert stats == {"prefilter": 0, "band": 0, "dense": 9, "fine": 0}
    assert_same(port, tiso.extract_geometry_dense(torus_sdf, octree_depth=5, chunk=CHUNK, method=method))


@pytest.mark.parametrize("path", list(PATHS))
def test_hierarchical_tetrahedra_matches_jax(path):
    """``method="tetrahedra"`` through every coarse path (dense 5, fine 6):
    JAX's arrays, and 1.5x-4x the faces of cubes on the same lattice."""
    kw = dict(dense_octree_depth=5, hierarchical_octree_depth=6, chunk=CHUNK, **PATHS[path])
    tets = tiso.hierarchical_extract_geometry(torus_sdf, method="tetrahedra", **kw)
    assert_same(tets, jiso.hierarchical_extract_geometry(torus_sdf, method="tetrahedra", **kw))
    cubes = tiso.hierarchical_extract_geometry(torus_sdf, **kw)
    assert 1.5 * len(cubes[1]) <= len(tets[1]) <= 4 * len(cubes[1])
    assert np.abs(torus_sdf(tets[0])).max() < 2.01 / 64


def test_hierarchical_cubes_numpy_matches_jax_numpy(monkeypatch):
    jax_numpy_only(monkeypatch)
    kw = dict(dense_octree_depth=5, hierarchical_octree_depth=6, chunk=CHUNK,
              grid_inside_fn=grid_inside_fn, ids_val_fn=ids_val_fn, prefilter_octree_depth=3)
    port = tiso.hierarchical_extract_geometry(torus_sdf, method="cubes_numpy", **kw)
    assert_same(port, jiso.hierarchical_extract_geometry(torus_sdf, **kw))


def test_coarse_fn_takes_the_prefilter_and_band_passes():
    """``ids_val_coarse_fn`` answers the prefilter and band passes (signs),
    ``ids_val_fn`` the fine pass (the values the vertices interpolate)."""
    calls = {"coarse": 0, "fine": 0}

    def counted(name):
        def fn(ijk, lo, step):
            calls[name] += len(ijk) // CHUNK
            return ids_val_fn(ijk, lo, step)
        return fn

    kw = dict(dense_octree_depth=5, hierarchical_octree_depth=6, chunk=CHUNK, prefilter_octree_depth=3)
    stats = {}
    port = tiso.hierarchical_extract_geometry(torus_sdf, ids_val_fn=counted("fine"),
                                              ids_val_coarse_fn=counted("coarse"), stats=stats, **kw)
    assert calls == {"coarse": stats["prefilter"] + stats["band"], "fine": stats["fine"]} and calls["fine"]
    assert_same(port, jiso.hierarchical_extract_geometry(torus_sdf, ids_val_fn=ids_val_fn, **kw))


@pytest.mark.parametrize("call", ["cells", "dense", "hierarchical"])
def test_unknown_method_raises(call):
    cells = torus_cells(8)
    run = {
        "cells": lambda: tiso.triangulate_cells(*cells, method="marching_squares"),
        "dense": lambda: tiso.extract_geometry_dense(torus_sdf, octree_depth=3, method="tets"),
        "hierarchical": lambda: tiso.hierarchical_extract_geometry(
            torus_sdf, dense_octree_depth=3, hierarchical_octree_depth=4, method="numpy"),
    }[call]
    with pytest.raises(ValueError, match="unknown triangulation method"):
        run()
