"""The port's exact TSDF (``preprocessing/sdf.py``) vs the JAX package's.

Both are host numpy in float64 with the same arithmetic in the same order,
so every result is held bit-equal, on a closed-loop scene's normalized
anchor (``make_scene``) and on a sphere against its analytic distance.
"""

import dataclasses

import numpy as np
import pytest

from actionmesh_tpu.io.mesh import Mesh as JMesh
from actionmesh_tpu.preprocessing import sdf as jsdf
from actionmesh_tpu_torch.models.stage0 import make_uv_sphere
from actionmesh_tpu_torch.preprocessing import sdf as tsdf
from actionmesh_tpu_torch.preprocessing.mesh import normalize_mesh
from actionmesh_tpu_torch.training.closed_loop import CascadeSpec, make_scene

SPEC = dataclasses.replace(CascadeSpec(), n_frames=4, n_lat=12, n_lon=16)


@pytest.fixture(scope="module")
def anchor():
    """A normalized scene anchor (port mesh, JAX mesh of the same arrays)
    and a query pool around it."""
    mesh, _, _ = normalize_mesh(make_scene(7, SPEC)[0])
    pool = tsdf.sample_sdf_queries(mesh, 300, 100, seed=3)
    return mesh, JMesh(mesh.vertices.copy(), mesh.faces.copy()), pool


def test_sample_sdf_queries_bit_equal(anchor):
    mesh, jmesh, pool = anchor
    np.testing.assert_array_equal(pool, jsdf.sample_sdf_queries(jmesh, 300, 100, seed=3))
    assert pool.shape == (400, 3) and pool.dtype == np.float32
    assert np.abs(pool[300:]).max() <= 1.1


@pytest.mark.parametrize("fn", ["point_mesh_distance", "winding_number", "mesh_tsdf"])
def test_fields_bit_equal(anchor, fn):
    mesh, jmesh, pool = anchor
    got = getattr(tsdf, fn)(pool, mesh)
    want = getattr(jsdf, fn)(pool, jmesh)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_closest_point_tiles_bit_equal(anchor):
    """The (query x face) squared distances themselves, every region of
    Eberly's case analysis exercised by points all around the mesh."""
    mesh, _, pool = anchor
    tri = mesh.vertices[mesh.faces]
    np.testing.assert_array_equal(
        tsdf._closest_point_sq_dist(pool[:64], tri), jsdf._closest_point_sq_dist(pool[:64], tri)
    )


def test_sphere_sign_and_distance():
    """Negative inside; within the mesh's chordal deviation of the
    analytic distance; clamped."""
    m = make_uv_sphere(radius=0.6, n_lat=32, n_lon=48)
    pts = np.random.default_rng(0).uniform(-1.0, 1.0, (300, 3)).astype(np.float32)
    sdf = tsdf.mesh_tsdf(pts, m, clamp=10.0)
    np.testing.assert_allclose(sdf, np.linalg.norm(pts, axis=1) - 0.6, atol=5e-3)
    assert (sdf[np.linalg.norm(pts, axis=1) < 0.55] < 0).all()
    assert np.abs(tsdf.mesh_tsdf(pts, m, clamp=0.2)).max() <= 0.2 + 1e-6
