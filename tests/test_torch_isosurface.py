"""The port's extraction, decimation and mesh cleanup vs the JAX package.

Both sides triangulate with the same native marching cubes and decimate
with the same native QEM, so on the same inputs their arrays are equal.
"""

import numpy as np
import pytest

from actionmesh_tpu.io.mesh import Mesh as JMesh
from actionmesh_tpu.ops.isosurface import hierarchical_extract_geometry as jextract
from actionmesh_tpu.preprocessing import mesh as jmesh
from actionmesh_tpu_torch.io.mesh import Mesh as TMesh
from actionmesh_tpu_torch.models.stage0 import make_uv_sphere
from actionmesh_tpu_torch.ops.isosurface import hierarchical_extract_geometry as textract
from actionmesh_tpu_torch.preprocessing import mesh as tmesh
from actionmesh_tpu_torch.utils import native

CHUNK = 1 << 12


def torus_sdf(pts: np.ndarray) -> np.ndarray:
    """Analytic torus (radii 0.5, 0.2) about z, inside negative."""
    p = np.asarray(pts, np.float64)
    q = np.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2) - 0.5
    return (np.sqrt(q**2 + p[:, 2] ** 2) - 0.2).astype(np.float32)


def grid_inside_fn(lo, step, Rc, level):
    """Sign-only dense lattice, as the device fast path returns it: row-major
    ids, points lo + ijk * step in fp32, padded to whole chunks."""
    n = -(-Rc**3 // CHUNK) * CHUNK
    idx = np.arange(n)
    ijk = np.stack([idx // (Rc * Rc), (idx // Rc) % Rc, idx % Rc], -1)
    pts = np.float32(lo) + ijk.astype(np.float32) * np.float32(step)
    return (torus_sdf(pts) < level).astype(np.int8)


def ids_val_fn(ijk, lo, step):
    return torus_sdf(np.float32(lo) + ijk.astype(np.float32) * np.float32(step))


PATHS = {
    "prefilter": dict(grid_inside_fn=grid_inside_fn, ids_val_fn=ids_val_fn, prefilter_octree_depth=3),
    "sign_only_dense": dict(grid_inside_fn=grid_inside_fn, ids_val_fn=ids_val_fn),
    "host_callbacks": dict(),
    "host_callbacks_prefilter": dict(prefilter_octree_depth=3),
}
CHUNKS = {
    "prefilter": {"prefilter": 1, "band": 5, "dense": 0, "fine": 5},
    "sign_only_dense": {"prefilter": 0, "band": 0, "dense": 9, "fine": 5},
    "host_callbacks": {"prefilter": 0, "band": 0, "dense": 9, "fine": 5},
    "host_callbacks_prefilter": {"prefilter": 1, "band": 5, "dense": 0, "fine": 5},
}


@pytest.mark.parametrize("path", list(PATHS))
def test_extraction_matches_jax_on_a_torus(path):
    """Dense depth 5, fine depth 6 (prefilter 3) on an analytic torus: the
    same vertices and faces as JAX, bit for bit, and the chunk count of
    every pass."""
    kw = dict(dense_octree_depth=5, hierarchical_octree_depth=6, chunk=CHUNK, **PATHS[path])
    jv, jf = jextract(torus_sdf, **kw)
    stats = {}
    tv, tf = textract(torus_sdf, stats=stats, **kw)
    assert len(tf) > 10_000 and tv.dtype == np.float32 and tf.dtype == np.int64
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tv, jv)
    assert stats == CHUNKS[path]
    # on the surface: |sdf| of every vertex within a fine cell's reach
    assert np.abs(torus_sdf(tv)).max() < 2.01 / 64


def test_extraction_without_a_surface_and_bad_depths():
    outside = lambda pts: np.ones(len(pts), np.float32)  # noqa: E731
    v, f = textract(outside, dense_octree_depth=3, hierarchical_octree_depth=4, chunk=CHUNK,
                    prefilter_octree_depth=2)
    assert v.shape == (0, 3) and f.shape == (0, 3)
    # a fine depth at or below the dense depth is JAX's single-level
    # extraction (the dense lattice triangulated whole), not an error
    for fine in (4, 3):
        kw = dict(dense_octree_depth=4, hierarchical_octree_depth=fine, chunk=CHUNK)
        (tv, tf), (jv, jf) = textract(torus_sdf, **kw), jextract(torus_sdf, **kw)
        assert len(tf) > 100
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tv, jv)
    with pytest.raises(ValueError, match="unknown triangulation method"):
        textract(torus_sdf, dense_octree_depth=4, hierarchical_octree_depth=5, chunk=CHUNK,
                 method="marching_squares")


def _sphere(n_lat, n_lon):
    m = make_uv_sphere(n_lat=n_lat, n_lon=n_lon)
    return m.vertices, m.faces


@pytest.mark.parametrize(
    "case",
    [
        # QEM alone: 16,128 faces -> 3,000
        ("qem", (64, 126), 3000),
        # above max(16 x target, 400,000) faces: the clustering pre-pass first
        ("cluster_pre_pass", (410, 500), 2000),
    ],
    ids=lambda c: c[0],
)
def test_decimate_mesh_matches_jax(case):
    _, (n_lat, n_lon), target = case
    verts, faces = _sphere(n_lat, n_lon)
    if case[0] == "cluster_pre_pass":
        assert len(faces) > 400_000
    jout = jmesh.decimate_mesh(JMesh(vertices=verts, faces=faces), target)
    tout = tmesh.decimate_mesh(TMesh(vertices=verts, faces=faces), target)
    assert 0.8 * target <= tout.n_faces <= target
    np.testing.assert_array_equal(tout.faces, jout.faces)
    np.testing.assert_array_equal(tout.vertices, jout.vertices)
    small = TMesh(vertices=verts[:3], faces=np.array([[0, 1, 2]]))
    assert tmesh.decimate_mesh(small, target) is small


def test_process_mesh_with_seed_matches_jax():
    """Merge, clean, decimate (QEM) and drop a floater, under the seed; the
    global numpy RNG comes back as it was."""
    tv, tf = textract(torus_sdf, dense_octree_depth=5, hierarchical_octree_depth=6, chunk=CHUNK)
    sv, sf = _sphere(4, 8)
    verts = np.concatenate([tv, sv * 0.02 + 0.9]).astype(np.float64)
    faces = np.concatenate([tf, sf + len(tv)])
    jout = jmesh.MeshPostprocessor(face_decimation=4000).process_mesh(
        JMesh(vertices=verts, faces=faces), seed=7
    )
    np.random.seed(123)
    before = np.random.get_state()[1].copy()
    tout = tmesh.MeshPostprocessor(face_decimation=4000).process_mesh(
        TMesh(vertices=verts, faces=faces), seed=7
    )
    np.testing.assert_array_equal(np.random.get_state()[1], before)
    assert tout.n_faces <= 4000
    np.testing.assert_array_equal(tout.faces, jout.faces)
    np.testing.assert_array_equal(tout.vertices, jout.vertices)
    assert tout.vertices.max() < 0.8  # the floater is gone


def test_native_library_builds_into_the_package():
    """The port builds its own copy under actionmesh_tpu_torch/_build/,
    keyed by the sources' hash, and writes nothing into native/."""
    path = native.build()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.name.startswith("actionmesh_native-") and path == native.library_path()
    assert native.build() == path
    assert not any(p.name.startswith("actionmesh_native-") for p in native.NATIVE_DIR.iterdir())
    with pytest.raises(ValueError, match="face indices"):
        native.quadric_decimate(np.zeros((3, 3)), np.array([[0, 1, 3]]), 1)


def test_native_library_path_follows_the_host_target(monkeypatch):
    """A build for another CPU (another -march=native target) has another
    path, so a copied build directory is rebuilt rather than loaded."""
    here = native.library_path()
    assert "-march=" in native.host_target()
    monkeypatch.setattr(native, "host_target", lambda: "-march= some-other-cpu")
    other = native.library_path()
    assert other != here and other.parent == here.parent
