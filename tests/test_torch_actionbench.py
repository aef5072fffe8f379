"""The port's ActionBench evaluator against the JAX package's, on the CPU.

Same numpy inputs on both sides; each test states its tolerance. The JAX
``nn_argmin`` Pallas kernel runs in interpret mode, as
``tests/test_actionbench.py`` runs it; the port's wrapper runs its plain
version on CPU tensors.
"""

from __future__ import annotations

import importlib.util
import json
import math
import struct
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import actionbench.benchmark as jbench
import actionbench.evaluate_dataset as jeval
import actionbench.icp as jicp
import actionbench.sample_mesh as jsample
from actionmesh_tpu.io import mesh as jmesh
from actionmesh_tpu.io.video_input import natsorted as jnatsorted
from actionmesh_tpu.models.stage0 import make_uv_sphere as jsphere
from actionmesh_tpu.ops.nn_argmin import nn_argmin as jnn_argmin
from actionmesh_tpu_torch.actionbench import benchmark as tbench
from actionmesh_tpu_torch.actionbench import evaluate_dataset as teval
from actionmesh_tpu_torch.actionbench import icp as ticp
from actionmesh_tpu_torch.actionbench import sample_mesh as tsample
from actionmesh_tpu_torch.actionbench import synthetic as tsynth
from actionmesh_tpu_torch.io import mesh as tmesh
from actionmesh_tpu_torch.io.video_input import natsorted as tnatsorted
from actionmesh_tpu_torch.models.stage0 import make_uv_sphere as tsphere
from actionmesh_tpu_torch.ops.nn_argmin import nn_argmin, nn_argmin_reference

REPO = Path(__file__).resolve().parent.parent


def _jax_synthetic():
    spec = importlib.util.spec_from_file_location(
        "jax_synthetic_actionbench", REPO / "scripts" / "synthetic_actionbench.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def nn_disagreements(x, y, got, want, rel=1e-6) -> int:
    """Assert that two argmin results pick points at the same distance.

    Where the indices differ, the float64 squared distances of the two
    picks must agree within ``rel * (|x|^2 + max |y_pick|^2)``: the fp32
    rounding of the terms that each version sums (|x|^2, |y|^2, 2 x.y) in
    its own order. Returns the count of such near-ties.
    """
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    got, want = np.asarray(got), np.asarray(want)
    r, i = np.nonzero(got != want)
    if not len(r):
        return 0
    ya, yb = y[r, got[r, i]], y[r, want[r, i]]
    da = ((x[r, i] - ya) ** 2).sum(-1)
    db = ((x[r, i] - yb) ** 2).sum(-1)
    scale = (x[r, i] ** 2).sum(-1) + np.maximum((ya**2).sum(-1), (yb**2).sum(-1))
    bad = np.abs(da - db) > rel * scale
    assert not bad.any(), f"{bad.sum()} of {len(r)} differing picks are not near-ties"
    return len(r)


NN_CASES = [
    ("random", (2, 300, 450), 5),
    ("ragged", (4, 512, 384), 6),
]


@pytest.mark.parametrize("name,shape,seed", NN_CASES, ids=[c[0] for c in NN_CASES])
def test_nn_argmin_reference_matches_jax(name, shape, seed):
    """Plain version == JAX's Pallas kernel (interpret) and its XLA path,
    up to near-ties of rel 1e-6 (counted, and none expected here)."""
    R, N, M = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R, N, 3)).astype(np.float32)
    y = rng.normal(size=(R, M, 3)).astype(np.float32)
    before = nn_argmin.launches
    got = nn_argmin(torch.from_numpy(x), torch.from_numpy(y), chunk=128)
    assert got.dtype == torch.int32 and got.shape == (R, N)
    assert nn_argmin.launches == before  # the CPU path launches nothing
    kernel = np.asarray(jnn_argmin(jnp.asarray(x), jnp.asarray(y)))
    xla = np.asarray(jicp._nn_indices(jnp.asarray(x), jnp.asarray(y), chunk=128))
    assert nn_disagreements(x, y, got.numpy(), kernel) == 0
    assert nn_disagreements(x, y, got.numpy(), xla) == 0
    brute = np.argmin(((x[:, :, None] - y[:, None]) ** 2).sum(-1), axis=-1)
    assert nn_disagreements(x, y, got.numpy(), brute) == 0


def test_nn_argmin_ties_go_to_smallest_index():
    """Every y point appears twice (and x sits on some of them): the pick is
    the first copy, as in JAX. Exact ties, so exact equality."""
    rng = np.random.default_rng(7)
    base = rng.normal(size=(3, 200, 3)).astype(np.float32)
    y = np.concatenate([base, base, base[:, :50]], axis=1)
    x = np.concatenate([base[:, :100], rng.normal(size=(3, 150, 3)).astype(np.float32)], axis=1)
    got = nn_argmin_reference(torch.from_numpy(x), torch.from_numpy(y), chunk=64).numpy()
    want = np.asarray(jnn_argmin(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(got, want)
    assert (got < 200).all()
    np.testing.assert_array_equal(got[:, :100], np.tile(np.arange(100), (3, 1)))


def test_rotation_inits_and_6d_match_jax():
    np.testing.assert_array_equal(ticp.canonical_rotation_matrices(), jicp.canonical_rotation_matrices())
    r6d = np.random.default_rng(0).normal(size=(40, 6)).astype(np.float32)
    got = ticp.rotation_6d_to_matrix(torch.from_numpy(r6d)).numpy()
    want = np.asarray(jicp.rotation_6d_to_matrix(jnp.asarray(r6d)))
    np.testing.assert_allclose(got, want, atol=1e-6)  # fp32, sums in another order


@pytest.mark.parametrize("nn_every,single", [(1, False), (4, False), (1, True)])
def test_gradient_icp_multi_matches_jax(nn_every, single):
    """(R, T, s) within 2e-5 of JAX after 30 Adam steps: the same losses
    and update; autodiff and fp32 sums round in another order. With
    nn_every=4, 30 steps end in a 2-step remainder round; ``single`` goes
    through the one-problem wrapper ``gradient_icp``."""
    rng = np.random.default_rng(0)
    K, N, M = 2, 256, 300
    gt = rng.uniform(-1, 1, (K, M, 3)).astype(np.float32)
    rot = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    pred = (gt[:, :N] @ rot.T * 0.8 + 0.1 + rng.normal(0, 0.01, (K, N, 3))).astype(np.float32)
    if single:
        want = jicp.gradient_icp(pred[1], gt[1], n_iter=30)
        got = ticp.gradient_icp(pred[1], gt[1], n_iter=30, device="cpu")
    else:
        want = jicp.gradient_icp_multi(pred, gt, n_iter=30, nn_every=nn_every)
        got = ticp.gradient_icp_multi(pred, gt, n_iter=30, nn_every=nn_every, device="cpu")
    for key in ("R", "T", "s"):
        a, b = getattr(got, key), getattr(want, key)
        assert a.dtype == np.float64 and a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=2e-5, err_msg=key)


def _mesh_pair(scale=1.0, seed=0):
    j = jsphere(n_lat=10, n_lon=14)
    noise = np.random.default_rng(seed).normal(0, 0.01, j.vertices.shape)
    verts = j.vertices * scale + noise
    return jmesh.Mesh(verts, j.faces), tmesh.Mesh(verts, j.faces)


@pytest.mark.parametrize("synchronized", [False, True])
def test_sample_meshes_bitwise_equal_to_jax(synchronized):
    pairs = [_mesh_pair(1.0 + 0.1 * t) for t in range(3)]
    want = jsample.sample_meshes([p[0] for p in pairs], n_pts=700, synchronized=synchronized, seed=3)
    got = tsample.sample_meshes([p[1] for p in pairs], n_pts=700, synchronized=synchronized, seed=3)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _glb_with_uv(path: Path) -> None:
    """A two-triangle GLB with TEXCOORD_0, 16-bit indices and a node
    translation, the parts of the format save_glb does not write."""
    pos = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    blob = pos.tobytes() + uv.tobytes() + idx.tobytes()
    blob += b"\x00" * ((-len(blob)) % 4)
    views = [
        {"buffer": 0, "byteOffset": 0, "byteLength": 48},
        {"buffer": 0, "byteOffset": 48, "byteLength": 32},
        {"buffer": 0, "byteOffset": 80, "byteLength": 12},
    ]
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "translation": [0.5, -1.0, 2.0]}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "TEXCOORD_0": 1}, "indices": 2}]}],
        "buffers": [{"byteLength": len(blob)}], "bufferViews": views,
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC2"},
            {"bufferView": 2, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 28 + len(js) + len(blob)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(blob), 0x004E4942) + blob)


def test_glb_bytes_and_cross_load(tmp_path):
    """save_glb writes the JAX package's bytes; each load_glb reads the
    other's file to the same arrays (exactly: both round through fp32)."""
    jm, tm = _mesh_pair(seed=1)
    jmesh.save_glb(jm, tmp_path / "jax.glb")
    tm.export(tmp_path / "port.glb")
    assert (tmp_path / "port.glb").read_bytes() == (tmp_path / "jax.glb").read_bytes()
    for name in ("jax.glb", "port.glb"):
        a, b = tmesh.load_glb(tmp_path / name), jmesh.load_glb(tmp_path / name)
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.faces, b.faces)
        assert a.uv is None and b.uv is None
    np.testing.assert_array_equal(tmesh.load_glb(tmp_path / "port.glb").vertices, jm.vertices.astype(np.float32))

    _glb_with_uv(tmp_path / "uv.glb")
    a, b = tmesh.load_glb(tmp_path / "uv.glb"), jmesh.load_glb(tmp_path / "uv.glb")
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    np.testing.assert_array_equal(a.uv, b.uv)
    assert a.uv.shape == (4, 2) and a.vertices[0].tolist() == [0.5, -1.0, 2.0]
    with pytest.raises(ValueError, match="Unsupported"):
        tm.export(tmp_path / "mesh.ply")


def test_natsorted_matches_jax():
    names = ["mesh_10.glb", "mesh_2.glb", "Mesh_1.glb", "mesh_02.glb", "a", "mesh_100.glb"]
    assert tnatsorted(names) == jnatsorted(names)
    paths = [Path(f"/d/mesh_{i}.glb") for i in (12, 3, 1, 20)]
    assert tnatsorted(paths) == jnatsorted(paths)


def test_chamfer_3d_4d_matches_jax():
    """CD-3D, CD-4D and CD-M within rel 1e-5 of JAX (3 frames of the
    synthetic blob with sigma-0.05 vertex noise, 256 ICP points, 2000
    chamfer points, 30 ICP steps): identical samples, ICP transforms within
    ~1e-7, the same float64 KDTree chamfer. ICP's correspondences are
    discrete, so a near-tied neighbour that the two sides' fp32 rounding
    resolves differently can move a frame's alignment by ~1e-3 (seen on the
    rigid class: CD-3D 0.35% apart); this input has no such tie."""
    meshes = tsynth.animated_mesh_sequence(5, 3)
    gt = tsynth.tracked_gt_points(meshes, 3000, 6)[..., :3]
    pred = tsynth.PERTURBATIONS["noise_05"](meshes, np.random.default_rng(1))
    kw = dict(is_4D=True, n_pts_icp=256, n_pts_chamfer=2000, icp_iters=30)
    want = jbench.compute_chamfer_3d_4d(gt, [jmesh.Mesh(m.vertices, m.faces) for m in pred], **kw)
    seconds = {}
    got = tbench.compute_chamfer_3d_4d(gt, pred, device="cpu", seconds=seconds, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[2] > 0 and set(seconds) == {"sampling", "icp", "chamfer"}


def _write_dataset(root: Path, uids=("sample1",), n_meshes=3, short=()):
    mesh = tsphere(n_lat=12, n_lon=16)
    pts = tsample.sample_meshes([mesh] * 3, n_pts=2000, seed=0)
    for uid in uids:
        (root / "gt" / uid).mkdir(parents=True)
        np.save(root / "gt" / uid / "surfaces.npy", pts)
        (root / "pred" / uid).mkdir(parents=True)
        for i in range(1 if uid in short else n_meshes):
            mesh.export(root / "pred" / uid / f"mesh_{i:02d}.glb")


SMALL = dict(n_pts_icp=256, n_pts_chamfer=2000, device="cpu")


def test_evaluator_end_to_end_with_resume(tmp_path, monkeypatch):
    """As tests/test_actionbench.py's e2e test: a prediction equal to the GT
    scores below 0.1; the second call resumes from the CSV and evaluates
    nothing."""
    _write_dataset(tmp_path)
    csv_path = tmp_path / "results.csv"
    results = teval.evaluate_dataset(
        gt_root=str(tmp_path / "gt"), pred_root=str(tmp_path / "pred"),
        output_csv=str(csv_path), is_4d=True, icp_iters=60, **SMALL,
    )
    summary = results.summary()
    assert summary["n_success"] == 1
    assert summary["cd_3d_mean"] < 0.1 and summary["cd_4d_mean"] < 0.1
    assert csv_path.exists() and csv_path.with_suffix(".summary.json").exists()
    assert csv_path.read_text().splitlines()[0] == ",".join(teval.COLUMNS)

    def evaluate_sample(**kw):
        raise AssertionError(f"resumed run evaluated {kw['uid']}")

    monkeypatch.setattr(teval, "evaluate_sample", evaluate_sample)
    results2 = teval.evaluate_dataset(
        gt_root=str(tmp_path / "gt"), pred_root=str(tmp_path / "pred"), output_csv=str(csv_path), **SMALL
    )
    assert results2.summary()["n_success"] == 1
    assert results2.samples == results.samples


def _same(a, b, rel=0.0) -> bool:
    """Equal in every CSV column (floats within ``rel``), NaN equal to NaN."""
    for key in teval.COLUMNS:
        x, y = getattr(a, key), getattr(b, key)
        if isinstance(x, float) and math.isnan(x):
            if not (isinstance(y, float) and math.isnan(y)):
                return False
        elif isinstance(x, float):
            if not math.isclose(x, y, rel_tol=rel, abs_tol=0.0):
                return False
        elif x != y:
            return False
    return True


def test_csv_compatible_both_ways(tmp_path, monkeypatch):
    """JAX's loader reads the port's CSV to equal values, NaN and error
    message included (floats within 1e-15: pandas' default float parser is
    not round-trip exact, whoever wrote the file); the port resumes from a CSV that JAX's save_results
    wrote, keeping the success and retrying the failure."""
    _write_dataset(tmp_path, uids=("good", "short"), short=("short",))
    port_csv = tmp_path / "port.csv"
    results = teval.evaluate_dataset(
        gt_root=str(tmp_path / "gt"), pred_root=str(tmp_path / "pred"),
        output_csv=str(port_csv), icp_iters=10, **SMALL,
    )
    status = {s.uid: s.status for s in results.samples}
    assert status == {"good": "success", "short": "error"}
    loaded = jeval.load_existing_results(port_csv)
    assert sorted(loaded) == ["good", "short"]
    for s in results.samples:
        assert _same(loaded[s.uid], s, rel=1e-15), (loaded[s.uid], s)
    assert "Not enough meshes" in loaded["short"].error_message

    jax_results = jeval.DatasetResults()
    for s in results.samples:
        jax_results.add(jeval.SampleResult(**{k: getattr(s, k) for k in teval.COLUMNS}))
    jax_csv = tmp_path / "jax.csv"
    jeval.save_results(jax_results, jax_csv)
    back = teval.load_existing_results(jax_csv)
    for s in results.samples:
        assert _same(back[s.uid], s), (back[s.uid], s)
    assert json.loads(jax_csv.with_suffix(".summary.json").read_text())["n_success"] == 1

    calls = []
    real = teval.evaluate_sample
    monkeypatch.setattr(teval, "evaluate_sample", lambda **kw: calls.append(kw["uid"]) or real(**kw))
    again = teval.evaluate_dataset(
        gt_root=str(tmp_path / "gt"), pred_root=str(tmp_path / "pred"),
        output_csv=str(jax_csv), icp_iters=10, **SMALL,
    )
    assert calls == ["short"]
    assert [s.status for s in again.samples] == ["success", "error"]


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    """--device cuda with no card fails the run, not each sample."""
    _write_dataset(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        teval.main(["--gt_root", str(tmp_path / "gt"), "--pred_root", str(tmp_path / "pred")])
    assert teval.build_args().parse_args(["--gt_root", "g", "--pred_root", "p"]).device == "cuda"


def test_synthetic_fixture_matches_jax(tmp_path):
    """Fixture, perturbations and the written dataset equal the JAX
    script's byte for byte (one seed per class, 2 frames, 500 points)."""
    jsynth = _jax_synthetic()
    for a, b in zip(tsynth.animated_mesh_sequence(1001, 3), jsynth.animated_mesh_sequence(1001, 3)):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        np.testing.assert_array_equal(a.faces, b.faces)
    tm, jm = tsynth.animated_mesh_sequence(3000, 2), jsynth.animated_mesh_sequence(3000, 2)
    np.testing.assert_array_equal(tsynth.tracked_gt_points(tm, 400, 9), jsynth.tracked_gt_points(jm, 400, 9))
    assert list(tsynth.PERTURBATIONS) == list(jsynth.PERTURBATIONS)
    for kind in tsynth.PERTURBATIONS:
        a = tsynth.PERTURBATIONS[kind](tm, np.random.default_rng(4))
        b = jsynth.PERTURBATIONS[kind](jm, np.random.default_rng(4))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.vertices, y.vertices)

    uids = tsynth.build_dataset(tmp_path / "port", 2, n_pts_gt=500, per_kind=1)
    assert uids == jsynth.build_dataset(tmp_path / "jax", 2, n_pts_gt=500, per_kind=1)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.*"))
    assert len(files) == 4 * 3
    for rel in files:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel


def test_synthetic_suite_through_the_evaluator(tmp_path):
    """The four classes through the evaluator at a small size on the CPU:
    all succeed, per-class means and both sanity checks come out."""
    tsynth.build_dataset(tmp_path, 3, n_pts_gt=2000, per_kind=1)
    results = teval.evaluate_dataset(
        gt_root=str(tmp_path / "gt"), pred_root=str(tmp_path / "pred"), icp_iters=30, **SMALL
    )
    assert [s.status for s in results.samples] == ["success"] * 4
    per_kind = tsynth.per_kind_means(results.samples)
    assert sorted(per_kind) == ["identity", "noise_02", "noise_05", "rigid"]
    checks = tsynth.sanity_checks(per_kind)
    assert checks == {"rigid_recovered": True, "noise_monotonic": True}, per_kind


NEW_MODULES = [
    "actionmesh_tpu_torch.ops.nn_argmin",
    "actionmesh_tpu_torch.io.mesh",
    "actionmesh_tpu_torch.io.video_input",
    "actionmesh_tpu_torch.actionbench.sample_mesh",
    "actionmesh_tpu_torch.actionbench.icp",
    "actionmesh_tpu_torch.actionbench.benchmark",
    "actionmesh_tpu_torch.actionbench.evaluate_dataset",
    "actionmesh_tpu_torch.actionbench.synthetic",
]


def test_actionbench_port_imports_without_jax_optax_pandas():
    """In a process where jax, optax, pandas and the JAX package cannot be
    imported, every new module (and the shared chamfer and point-cloud
    modules they pull in) imports."""
    code = f"""
import importlib, importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "optax", "pandas", "flax", "actionmesh_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
for m in {NEW_MODULES!r}:
    importlib.import_module(m)
assert "actionbench.chamfer" in sys.modules and "actionbench.sample_point_cloud" in sys.modules
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
