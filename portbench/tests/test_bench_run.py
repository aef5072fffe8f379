"""A whole run of the tiny cells on the CPU: the result line, the window,
the work count, the roofline's peaks, the reference held against the port,
the control, and the cell that exists only as new files."""

import ast
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.bench import check, manifest, window
from portbench.bench.traffic import frames, mesh

ROOT = Path(__file__).resolve().parents[2]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", ["tiny.video", "tiny.mesh"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(tiny_runs, tiny_root, cell, trace):
    out = tiny_runs[cell, trace]
    assert list(out)[:5] == KEYS and list(out)[-1] == "compared"
    assert ("breakdown" in out) == trace
    assert ("busy_s" in out["device"]) == trace
    man = manifest.load(tiny_root)
    expected = {m["name"] for m in manifest.metrics_of(man, cell, per_layer=trace)}
    readable = expected - {"attn_roofline", "device_idle"}  # no device on the CPU
    assert readable <= set(out["metrics"]) <= expected
    for c in out["compared"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell", ["tiny.video", "tiny.mesh"])
def test_reference_holds_the_port_at_tiny_widths(tiny_runs, cell):
    """fp32 port against the fp32 reference: every number within 1e-4."""
    out = tiny_runs[cell, False]
    assert out["correct"], out["compared"]
    names = set(out["compared"])
    stage0 = {"s0_v", "s0_step", "sdf"} if cell == "tiny.video" else {"s0_vae"}
    assert names == {"enc", "s1_v", "s1_step", "s2", "handoff"} | stage0


def test_split_cfg_batch_cell_runs(tiny_root, monkeypatch):
    """The low-RAM preset's cell, added as a configuration file, a limits
    file and a manifest entry: its denoiser runs one guidance branch a
    call, and the check reads each step from those calls."""
    import time

    import actionmesh_tpu_torch.sampling.denoise_loop as loop

    from portbench.bench import driver
    from portbench.tests.conftest import LOWRAM_CELL

    rows = []
    orig = loop.denoiser_forward

    def counted(params, dcfg, hidden, *a, **k):
        rows.append(hidden.shape[0])
        return orig(params, dcfg, hidden, *a, **k)

    monkeypatch.setattr(loop, "denoiser_forward", counted)
    out = driver.run(tiny_root, LOWRAM_CELL, 2**31 + 77, 0.05, False, time.perf_counter(),
                     device="cpu")
    assert rows and set(rows) == {1}
    assert out["correct"], out["compared"]
    assert set(out["compared"]) == {"enc", "s0_v", "s0_step", "sdf", "s1_v", "s1_step", "s2",
                                    "handoff"}


def test_control_fails_at_tiny_widths(tiny_root):
    from portbench.bench import control

    (r,) = control.readings(tiny_root, "tiny.video", [5], seconds=0.01, device="cpu")
    assert r["correct"]
    assert control.control_fails(r), r


def test_window_arithmetic():
    ticks = iter([100.0, 103.0, 107.5, 112.0])
    w = window.closed_loop(lambda i: None, 7.0, clock=lambda: next(ticks))
    assert w["clips"] == 2 and w["window_s"] == 7.5 and w["ends"] == [3.0, 7.5]
    assert window.clip_seconds(w) == 3.75
    ticks = iter([0.0, 52.0])
    one = window.closed_loop(lambda i: None, 10.0, clock=lambda: next(ticks))
    assert one["clips"] == 1 and window.clip_seconds(one) == 52.0


def _hand_flow(w, L, T, N, ctx, cin, cdim, batch, cond, inflated):
    m = batch * T * (N + 1)
    f = 4 * batch * T * N * cin * w + 16 * batch * T * w * w
    seq = T * (N + 1) if inflated else N + 1
    nseq = batch if inflated else batch * T
    for i in range(L):
        f += 8 * m * w * w + 4 * nseq * seq * seq * w + 16 * m * w * w
        f += cond * T * (4 * (N + 1) * w * w + 4 * ctx * cdim * w + 4 * (N + 1) * ctx * w)
        f += 4 * m * w * w if i > L // 2 else 0
    return f


@pytest.mark.parametrize("shape", [(64, 3, 4, 16, 8, 32), (2048, 21, 16, 2048, 64, 1024)])
def test_work_count_against_hand_sums(shape):
    w, L, T, N, cin, cdim = shape
    work = manifest.work_model("actionmesh", ROOT)
    c = {"width": w, "num_layers": L, "in_channels": cin, "cross_attention_dim": cdim, "mlp_ratio": 4.0}
    for batch, cond, inflated in ((2, 1, True), (2, 1, False), (1, 1, False)):
        got = work.flow_transformer(c, batch, T, N, 257, cond, inflated)
        assert got == pytest.approx(_hand_flow(w, L, T, N, 257, cin, cdim, batch, cond, inflated), rel=1e-12)
    assert check.windows(16, 16, 15) == [list(range(16))]
    assert check.windows(31, 16, 15) == [list(range(16)), list(range(15, 31))]


def test_roofline_peak_per_dtype():
    roof = manifest.metric_reader.__globals__["_module"](ROOT / "portbench/metrics/attn_roofline.py", "t")
    assert roof.PEAK == {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12}
    ops = 4.0 * 2 * 16 * 32784 * 32784 * 128
    assert roof.bound_s(2, 16, 32784, 32784, 128, "bfloat16") == pytest.approx(ops / 989e12)
    assert roof.bound_s(2, 16, 32784, 32784, 128, "float32") == pytest.approx(ops / 495e12)
    small = roof.bound_s(1, 8, 64, 64, 128, "bfloat16")
    assert small == pytest.approx(2 * 8 * 128 * (2 * 64 + 2 * 64) / 3.35e12)
    rec = {"trace": {"attn": [("2x16x32784x32784x128:bfloat16", ops / 989e12 * 2)]}}
    assert roof.read(rec) == pytest.approx(50.0)
    assert roof.read({"trace": {"attn": []}}) is None


def test_traffic_same_sizes_on_every_seed():
    mix = json.loads((ROOT / "portbench/traffic/mesh16.json").read_text())
    for seed in (0, 2**31 + 5, 10**12):
        f = frames(dict(mix, frame_size=96), seed)
        assert len(f) == 16 and f[0].shape == (96, 96, 4)
        v, fa = mesh(mix, seed)
        assert v.shape == (50002, 3) and fa.shape == (100000, 3)
    a, b = frames(dict(mix, frame_size=64), 7), frames(dict(mix, frame_size=64), 7)
    assert all((x == y).all() for x, y in zip(a, b))


def test_no_jax_in_a_run(tiny_root):
    """A tiny cell in a fresh process leaves no module named jax, jaxlib,
    flax or actionmesh_tpu (whole top-level names) in sys.modules."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from portbench.bench import driver\n"
        "driver.run(__import__('pathlib').Path(%r), 'tiny.video', 3, 0.01, False, time.perf_counter(), device='cpu')\n"
        "sys.path.insert(0, %r); import run\n"
        "print('BAD', run.forbidden_modules())\n"
    ) % (str(ROOT), str(tiny_root), str(ROOT / "portbench"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "BAD []" in out.stdout


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    spec = importlib.util.spec_from_file_location("portbench_run", ROOT / "portbench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    clean = {k: v for k, v in sys.modules.items() if k.split(".")[0] not in run.FORBIDDEN}
    fake = {"actionmesh_tpu_torch.ops": None, "jaxtyping": None, "flaxen": None}
    monkeypatch.setattr(sys, "modules", {**clean, **fake})
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {**clean, "actionmesh_tpu.models": None, "jaxlib": None})
    assert run.forbidden_modules() == ["actionmesh_tpu", "jaxlib"]


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("actionmesh_tpu_torch", "actionmesh_tpu", "jax"), (path, n)
