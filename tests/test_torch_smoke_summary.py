"""The short kernels line that ``chip_smoke.py`` prints just before its last
line: built from rows named and shaped as the smoke run's case lists give
them, it names every kernel path once and stays under 4 KB, so the tail of
the card tool's output always holds it; and it refuses a row that claims to
beat its bound."""

import json

import numpy as np
import pytest

import chip_smoke as smoke

PATHS = ["A bf16", "A fp32", "A fp16", "B fwd", "B bwd", "C bf16", "D bf16", "C fp32", "D fp32",
         "E", "F"]


def _rows(seed: int):
    """Rows of every case, with long unrounded numbers of the smoke run's
    keys (the line must round them); every bound under its time."""
    rng = np.random.default_rng(seed)

    def x():
        return float(rng.uniform(1e-7, 1e4))

    def timed(ms_key):
        ms = x()
        return {ms_key: ms, "bound_ms": ms * float(rng.uniform(0.05, 1.0))}

    flash = [{"name": n, "shape": list(s), **timed("ms"), "library_ms": x(), "max_abs_err": x(), "tol": x()}
             for n, s, _, _ in smoke.flash_cases(19154) + smoke.flash_cases_fp16(19154)]
    rope = [{"name": c[0], "shape": list(c[1]), **timed("device_ms"), "library_ms": None,
             "max_abs_err": x()} for c in smoke.ROPE_CASES]
    rope_bwd = [{"name": c[0], "shape": list(c[1]), **timed("ms"), "library_ms": x(),
                 "errors": {"dx": x()}, "tol": {"dx": x()}} for c in smoke.ROPE_BWD_CASES]
    bwd = []
    for n, s, _ in smoke.BWD_CASES:
        c, d = timed("ms"), timed("ms")
        bwd.append({"name": n, "shape": list(s), "ms_dkv": c["ms"], "ms_dq": d["ms"],
                    "bound_dkv": {"bound_ms": c["bound_ms"]}, "bound_dq": {"bound_ms": d["bound_ms"]},
                    "library_bwd_ms": x(), "max_abs_err": {g: x() for g in ("dq", "dk", "dv")},
                    "tol": {g: x() for g in ("dq", "dk", "dv")}})
    nn = [{"name": "icp", "shape": [384, 10000, 10000, 3], **timed("ms"), "library_ms": None,
           "max_abs_err": x(), "tol": f"rel {smoke.NN_TIE_REL} of |x|^2 + |y|^2"}]
    fused = [{"name": n, "shape": list(s), **timed("ms"), "library_ms": x(), "max_abs_err": x(), "tol": x()}
             for n, s, _ in smoke.FUSED_CASES]
    return flash, rope, rope_bwd, bwd, nn, fused


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_summary_names_every_path_under_4kb(seed):
    flash, rope, rope_bwd, bwd, nn, fused = _rows(seed)
    line = json.dumps(smoke.kernel_summary(flash, rope, rope_bwd, bwd, nn, fused))
    assert "\n" not in line and len(line.encode()) < 4096
    entries = json.loads(line)["kernel_summary"]
    assert [e["path"] for e in entries] == PATHS
    heads = {"A fp32": [2, 16, 32784, 32784, 128], "C fp32": [2, 16, 32784, 32784, 128],
             "D fp32": [2, 16, 32784, 32784, 128], "B fwd": [2, 16, 32784, 128],
             "B bwd": [2, 16, 32784, 128]}
    for e in entries:
        assert set(e) == {"path", "shape", "ms", "share", "x_lib", "err", "tol"}
        if e["path"] in heads:
            assert e["shape"] == heads[e["path"]]
    by_path = {e["path"]: e for e in entries}
    c32 = next(r for r in bwd if r["name"] == "stage1_self_f32")
    assert by_path["C fp32"]["ms"] == pytest.approx(c32["ms_dkv"], rel=1e-3)
    assert by_path["C fp32"]["err"] == pytest.approx(max(c32["max_abs_err"][g] for g in ("dk", "dv")), rel=1e-2)
    assert by_path["D fp32"]["x_lib"] == pytest.approx(c32["ms_dq"] / c32["library_bwd_ms"], rel=1e-2)
    assert by_path["E"]["x_lib"] is None and by_path["B fwd"]["x_lib"] is None


@pytest.mark.parametrize("path", PATHS)
def test_kernel_summary_refuses_a_share_above_the_bound(path):
    """A head row that runs faster than its bound (1.27 of it, as an
    L2-resident row timed against a DRAM-byte bound reads) fails the smoke
    run; the same share in a row that no path heads (Stage 0's DiT q/k,
    which fits in L2) leaves the line as it was."""
    flash, rope, rope_bwd, bwd, nn, fused = _rows(2)
    dit = next(r for r in rope if r["name"] == "stage0_dit_self_qk")
    dit["bound_ms"] = 1.27 * dit["device_ms"]
    before = smoke.kernel_summary(flash, rope, rope_bwd, bwd, nn, fused)
    assert all(e["share"] <= smoke.SHARE_MAX for e in before["kernel_summary"])
    heads = {"A bf16": (flash, "stage1_self", "ms"), "A fp32": (flash, "stage1_self_f32", "ms"),
             "A fp16": (flash, "stage1_self_fp16", "ms"), "B fwd": (rope, "stage1_self_qk", "device_ms"),
             "B bwd": (rope_bwd, "stage1_self_qk", "ms"), "E": (nn, "icp", "ms"),
             "F": (fused, "stage1_self", "ms")}
    if path in heads:
        rows, name, ms_key = heads[path]
        r = next(r for r in rows if r["name"] == name)
        r["bound_ms"] = 1.27 * r[ms_key]
    else:
        kernel, dtype = path.split()
        key = "dkv" if kernel == "C" else "dq"
        r = next(r for r in bwd if r["name"] == ("stage1_self" if dtype == "bf16" else "stage1_self_f32"))
        r[f"bound_{key}"]["bound_ms"] = 1.27 * r[f"ms_{key}"]
    with pytest.raises(AssertionError, match=path):
        smoke.kernel_summary(flash, rope, rope_bwd, bwd, nn, fused)


def test_bwd_times_reads_the_smoke_fp32_rows():
    """``bwd_times.py`` times C and D at the fp32 rows of the smoke run's
    BWD_CASES, read from its source, so the two lists cannot drift."""
    import bwd_times

    want = {n: s for n, s, dtype in smoke.BWD_CASES if dtype == smoke.torch.float32}
    assert bwd_times.fp32_shapes() == want


@pytest.mark.parametrize("failing", [(), ("--bad",)], ids=["all_pass", "one_fails"])
def test_cli_mode_reports_every_run_then_fails_on_a_failure(monkeypatch, capsys, failing):
    """``chip_smoke.py --cli "FLAGS" ...`` runs and reports every quoted set
    of flags, a failed one with its error, and then exits non-zero when any
    run failed (a failure is never caught into a passing exit)."""
    specs = ["--fast", "--bad", "--dtype float16"] if failing else ["--fast", "--dtype float16"]
    ran = []

    def phase_cli(presets):
        (spec, flags), = presets.items()
        ran.append(spec)
        if spec in failing:
            raise AssertionError(f"cli {spec}: launch counts differ")
        return {spec: {"flags": flags, "clip_seconds": 1.0}}

    monkeypatch.setattr(smoke, "phase_device", lambda: {"nvidia_smi": "a card, 700 W"})
    monkeypatch.setattr(smoke, "phase_build", lambda: {})
    monkeypatch.setattr(smoke, "phase_cli", phase_cli)
    if failing:
        with pytest.raises(SystemExit) as exit_info:
            smoke.main_cli_runs(specs)
        assert exit_info.value.code not in (0, None) and "--bad" in str(exit_info.value.code)
    else:
        smoke.main_cli_runs(specs)
    assert ran == specs
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["cli"]
    assert list(report) == specs
    if failing:
        assert report["--bad"]["error"].startswith("AssertionError")
    assert report["--dtype float16"] == {"flags": ["--dtype", "float16"], "clip_seconds": 1.0}


def test_train_cli_on_mesh_rewrites_the_restored_checkpoint(tmp_path, monkeypatch):
    """The four-card run's ``train.py --mesh`` sequence on two gloo ranks
    at tp 2, tiny size: two steps and a checkpoint; a ``--steps 2`` resume
    that takes no step and writes the restored state back, equal to the
    first checkpoint in every entry (re-cut over tp, then gathered); a
    third step, logged as step 3."""
    monkeypatch.setattr(smoke, "OUT_DIR", tmp_path)
    args = ["--synthetic", "--size", "tiny", "--window", "4", "--batch", "2", "--warmup", "0",
            "--log-every", "1", "--ckpt-every", "0", "--mesh", "tp=2", "--device", "cpu"]
    out = smoke.train_cli_on_mesh(2, args)
    assert out["rewrite_differs_in"] == []
    assert [r["step"] for r in out["runs"][-1]["log"]] == [1, 2, 3]
    assert [r["step"] for r in out["runs"][1]["log"]] == [1, 2]
