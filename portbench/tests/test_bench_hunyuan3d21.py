"""The second model family, ``families/hunyuan3d21.py`` (Hunyuan3D-2.1's
shape model as Stage 0), run as a tiny cell added as new files only: the
program passes every limit, the fp8 control fails them, and every other
file of ``portbench/`` stays byte-identical. On a card, the family's cell
at its own size passes its limits while the control fails them, on three
seeds."""

import json
import shutil
import time
from pathlib import Path

import pytest

from portbench.bench import control, driver

ROOT = Path(__file__).resolve().parents[2]
DATA = ROOT / "portbench" / "tests" / "data"
CELL = "tiny_hunyuan3d21.video"
FILES = {"configs/tiny_hunyuan3d21.json": "tiny_hunyuan3d21.json",
         "traffic/tiny_video.json": "tiny_video.json",
         f"checks/{CELL}.json": "tiny_hunyuan3d21_checks.json"}
STAGE0 = ["s0_v", "s0_step", "sdf", "s0_vae", "s0_gate", "s0_route"]
SEEDS = (2**31 + 2201, 2**31 + 2202, 2**31 + 2203)


def _files(base: Path) -> dict[str, Path]:
    return {p.relative_to(base).as_posix(): p for p in base.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def hunyuan_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("hunyuan_root")
    d = root / "portbench"
    shutil.copytree(ROOT / "portbench", d, ignore=shutil.ignore_patterns("__pycache__"))
    for dst, src in FILES.items():
        shutil.copy(DATA / src, d / dst)
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny_hunyuan3d21", "source": "test", "reduced": [],
                           "file": "portbench/configs/tiny_hunyuan3d21.json", "why": "test"})
    man["workloads"].append({"name": CELL, "config": "tiny_hunyuan3d21", "traffic": "tiny_video",
                             "chips": 1, "why": "test"})
    for m in man["per_layer"]:
        if m["name"] == "stage0.handoff_s":
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return root


def test_tiny_cell_correct_and_control_fails(hunyuan_root):
    (r,) = control.readings(hunyuan_root, CELL, [2**31 + 77], seconds=0.01, device="cpu")
    assert r["correct"], r["program"]
    assert list(r["program"]) == ["enc", *STAGE0, "s1_v", "s1_step", "s2", "handoff"]
    assert r["program"]["handoff"] == 0
    assert set(control.control_fails(r)) >= set(STAGE0) - {"s0_route"}, r["control"]

    repo, copy = _files(ROOT / "portbench"), _files(hunyuan_root / "portbench")
    assert set(copy) - set(repo) == set(FILES)
    for name, path in repo.items():
        assert copy[name].read_bytes() == path.read_bytes(), name


def test_tiny_cell_traced_reports_the_handoff(hunyuan_root):
    out = driver.run(hunyuan_root, CELL, 2**31 + 78, 0.01, True, time.perf_counter(), device="cpu")
    assert out["correct"], out["compared"]
    assert out["metrics"]["stage0.handoff_s"]["value"] > 0


@pytest.mark.card
def test_control_fails_program_passes(card):
    for r in control.readings(ROOT, "hunyuan3d21_fast.video16", SEEDS):
        print(json.dumps(r))
        assert r["correct"], r["program"]
        assert set(control.control_fails(r)) == set(r["program"]) - {"handoff"}, r["control"]
