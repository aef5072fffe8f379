"""Shared fixtures of the benchmark's tests.

``card`` marks the tests that need a CUDA card; whether one is there is
decided inside the ``card`` fixture, so that every worker collects the
same tests. ``tiny_root`` is a checkout-like directory holding a copy of
``portbench/`` plus two tiny configurations (the default preset's and the
low-RAM preset's, which runs the guidance branches one call each), two
tiny mixes, their limits and a manifest naming them: new files and new
entries only.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CELLS = ("tiny.video", "tiny.mesh")
LOWRAM_CELL = "tiny_lowram.video"


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs a cell at its own size on the chip")


def make_tiny_root(dest: Path) -> Path:
    src = ROOT / "portbench"
    shutil.copytree(src, dest / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    d = dest / "portbench"
    data = d / "tests" / "data"
    for config in ("tiny", "tiny_lowram"):
        shutil.copy(data / f"{config}.json", d / "configs" / f"{config}.json")
    for mix in ("video", "mesh"):
        shutil.copy(data / f"tiny_{mix}.json", d / "traffic" / f"tiny_{mix}.json")
        shutil.copy(data / "tiny_checks.json", d / "checks" / f"tiny.{mix}.json")
    shutil.copy(data / "tiny_checks.json", d / "checks" / f"{LOWRAM_CELL}.json")
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    for config in ("tiny", "tiny_lowram"):
        man["configs"].append({"name": config, "source": "test", "reduced": [],
                               "file": f"portbench/configs/{config}.json",
                               "why": "tiny widths for the CPU tests"})
    man["workloads"] += [
        {"name": "tiny.video", "config": "tiny", "traffic": "tiny_video", "chips": 1, "why": "test"},
        {"name": "tiny.mesh", "config": "tiny", "traffic": "tiny_mesh", "chips": 1, "why": "test"},
        {"name": LOWRAM_CELL, "config": "tiny_lowram", "traffic": "tiny_video", "chips": 1,
         "why": "test"}]
    for m in man["per_layer"]:
        if "workloads" in m:
            video_only = all(not w.endswith("mesh16") for w in m["workloads"])
            m["workloads"] = m["workloads"] + (["tiny.video", LOWRAM_CELL] if video_only
                                               else [*TINY_CELLS, LOWRAM_CELL])
    (dest / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("tiny_root"))


@pytest.fixture(scope="session")
def tiny_runs(tiny_root):
    """One untraced and one traced run of each tiny cell on the CPU."""
    import time

    from portbench.bench import driver

    out = {}
    for cell in TINY_CELLS:
        for trace in (False, True):
            out[cell, trace] = driver.run(tiny_root, cell, 2**31 + 77, 0.05, trace,
                                          time.perf_counter(), device="cpu")
    return out
