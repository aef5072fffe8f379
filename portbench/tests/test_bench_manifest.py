"""The manifest against the contract's form, and every piece it names
found by name."""

import json
import re
from pathlib import Path

import pytest

from portbench.bench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert MAN["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w for w in MAN["command"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


def test_end_to_end_bounds():
    names = {m["name"] for m in MAN["end_to_end"]}
    assert {"clip_s", "setup_s"} <= names
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_per_layer_moves_and_cells():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_each_cell_finds_its_files(cell):
    wl = manifest.workload(MAN, cell)
    cfg = manifest.config(MAN, wl["config"], ROOT)
    assert cfg["name"] == wl["config"] and cfg["family"]
    assert wl["chips"] == 1
    mix = manifest.traffic(wl["traffic"], ROOT)
    assert mix["mode"] in ("video", "video_mesh")
    limits = manifest.checks(cell, ROOT)
    assert limits["limits"]["handoff"] == 0
    assert hasattr(manifest.work_model(cfg["family"], ROOT), "flops_per_clip")
    for per_layer in (False, True):
        for m in manifest.metrics_of(MAN, cell, per_layer):
            assert callable(manifest.metric_reader(m["name"], ROOT))
    reported = {m["moves"] for m in manifest.metrics_of(MAN, cell, True)}
    assert reported <= {m["name"] for m in manifest.metrics_of(MAN, cell, False)}


def test_configs_files_unique_and_under_paths():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["file"].startswith("portbench/")
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] == []
        assert data["source"] == c["source"]
