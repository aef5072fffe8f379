"""Finding a cell's pieces by name: the manifest (``BENCHMARK.json``) and
the files beside it under ``portbench/``.

A configuration is the file its manifest entry names; a traffic mix is
``traffic/<traffic>.json``; the limits of a cell's comparison are
``checks/<workload>.json``; a per-layer metric is the reader
``metrics/<metric>.py``; a model family (the configuration's ``family``)
is ``families/<family>.py``, its networks, the port's build and its
Stage-0 capture and check, and ``work/<family>.py``, its work count. A new
cell, configuration, mix, metric or family is new files and new manifest
entries.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(manifest: dict, name: str) -> dict:
    return _by_name(manifest["workloads"], name, "workload")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    entry = _by_name(manifest["configs"], name, "configuration")
    return json.loads((Path(root) / entry["file"]).read_text())


def bench_dir(root: Path = ROOT) -> Path:
    return Path(root) / "portbench"


def traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((bench_dir(root) / "traffic" / f"{name}.json").read_text())


def checks(workload_name: str, root: Path = ROOT) -> dict:
    return json.loads((bench_dir(root) / "checks" / f"{workload_name}.json").read_text())


def _module(path: Path, tag: str):
    if not path.is_file():
        raise FileNotFoundError(f"portbench: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(record) -> value | None`` of ``metrics/<name>.py``."""
    path = bench_dir(root) / "metrics" / f"{name}.py"
    return _module(path, "metric_" + name.replace(".", "_")).read


def work_model(family: str, root: Path = ROOT):
    return _module(bench_dir(root) / "work" / f"{family}.py", "work_" + family)


def family(name: str, root: Path = ROOT):
    """The model family ``families/<name>.py`` (see ``families/actionmesh.py``)."""
    return _module(bench_dir(root) / "families" / f"{name}.py", "family_" + name)


def metrics_of(manifest: dict, workload_name: str, per_layer: bool) -> list[dict]:
    """The metrics a cell reports: with ``per_layer`` its per-layer
    metrics, else its end-to-end ones (an entry with ``workloads`` only in
    the cells it lists)."""
    entries = manifest["per_layer" if per_layer else "end_to_end"]
    return [m for m in entries if workload_name in m.get("workloads", [workload_name])]
