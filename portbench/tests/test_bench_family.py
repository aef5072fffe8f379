"""The model family as an extension point: a second family added as new
files only runs a cell to a correct result line, and the release's family
(``families/actionmesh.py``) draws the same networks, layouts, weights and
work count as the harness did before families were files of their own
(the hashes below were taken from that harness)."""

import hashlib
import json
import shutil
import time
from pathlib import Path

import pytest
import torch

from portbench.bench import driver, manifest
from portbench.bench.weights import make_states

ROOT = Path(__file__).resolve().parents[2]
DATA = ROOT / "portbench" / "tests" / "data"
STUB_CELL = "tiny_stub.video"
# the stub family's files: where each goes under portbench/, from tests/data/
STUB_FILES = {"families/stub.py": "stub_family.py", "work/stub.py": "stub_work.py",
              "configs/tiny_stub.json": "tiny_stub.json", "traffic/tiny_video.json": "tiny_video.json",
              f"checks/{STUB_CELL}.json": "tiny_checks.json"}

VIDEO_NETS = ["dinov2", "triposg_vae", "denoiser", "autoencoder", "triposg_dit"]
MESH_NETS = ["dinov2", "triposg_vae", "denoiser", "autoencoder"]
VIDEO_LAYOUT = "5e9e2c8383cec7ebe6718dd874ad9a9bdaf785f1490bc3f53a6bea10f5d8b4c8"
MESH_LAYOUT = "ac290c6335413f256ed20882cd5b4b3644ac71a1ec09c66cb06fe4f6e5b34282"
LAYOUTS = {("actionmesh", "video"): (VIDEO_NETS, VIDEO_LAYOUT),
           ("actionmesh", "video_mesh"): (MESH_NETS, MESH_LAYOUT),
           ("actionmesh_fast", "video"): (VIDEO_NETS, VIDEO_LAYOUT),
           ("actionmesh_fast", "video_mesh"): (MESH_NETS, MESH_LAYOUT)}
TINY_STATES = {"video": "1bd6c0b0d35e17c1e526d8bd55c8d81c65f00e5e446b973310e9d8bbb0653927",
               "video_mesh": "a8fba1c2c94515b625f1f10c27a9fa256ade0988694a8dd8c497ea725a0b59db"}
FLOPS_AT_50002_VERTICES = {"actionmesh.video16": 1.8537372585865216e+16,
                           "actionmesh_fast.mesh16": 9373410276782080.0,
                           "actionmesh_fast.video31": 1.9330147472449536e+16}


def _files(base: Path) -> dict[str, Path]:
    return {p.relative_to(base).as_posix(): p for p in base.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_family_added_as_files_only(tmp_path, monkeypatch):
    d = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", d, ignore=shutil.ignore_patterns("__pycache__"))
    for dst, src in STUB_FILES.items():
        shutil.copy(DATA / src, d / dst)
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny_stub", "source": "test", "reduced": [],
                           "file": "portbench/configs/tiny_stub.json", "why": "test"})
    man["workloads"].append({"name": STUB_CELL, "config": "tiny_stub", "traffic": "tiny_video",
                             "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man, indent=1))

    drawn = []

    def make(layouts, *a, **k):
        drawn.append(list(layouts))
        return make_states(layouts, *a, **k)

    monkeypatch.setattr(driver, "make_states", make)
    out = driver.run(tmp_path, STUB_CELL, 2**31 + 77, 0.05, False, time.perf_counter(), device="cpu")
    assert drawn == [["dinov2", "denoiser", "autoencoder"]]
    assert out["correct"], out["compared"]
    assert list(out["compared"]) == ["enc", "s1_v", "s1_step", "s2", "handoff"]
    assert out["compared"]["handoff"]["value"] == 0
    assert set(out["metrics"]) == {"clip_s", "setup_s"}

    repo, copy = _files(ROOT / "portbench"), _files(d)
    assert set(copy) - set(repo) == set(STUB_FILES)
    assert set(repo) <= set(copy)
    for name, path in repo.items():
        assert copy[name].read_bytes() == path.read_bytes(), name


def test_a_family_without_a_file_is_named():
    with pytest.raises(FileNotFoundError, match="families/nowhere.py"):
        manifest.family("nowhere", ROOT)


def _layout_digest(lays) -> str:
    h = hashlib.sha256()
    for net, lay in lays.items():
        h.update(json.dumps([net, [[n, list(s), k] for n, (s, k) in lay.items()]]).encode())
    return h.hexdigest()


def _state_digest(states) -> str:
    h = hashlib.sha256()
    for net, state in states.items():
        h.update(net.encode())
        for name, t in state.items():
            h.update(name.encode())
            h.update(str(tuple(t.shape)).encode())
            h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("config, mode", sorted(LAYOUTS))
def test_actionmesh_layouts_pinned(config, mode):
    """Names, shapes and kinds, in order, at the release's widths."""
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{config}.json").read_text())
    family = manifest.family(cfg["family"], ROOT)
    lays = family.layouts(cfg["model"], family.networks(mode))
    nets, digest = LAYOUTS[config, mode]
    assert list(lays) == nets
    assert _layout_digest(lays) == digest


@pytest.mark.parametrize("mode", sorted(TINY_STATES))
def test_actionmesh_states_pinned(mode):
    """The weights drawn on the CPU at the tiny widths, bit for bit."""
    tiny = json.loads((DATA / "tiny.json").read_text())
    family = manifest.family(tiny["family"], ROOT)
    states = make_states(family.layouts(tiny["model"], family.networks(mode)), 2**31 + 77, "cpu",
                         torch.float32)
    assert _state_digest(states) == TINY_STATES[mode]


@pytest.mark.parametrize("cell", sorted(FLOPS_AT_50002_VERTICES))
def test_actionmesh_work_count_pinned(cell):
    man = manifest.load(ROOT)
    wl = manifest.workload(man, cell)
    cfg = manifest.config(man, wl["config"], ROOT)
    mix = manifest.traffic(wl["traffic"], ROOT)
    flops = manifest.work_model(cfg["family"], ROOT).flops_per_clip(cfg, mix, 50002)
    assert flops == FLOPS_AT_50002_VERTICES[cell]
