"""The per-layer metrics read from the program's span tree: the SDF
extraction's own time and the three steps of the mesh processing, in the
traced run of the tiny video cell and in no cell without Stage 0's
extraction."""

import pytest

SPAN_METRICS = ("stage0.extract_s", "stage0.mesh_clean_s", "stage0.decimate_s",
                "stage0.floaters_s")
MESH_STEPS = ("stage0.mesh_clean_s", "stage0.decimate_s", "stage0.floaters_s")


def test_span_metrics_in_the_video_cell(tiny_runs):
    metrics = tiny_runs["tiny.video", True]["metrics"]
    for name in SPAN_METRICS:
        assert metrics[name]["value"] > 0 and metrics[name]["unit"] == "s/clip", name
    mesh = metrics["stage0.mesh_s"]["value"]
    steps = sum(metrics[name]["value"] for name in MESH_STEPS)
    assert steps == pytest.approx(mesh, rel=0.02, abs=0.005)
    assert metrics["stage0.extract_s"]["value"] < metrics["stage0.decode_s"]["value"]


@pytest.mark.parametrize("cell, trace", [("tiny.mesh", True), ("tiny.mesh", False),
                                         ("tiny.video", False)])
def test_span_metrics_absent_elsewhere(tiny_runs, cell, trace):
    """The {video + 3D} cell has no extraction or mesh processing; an
    untraced run reports no per-layer metric."""
    assert not set(SPAN_METRICS) & set(tiny_runs[cell, trace]["metrics"])
