"""The port's clip preparation (``prepare_clips.py``) vs ``scripts/prepare_clips.py``.

Both tiny pipelines of ``test_torch_cli.py`` (the same weights, Stage-0
latent and sphere, and initial noise) on one 16-frame clip. Both resize
DINOv2's input with PIL here: the port's own resize is held to PIL's
separately (one uint8 level at a pixel,
``test_torch_ops.py::test_preprocess_for_dino_matches_pil``).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import actionmesh_tpu_torch.models.image_encoder as timage_encoder
from actionmesh_tpu.io.video_input import ActionMeshInput as JInput
from actionmesh_tpu_torch import prepare_clips
from actionmesh_tpu_torch.io.video_input import ActionMeshInput
from actionmesh_tpu_torch.training.data import ClipWindowDataset
from tests.test_torch_cli import tiny_pipelines
from tests.test_torch_closed_loop import _pil_preprocess_for_dino
from tests.test_torch_pipeline import make_frames

REPO = Path(__file__).resolve().parent.parent


def load_jax_script():
    spec = importlib.util.spec_from_file_location("jax_prepare_clips", REPO / "scripts" / "prepare_clips.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """JAX's prepare_clip and the port's on the same clip (timesteps out of
    order, so the reordering to timestep order is exercised), and the
    port's CLI on the same frames written as PNGs."""
    root = tmp_path_factory.mktemp("clips")
    frames = make_frames(16)
    order = np.r_[np.arange(8, 16), np.arange(8)]
    timesteps = order.astype(np.float32)
    mp = pytest.MonkeyPatch()
    try:
        jpipe, tpipe = tiny_pipelines(mp, jnp.float32, torch.float32)
        mp.setattr(timage_encoder, "preprocess_for_dino", _pil_preprocess_for_dino)
        jstats = load_jax_script().prepare_clip(
            jpipe, JInput(frames=[Image.fromarray(frames[i]) for i in order], timesteps=timesteps),
            root / "jax.npz", seed=44,
        )
        tstats = prepare_clips.prepare_clip(
            tpipe, ActionMeshInput(frames=[frames[i] for i in order], timesteps=timesteps),
            root / "port.npz", seed=44,
        )
        frame_dir = root / "in" / "clip_a"
        frame_dir.mkdir(parents=True)
        for i, f in enumerate(frames):
            Image.fromarray(f).save(frame_dir / f"{i:02d}.png")
        rc = prepare_clips.main(["--input", str(root / "in"), "--out", str(root / "out"),
                                 "--device", "cpu", "--stage-1-steps", "2"], pipe=tpipe)
    finally:
        mp.undo()
    return root, jstats, tstats, rc


def test_prepare_clip_matches_jax(clips):
    """Latents and context within 1e-5 of their largest magnitude (fp32
    sums in another order); framestep equal and in timestep order."""
    root, jstats, tstats, _ = clips
    assert tstats == jstats
    with np.load(root / "port.npz") as t, np.load(root / "jax.npz") as j:
        np.testing.assert_array_equal(t["framestep"], j["framestep"])
        np.testing.assert_array_equal(t["framestep"], np.arange(16, dtype=np.float32))
        for k in ("latents", "context"):
            assert t[k].shape == j[k].shape and t[k].dtype == np.float32
            scale = float(np.abs(j[k]).max())
            assert np.abs(t[k] - j[k]).max() <= 1e-5 * scale, k


def test_entry_point_writes_a_loadable_clip(clips):
    """``main`` on a directory of frame directories writes one clip per
    source that ``ClipWindowDataset`` loads; a second run skips it."""
    root, _, _, rc = clips
    assert rc == 0
    assert (root / "out" / "clip_a.npz").exists()
    ds = ClipWindowDataset(root / "out", window=16)
    item = ds[0]
    assert item["latents"].shape == (16, 16, 8) and item["context"].shape[0] == 16
    assert list(prepare_clips.iter_inputs(root / "in")) == [root / "in" / "clip_a"]
