"""The port's video and JPEG/WebP loaders against the JAX package's.

Videos are written by OpenCV and images by PIL, as
``tests/test_video_input.py`` writes them; both packages decode them with
the same libraries (the port imports them lazily), so frames and
timesteps must be equal, bit for bit.
"""

import numpy as np
import pytest
from PIL import Image

from actionmesh_tpu.io import video_input as jvideo
from actionmesh_tpu_torch.io import video_input as tvideo

cv2 = pytest.importorskip("cv2")


def assert_same(tin, jin):
    assert len(tin.frames) == len(jin.frames)
    np.testing.assert_array_equal(tin.timesteps, jin.timesteps)
    for t, j in zip(tin.frames, jin.frames):
        j = np.asarray(j.convert("RGBA"))
        assert t.dtype == np.uint8 and t.shape == j.shape and np.array_equal(t, j)


@pytest.fixture(scope="module", params=[("clip.mp4", "mp4v"), ("clip.avi", "MJPG")])
def video(request, tmp_path_factory):
    name, fourcc = request.param
    path = tmp_path_factory.mktemp("video") / name
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 8, (40, 24))
    if not writer.isOpened():
        pytest.skip(f"no {fourcc} encoder in this OpenCV")
    rng = np.random.default_rng(2)
    for i in range(34):
        frame = np.full((24, 40, 3), 20 + 6 * i, np.uint8)
        frame[4:20, i % 20 : i % 20 + 12] = rng.integers(0, 255, (16, 12, 3), dtype=np.uint8)
        writer.write(frame)
    writer.release()
    return path


@pytest.mark.parametrize("stride,max_frames", [(1, None), (2, None), (1, 16), (2, 16)])
def test_video_matches_jax(video, stride, max_frames):
    tin = tvideo.load_frames(video, max_frames=max_frames, stride=stride)
    assert_same(tin, jvideo.load_frames(video, max_frames=max_frames, stride=stride))
    assert tin.frames[0].shape == (24, 40, 4) and (tin.frames[0][..., 3] == 255).all()


def test_video_errors_match_jax(tmp_path):
    with pytest.raises(FileNotFoundError, match="Video file not found"):
        tvideo.load_from_video(tmp_path / "missing.mp4")
    broken = tmp_path / "broken.mp4"
    broken.write_bytes(b"not a video")
    with pytest.raises((RuntimeError, ValueError)) as port_err:
        tvideo.load_from_video(broken)
    with pytest.raises((RuntimeError, ValueError)) as jax_err:
        jvideo.load_from_video(broken)
    assert type(port_err.value) is type(jax_err.value)


@pytest.mark.parametrize("ext,mode", [(".jpg", "RGB"), (".jpeg", "L"), (".webp", "RGBA")])
def test_jpeg_and_webp_frames_match_jax(tmp_path, ext, mode):
    """JPEG (RGB and greyscale) and WebP (with alpha) frames through the
    directory and glob loaders."""
    rng = np.random.default_rng(3)
    for i in range(17):
        img = rng.integers(0, 256, (20, 28, 4), dtype=np.uint8)
        img[..., 3] = np.where(np.arange(28) < 14 + i % 5, 255, 0)[None]
        Image.fromarray(img).convert(mode).save(tmp_path / f"frame_{i}{ext}")
    assert_same(tvideo.load_frames(tmp_path), jvideo.load_frames(tmp_path))
    pattern = tmp_path / f"frame_*{ext}"
    assert_same(tvideo.load_frames(pattern, stride=1, max_frames=16),
                jvideo.load_frames(pattern, stride=1, max_frames=16))
