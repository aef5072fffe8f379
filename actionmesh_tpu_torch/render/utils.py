"""Render utilities: temporal resampling, compositing, image grids, the video.

Counterpart of ``actionmesh_tpu/render/utils.py``. ``write_mp4`` writes an
mp4 through imageio where imageio and its ffmpeg plugin are installed;
otherwise it writes a GIF beside it with its own encoder (numpy and the
standard library): a fixed 6 x 7 x 6 color cube as the palette, each channel
rounded to its nearest level (at most 25 levels off in red and blue, 22 in
green), and LZW codes of 9 bits that are all literals, a clear code before
every 254 of them, so the code width never grows and the packing is
vectorised.
"""

from __future__ import annotations

import importlib.util
import logging
import struct
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

# the GIF palette: 6 levels of red, 7 of green, 6 of blue (252 of 256 entries)
_LEVELS = (6, 7, 6)
_CLEAR, _END = 256, 257
_RUN = 254  # literal codes between clear codes: the table never reaches 512


def resample_list(items: list, n: int) -> list:
    """Nearest-neighbor temporal resampling of a list to length n."""
    if len(items) == n:
        return list(items)
    idx = np.round(np.linspace(0, len(items) - 1, n)).astype(int)
    return [items[i] for i in idx]


def composite_rgba_on_white(frame: np.ndarray) -> np.ndarray:
    """(H, W, 3|4) uint8 -> (H, W, 3) uint8 on a white background."""
    if frame.shape[-1] == 3:
        return np.array(frame, np.uint8)
    rgba = np.asarray(frame, np.float32) / 255.0
    rgb = rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])
    return (rgb * 255).astype(np.uint8)


def make_grid(images: list[np.ndarray], n_cols: int) -> np.ndarray:
    """Tile equal-size (H, W, 3) images into a grid."""
    h, w, _ = images[0].shape
    n_rows = -(-len(images) // n_cols)
    grid = np.full((n_rows * h, n_cols * w, 3), 255, np.uint8)
    for i, img in enumerate(images):
        r, c = divmod(i, n_cols)
        grid[r * h : (r + 1) * h, c * w : (c + 1) * w] = img
    return grid


def _gif_palette() -> np.ndarray:
    """(256, 3) uint8: the color cube, then black."""
    axes = [np.round(np.arange(n) * 255.0 / (n - 1)) for n in _LEVELS]
    cube = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    palette = np.zeros((256, 3), np.uint8)
    palette[: len(cube)] = cube
    return palette


def _gif_indices(frame: np.ndarray) -> np.ndarray:
    """Palette index of each pixel of an (H, W, 3) uint8 frame."""
    idx = np.zeros(frame.shape[:2], np.int64)
    for c, n in enumerate(_LEVELS):
        level = np.floor(frame[..., c].astype(np.float32) * ((n - 1) / 255.0) + 0.5)
        idx = idx * n + level.astype(np.int64)
    return idx


def _lzw_literal(indices: np.ndarray) -> bytes:
    """GIF image data (minimum code size 8) of the flat ``indices``."""
    n = indices.size
    runs = -(-n // _RUN)
    literals = np.full(runs * _RUN, -1, np.int64)
    literals[:n] = indices.reshape(-1)
    codes = np.empty((runs, _RUN + 1), np.int64)
    codes[:, 0] = _CLEAR
    codes[:, 1:] = literals.reshape(runs, _RUN)
    codes = np.append(codes[codes >= 0], _END)
    bits = ((codes[:, None] >> np.arange(9)) & 1).astype(np.uint8)
    data = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    blocks = b"".join(bytes([len(data[i : i + 255])]) + data[i : i + 255]
                      for i in range(0, len(data), 255))
    return bytes([8]) + blocks + b"\x00"


def write_gif(frames: list[np.ndarray], path: str | Path, fps: int = 8) -> None:
    """An animated, looping GIF of (H, W, 3) uint8 frames (palette above)."""
    h, w, _ = frames[0].shape
    delay = int(1000 / fps) // 10  # hundredths of a second, as PIL writes it
    out = [
        b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), _gif_palette().tobytes(),
        b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", 0) + b"\x00",
    ]
    for frame in frames:
        if frame.shape != (h, w, 3):
            raise ValueError(f"write_gif: frame {frame.shape}, expected {(h, w, 3)}")
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0))
        out.append(_lzw_literal(_gif_indices(frame)))
    out.append(b"\x3b")
    Path(path).write_bytes(b"".join(out))


def write_mp4(frames: list[np.ndarray], path: str | Path, fps: int = 8) -> Path:
    """Write frames to ``path`` as mp4 where imageio can, else as a GIF beside
    it; returns the path written."""
    path = Path(path)
    if importlib.util.find_spec("imageio") and importlib.util.find_spec("imageio_ffmpeg"):
        import imageio.v2 as imageio

        writer = imageio.get_writer(str(path), fps=fps)
        try:
            for f in frames:
                writer.append_data(f)
        finally:
            writer.close()
        logger.info("Wrote %s (%d frames)", path, len(frames))
        return path
    gif_path = path.with_suffix(".gif")
    write_gif(frames, gif_path, fps=fps)
    logger.info("No imageio-ffmpeg: wrote %s (%d frames)", gif_path, len(frames))
    return gif_path
