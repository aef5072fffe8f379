"""Pipeline input: RGBA frames and their timesteps, and the file loaders.

Counterpart of ``actionmesh_tpu/io/video_input.py``, over (H, W, 4) uint8
numpy frames instead of PIL images: ``ActionMeshInput``, ``natsorted``,
``load_from_image_mask_pairs``, ``load_from_image_dir`` and ``load_frames``'
dispatch. PNG is decoded by ``io/png.py`` (as PIL's ``convert("RGBA")``
gives it); a mask of another size than its image is resized as PIL's LANCZOS
does (``pil_resize``, which also has PIL's BILINEAR, for the RMBG matte).
JPEG and WebP frames are decoded by PIL and videos (.mp4, .avi, .mov) by
OpenCV, as in the JAX package; each is imported only inside the function
that decodes such a file, so PNG inputs need neither.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import re
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from actionmesh_tpu_torch.io.png import read_png

logger = logging.getLogger(__name__)

MIN_FRAMES = 16
VIDEO_EXTENSIONS = {".mp4", ".avi", ".mov"}
IMAGE_EXTENSIONS = {".png", ".jpg", ".jpeg", ".webp"}


def natsorted(paths: Sequence) -> list:
    """Natural sort (numeric-aware), replacing the natsort dependency."""

    def key(p):
        return [int(tok) if tok.isdigit() else tok.lower() for tok in re.split(r"(\d+)", str(p))]

    return sorted(paths, key=key)


@dataclasses.dataclass
class ActionMeshInput:
    """Frames (list of (H, W, 4) uint8 arrays) + timesteps (N,) float32."""

    frames: list[np.ndarray]
    timesteps: np.ndarray

    def __post_init__(self) -> None:
        self.timesteps = np.asarray(self.timesteps, dtype=np.float32)
        if len(self.frames) < MIN_FRAMES:
            raise ValueError(
                f"At least {MIN_FRAMES} frames are required, got {len(self.frames)}"
            )
        if self.timesteps.ndim != 1:
            raise ValueError("Expected 1D timesteps")
        if len(self.frames) != self.timesteps.shape[0]:
            raise ValueError(
                f"Number of frames ({len(self.frames)}) must match "
                f"timesteps ({self.timesteps.shape[0]})"
            )
        for i, frame in enumerate(self.frames):
            if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] not in (3, 4):
                raise ValueError(
                    f"frame {i}: expected (H, W, 3|4) uint8, got "
                    f"{frame.shape} {frame.dtype}"
                )
        if self.timesteps.shape[0] > 1:
            gaps = np.diff(self.timesteps)
            if not np.allclose(gaps, 1.0, atol=1e-6):
                logger.warning(
                    "Timesteps are not unit-spaced frame indices (gaps "
                    "%.3g..%.3g): Stage II interpolates int(span+1) output "
                    "timesteps from min to max, which will not coincide "
                    "with your input frames.",
                    float(gaps.min()), float(gaps.max()),
                )

    @property
    def n_frames(self) -> int:
        return len(self.frames)

    def get(self, indices) -> "ActionMeshInput":
        """Window-select a subset (bypasses the MIN_FRAMES invariant)."""
        idx = np.asarray(indices, dtype=np.int64).reshape(-1)
        out = object.__new__(ActionMeshInput)
        out.frames = [self.frames[int(i)] for i in idx]
        out.timesteps = self.timesteps[idx]
        return out


# -- PIL's resize of 8-bit images (libImaging/Resample.c) -----------------------

_PRECISION_BITS = 32 - 8 - 2  # PIL's fixed-point coefficients


def _lanczos(x: np.ndarray) -> np.ndarray:
    """sinc(x) sinc(x / 3) on [-3, 3), else 0."""
    return np.where((x >= -3.0) & (x < 3.0), np.sinc(x) * np.sinc(x / 3.0), 0.0)


def _triangle(x: np.ndarray) -> np.ndarray:
    """PIL's bilinear filter: 1 - |x| on (-1, 1), else 0."""
    return np.maximum(1.0 - np.abs(x), 0.0)


# PIL's resampling filters: (filter, support)
FILTERS = {"lanczos": (_lanczos, 3.0), "bilinear": (_triangle, 1.0)}


def _coefficients(in_size: int, out_size: int, resample: str) -> tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``: the first
    input index (out_size,) and the fixed-point taps (out_size, ksize) of
    each output pixel. Downscaling widens the filter's support by the scale."""
    filt, base_support = FILTERS[resample]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ss = 1.0 / filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    taps = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)  # int() truncates, as C's cast
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = filt((np.arange(xmax) + xmin - center + 0.5) * ss)
        total = w.sum()
        if total != 0.0:
            w = w / total
        fixed = w * (1 << _PRECISION_BITS)
        taps[xx, :xmax] = np.trunc(np.where(w < 0, fixed - 0.5, fixed + 0.5)).astype(np.int64)
        first[xx] = xmin
    return first, taps


def _resample_axis(img: np.ndarray, out_size: int, axis: int, resample: str) -> np.ndarray:
    """One pass of PIL's separable resample along ``axis``, rounded to uint8."""
    first, taps = _coefficients(img.shape[axis], out_size, resample)
    src = np.moveaxis(img, axis, -1).astype(np.int64)
    idx = np.minimum(first[:, None] + np.arange(taps.shape[1]), img.shape[axis] - 1)
    acc = (src[..., idx] * taps).sum(axis=-1) + (1 << (_PRECISION_BITS - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, -1, axis)


def pil_resize(img: np.ndarray, size: tuple[int, int], resample: str = "lanczos") -> np.ndarray:
    """(H, W[, C]) uint8 resized to ``size`` = (width, height) as PIL's
    ``Image.resize(size, Image.LANCZOS | Image.BILINEAR)``: width first,
    rounded to uint8, then height, in PIL's fixed-point arithmetic."""
    width, height = size
    out = img
    if width != img.shape[1]:
        out = _resample_axis(out, width, 1, resample)
    if height != img.shape[0]:
        out = _resample_axis(out, height, 0, resample)
    return out


def lanczos_resize(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``pil_resize`` with PIL's LANCZOS filter."""
    return pil_resize(img, size, "lanczos")


# -- loaders --------------------------------------------------------------------


def _to_luma(rgba: np.ndarray) -> np.ndarray:
    """PIL's ``convert("L")`` of an RGB(A) image (ITU-R 601-2, fixed point)."""
    rgb = rgba[..., :3].astype(np.int64)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def _read_rgba(path: Path) -> np.ndarray:
    """An image file as (H, W, 4) uint8 RGBA: PNG by ``io/png.py``, other
    formats (JPEG, WebP) by PIL's ``convert("RGBA")``, as JAX reads them."""
    if path.suffix.lower() == ".png":
        return read_png(path)
    from PIL import Image

    with Image.open(path) as img:
        return np.array(img.convert("RGBA"))


def load_from_image_mask_pairs(
    directory: str | Path, max_frames: Optional[int] = None, stride: int = 1
) -> ActionMeshInput:
    """Load *_image.png + *_mask.png pairs as RGBA frames."""
    directory = Path(directory)
    image_files = sorted(directory.glob("*_image.png"))
    if not image_files:
        raise ValueError(f"No *_image.png files found in '{directory}'")
    image_files = image_files[::stride]
    if max_frames is not None:
        image_files = image_files[:max_frames]

    frames = []
    for image_file in image_files:
        prefix = image_file.stem.replace("_image", "")
        mask_file = directory / f"{prefix}_mask.png"
        if not mask_file.exists():
            raise ValueError(f"No mask found for {image_file.name}: {mask_file}")
        rgba = read_png(image_file)
        mask = _to_luma(read_png(mask_file))
        if mask.shape != rgba.shape[:2]:
            mask = lanczos_resize(mask, (rgba.shape[1], rgba.shape[0]))
        rgba[..., 3] = mask
        frames.append(rgba)

    logger.info("Loaded %d frames from image+mask pairs: %s", len(frames), directory)
    return ActionMeshInput(frames=frames, timesteps=np.arange(len(frames), dtype=np.float32))


def load_from_image_dir(
    path_pattern: str | Path, max_frames: Optional[int] = None, stride: int = 1
) -> ActionMeshInput:
    """Load the files a glob pattern matches, in natural order, as RGBA."""
    path_pattern = Path(path_pattern)
    image_paths = natsorted(path_pattern.parent.glob(path_pattern.name))
    if not image_paths:
        raise ValueError(f"No images found matching '{path_pattern}'")
    image_paths = image_paths[::stride]
    if max_frames is not None:
        image_paths = image_paths[:max_frames]
    frames = [_read_rgba(p) for p in image_paths]
    logger.info("Loaded %d frames from image folder: %s", len(frames), path_pattern.parent)
    return ActionMeshInput(frames=frames, timesteps=np.arange(len(frames), dtype=np.float32))


def load_from_video(
    video_path: str | Path, max_frames: Optional[int] = None, stride: int = 1
) -> ActionMeshInput:
    """Every ``stride``-th frame of a video (up to ``max_frames``) as RGBA,
    decoded by OpenCV (``cv2``) as the JAX ``load_from_video`` does; the
    alpha is 255 (no mask, so preprocessing mattes the frames)."""
    import cv2

    video_path = Path(video_path)
    if not video_path.exists():
        raise FileNotFoundError(f"Video file not found: {video_path}")
    cap = cv2.VideoCapture(str(video_path))
    if not cap.isOpened():
        raise RuntimeError(f"Failed to open video: {video_path}")
    frames: list[np.ndarray] = []
    try:
        frame_idx = 0
        while max_frames is None or len(frames) < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            if frame_idx % stride == 0:
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGBA))
            frame_idx += 1
    finally:
        cap.release()
    if not frames:
        raise ValueError(f"No frames could be read from video: {video_path}")
    logger.info("Loaded %d frames from video: %s", len(frames), video_path)
    return ActionMeshInput(frames=frames, timesteps=np.arange(len(frames), dtype=np.float32))


def load_frames(
    path: str | Path, max_frames: Optional[int] = None, stride: int = 1
) -> ActionMeshInput:
    """Auto-dispatch: video file / glob pattern / image dir / mask pairs."""
    path = Path(path)
    path_str = str(path)
    if "*" in path_str or "?" in path_str:
        return load_from_image_dir(path, max_frames=max_frames, stride=stride)
    if path.suffix.lower() in VIDEO_EXTENSIONS:
        return load_from_video(path, max_frames=max_frames, stride=stride)
    if path.is_dir():
        if list(path.glob("*_mask.png")):
            return load_from_image_mask_pairs(path, max_frames=max_frames, stride=stride)
        for ext in IMAGE_EXTENSIONS:
            try:
                return load_from_image_dir(path / f"*{ext}", max_frames=max_frames, stride=stride)
            except ValueError:
                continue
        raise ValueError(f"No images found in directory: {path}")
    raise ValueError(
        f"Unsupported input: {path}. Expected video file, image pattern, or directory."
    )
