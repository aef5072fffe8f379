"""Image preprocessing: RGBA compositing, shared-bbox crop, square padding.

Numpy copy of ``actionmesh_tpu/preprocessing/image.py`` over (H, W, 4)
uint8 arrays instead of PIL images.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def is_valid_alpha(alpha: np.ndarray, min_ratio: float = 0.01, threshold: int = 127) -> bool:
    """True if alpha has at least min_ratio foreground AND background."""
    min_count = int(alpha.size * min_ratio)
    fg_count = int(np.count_nonzero(alpha > threshold))
    return alpha.size - fg_count >= min_count and fg_count >= min_count


def load_image(
    image: np.ndarray, bg_color: np.ndarray
) -> tuple[np.ndarray, tuple[int, int, int, int]]:
    """Composite (H, W, 4) uint8 on bg_color -> (H, W, 3) float [0, 1] + bbox."""
    rgb = image[..., :3]
    alpha = image[..., 3]
    if not is_valid_alpha(alpha):
        raise ValueError("Invalid alpha channel: insufficient foreground/background")
    alpha_norm = alpha.astype(np.float32) / 255.0
    rgb_composite = (
        rgb.astype(np.float32) / 255.0 * alpha_norm[..., None]
        + bg_color.astype(np.float32) * (1.0 - alpha_norm[..., None])
    )
    alpha_mask = alpha > 0
    rows = np.nonzero(alpha_mask.any(axis=1))[0]
    cols = np.nonzero(alpha_mask.any(axis=0))[0]
    y, y_max = int(rows[0]), int(rows[-1])
    x, x_max = int(cols[0]), int(cols[-1])
    return rgb_composite, (x, y, x_max - x + 1, y_max - y + 1)


def aggregate_bboxes(bboxes: list[tuple[int, int, int, int]]) -> tuple[int, int, int, int]:
    """Union bounding box of (x, y, w, h) boxes."""
    x_min = min(b[0] for b in bboxes)
    y_min = min(b[1] for b in bboxes)
    x_max = max(b[0] + b[2] for b in bboxes)
    y_max = max(b[1] + b[3] for b in bboxes)
    return x_min, y_min, x_max - x_min, y_max - y_min


def apply_padding(
    rgb_image: np.ndarray,
    bbox: tuple[int, int, int, int],
    padding_ratio: float = 0.1,
    padding_value: float = 1.0,
) -> np.ndarray:
    """Crop (H, W, 3) to bbox, pad to a square with a margin."""
    x, y, w, h = bbox
    cropped = rgb_image[y : y + h, x : x + w]
    max_dim = max(w, h)
    pad_base = int(max_dim * padding_ratio)
    pad_x = pad_base + (max_dim - w) // 2
    pad_y = pad_base + (max_dim - h) // 2
    return np.pad(
        cropped,
        ((pad_y, pad_y), (pad_x, pad_x), (0, 0)),
        mode="constant",
        constant_values=padding_value,
    )


@dataclasses.dataclass
class ImagePreprocessor:
    """Composite on white, crop to the shared foreground bbox, square-pad.

    Returns (H', W', 3) uint8 frames, truncated as the JAX package's
    ``Image.fromarray((img * 255).astype(np.uint8))`` does.
    """

    independent_cropping: bool = False
    padding_ratio: float = 0.1

    def __post_init__(self):
        self.bg_color = np.array([1.0, 1.0, 1.0])

    def process_images(self, frames: list[np.ndarray]) -> list[np.ndarray]:
        results = [load_image(frame, self.bg_color) for frame in frames]
        bboxes = [r[1] for r in results]
        if not self.independent_cropping:
            bboxes = [aggregate_bboxes(bboxes)] * len(bboxes)
        return [
            (apply_padding(img, bbox, self.padding_ratio, float(self.bg_color[0])) * 255)
            .astype(np.uint8)
            for (img, _), bbox in zip(results, bboxes)
        ]
