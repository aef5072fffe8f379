"""Background removal: RMBG-1.4 matting and mask refinement.

Counterpart of ``actionmesh_tpu/preprocessing/background.py``. Frames that
already carry a valid alpha (RGBA frames with both foreground and
background, the ``*_mask.png`` pairs) skip matting, as the reference does;
the others are matted by RMBG-1.4 (``models/rmbg.py``) on the device, and
each matte is refined on the host: Otsu's threshold, then connected
components below 0.1% of the frame dropped (scipy ``ndimage``).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from actionmesh_tpu_torch.preprocessing.image import is_valid_alpha

logger = logging.getLogger(__name__)


def otsu_threshold(gray: np.ndarray) -> float:
    """Otsu's threshold of a uint8 image (the largest between-class
    variance; the first threshold on ties)."""
    hist = np.bincount(gray.reshape(-1), minlength=256).astype(np.float64)
    total = gray.size
    sum_total = (np.arange(256) * hist).sum()
    sum_b, w_b, best_t, best_var = 0.0, 0.0, 0, -1.0
    for t in range(256):
        w_b += hist[t]
        if w_b == 0:
            continue
        w_f = total - w_b
        if w_f == 0:
            break
        sum_b += t * hist[t]
        m_b = sum_b / w_b
        m_f = (sum_total - sum_b) / w_f
        var_between = w_b * w_f * (m_b - m_f) ** 2
        if var_between > best_var:
            best_var, best_t = var_between, t
    return float(best_t)


def remove_small_components(mask: np.ndarray, min_size: int) -> np.ndarray:
    """Drop the connected components (4-connected) of fewer than
    ``min_size`` pixels."""
    from scipy import ndimage

    labels, n = ndimage.label(mask)
    if n == 0:
        return mask
    sizes = ndimage.sum_labels(mask, labels, index=np.arange(1, n + 1))
    keep = np.zeros(n + 1, dtype=bool)
    keep[1:] = sizes >= min_size
    return keep[labels]


def refine_mask(mask: np.ndarray, min_size_ratio: float = 0.001) -> np.ndarray:
    """Otsu threshold, then small components removed -> binary uint8 mask."""
    binary = mask > otsu_threshold(mask)
    binary = remove_small_components(binary, int(binary.size * min_size_ratio))
    return (binary * 255).astype(np.uint8)


class BackgroundRemover:
    """RMBG-1.4 matting of the frames that lack a valid alpha."""

    def __init__(self, weights_dir: Optional[str | Path], device: torch.device):
        self._model = None
        self._weights_dir = weights_dir
        if weights_dir is not None and Path(weights_dir).exists():
            from actionmesh_tpu_torch.models.rmbg import RMBGModel

            logger.info("Loading RMBG weights from %s", weights_dir)
            self._model = RMBGModel.from_pretrained(Path(weights_dir), device)

    @staticmethod
    def has_valid_alpha(frame: np.ndarray) -> bool:
        return frame.shape[-1] == 4 and is_valid_alpha(frame[..., 3])

    def process_images(self, frames: list[np.ndarray]) -> list[np.ndarray]:
        """The frames, those without a valid alpha given RMBG's refined
        matte as alpha (RGBA)."""
        needs = [i for i, f in enumerate(frames) if not self.has_valid_alpha(f)]
        if not needs:
            logger.info("All frames carry valid alpha — skipping matting")
            return frames
        if self._model is None:
            raise RuntimeError(
                "Frames lack valid alpha masks and RMBG weights are not "
                "available. Provide RGBA inputs / *_mask.png pairs, or place "
                "RMBG-1.4 weights under pretrained_weights/RMBG."
            )
        alphas = self._model.predict_alphas([frames[i] for i in needs])
        out = list(frames)
        for i, alpha in zip(needs, alphas):
            out[i] = np.concatenate([frames[i][..., :3], refine_mask(alpha)[..., None]], axis=-1)
        return out
