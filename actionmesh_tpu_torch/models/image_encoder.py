"""Image conditioning encoder: DINOv2-L features per frame.

Counterpart of ``actionmesh_tpu/models/image_encoder.py``. Preprocessing
follows HF BitImageProcessor for dinov2 (resize the shortest edge to 256
bicubic, centre-crop 224, ImageNet normalisation) -> 257 tokens per frame;
all frames encode in one batched forward. The JAX package resizes with PIL;
here ``F.interpolate(mode="bicubic", antialias=True)`` does it (PyTorch's
antialiased bicubic uses PIL's a = -0.5 kernel), in PIL's two passes with
PIL's rounding to uint8 after each. ``tests/test_torch_ops.py`` holds the
two against each other.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from actionmesh_tpu_torch.models.dinov2 import DinoV2Config, dinov2_forward, init_dinov2

logger = logging.getLogger(__name__)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def resize_bicubic(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """(H, W, C) uint8 resized as PIL's antialiased bicubic does it: width
    first, then height, rounding to uint8 after each pass."""
    h, w = img.shape[:2]
    if (new_h, new_w) == (h, w):  # PIL returns an unchanged copy
        return np.array(img)
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    for size in ((h, new_w), (new_h, new_w)):
        x = F.interpolate(x, size=size, mode="bicubic", antialias=True, align_corners=False)
        x = (x + 0.5).floor().clamp(0, 255)
    return x[0].permute(1, 2, 0).to(torch.uint8).numpy()


def preprocess_for_dino(
    frames: list[np.ndarray], resize_shortest: int = 256, crop_size: int = 224
) -> np.ndarray:
    """(H, W, 3|4) uint8 frames -> (T, crop, crop, 3) float32 normalised."""
    out = []
    for frame in frames:
        h, w = frame.shape[:2]
        scale = resize_shortest / min(w, h)
        new_w, new_h = round(w * scale), round(h * scale)
        img = resize_bicubic(frame[..., :3], new_h, new_w)
        left = (new_w - crop_size) // 2
        top = (new_h - crop_size) // 2
        arr = img[top : top + crop_size, left : left + crop_size]
        arr = arr.astype(np.float32) / 255.0
        out.append((arr - IMAGENET_MEAN) / IMAGENET_STD)
    return np.stack(out)


class ImageEncoder:
    """DINOv2-large producing (T, S, 1024) context embeddings.

    Weights: ``params`` if given, else the checkpoint in ``weights_dir`` (a
    Hugging Face ``Dinov2Model`` in safetensors) if that exists, else seeded
    random ones (development mode).
    """

    def __init__(
        self,
        device: torch.device,
        dtype: torch.dtype = torch.bfloat16,
        config: Optional[DinoV2Config] = None,
        init_seed: int = 1,
        params=None,
        weights_dir: Optional[str | Path] = None,
    ):
        self.config = config or DinoV2Config()
        self.device = device
        self._dtype = dtype
        if params is None and weights_dir is not None and Path(weights_dir).exists():
            from actionmesh_tpu_torch.utils.weights import load_dinov2

            logger.info("Loading DINOv2 weights from %s", weights_dir)
            params = load_dinov2(Path(weights_dir), self.config, dtype=dtype, device=device)
        elif params is None:
            logger.warning(
                "DINOv2 weights not found (%s) — using seeded random "
                "initialization (development mode).",
                weights_dir,
            )
            gen = torch.Generator(device=device).manual_seed(init_seed)
            params = init_dinov2(gen, self.config, dtype=dtype, device=device)
        self.params = params

    def encode_images(self, images: list[np.ndarray]) -> torch.Tensor:
        pixels = torch.as_tensor(preprocess_for_dino(images), device=self.device)
        return dinov2_forward(self.params, self.config, pixels.to(self._dtype))
