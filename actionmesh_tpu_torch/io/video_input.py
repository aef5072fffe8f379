"""Pipeline input: RGBA frames and their timesteps.

Counterpart of ``ActionMeshInput`` in ``actionmesh_tpu/io/video_input.py``,
over (H, W, 4) uint8 numpy frames instead of PIL images, and ``natsorted``.
File and video loaders are not ported yet.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from typing import Sequence

import numpy as np

logger = logging.getLogger(__name__)

MIN_FRAMES = 16


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
