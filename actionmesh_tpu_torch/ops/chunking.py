"""Autoregressive sliding-window index chunking (host-side numpy).

Copy of ``actionmesh_tpu/ops/chunking.py``: the JAX package cannot be
imported where the port runs (its ``__init__`` imports jax).
"""

from __future__ import annotations

import numpy as np


def chunk_right(start: int, end: int, size: int, slide: int) -> list[np.ndarray]:
    """Overlapping chunks moving left->right.

    Example: start=0, end=10, size=4, slide=2
        [[0,1,2,3], [2,3,4,5], [4,5,6,7], [6,7,8,9]]
    """
    if not 0 < slide <= size:
        raise ValueError(f"Need 0 < slide <= size, got slide={slide} size={size}")
    chunks: list[np.ndarray] = []
    chunk_end = start
    while chunk_end < end:
        if not chunks:
            chunk_end = min(start + size, end)
        else:
            chunk_end = min(chunk_end + slide, end)
        chunk_start = max(start, chunk_end - size)
        chunks.append(np.arange(chunk_start, chunk_end))
    return chunks


def chunk_left(start: int, end: int, size: int, slide: int) -> list[np.ndarray]:
    """Overlapping chunks moving right->left (reversed chunks, reversed order)."""
    right_chunks = chunk_right(start, end, size, slide)
    return [chunk[::-1].copy() for chunk in reversed(right_chunks)]


def chunk_from(start: int, total: int, size: int, slide: int) -> list[np.ndarray]:
    """Windows expanding bidirectionally from an anchor index.

    ``total == size`` puts the anchor first; ``total < size`` raises, since
    negative clamps would silently wrap to the last frames.
    """
    if total < size:
        raise ValueError(
            f"AR window size ({size}) exceeds the sequence length "
            f"({total}) — lower temporal_context_size or provide more "
            "frames"
        )
    context = size - slide

    if total == size:
        indices = np.arange(total)
        return [
            np.concatenate([indices[start : start + 1], indices[indices != start]])
        ]

    if start == 0:
        return chunk_right(0, total, size, slide)
    if start == total - 1:
        return chunk_left(0, total, size, slide)

    if start > total - start:
        left = chunk_left(0, start + 1, size, slide)
        right_start = min(max(0, start - context + 1), total - size)
        right = chunk_right(right_start, total, size, slide)
        return left + right
    right = chunk_right(start, total, size, slide)
    left_end = max(min(start + context, total), size)
    left = chunk_left(0, left_end, size, slide)
    return right + left
