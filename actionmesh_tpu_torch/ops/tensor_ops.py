"""Reshapes between the per-frame and the inflated sequence layouts.

Shape convention ``(B, T, N, D)``: batch, frames, tokens per frame, features.
Counterpart of ``actionmesh_tpu/ops/tensor_ops.py``. Every function is a
``reshape``; on contiguous inputs each one is a view.
"""

from __future__ import annotations

import torch


def merge_batch_time(x: torch.Tensor) -> torch.Tensor:
    """(B, T, ...) -> (B*T, ...)."""
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def split_batch_time(x: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(B*T, ...) -> (B, T, ...)."""
    return x.reshape((x.shape[0] // n_frames, n_frames) + tuple(x.shape[1:]))


def merge_time_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, T, N, ...) -> (B, T*N, ...)."""
    return x.reshape((x.shape[0], x.shape[1] * x.shape[2]) + tuple(x.shape[3:]))


def flat_batch_to_flat_seq(x: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(B*T, N, ...) -> (B, T*N, ...): the attention "inflation" reshape."""
    b = x.shape[0] // n_frames
    return x.reshape((b, n_frames * x.shape[1]) + tuple(x.shape[2:]))


def flat_seq_to_flat_batch(x: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(B, T*N, ...) -> (B*T, N, ...)."""
    n = x.shape[1] // n_frames
    return x.reshape((x.shape[0] * n_frames, n) + tuple(x.shape[2:]))
