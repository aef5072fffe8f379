"""Farthest point sampling (FPS) on the device, and its grouped variant.

Counterpart of ``actionmesh_tpu/ops/fps.py``: a loop over the samples
keeping each point's running squared distance to the chosen set, the next
pick its argmax (the first on ties, as ``jnp.argmax``). The picks stay on
the device, so the loop never waits on the host. The JAX package draws the
start point (and ``random`` sampling's indices) from a ``jax.random`` key;
here they are arguments, drawn by the caller from a ``torch.Generator``:
the two generators cannot draw the same bits, so both functions take the
indices as well.
"""

from __future__ import annotations

from typing import Optional

import torch


def farthest_point_sampling(
    points: torch.Tensor, n_samples: int, start: Optional[torch.Tensor] = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """FPS over (B, N, 3) points -> (sampled (B, K, 3), indices (B, K) int64).

    ``start``: (B,) index of each batch entry's first pick (the JAX
    package's random start); index 0 when None.
    """
    B, N, _ = points.shape
    pts = points.float()
    idx = torch.zeros((B, n_samples), dtype=torch.long, device=points.device)
    if start is not None:
        idx[:, 0] = start.to(device=points.device, dtype=torch.long)
    min_dist = torch.full((B, N), float("inf"), device=points.device)
    rows = torch.arange(B, device=points.device)
    for i in range(1, n_samples):
        last = pts[rows, idx[:, i - 1]]  # (B, 3)
        d = (pts - last[:, None]).square().sum(-1)
        min_dist = torch.minimum(min_dist, d)
        idx[:, i] = min_dist.argmax(dim=1)
    sampled = torch.take_along_dim(points, idx[..., None], dim=1)
    return sampled, idx


def sample_pc(
    points: torch.Tensor,
    n_samples: int,
    sampling_type: str = "fps",
    indices: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Point-cloud sampling dispatch (fps | random | identity).

    ``indices``: for ``fps`` the (B,) start indices (None: index 0); for
    ``random`` the (B, K) drawn indices, which it needs.
    """
    B, N, _ = points.shape
    if sampling_type == "identity" or n_samples >= N:
        idx = torch.arange(N, device=points.device).expand(B, N)
        return points, idx
    if sampling_type == "random":
        if indices is None:
            raise ValueError("random sampling needs its drawn indices")
        idx = indices.to(device=points.device, dtype=torch.long)
        return torch.take_along_dim(points, idx[..., None], dim=1), idx
    if sampling_type == "fps":
        return farthest_point_sampling(points, n_samples, start=indices)
    raise ValueError(f"unknown sampling_type: {sampling_type}")


def sample_pc_grouped(
    points: torch.Tensor,
    n_samples: int,
    n_grouped_frames: int,
    sampling_type: str = "fps",
    indices: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Temporally corresponding sampling: pick the indices on frame 0 of each
    batch entry and reuse them for all ``n_grouped_frames`` frames of
    ``points`` (B*T, N, 3)."""
    BT, N, _ = points.shape
    T = n_grouped_frames
    frame0 = points.reshape(BT // T, T, N, -1)[:, 0]
    _, idx = sample_pc(frame0, n_samples, sampling_type, indices=indices)
    idx_full = idx.repeat_interleave(T, dim=0)  # (B*T, K)
    return torch.take_along_dim(points, idx_full[..., None], dim=1), idx_full
