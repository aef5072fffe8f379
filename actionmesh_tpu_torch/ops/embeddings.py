"""Timestep and positional embedding math (no parameters), float32.

Counterpart of ``actionmesh_tpu/ops/embeddings.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sinusoidal_timestep_embedding(
    timesteps: torch.Tensor,
    embedding_dim: int,
    max_period: float = 10000.0,
    flip_sin_to_cos: bool = False,
    downscale_freq_shift: float = 0.0,
    scale: float = 1.0,
) -> torch.Tensor:
    """diffusers ``get_timestep_embedding``: (...,) -> (..., embedding_dim)."""
    half = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half - downscale_freq_shift)
    freqs = torch.exp(exponent)
    args = timesteps.to(torch.float32)[..., None] * freqs * scale
    sin, cos = torch.sin(args), torch.cos(args)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)


def timestep_embedder(
    *timesteps: torch.Tensor,
    frequency_embedding_size: int = 256,
    max_period: float = 10_000.0,
) -> torch.Tensor:
    """[cos | sin] embedding per input, inputs concatenated on the last axis."""
    if frequency_embedding_size % 2:
        raise ValueError("frequency_embedding_size must be even")
    half = frequency_embedding_size // 2
    device = timesteps[0].device
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=device)
        / half
    )
    outs = []
    for t in timesteps:
        args = t.to(torch.float32)[..., None] * freqs
        outs.append(torch.cat([torch.cos(args), torch.sin(args)], dim=-1))
    return torch.cat(outs, dim=-1)


def frequency_positional_embedding(
    x: torch.Tensor,
    num_freqs: int = 8,
    logspace: bool = True,
    include_input: bool = True,
    include_pi: bool = False,
) -> torch.Tensor:
    """NeRF-style xyz encoding: [x, sin(x*f), cos(x*f)], channel-major."""
    if num_freqs == 0:
        return x
    if logspace:
        freqs = 2.0 ** np.arange(num_freqs, dtype=np.float32)
    else:
        freqs = np.linspace(
            1.0, 2.0 ** (num_freqs - 1), num_freqs, dtype=np.float32
        )
    if include_pi:
        freqs = freqs * np.pi
    freqs_t = torch.as_tensor(freqs, dtype=torch.float32, device=x.device)
    embed = (x[..., None] * freqs_t).reshape(
        tuple(x.shape[:-1]) + (x.shape[-1] * num_freqs,)
    )
    parts = [torch.sin(embed), torch.cos(embed)]
    if include_input:
        parts = [x] + parts
    return torch.cat(parts, dim=-1)


def frequency_embedding_out_dim(
    input_dim: int = 3, num_freqs: int = 8, include_input: bool = True
) -> int:
    extra = 1 if (include_input or num_freqs == 0) else 0
    return input_dim * (num_freqs * 2 + extra)


def scale_timestep(
    timestep: torch.Tensor, center: bool = True, scale: bool = False
) -> torch.Tensor:
    """Center (and optionally scale) per-row timesteps. Input (B, T)."""
    t_min = timestep.amin(dim=1, keepdim=True)
    t_max = timestep.amax(dim=1, keepdim=True)
    if center:
        timestep = timestep - t_min
    if scale:
        timestep = timestep / (t_max - t_min)
    return timestep


def get_scaling(timesteps: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-row (min, range) of (B, T) host timesteps."""
    t_min = timesteps.min(axis=1)
    t_max = timesteps.max(axis=1)
    return t_min, t_max - t_min


def apply_scaling(
    timesteps: np.ndarray, t_min: np.ndarray, t_range: np.ndarray
) -> np.ndarray:
    """Normalize host timesteps to [0, 1] with precomputed (min, range)."""
    if timesteps.ndim == 1:
        return (timesteps - t_min) / t_range
    return (timesteps - t_min[:, None]) / t_range[:, None]


def get_n_subdivisions(start: float, end: float, level: int = 1) -> int:
    """Number of points after recursive midpoint subdivision of [start, end]."""
    n_points = int(end - start + 1)
    for _ in range(1, level):
        n_points += n_points - 1
    return n_points


def interpolate_timesteps(
    timesteps: np.ndarray,
    subsampling_level: int,
    drop_first: bool = False,
) -> np.ndarray:
    """(1, n_steps) output timesteps spanning min..max of the input."""
    t_min = float(np.min(timesteps))
    t_max = float(np.max(timesteps))
    n_steps = get_n_subdivisions(t_min, t_max, level=subsampling_level)
    out = np.linspace(t_min, t_max, n_steps, dtype=np.float32).reshape(1, -1)
    if drop_first:
        out = out[:, 1:]
    return out
