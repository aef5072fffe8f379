"""Rotary position tables from float positions, and the rotation itself.

Counterpart of ``actionmesh_tpu/ops/rotary.py``. ActionMesh uses real-valued
(centered) video timesteps as positions. Two channel layouts:

  * ``half`` (the models' layout): channel i pairs with channel D/2+i. The
    q/k projection columns of every checkpoint the JAX package writes are
    already permuted to it (``rope_half_permutation``, applied by the
    checkpoint converters in ``utils/weights.py``), so the port reads them
    as they are; the models' rotation runs inside ``ops/rope_norm.py``.
  * ``interleaved`` (the reference's): channels (2i, 2i+1) form the pair.
    Only the plain version of kernel F (``ops/flash_attention.py:
    flash_attention_fused``) uses it.
"""

from __future__ import annotations

import numpy as np
import torch

LAYOUTS = ("half", "interleaved")


def rope_half_permutation(dim_head: int) -> np.ndarray:
    """Channel permutation taking interleaved RoPE pairs to half-layout
    pairs: ``new[i] = old[perm[i]]``, even source channels first, then the
    odd ones, so pair (2i, 2i+1) becomes (i, D/2 + i)."""
    return np.concatenate([np.arange(0, dim_head, 2), np.arange(1, dim_head, 2)])


def compute_rotary_embeddings(
    embed_dim: int,
    positions: torch.Tensor,
    base_freq: float = 10000.0,
    freq_scale: float = 1.0,
    layout: str = "half",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables, each (S, embed_dim) float32, for (S,) positions."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    if layout not in LAYOUTS:
        raise ValueError(f"unknown rope layout: {layout}")
    positions = positions.to(torch.float32)
    exponent = (
        torch.arange(0, embed_dim, 2, dtype=torch.float32, device=positions.device)
        / embed_dim
    )
    inv_freq = 1.0 / (base_freq ** exponent) / freq_scale
    phases = torch.outer(positions, inv_freq)  # (S, D/2)
    if layout == "half":
        return torch.cat([torch.cos(phases)] * 2, dim=-1), torch.cat([torch.sin(phases)] * 2, dim=-1)
    return (
        torch.repeat_interleave(torch.cos(phases), 2, dim=-1),
        torch.repeat_interleave(torch.sin(phases), 2, dim=-1),
    )


def rotate_half_pairwise(x: torch.Tensor) -> torch.Tensor:
    """Pairwise 90-degree rotation: (x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    pairs = x.unflatten(-1, (-1, 2))
    return torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)


def rotate_half_split(x: torch.Tensor) -> torch.Tensor:
    """Half-layout 90-degree rotation: (x1 | x2) -> (-x2 | x1)."""
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rotary_embedding(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, layout: str = "half"
) -> torch.Tensor:
    """RoPE on a (B, H, S, D) tensor with (S, D) or (B, S, D) tables built for
    the same ``layout``. Math in float32, result cast back to x.dtype."""
    if cos.ndim not in (2, 3):
        raise ValueError(f"cos/sin must be 2D or 3D, got {cos.ndim}D")
    cb = cos[None, None] if cos.ndim == 2 else cos[:, None]
    sb = sin[None, None] if sin.ndim == 2 else sin[:, None]
    if layout == "half":
        rotate = rotate_half_split
    elif layout == "interleaved":
        rotate = rotate_half_pairwise
    else:
        raise ValueError(f"unknown rope layout: {layout}")
    xf = x.float()
    return (xf * cb + rotate(xf) * sb).to(x.dtype)
