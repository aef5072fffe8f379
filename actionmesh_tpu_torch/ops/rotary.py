"""Rotary position tables from float positions, ``half`` channel layout.

Counterpart of ``actionmesh_tpu/ops/rotary.py``. ActionMesh uses real-valued
(centered) video timesteps as positions. Only the ``half`` layout is ported:
channel i pairs with channel D/2+i, and the q/k projection columns of every
checkpoint the JAX package writes are already permuted to it
(``actionmesh_tpu/ops/rotary.py:rope_half_permutation``), so the port reads
them as they are. The rotation itself lives in ``ops/rope_norm.py``.
"""

from __future__ import annotations

import torch


def compute_rotary_embeddings(
    embed_dim: int,
    positions: torch.Tensor,
    base_freq: float = 10000.0,
    freq_scale: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables, each (S, embed_dim) float32, for (S,) positions."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim must be even, got {embed_dim}")
    positions = positions.to(torch.float32)
    exponent = (
        torch.arange(0, embed_dim, 2, dtype=torch.float32, device=positions.device)
        / embed_dim
    )
    inv_freq = 1.0 / (base_freq ** exponent) / freq_scale
    phases = torch.outer(positions, inv_freq)  # (S, D/2)
    cos = torch.cat([torch.cos(phases)] * 2, dim=-1)
    sin = torch.cat([torch.sin(phases)] * 2, dim=-1)
    return cos, sin
