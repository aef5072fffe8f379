"""Multi-head attention dispatch and its plain PyTorch version.

Counterpart of ``actionmesh_tpu/ops/attention.py``. ``dot_product_attention``
sends CUDA tensors to the hand-written flash kernel
(``ops/flash_attention.py``) and CPU tensors to ``chunked_attention``.

Stage I's inflated self-attention spans 16 x 2049 = 32,784 tokens; a
materialised fp32 score matrix there would be 2 x 16 x 32,784^2 x 4 bytes
= 137 GB, so the plain version scans KV in chunks with an online softmax.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
    q_chunk: int = 512,
    k_chunk: int = 1024,
    return_stats: bool = False,
):
    """Online-softmax attention over KV chunks, fp32 statistics.

    q (B, H, Sq, D); k, v (B, H, Sk, D); kv_mask (B, Sk), nonzero = valid.
    Scores are q.k products of the input values accumulated in fp32, times
    ``scale``; masked scores are -1e30; probabilities are rounded to v's
    dtype before the PV product (as the TPU kernel does) and the row sum
    ``l`` uses the fp32 probabilities. ``return_stats`` also gives the
    per-row running max ``m`` and sum ``l``, (B, H, Sq) fp32. Keys beyond
    Sk do not exist (no padding), so a row whose keys are all masked
    averages v over its Sk keys.
    """
    out_dtype = q.dtype
    if scale is None:
        scale = q.shape[-1] ** -0.5
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    valid = None if kv_mask is None else (kv_mask != 0)[:, None, None, :]
    outs, ms, ls = [], [], []
    for q0 in range(0, Sq, q_chunk):
        qb = q[:, :, q0 : q0 + q_chunk].float()
        acc = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
        m = torch.full(qb.shape[:3], NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros(qb.shape[:3], dtype=torch.float32, device=q.device)
        for k0 in range(0, Sk, k_chunk):
            kb = k[:, :, k0 : k0 + k_chunk].float()
            vb = v[:, :, k0 : k0 + k_chunk]
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            if valid is not None:
                s = torch.where(valid[..., k0 : k0 + k_chunk], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.matmul(p.to(vb.dtype).float(), vb.float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        outs.append((acc / torch.clamp(l[..., None], min=1e-30)).to(out_dtype))
        ms.append(m)
        ls.append(l)
    out = torch.cat(outs, dim=2)
    if return_stats:
        return out, (torch.cat(ms, dim=2), torch.cat(ls, dim=2))
    return out


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused multi-head attention, q (B,H,Sq,D), k/v (B,H,Sk,D) -> q.dtype.

    CUDA tensors go to the flash kernel (which raises on what it does not
    take); CPU tensors to the plain chunked version.
    """
    from actionmesh_tpu_torch.ops.flash_attention import flash_attention

    return flash_attention(q, k, v, scale=scale, kv_mask=kv_mask)
