"""Multi-head attention dispatch and its plain PyTorch versions.

Counterpart of ``actionmesh_tpu/ops/attention.py``. ``dot_product_attention``
sends CUDA tensors to the hand-written flash kernels
(``ops/flash_attention.py``) and CPU tensors to the plain versions here:
``chunked_attention`` for the forward, ``attention_bwd_reference`` for the
backward, and ``chunked_attention_trainable`` joining the two.

Stage I's inflated self-attention spans 16 x 2049 = 32,784 tokens; a
materialised fp32 score matrix there would be 2 x 16 x 32,784^2 x 4 bytes
= 137 GB, so the plain version scans KV in chunks with an online softmax.

Under a device mesh (``parallel/mesh.py``), ``dot_product_attention(mesh=)``
runs the kernel on the rank's (batch, head, sequence) shard; a sequence
split over ``sp`` runs ``ring_attention_local``, which merges the kernel's
per-shard partials by their online-softmax statistics (``merge_partials``),
or, for training, ``ring_attention_trainable``, whose backward runs kernels
C and D on each KV shard as it goes round the ring with the whole
sequence's row statistics.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from actionmesh_tpu_torch.parallel.mesh import axis_size

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


def bwd_row_stats(o, m, l, do):
    """Per-row L = m + log l (1e30 for rows with l = 0, so that their
    exp(s - L) is 0) and delta = sum_d dO*O, (B, H, Sq) fp32."""
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)), -NEG_INF)
    return lse, (do.float() * o.float()).sum(dim=-1)


def attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    do: torch.Tensor,
    scale: Optional[float] = None,
    q_chunk: int = 2048,
    k_chunk: int = 1024,
):
    """Plain O(S)-memory attention backward from the forward's stats.

    Port of ``actionmesh_tpu/ops/attention.py:_chunked_trainable_bwd``, in
    (q_chunk, k_chunk) tiles: P = exp(scale * q.k - L) with L = m + log l
    recomputed per tile, dV = P^T dO with P rounded to v's dtype,
    dS = P * (dO.v - delta) * scale with delta = sum dO*O, dQ = dS K and
    dK = dS^T Q with dS rounded to q's dtype; fp32 accumulation. Returns
    (dq, dk, dv) in the dtypes of q, k, v.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    lse, delta = bwd_row_stats(o, m, l, do)
    return attention_bwd_stats_reference(q, k, v, lse, delta, do, scale, q_chunk, k_chunk)


def attention_bwd_stats_reference(q, k, v, lse, delta, do, scale: float, q_chunk: int = 2048,
                                  k_chunk: int = 1024):
    """``attention_bwd_reference`` from the row statistics L and delta
    (``bwd_row_stats``), which need not be those of these keys alone: the
    plain version of kernels C and D on one KV shard of the ring."""
    Sq, Sk = q.shape[2], k.shape[2]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, Sk, k_chunk):
        kb = k[:, :, k0 : k0 + k_chunk].float()
        vb = v[:, :, k0 : k0 + k_chunk].float()
        for q0 in range(0, Sq, q_chunk):
            qs = slice(q0, q0 + q_chunk)
            qb = q[:, :, qs]
            dob = do[:, :, qs].to(v.dtype).float()
            s = torch.matmul(qb.float(), kb.transpose(-1, -2)) * scale
            p = torch.exp(s - lse[:, :, qs, None])
            dv[:, :, k0 : k0 + k_chunk] += torch.matmul(
                p.to(v.dtype).float().transpose(-1, -2), dob
            )
            dp = torch.matmul(dob, vb.transpose(-1, -2))
            ds = p * (dp - delta[:, :, qs, None]) * scale
            dq[:, :, qs] += torch.matmul(ds.to(k.dtype).float(), kb)
            dk[:, :, k0 : k0 + k_chunk] += torch.matmul(
                ds.to(q.dtype).float().transpose(-1, -2), qb.float()
            )
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _ChunkedAttentionTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, (m, l) = chunked_attention(q, k, v, scale=scale, return_stats=True)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        return (*attention_bwd_reference(*ctx.saved_tensors, do, ctx.scale), None)


def chunked_attention_trainable(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """``chunked_attention`` with the O(S)-memory recomputing backward.

    Port of ``actionmesh_tpu/ops/attention.py:chunked_attention_trainable``:
    the plain version of kernels A, C and D together. No kv mask (training
    needs none).
    """
    return _ChunkedAttentionTrainable.apply(q, k, v, scale)


def merge_partials(partials: Sequence, dtype: Optional[torch.dtype] = None, return_stats: bool = False):
    """Attention over the union of KV shards from each shard's partial.

    ``partials``: (out, (m, l)) per KV shard, as ``flash_attention(...,
    return_stats=True)`` gives them for the same queries: out (B, H, Sq, D)
    normalised by its own l, m the running max of the scaled scores and l
    the sum of exp(s - m), (B, H, Sq) fp32. The log-sum-exp combine of
    ``actionmesh_tpu/ops/attention.py:ring_attention_local``: with M the max
    of the m_i, w_i = l_i exp(m_i - M), out = sum_i w_i out_i / max(sum_i
    w_i, 1e-30) in fp32. A partial with l = 0 weighs 0 whatever its m (so
    -inf stats give no NaN). A shard whose keys a row masks entirely has
    m = -1e30 and weighs exp(-1e30 - M) = 0 beside any shard with a valid
    key; when every shard masks the row, the result is the mean of v over
    all keys, as one unsharded call gives. Returns ``dtype`` (the first
    out's by default); ``return_stats`` also gives the merged (M, L), the
    statistics of one call over all the keys.
    """
    m = torch.stack([p[1][0] for p in partials]).amax(dim=0)
    num = l = None
    for out_i, (m_i, l_i) in partials:
        w = torch.where(l_i > 0, l_i * torch.exp(m_i - m), 0.0)
        term = out_i.float() * w[..., None]
        num = term if num is None else num + term
        l = w if l is None else l + w
    out = (num / torch.clamp(l, min=1e-30)[..., None]).to(dtype or partials[0][0].dtype)
    return (out, (m, l)) if return_stats else out


def _ring_peers(group) -> tuple[int, int, int]:
    """(size, next rank, previous rank) of the ring over ``group``, as
    global ranks."""
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    return n, dist.get_global_rank(group, (rank + 1) % n), dist.get_global_rank(group, (rank - 1) % n)


def _pass_on(tensors, group, nxt: int, prv: int):
    """Send ``tensors`` to the next rank and receive their like from the
    previous one: (incoming buffers, requests to wait on)."""
    incoming = [torch.empty_like(t) for t in tensors]
    reqs = dist.batch_isend_irecv(
        [dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
        + [dist.P2POp(dist.irecv, t, prv, group) for t in incoming]
    )
    return incoming, reqs


def _wait(reqs) -> None:
    for req in reqs:
        req.wait()


def _ring_partials(q, k, v, scale, kv_mask, group) -> list:
    """Kernel A's (out, (m, l)) of ``q`` against each KV shard of the ring,
    this rank's first; the next shard's transfer runs while the current
    one's partial is computed."""
    from actionmesh_tpu_torch.ops.flash_attention import flash_attention

    n, nxt, prv = _ring_peers(group)
    cur = [k.contiguous(), v.contiguous()]
    if kv_mask is not None:
        cur.append(kv_mask.to(torch.int32).contiguous())
    partials = []
    for step in range(n):
        reqs = ()
        if step < n - 1:
            incoming, reqs = _pass_on(cur, group, nxt, prv)
        partials.append(flash_attention(
            q, cur[0], cur[1], scale=scale,
            kv_mask=cur[2] if kv_mask is not None else None, return_stats=True,
        ))
        _wait(reqs)  # the buffers are read or replaced only after this
        if reqs:
            cur = incoming
    return partials


def ring_attention_local(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float],
    kv_mask: Optional[torch.Tensor],
    group,
) -> torch.Tensor:
    """Sequence-parallel attention on this rank's shard (ring schedule).

    Each rank of ``group`` (the sp axis) holds S/sp query rows and the S/sp
    keys of the same positions, k, v (B, H, S/sp, D) and kv_mask (B, S/sp).
    The KV shards go round the ring (this rank sends to the next and
    receives from the previous, ``dist.batch_isend_irecv``, the next shard's
    transfer running while the current one's partial is computed); each step
    runs kernel A (the plain version on CPU tensors) with
    ``return_stats=True``, and the sp partials are merged by
    ``merge_partials``. Port of ``actionmesh_tpu/ops/attention.py:
    ring_attention_local``.
    """
    from actionmesh_tpu_torch.ops.flash_attention import flash_attention

    if dist.get_world_size(group) == 1:
        return flash_attention(q, k, v, scale=scale, kv_mask=kv_mask)
    return merge_partials(_ring_partials(q, k, v, scale, kv_mask, group), q.dtype)


def attention_bwd_from_stats(q, k, v, do, lse, delta, scale: float):
    """(dq, dk, dv) of one KV shard from the row statistics of the whole
    sequence: kernels C and D on CUDA tensors (they raise on what they do
    not take), the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return attention_bwd_stats_reference(q, k, v, lse, delta, do, scale)
    from actionmesh_tpu_torch.ops.flash_attention import flash_attention_bwd_from_stats

    return flash_attention_bwd_from_stats(q, k, v, do, lse, delta, scale)


class _RingAttentionTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, group):
        out, (m, l) = merge_partials(_ring_partials(q, k, v, scale, None, group), q.dtype,
                                     return_stats=True)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.scale, ctx.group = scale, group
        return out

    @staticmethod
    def backward(ctx, do):
        from actionmesh_tpu_torch.ops.flash_attention import kernel_takes_layout

        q, k, v, o, m, l = ctx.saved_tensors
        group = ctx.group
        n, nxt, prv = _ring_peers(group)
        do = do.to(q.dtype)
        if not kernel_takes_layout(do):
            do = do.contiguous()
        lse, delta = (x.contiguous() for x in bwd_row_stats(o, m, l, do))
        cur = [k.contiguous(), v.contiguous()]
        dq = acc = None
        acc_reqs = ()
        for step in range(n):
            kv_reqs = ()
            if step < n - 1:
                incoming, kv_reqs = _pass_on(cur, group, nxt, prv)
            dq_i, dk_i, dv_i = attention_bwd_from_stats(q, cur[0], cur[1], do, lse, delta, ctx.scale)
            dq = dq_i.float() if dq is None else dq + dq_i.float()
            dk_i, dv_i = dk_i.float(), dv_i.float()
            if acc is not None:  # the sums so far of the shard held now
                _wait(acc_reqs)
                dk_i, dv_i = acc[0] + dk_i, acc[1] + dv_i
            # the sums travel on with their shard; after the last step
            # they reach the shard's owner
            acc, acc_reqs = _pass_on([dk_i, dv_i], group, nxt, prv)
            _wait(kv_reqs)
            if kv_reqs:
                cur = incoming
        _wait(acc_reqs)
        return dq.to(q.dtype), acc[0].to(k.dtype), acc[1].to(v.dtype), None, None


def ring_attention_trainable(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float], group
) -> torch.Tensor:
    """Sequence-parallel attention with the O(S)-memory backward (no kv
    mask), on this rank's shards as ``ring_attention_local`` takes them.

    Forward: ``ring_attention_local``'s partials and merge, keeping the
    merged (M, L) of the whole sequence. Backward: delta = rowsum(dO*O)
    once, then for each KV shard round the ring kernel D's dQ of that shard
    (added into an fp32 sum) and kernel C's dK and dV, both from the global
    log-sum-exp M + log L and delta, so each shard's terms are those of one
    unsharded call. The fp32 dK/dV sums travel with their K/V shard (sent
    on after each step, while the next step's kernels run) and reach the
    owner after the full circle; every sum is taken in ring order, so two
    calls give the same bits. The plain version per shard on CPU tensors.
    """
    from actionmesh_tpu_torch.ops.flash_attention import flash_attention_trainable

    if scale is None:
        scale = q.shape[-1] ** -0.5
    if dist.get_world_size(group) == 1:
        return flash_attention_trainable(q, k, v, scale=scale)
    return _RingAttentionTrainable.apply(q, k, v, scale, group)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
    trainable: bool = False,
    mesh=None,
    sequence_parallel: bool = False,
) -> torch.Tensor:
    """Fused multi-head attention, q (B,H,Sq,D), k/v (B,H,Sk,D) -> q.dtype.

    CUDA tensors go to the flash kernels (which raise on what they do not
    take); CPU tensors to the plain chunked versions. ``trainable`` gives
    the O(S)-memory backward (kernels C and D on the card), as JAX's
    ``auto_train``; it takes no kv mask.

    ``mesh``: q, k, v (and the mask) are this rank's shards, as the layers
    hold them. A (batch, head) shard needs no communication and runs the
    local kernel (trainable: kernels A, C and D on the rank's heads and
    rows). With ``sequence_parallel`` they hold the rank's S/sp rows of a
    self-attention whose sequence is split over the mesh's sp axis, and it
    runs as the ring over sp (``ring_attention_local``; trainable,
    ``ring_attention_trainable``).
    """
    from actionmesh_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_trainable,
    )

    ring = sequence_parallel and axis_size(mesh, "sp") > 1
    if trainable:
        if kv_mask is not None:
            raise ValueError("trainable attention takes no kv_mask")
        if ring:
            return ring_attention_trainable(q, k, v, scale, mesh.get_group("sp"))
        return flash_attention_trainable(q, k, v, scale=scale)
    if ring:
        return ring_attention_local(q, k, v, scale, kv_mask, mesh.get_group("sp"))
    return flash_attention(q, k, v, scale=scale, kv_mask=kv_mask)
