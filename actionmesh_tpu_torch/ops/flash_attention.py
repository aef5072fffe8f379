"""Flash attention: wrappers of the Hopper kernels in ``csrc/flash_fwd.cu``
(kernel A, forward, and kernel F, a qk-norm + RoPE pre-pass followed by
kernel A's mainloop) and ``csrc/flash_bwd.cu`` (kernels C and D, backward).

Kernel A replaces ``actionmesh_tpu/ops/flash_attention.py:
flash_attention_pipelined`` and ``flash_attention`` (the Pallas TPU kernels)
and meets both contracts. Its bf16 and fp16 path is one warp-specialised TMA
+ ``wgmma`` kernel template over the element type (a producer warpgroup
feeding a ring of K/V tiles, two consumer warpgroups of 64 query rows each);
its fp32 path is built the same way on
TF32 ``wgmma`` with fp32 accuracy, each product three TF32 products of split
operands (``tf32_split``; a pre-pass writes k and v^T split into a
workspace allocated here; ``split_precision_attention_reference`` is the
plain model of that arithmetic). Kernels C (dK,
dV) and D (dQ) replace the two kernels of ``actionmesh_tpu/ops/
flash_attention_bwd.py:flash_attention_bwd``; their bf16 paths are built the
same way (C: a CTA owns 128 keys and walks 64-query steps; D: a CTA owns 128
queries and walks 128-key tiles), deterministic, without atomics; their fp32
paths are 3xTF32 on TF32 ``wgmma`` as A's (a pre-pass per kernel writes the
walked inputs, and their transposes, split into a workspace allocated here;
each CTA owns 128 rows and walks 32-row steps;
``split_precision_attention_bwd_reference`` is the plain model of that
arithmetic); they take no fp16. ``flash_attention_trainable`` joins A
with C and D as that module's ``custom_vjp`` does. Kernel F replaces
``actionmesh_tpu/ops/flash_attention.py:flash_attention_fused``; no path of
either package calls it. See the notes at the top of the CUDA sources for
their design. On CPU tensors each wrapper runs its plain version (from
``ops/attention.py``, and for F ``flash_attention_fused_reference`` here,
whose pre-pass is ``norm_rope_interleaved``); on CUDA tensors it launches its
kernel or raises. ``flash_attention.launches``,
``flash_attention_bwd.dkv_launches``, ``flash_attention_bwd.dq_launches`` and
``flash_attention_fused.launches`` count calls that launch their kernels (one
fp32 call of A launches two device kernels, the split pre-pass and the
mainloop, and one fp32 call of C or D its split pre-pass and its kernel; one
call of F launches its qk-norm pre-pass, then A's).

The kernels are instantiated at head dims 64 and 128. A, C and D take any
head dim up to 128: a smaller one is zero-padded here to the next
instantiated width (``pad_head_dim``) and the result sliced back, with the
scale of the true head dim. That is exact: zero columns add nothing to
q.k, give zero output columns in PV, and zero gradient columns (dO's padded
columns are zero). The plain versions take the true head dim unpadded.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from actionmesh_tpu_torch.ops.attention import (
    NEG_INF,
    attention_bwd_reference,
    bwd_row_stats,
    chunked_attention,
    chunked_attention_trainable,
)
from actionmesh_tpu_torch.ops.rotary import apply_rotary_embedding

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
_HEAD_DIMS = (64, 128)  # the kernels' instantiated widths
_lib = None
_bwd_lib = None


def _library():
    global _lib
    if _lib is None:
        from actionmesh_tpu_torch.utils.cuda_build import load_library

        lib = load_library("flash_fwd")
        # q, k, v, o, kv_mask, m, l, the fp32 split workspace, strides (host int64[12])
        lib.flash_fwd.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        )
        # kernel F: q, k, v, o, q^, k^ (workspaces), cos, sin, q_scale, k_scale,
        # the fp32 split workspace, strides (host int64[12])
        lib.flash_fused.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        )
        # the split pre-pass alone: k, v, workspace, strides (host int64[6])
        lib.flash_split_kv.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.flash_fwd.restype = lib.flash_fused.restype = lib.flash_split_kv.restype = ctypes.c_int
        _lib = lib
    return _lib


def _bwd_library():
    global _bwd_lib
    if _bwd_lib is None:
        from actionmesh_tpu_torch.utils.cuda_build import load_library

        lib = load_library("flash_bwd")
        # q, k, v, dO, lse, delta, then 2 (dk, dv) or 1 (dq) outputs, the fp32
        # split workspace, strides (host int64[21])
        tail = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
        lib.flash_bwd_dkv.argtypes = [ctypes.c_void_p] * 10 + tail
        lib.flash_bwd_dq.argtypes = [ctypes.c_void_p] * 9 + tail
        lib.flash_bwd_dkv.restype = lib.flash_bwd_dq.restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib


def _check_launch(what: str, err: int) -> None:
    """Raise on a nonzero return of a C entry point: a cudaError_t, or one of
    the tensor-map codes of ``csrc/sm90.cuh`` (10000: no
    cuTensorMapEncodeTiled in the driver; 20000 + CUresult: a refused
    encode)."""
    if err == 0:
        return
    if err == 10000:
        detail = "no cuTensorMapEncodeTiled was found in the CUDA driver"
    elif err >= 20000:
        detail = f"the tensor-map encode was refused (CUresult {err - 20000})"
    else:
        detail = f"CUDA error {err}"
    raise RuntimeError(f"{what} launch failed: {detail}")


def kernel_takes_layout(x: torch.Tensor) -> bool:
    """Whether the kernels can read ``x`` (B, H, S, D) through its strides:
    a contiguous last axis, and 16-byte aligned row strides and address
    (16-byte vector loads of rows, 4-byte loads of pairs)."""
    return x.stride(3) == 1 and not any(s % 8 for s in x.stride()[:3]) and not x.data_ptr() % 16


def padded_head_dim(D: int) -> Optional[int]:
    """The instantiated width a head dim ``D`` runs at: the smallest of
    ``_HEAD_DIMS`` at or above it, None above the largest."""
    return next((w for w in _HEAD_DIMS if D <= w), None) if D > 0 else None


def pad_head_dim(x: torch.Tensor, width: int) -> torch.Tensor:
    """x (..., D) zero-padded to (..., width), a new contiguous tensor."""
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


def _needs_padding(q: torch.Tensor) -> Optional[int]:
    """The padded width of q's head dim when the kernels do not take it as
    it is, else None."""
    D = q.shape[-1]
    width = padded_head_dim(D)
    return width if width is not None and width != D else None


def _check(q, k, v, kv_mask):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention: q, k, v must all be CUDA tensors")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; the kernel "
            "takes bf16, fp16 or fp32, the same for q, k and v"
        )
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be (B, H, S, D)")
    B, H, Sq, D = q.shape
    if k.shape[:2] != (B, H) or k.shape[3] != D or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
            f"v {tuple(v.shape)} do not match"
        )
    if D not in _HEAD_DIMS:
        raise ValueError(
            f"flash_attention: head dim {D} not in {_HEAD_DIMS} (the wrappers of A, C "
            f"and D pad head dims below {_HEAD_DIMS[-1]})"
        )
    if k.shape[2] == 0:
        raise ValueError("flash_attention: empty key sequence")
    if B > 65535 or H > 65535:  # grid z and y
        raise ValueError(f"flash_attention: batch {B} or heads {H} above 65535")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not kernel_takes_layout(x):
            raise ValueError(
                f"flash_attention: {name} (strides {x.stride()}) needs a contiguous "
                "last axis and 16-byte aligned strides and address"
            )
    if kv_mask is not None and (kv_mask.shape != (B, k.shape[2]) or kv_mask.device != q.device):
        raise ValueError(
            f"flash_attention: kv_mask must be (B, Sk) = {(B, k.shape[2])} on {q.device}"
        )


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
    return_stats: bool = False,
):
    """Attention forward, q (B,H,Sq,D), k/v (B,H,Sk,D) -> (B,H,Sq,D) q.dtype.

    ``kv_mask`` (B, Sk): nonzero = valid key. ``return_stats`` also returns
    the online-softmax statistics ``(m, l)``, each (B, H, Sq) fp32.
    Inputs may be strided views (e.g. heads split off a (B, S, H*D)
    projection) as long as the last axis is contiguous; the output has the
    same strides as q, so merging the heads back is a view.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return chunked_attention(
            q, k, v, scale=scale, kv_mask=kv_mask, return_stats=return_stats
        )
    width = _needs_padding(q)
    if width is not None and k.shape[-1] == v.shape[-1] == q.shape[-1]:
        out = flash_attention(
            pad_head_dim(q, width), pad_head_dim(k, width), pad_head_dim(v, width),
            scale=scale, kv_mask=kv_mask, return_stats=return_stats,
        )
        D = q.shape[-1]
        return (out[0][..., :D], out[1]) if return_stats else out[..., :D]
    _check(q, k, v, kv_mask)
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    out = torch.empty_like(q)  # q's strides if q is dense, else contiguous
    mask = None
    if kv_mask is not None:
        mask = kv_mask.to(torch.int32).contiguous()
    m = l = None
    if return_stats:
        m = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        l = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    ws = split_workspace(B, H, Sk, D, q.device)[0] if q.dtype == torch.float32 else None
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    err = _library().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        m.data_ptr() if m is not None else None,
        l.data_ptr() if l is not None else None,
        ws.data_ptr() if ws is not None else None,
        ctypes.cast(strides, ctypes.c_void_p),
        B, H, Sq, Sk, D, _DTYPE_CODES[q.dtype], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _check_launch("flash_fwd", err)
    flash_attention.launches += 1
    if return_stats:
        return out, (m, l)
    return out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# Kernel A's fp32 path: split precision (3xTF32). Plain versions of the split
# and of the arithmetic, for the tests and the card's checks; the main path
# calls none of them.
# ---------------------------------------------------------------------------

_TF32_KEEP = -0x2000  # 0xFFFFE000 as int32: sign, exponent, top 10 mantissa bits
_EXPONENT = 0x7F800000


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of fp32 ``x``, the kernel's split to the bit: hi = x rounded
    to TF32 (10 mantissa bits) to nearest, ties away from zero, on the bit
    pattern (truncated where rounding would overflow to inf); lo = x - hi,
    exact in fp32, so hi + lo == x and |lo| <= 2^-11 |x|. inf and NaN give
    hi = x, lo = 0."""
    if x.dtype != torch.float32:
        raise ValueError(f"tf32_split takes fp32, got {x.dtype}")
    bits = x.view(torch.int32)
    special = (bits & _EXPONENT) == _EXPONENT
    rounded = (torch.where(special, 0, bits) + 0x1000) & _TF32_KEEP
    overflow = (rounded & _EXPONENT) == _EXPONENT
    hi_bits = torch.where(special, bits, torch.where(overflow, bits & _TF32_KEEP, rounded))
    hi = hi_bits.view(torch.float32)
    return hi, torch.where(special, torch.zeros_like(x), x - hi)


def _tensor_core_view(x: torch.Tensor) -> torch.Tensor:
    """What a TF32 product reads of an fp32 operand: its top 19 bits."""
    return (x.view(torch.int32) & _TF32_KEEP).view(torch.float32)


def _split_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (fp32) as the kernel forms it: a_lo*b_hi + a_hi*b_lo, then
    a_hi*b_hi, each product of two TF32 values exact in fp32 (three fp32
    matmuls; a TF32 product on the card would round)."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    al, bl = _tensor_core_view(al), _tensor_core_view(bl)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(ah, bh)


def split_precision_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    kv_mask: Optional[torch.Tensor] = None,
    return_stats: bool = False,
):
    """Plain model of kernel A's fp32 path: ``chunked_attention``'s online
    softmax over the same chunks (same masking, stats and output rule) with
    every product of QK^T and PV formed from split operands as the kernel
    forms them (``_split_matmul``). fp32 q, k, v (B, H, S, D)."""
    q_chunk, k_chunk = 512, 1024
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not q.dtype == k.dtype == v.dtype == torch.float32:
        raise ValueError("split_precision_attention_reference takes fp32 q, k, v")
    Sq, Sk = q.shape[2], k.shape[2]
    valid = None if kv_mask is None else (kv_mask != 0)[:, None, None, :]
    outs, ms, ls = [], [], []
    for q0 in range(0, Sq, q_chunk):
        qb = q[:, :, q0 : q0 + q_chunk]
        acc = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
        m = torch.full(qb.shape[:3], NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros(qb.shape[:3], dtype=torch.float32, device=q.device)
        for k0 in range(0, Sk, k_chunk):
            s = _split_matmul(qb, k[:, :, k0 : k0 + k_chunk].transpose(-1, -2)) * scale
            if valid is not None:
                s = torch.where(valid[..., k0 : k0 + k_chunk], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + _split_matmul(p, v[:, :, k0 : k0 + k_chunk])
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
        ms.append(m)
        ls.append(l)
    out = torch.cat(outs, dim=2)
    if return_stats:
        return out, (torch.cat(ms, dim=2), torch.cat(ls, dim=2))
    return out


def split_workspace(B: int, H: int, Sk: int, D: int, device):
    """The fp32 path's workspace, one fp32 allocation, and its four views:
    k_hi, k_lo (B, H, Sk, D) and v^T's hi and lo (B, H, D, Skp), Skp = Sk
    rounded up to a multiple of 8."""
    skp = -(-Sk // 8) * 8
    nk, nv = B * H * Sk * D, B * H * D * skp
    ws = torch.empty(2 * nk + 2 * nv, dtype=torch.float32, device=device)
    views = (
        ws[:nk].view(B, H, Sk, D), ws[nk : 2 * nk].view(B, H, Sk, D),
        ws[2 * nk : 2 * nk + nv].view(B, H, D, skp), ws[2 * nk + nv :].view(B, H, D, skp),
    )
    return ws, views


def vt_key_order(skp: int) -> torch.Tensor:
    """Key at each position of the v^T workspaces: within each group of 8,
    position p holds key (p % 4) * 2 + p // 4."""
    pos = torch.arange(skp)
    return (pos & ~7) | ((pos & 3) << 1) | ((pos >> 2) & 1)


def _split_transposed(x: torch.Tensor):
    """(hi, lo) of x (B, H, S, D) transposed to (B, H, D, Sp), Sp = S rounded
    up to a multiple of 8, its rows in ``vt_key_order`` and zero past S: a
    transposed split workspace tensor as the pre-passes write it."""
    S = x.shape[2]
    sp = -(-S // 8) * 8
    xp = torch.nn.functional.pad(x, (0, 0, 0, sp - S))
    return tf32_split(xp[:, :, vt_key_order(sp).to(x.device)].transpose(-1, -2).contiguous())


def split_kv_reference(k: torch.Tensor, v: torch.Tensor):
    """Plain version of the fp32 path's pre-pass: (k_hi, k_lo, vt_hi, vt_lo)
    as ``split_workspace``'s views hold them after it (keys Sk..Skp-1 of v^T
    zero)."""
    return (*tf32_split(k.contiguous()), *_split_transposed(v))


def tf32_split_kv(k: torch.Tensor, v: torch.Tensor):
    """The fp32 path's pre-pass alone on the card (``flash_attention``
    launches it itself before the mainloop; this is for checking it):
    returns ``split_workspace``'s four views. Not counted as a launch."""
    _check(k, k, v, None)
    if k.dtype != torch.float32:
        raise ValueError("tf32_split_kv: the split pre-pass is the fp32 path's")
    B, H, Sk, D = k.shape
    _, views = split_workspace(B, H, Sk, D, k.device)
    strides = (ctypes.c_longlong * 6)(*k.stride()[:3], *v.stride()[:3])
    err = _library().flash_split_kv(
        k.data_ptr(), v.data_ptr(), views[0].data_ptr(), ctypes.cast(strides, ctypes.c_void_p),
        B, H, Sk, D, torch.cuda.current_stream(k.device).cuda_stream,
    )
    _check_launch("flash_split_kv", err)
    return views


# ---------------------------------------------------------------------------
# Kernels C and D's fp32 path: split precision (3xTF32), as kernel A's. The
# workspace of their pre-pass, and plain versions of the pre-pass and of the
# arithmetic for the tests (the main path calls neither).
# ---------------------------------------------------------------------------

BWD_STEP = 32  # rows of the walked axis a step of kernel C or D reads


def bwd_split_workspace(B: int, H: int, S: int, D: int, n_transposed: int, device) -> torch.Tensor:
    """The fp32 workspace of one launch of kernel C or D, one flat fp32
    tensor (no views: a launch of a small shape is host-bound, and views
    cost microseconds each): hi, lo of the two walked inputs (B, H, S, D)
    each, then hi, lo of the first ``n_transposed`` of them transposed,
    (B, H, D, Sp) with Sp = S rounded up to a multiple of 8. Kernel C: q and
    dO, both transposed, S = Sq; kernel D: k (transposed) and v, S = Sk."""
    sp = -(-S // 8) * 8
    n = B * H * D * (4 * S + 2 * n_transposed * sp)
    return torch.empty(n, dtype=torch.float32, device=device)


def bwd_split_reference(x0: torch.Tensor, x1: torch.Tensor, n_transposed: int):
    """Plain version of kernels C and D's pre-pass: the tensors of
    ``bwd_split_workspace`` in its order, as it leaves them. The transposed
    tensors hold the rows of each group of 8 in ``vt_key_order`` (the order
    of an accumulator's columns as A fragments) and zeros for rows S..Sp-1."""
    out = [*tf32_split(x0.contiguous()), *tf32_split(x1.contiguous())]
    for x in (x0, x1)[:n_transposed]:
        out += _split_transposed(x)
    return tuple(out)


def split_precision_attention_bwd_reference(q, k, v, o, m, l, do, scale: Optional[float] = None):
    """Plain model of kernels C and D's fp32 path, fp32 inputs as
    ``attention_bwd_reference`` takes them; returns (dq, dk, dv). C walks the
    queries and D the keys in steps of ``BWD_STEP`` rows; every product is
    formed from split operands as the kernels form it (``_split_matmul``;
    the kernels split their resident inputs with tf32_split's finite form,
    the same bits for finite inputs), and each step's share of dK and dV (C)
    or dQ (D) is a product of its own (a fresh accumulator on the card)
    added to the sum in fp32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if not all(x.dtype == torch.float32 for x in (q, k, v, o, do)):
        raise ValueError("split_precision_attention_bwd_reference takes fp32 inputs")
    lse, delta = bwd_row_stats(o, m, l, do)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for q0 in range(0, q.shape[2], BWD_STEP):  # kernel C: S^T, dP^T against one step of queries
        qs = slice(q0, q0 + BWD_STEP)
        qt, dot = q[:, :, qs], do[:, :, qs]
        pt = torch.exp(_split_matmul(k, qt.transpose(-1, -2)) * scale - lse[:, :, None, qs])
        dpt = _split_matmul(v, dot.transpose(-1, -2))
        dv += _split_matmul(pt, dot)
        dk += _split_matmul(pt * (dpt - delta[:, :, None, qs]) * scale, qt)
    for k0 in range(0, k.shape[2], BWD_STEP):  # kernel D: S, dP against one step of keys
        kt, vt = k[:, :, k0 : k0 + BWD_STEP], v[:, :, k0 : k0 + BWD_STEP]
        p = torch.exp(_split_matmul(q, kt.transpose(-1, -2)) * scale - lse[..., None])
        dp = _split_matmul(do, vt.transpose(-1, -2))
        dq += _split_matmul(p * (dp - delta[..., None]) * scale, kt)
    return dq, dk, dv


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    do: torch.Tensor,
    scale: Optional[float] = None,
):
    """Gradients (dq, dk, dv) from the forward's residuals and stats.

    q, o, do (B, H, Sq, D); k, v (B, H, Sk, D); m, l (B, H, Sq) fp32 as
    ``flash_attention(return_stats=True)`` gives them. The row log-sum-exp
    L = m + log l and delta = sum_d dO*O are computed here in plain torch
    (as XLA does for the TPU kernels); kernel C then writes dk and dv,
    kernel D dq. Gradients take the dtypes and, where dense, the strides of
    q, k and v. dO must have q's dtype and a layout the kernels read
    (``kernel_takes_layout``).
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, o, m, l, do, scale)
    width = _needs_padding(q)
    if width is not None and all(x.shape[-1] == q.shape[-1] for x in (k, v, o, do)):
        D = q.shape[-1]
        grads = flash_attention_bwd(
            *(pad_head_dim(x, width) for x in (q, k, v, o)), m, l, pad_head_dim(do, width), scale,
        )
        return tuple(g[..., :D] for g in grads)
    B, H, Sq, _ = q.shape
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"flash_attention_bwd: {name} {tuple(x.shape)} {x.dtype} must match "
                f"q {tuple(q.shape)} {q.dtype} on {q.device}"
            )
    for name, x in (("m", m), ("l", l)):
        if x.shape != (B, H, Sq) or x.dtype != torch.float32 or x.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} must be (B, H, Sq) fp32")
    lse, delta = (x.contiguous() for x in bwd_row_stats(o, m, l, do))
    return flash_attention_bwd_from_stats(q, k, v, do, lse, delta, scale)


def flash_attention_bwd_from_stats(q, k, v, do, lse, delta, scale: float):
    """Kernels C (dk, dv) and D (dq) from given row statistics: the
    log-sum-exp L and delta = sum_d dO*O, (B, H, Sq) fp32, which may be
    those of a longer key sequence than ``k`` (one KV shard of the ring
    backward, ``ops/attention.py:ring_attention_trainable``). The same
    checks, padding and gradient dtypes as ``flash_attention_bwd``."""
    width = _needs_padding(q)
    if width is not None and all(x.shape[-1] == q.shape[-1] for x in (k, v, do)):
        D = q.shape[-1]
        grads = flash_attention_bwd_from_stats(
            *(pad_head_dim(x, width) for x in (q, k, v, do)), lse, delta, scale,
        )
        return tuple(g[..., :D] for g in grads)
    _check(q, k, v, None)
    if q.dtype == torch.float16:
        raise ValueError("flash_attention_bwd: kernels C and D take bf16 or fp32, not fp16")
    if do.shape != q.shape or do.dtype != q.dtype or not kernel_takes_layout(do):
        raise ValueError(
            f"flash_attention_bwd: do {tuple(do.shape)} {do.dtype} (strides {do.stride()}) must "
            f"match q {tuple(q.shape)} {q.dtype}, with a contiguous last axis and 16-byte "
            "aligned strides and address"
        )
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != q.shape[:3] or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"flash_attention_bwd: {name} must be (B, H, Sq) fp32 contiguous")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    launch_bwd_kernels(q, k, v, do, lse, delta, dq, dk, dv, scale)
    return dq, dk, dv


def launch_bwd_kernels(q, k, v, do, lse, delta, dq, dk, dv, scale, which=("dkv", "dq")):
    """Launch kernel C (writes dk, dv) and/or kernel D (writes dq) on
    checked inputs, lse and delta (B, H, Sq) fp32 contiguous; each launch
    adds one to its counter. ``flash_attention_bwd`` is the checked entry;
    this one lets a benchmark time the two kernels apart."""
    B, H, Sq, D = q.shape
    strides = (ctypes.c_longlong * 21)(
        *(s for x in (q, k, v, do, dq, dk, dv) for s in x.stride()[:3])
    )
    common = (
        ctypes.cast(strides, ctypes.c_void_p), B, H, Sq, k.shape[2], D,
        _DTYPE_CODES[q.dtype], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    inputs = (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(),
    )
    lib = _bwd_library()
    f32 = q.dtype == torch.float32
    # fp32: each kernel's split workspace, allocated for its launch and
    # released before the next (kernel C's 4.3 GB, D's 3.2 GB at Stage-I self)
    if "dkv" in which:
        ws = bwd_split_workspace(B, H, Sq, D, 2, q.device) if f32 else None
        err = lib.flash_bwd_dkv(
            *inputs, dk.data_ptr(), dv.data_ptr(), ws.data_ptr() if f32 else None, *common
        )
        _check_launch("flash_bwd_dkv", err)
        flash_attention_bwd.dkv_launches += 1
        del ws
    if "dq" in which:
        ws = bwd_split_workspace(B, H, k.shape[2], D, 1, q.device) if f32 else None
        err = lib.flash_bwd_dq(*inputs, dq.data_ptr(), ws.data_ptr() if f32 else None, *common)
        _check_launch("flash_bwd_dq", err)
        flash_attention_bwd.dq_launches += 1


flash_attention_bwd.dkv_launches = 0
flash_attention_bwd.dq_launches = 0


class _FlashAttentionTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, (m, l) = flash_attention(q, k, v, scale=scale, return_stats=True)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        # The gradient of out.transpose(1, 2).reshape(B, S, H*D) arrives as a
        # strided view with a contiguous last axis, which the kernels read in
        # place; any other layout is copied to a contiguous one here.
        do = do.to(q.dtype)
        if not kernel_takes_layout(do):
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, m, l, do, ctx.scale)
        return dq, dk, dv, None


def flash_attention_trainable(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """Attention with the O(S)-memory flash backward, no kv mask.

    Port of ``actionmesh_tpu/ops/flash_attention_bwd.py:
    flash_attention_trainable``. On CUDA tensors the forward is kernel A
    with its stats and the backward kernels C and D; on CPU tensors the
    plain version, ``chunked_attention_trainable``.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return chunked_attention_trainable(q, k, v, scale)
    return _FlashAttentionTrainable.apply(q, k, v, scale)


# ---------------------------------------------------------------------------
# Kernel F: self-attention with fp32 rms qk-norm + interleaved RoPE first
# ---------------------------------------------------------------------------


def norm_rope_interleaved(x, norm_scale, cos, sin, eps: float = 1e-6):
    """Plain version of kernel F's pre-pass: fp32 rms-norm over D times
    ``norm_scale``, then interleaved RoPE, rounded once to x.dtype (the TPU
    kernel's ``_norm_rope`` + astype). x (B, H, S, D), cos/sin (B, S, D)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps) * norm_scale.float()
    return apply_rotary_embedding(xf, cos.float(), sin.float(), layout="interleaved").to(x.dtype)


def flash_attention_fused_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    q_norm_scale: torch.Tensor,
    k_norm_scale: torch.Tensor,
    scale: Optional[float] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain version of kernel F: rms-norm, interleaved RoPE, then
    ``chunked_attention``; normalised q and k are rounded to the input dtype
    before the scores, as the kernel rounds them."""
    qn = norm_rope_interleaved(q, q_norm_scale, cos, sin, eps)
    kn = norm_rope_interleaved(k, k_norm_scale, cos, sin, eps)
    return chunked_attention(qn, kn, v, scale=scale)


def _check_fused(q, k, v, cos, sin, q_norm_scale, k_norm_scale):
    _check(q, k, v, None)
    B, H, S, D = q.shape
    if k.shape != q.shape:
        raise ValueError(
            f"flash_attention_fused: self-attention only, q {tuple(q.shape)} "
            f"k {tuple(k.shape)}"
        )
    for name, t in (("cos", cos), ("sin", sin)):
        if (
            t.shape != (B, S, D) or t.dtype != torch.float32 or not t.is_contiguous()
            or t.device != q.device or t.data_ptr() % 16
        ):
            raise ValueError(
                f"flash_attention_fused: {name} must be a contiguous 16-byte aligned "
                f"(B, S, D) = {(B, S, D)} fp32 tensor on {q.device}; got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}"
            )
    for name, t in (("q_norm_scale", q_norm_scale), ("k_norm_scale", k_norm_scale)):
        if (
            t.shape != (D,) or t.dtype != torch.float32 or not t.is_contiguous()
            or t.device != q.device
        ):
            raise ValueError(
                f"flash_attention_fused: {name} must be a contiguous ({D},) fp32 "
                f"tensor on {q.device}; got {tuple(t.shape)} {t.dtype}"
            )


def flash_attention_fused(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    q_norm_scale: torch.Tensor,
    k_norm_scale: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Self-attention with fp32 rms qk-norm and interleaved RoPE fused in.

    Port of ``actionmesh_tpu/ops/flash_attention.py:flash_attention_fused``.
    q, k, v (B, H, S, D) pre-norm projections, bf16, fp16 or fp32, strided views
    with a contiguous last axis allowed; cos/sin (B, S, D) fp32 interleaved
    tables; q_norm_scale, k_norm_scale (D,) fp32. Returns (B, H, S, D) in
    q.dtype with q's strides where q is dense. On the card the normalised
    and rotated q and k go through two (B, H, S, D) workspaces allocated
    here, then kernel A's mainloop.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_fused_reference(
            q, k, v, cos, sin, q_norm_scale, k_norm_scale, scale=scale
        )
    _check_fused(q, k, v, cos, sin, q_norm_scale, k_norm_scale)
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    qn, kn = torch.empty((2, B, H, S, D), dtype=q.dtype, device=q.device)
    ws = split_workspace(B, H, S, D, q.device)[0] if q.dtype == torch.float32 else None
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    err = _library().flash_fused(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), qn.data_ptr(), kn.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), q_norm_scale.data_ptr(), k_norm_scale.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        ctypes.cast(strides, ctypes.c_void_p),
        B, H, S, D, _DTYPE_CODES[q.dtype], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _check_launch("flash_fused", err)
    flash_attention_fused.launches += 1
    return out


flash_attention_fused.launches = 0
