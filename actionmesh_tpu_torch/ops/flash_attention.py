"""Flash attention forward: wrapper of the Hopper kernel in ``csrc/flash_fwd.cu``.

Replaces ``actionmesh_tpu/ops/flash_attention.py:flash_attention_pipelined``
and ``flash_attention`` (the Pallas TPU kernels) with one CUDA kernel that
meets both contracts; see the note at the top of the CUDA source for its
design. On CPU tensors the wrapper runs the plain version,
``ops/attention.py:chunked_attention``; on CUDA tensors it launches the
kernel or raises. ``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from actionmesh_tpu_torch.ops.attention import chunked_attention

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_HEAD_DIMS = (64, 128)
_lib = None


def _library():
    global _lib
    if _lib is None:
        from actionmesh_tpu_torch.utils.cuda_build import load_library

        lib = load_library("flash_fwd")
        lib.flash_fwd.argtypes = (
            [ctypes.c_void_p] * 7
            + [ctypes.c_void_p]  # strides (host int64[12])
            + [ctypes.c_int] * 6
            + [ctypes.c_float, ctypes.c_void_p]
        )
        lib.flash_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q, k, v, kv_mask):
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention: q, k, v must all be CUDA tensors")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: dtypes {q.dtype}/{k.dtype}/{v.dtype}; the kernel "
            "takes bf16 or fp32, the same for q, k and v"
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
        raise ValueError(f"flash_attention: head dim {D} not in {_HEAD_DIMS}")
    if k.shape[2] == 0:
        raise ValueError("flash_attention: empty key sequence")
    if B > 65535 or H > 65535:  # grid z and y
        raise ValueError(f"flash_attention: batch {B} or heads {H} above 65535")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s last axis must be contiguous")
        # 16-byte vector loads of K/V rows and 4-byte loads of Q pairs
        if any(s % 8 for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(
                f"flash_attention: {name} strides {x.stride()} or its address "
                "are not 16-byte aligned"
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
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    err = _library().flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        m.data_ptr() if m is not None else None,
        l.data_ptr() if l is not None else None,
        ctypes.cast(strides, ctypes.c_void_p),
        B, H, Sq, Sk, D, _DTYPE_CODES[q.dtype], float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: CUDA error {err}")
    flash_attention.launches += 1
    if return_stats:
        return out, (m, l)
    return out


flash_attention.launches = 0
