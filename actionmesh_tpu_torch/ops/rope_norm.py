"""Fused per-head qk RMS-norm + half-layout RoPE: kernel B, the wrapper of
the Hopper kernels in ``csrc/rms_rope.cu`` (forward and backward) and their
plain PyTorch versions.

Replaces ``actionmesh_tpu/ops/rope_norm.py:fused_rms_rope`` (the Pallas TPU
kernel ``_norm_rope_kernel``). The op reads each (row, head) vector of D
values (D in ``HEAD_DIMS``) once, normalises it in fp32, rotates it and
writes it once:
no matrix product, so it is bound by device-memory bandwidth. See the note
at the top of the CUDA source for the design.

On CPU tensors the wrapper runs the plain versions, ``rms_rope_reference``
and, for the gradient, ``rms_rope_backward_reference``; on CUDA tensors it
launches the kernels or raises. Where a gradient is needed the op is a
``torch.autograd.Function`` whose backward kernel recomputes the norm from
the saved inputs, as the JAX custom VJP does
(``actionmesh_tpu/ops/rope_norm.py:_fused_bwd``). ``fused_rms_rope.launches``
counts forward launches, ``fused_rms_rope.bwd_launches`` backward calls (a
call launches the backward kernel and its fixed-order sums). Under a device
mesh the layers call it on the rank's local shard, with the tables the
model-level functions cut to the shard's rows.
"""

from __future__ import annotations

import ctypes
import struct
from array import array
from typing import Optional

import torch

from actionmesh_tpu_torch.ops.rotary import apply_rotary_embedding

_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
HEAD_DIMS = (12, 16, 32, 64, 128)  # the kernels' instantiations
_lib = None
_bwd_ws_rows = 0


def _library():
    global _lib, _bwd_ws_rows
    if _lib is None:
        from actionmesh_tpu_torch.utils.cuda_build import load_library

        lib = load_library("rms_rope")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rms_rope_fwd.argtypes = [ptr]
        lib.rms_rope_fwd.restype = i32
        lib.rms_rope_bwd.argtypes = [ptr] * 12 + [i32] * 6 + [ctypes.c_float, ptr]
        lib.rms_rope_bwd.restype = i32
        lib.rms_rope_bwd_ws_rows.restype = i32
        _bwd_ws_rows = lib.rms_rope_bwd_ws_rows()
        _lib = lib
    return _lib


def rms_rope_reference(
    x: torch.Tensor,
    scale: Optional[torch.Tensor],
    cos: Optional[torch.Tensor],
    sin: Optional[torch.Tensor],
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain version: fp32 rms-norm over D (times ``scale``), then rotation.

    x (B, H, S, D); cos/sin (S, D) or (B, S, D) fp32 half-layout tables;
    either step is skipped when its argument is None. Returns x.dtype.
    """
    xf = x.float()
    if scale is not None:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        xf = xf * torch.rsqrt(var + eps) * scale.float()
    if cos is not None:
        xf = apply_rotary_embedding(xf, cos, sin, layout="half")
    return xf.to(x.dtype)


def _batch_tables(t: torch.Tensor, B: int) -> torch.Tensor:
    """(S, D) or (cb, S, D) -> (B, 1, S, D), table b % cb for entry b."""
    if t.ndim == 2:
        return t[None, None]
    return t.repeat(B // t.shape[0], 1, 1)[:, None]


def rms_rope_backward_reference(
    x: torch.Tensor,
    scale: Optional[torch.Tensor],
    cos: Optional[torch.Tensor],
    sin: Optional[torch.Tensor],
    g: torch.Tensor,
    eps: float = 1e-6,
    table_grads: bool = True,
):
    """Plain version of the backward, the kernel's closed form in fp32.

    With u = x r w, r = rsqrt(mean(x^2) + eps) and halves 1, 2 of D:
    gu = (g1 c1 + g2 s2, g2 c2 - g1 s1) (g without tables); dx = r (gu w) -
    x r^3 mean(gu w x) (gu without scale), in x's dtype; dscale = the sum of
    gu x r over (B, H, S); dcos = g u and dsin = g (-u2, u1), summed over
    the heads and the batch entries that share a table, in the tables'
    shape (only with ``table_grads``). Returns (dx, dscale, dcos, dsin),
    None for what does not apply.
    """
    B, _, _, D = x.shape
    half = D // 2
    xf, gf = x.float(), g.float()
    g1, g2 = gf[..., :half], gf[..., half:]
    if cos is not None:
        c, s = _batch_tables(cos, B), _batch_tables(sin, B)
        gu = torch.cat([g1 * c[..., :half] + g2 * s[..., half:],
                        g2 * c[..., half:] - g1 * s[..., :half]], dim=-1)
    else:
        gu = gf
    dscale = None
    if scale is not None:
        w = scale.float()
        r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        n = xf * r
        dn = gu * w
        dx = r * dn - xf * r**3 * torch.mean(dn * xf, dim=-1, keepdim=True)
        dscale = (gu * n).sum(dim=(0, 1, 2))
        u = n * w
    else:
        dx, u = gu, xf
    dcos = dsin = None
    if cos is not None and table_grads:
        u1, u2 = u[..., :half], u[..., half:]
        per_row_c = torch.cat([g1 * u1, g2 * u2], dim=-1).sum(1)  # (B, S, D)
        per_row_s = torch.cat([-g1 * u2, g2 * u1], dim=-1).sum(1)
        cb = 1 if cos.ndim == 2 else cos.shape[0]
        dcos = per_row_c.view(B // cb, cb, *per_row_c.shape[1:]).sum(0).reshape(cos.shape)
        dsin = per_row_s.view(B // cb, cb, *per_row_s.shape[1:]).sum(0).reshape(sin.shape)
    return dx.to(x.dtype), dscale, dcos, dsin


def _aligned(t: torch.Tensor) -> bool:
    """16-byte aligned rows: the kernels' vector loads and stores. A head
    dim whose halves do not split into 16-byte runs (12) is read with scalar
    accesses, which need no alignment."""
    size = t.element_size()
    if (t.shape[-1] // 2) % (16 // size):
        return True
    sb, sh, ss, _ = t.stride()
    return not (t.data_ptr() | sb * size | sh * size | ss * size) & 15


def _check(x, scale, cos, sin) -> tuple[int, int, int, int]:
    """Raise on what the kernels do not take (reading no device memory);
    the shape (B, H, S, D)."""
    if x.ndim != 4:
        raise ValueError(f"fused_rms_rope: x must be (B, H, S, D), got {tuple(x.shape)}")
    B, H, S, D = x.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"fused_rms_rope: head dim {D} not in {HEAD_DIMS}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"fused_rms_rope: unsupported dtype {x.dtype}")
    if x.stride(3) != 1:
        raise ValueError("fused_rms_rope: x's last axis must be contiguous")
    if B * S >= 2**31:
        raise ValueError(f"fused_rms_rope: shape {tuple(x.shape)} too large")
    if scale is not None and (
        scale.ndim != 1 or scale.shape[0] != D or scale.dtype != torch.float32
        or scale.device != x.device or not scale.is_contiguous()
    ):
        raise ValueError("fused_rms_rope: scale must be a contiguous (D,) fp32 CUDA tensor")
    if (cos is None) != (sin is None):
        raise ValueError("fused_rms_rope: pass both cos and sin, or neither")
    if cos is not None:
        for t in (cos, sin):
            if (
                t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != x.device or t.shape[-2:] != (S, D)
                or t.ndim not in (2, 3) or (t.ndim == 3 and B % t.shape[0])
            ):
                raise ValueError(
                    f"fused_rms_rope: tables must be contiguous fp32 (S, D) or "
                    f"(cb, S, D) with B % cb == 0 on {x.device}; got "
                    f"{tuple(t.shape)} {t.dtype}"
                )
    return B, H, S, D


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _f32_aligned(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """An fp32 operand whose base the kernel reads 16 bytes at a time."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def _stream(x: torch.Tensor) -> int:
    """The current stream of x's device, as the raw handle (the public
    ``torch.cuda.current_stream`` builds a Stream object, a few us a call)."""
    return torch._C._cuda_getCurrentRawStream(x.get_device())


def _check_launch(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


_EPS_BITS: dict[float, int] = {}


def _eps_bits(eps: float) -> int:
    """eps as the bits of an fp32, the kernels' parameter block carries it."""
    bits = _EPS_BITS.get(eps)
    if bits is None:
        bits = _EPS_BITS[eps] = struct.unpack("<i", struct.pack("<f", eps))[0]
    return bits


def _rms_rope_forward(x, scale, cos, sin, eps):
    if x.device.type == "cpu":
        return rms_rope_reference(x, scale, cos, sin, eps)
    if not x.is_cuda:
        raise ValueError(f"fused_rms_rope: unsupported device {x.device}")
    B, H, S, D = _check(x, scale, cos, sin)
    lib = _library()
    # Kept short: a call at the DiT's small rows is ~10 us of device time,
    # so the host's work per call counts. No device memory is read.
    if not _aligned(x):
        x = x.contiguous() if not x.is_contiguous() else x.clone()
    sp = cp = sn = 0
    cb = 1
    if scale is not None:
        sp = scale.data_ptr()
    if cos is not None:
        cp, sn = cos.data_ptr(), sin.data_ptr()
        if cos.ndim == 3:
            cb = cos.shape[0]
    if (sp | cp | sn) & 15:
        scale, cos, sin = _f32_aligned(scale), _f32_aligned(cos), _f32_aligned(sin)
        sp, cp, sn = _ptr(scale) or 0, _ptr(cos) or 0, _ptr(sin) or 0
    out = torch.empty_like(x)  # x's strides if x is dense, else contiguous
    xs, os_ = x.stride(), out.stride()
    params = array("q", (
        x.data_ptr(), out.data_ptr(), sp, cp, sn, xs[0], xs[1], xs[2], os_[0], os_[1], os_[2],
        B, H, S, D, cb, _DTYPES[x.dtype], _eps_bits(eps), _stream(x),
    ))
    _check_launch("fused_rms_rope", lib.rms_rope_fwd(params.buffer_info()[0]))
    fused_rms_rope.launches += 1
    return out


def _rms_rope_backward(x, scale, cos, sin, g, eps, table_grads):
    """The backward kernel on CUDA tensors: (dx, dscale, dcos, dsin)."""
    lib = _library()
    if g.stride(3) != 1 or not _aligned(g):
        g = g.contiguous() if not g.is_contiguous() else g.clone()
    if not _aligned(x):
        x = x.contiguous() if not x.is_contiguous() else x.clone()
    scale, cos, sin = _f32_aligned(scale), _f32_aligned(cos), _f32_aligned(sin)
    B, H, S, D = x.shape
    dx = torch.empty_like(x)
    dscale = ws = None
    if scale is not None:
        dscale = torch.empty(D, dtype=torch.float32, device=x.device)
        ws = torch.empty((_bwd_ws_rows, D), dtype=torch.float32, device=x.device)
    dcos = dsin = tab_ws = None
    if cos is not None and table_grads:
        dcos, dsin = torch.empty_like(cos), torch.empty_like(sin)
        tab_ws = torch.empty((2, B, S, D), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 9)(*x.stride()[:3], *g.stride()[:3], *dx.stride()[:3])
    err = lib.rms_rope_bwd(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), _ptr(scale), _ptr(cos), _ptr(sin),
        _ptr(dscale), _ptr(dcos), _ptr(dsin), _ptr(ws), _ptr(tab_ws), ctypes.addressof(strides),
        B, H, S, D, 1 if cos is None or cos.ndim == 2 else cos.shape[0], _DTYPES[x.dtype],
        eps, _stream(x),
    )
    _check_launch("fused_rms_rope backward", err)
    fused_rms_rope.bwd_launches += 1
    return dx, dscale, dcos, dsin


class _RmsRope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, cos, sin, eps):
        ctx.save_for_backward(x, scale, cos, sin)
        ctx.eps = eps
        return _rms_rope_forward(x, scale, cos, sin, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale, cos, sin = ctx.saved_tensors
        need = ctx.needs_input_grad
        table_grads = need[2] or need[3]
        if x.device.type == "cpu":
            dx, dscale, dcos, dsin = rms_rope_backward_reference(
                x, scale, cos, sin, g, ctx.eps, table_grads)
        else:
            dx, dscale, dcos, dsin = _rms_rope_backward(
                x, scale, cos, sin, g, ctx.eps, table_grads)
        return (dx if need[0] else None, dscale if need[1] else None,
                dcos if need[2] else None, dsin if need[3] else None, None)


def fused_rms_rope(
    x: torch.Tensor,
    scale: Optional[torch.Tensor],
    cos: Optional[torch.Tensor],
    sin: Optional[torch.Tensor],
    eps: float = 1e-6,
) -> torch.Tensor:
    """rms_norm(x) then half-layout RoPE, fused; either step optional.

    x (B, H, S, D), any strides with a contiguous last axis; scale (D,)
    fp32 or None; cos/sin fp32 (S, D) or (cb, S, D), table b % cb serving
    batch entry b, or None. Returns x.dtype with x's strides.
    Differentiable in x, scale, cos and sin.
    """
    if scale is None and cos is None:
        return x
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, scale, cos, sin)
    ):
        return _RmsRope.apply(x, scale, cos, sin, eps)
    return _rms_rope_forward(x, scale, cos, sin, eps)


fused_rms_rope.launches = 0
fused_rms_rope.bwd_launches = 0
