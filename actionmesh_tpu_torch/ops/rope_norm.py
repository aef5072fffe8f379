"""Fused per-head qk RMS-norm + half-layout RoPE: a Triton kernel for Hopper.

Replaces ``actionmesh_tpu/ops/rope_norm.py:fused_rms_rope`` (the Pallas TPU
kernel ``_norm_rope_kernel``). The op reads each (row, head) vector of D=64
or 128 values once, normalises it in fp32, rotates it and writes it once:
no matrix product, so it is bound by device-memory bandwidth. One Triton
program covers BLOCK_S rows of one (batch, head); heads vary fastest across
programs, so the fp32 cos/sin rows, shared by all heads, are read from
device memory once and from L2 for the other heads.

On CPU tensors the wrapper runs the plain version, ``rms_rope_reference``;
on CUDA tensors it launches the kernel or raises.
``fused_rms_rope.launches`` counts kernel launches. Where a gradient is
needed the op is a ``torch.autograd.Function`` whose backward is the vjp of
``rms_rope_reference``, recomputed from the saved inputs, as the JAX custom
VJP is (``actionmesh_tpu/ops/rope_norm.py:_fused_bwd``): the TPU has no
Pallas backward for it either.
"""

from __future__ import annotations

from typing import Optional

import torch

from actionmesh_tpu_torch.ops.rotary import apply_rotary_embedding

_BLOCK_S = 32
_kernel = None


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


def _build_kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def rms_rope_kernel(
        x_ptr, o_ptr, scale_ptr, cos_ptr, sin_ptr,
        S, cb, eps,
        x_sb, x_sh, x_ss, o_sb, o_sh, o_ss, t_sb, t_ss,
        D: tl.constexpr, HALF: tl.constexpr, BLOCK_S: tl.constexpr,
        WITH_NORM: tl.constexpr, WITH_ROPE: tl.constexpr,
    ):
        h = tl.program_id(0)
        rows = tl.program_id(1) * BLOCK_S + tl.arange(0, BLOCK_S)
        b = tl.program_id(2)
        cols = tl.arange(0, HALF)
        rmask = (rows < S)[:, None]
        xp = x_ptr + b * x_sb + h * x_sh + rows[:, None] * x_ss + cols[None, :]
        x1 = tl.load(xp, mask=rmask, other=0.0).to(tl.float32)
        x2 = tl.load(xp + HALF, mask=rmask, other=0.0).to(tl.float32)
        if WITH_NORM:
            var = (tl.sum(x1 * x1, axis=1) + tl.sum(x2 * x2, axis=1)) / D
            r = (1.0 / tl.sqrt(var + eps))[:, None]
            w1 = tl.load(scale_ptr + cols)[None, :]
            w2 = tl.load(scale_ptr + HALF + cols)[None, :]
            x1 = x1 * r * w1
            x2 = x2 * r * w2
        if WITH_ROPE:
            tp = (b % cb) * t_sb + rows[:, None] * t_ss + cols[None, :]
            c1 = tl.load(cos_ptr + tp, mask=rmask, other=0.0)
            c2 = tl.load(cos_ptr + tp + HALF, mask=rmask, other=0.0)
            s1 = tl.load(sin_ptr + tp, mask=rmask, other=0.0)
            s2 = tl.load(sin_ptr + tp + HALF, mask=rmask, other=0.0)
            y1 = x1 * c1 - x2 * s1
            y2 = x2 * c2 + x1 * s2
            x1 = y1
            x2 = y2
        op = o_ptr + b * o_sb + h * o_sh + rows[:, None] * o_ss + cols[None, :]
        tl.store(op, x1.to(o_ptr.dtype.element_ty), mask=rmask)
        tl.store(op + HALF, x2.to(o_ptr.dtype.element_ty), mask=rmask)

    return rms_rope_kernel


def _check(x, scale, cos, sin):
    if x.ndim != 4:
        raise ValueError(f"fused_rms_rope: x must be (B, H, S, D), got {tuple(x.shape)}")
    B, H, S, D = x.shape
    if D not in (64, 128):
        raise ValueError(f"fused_rms_rope: head dim {D} not in (64, 128)")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"fused_rms_rope: unsupported dtype {x.dtype}")
    if x.stride(3) != 1:
        raise ValueError("fused_rms_rope: x's last axis must be contiguous")
    # grid (H, S / BLOCK_S, B) limits, and 32-bit offsets inside the kernel
    if B > 65535 or -(-S // _BLOCK_S) > 65535 or x.numel() >= 2**31:
        raise ValueError(f"fused_rms_rope: shape {tuple(x.shape)} too large")
    if scale is not None and (
        scale.shape != (D,) or scale.dtype != torch.float32
        or not scale.is_contiguous() or scale.device != x.device
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


class _RmsRope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, cos, sin, eps):
        ctx.save_for_backward(x, scale, cos, sin)
        ctx.eps = eps
        return _rms_rope_forward(x, scale, cos, sin, eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            inputs = [
                None if t is None else t.detach().requires_grad_(need)
                for t, need in zip(saved, ctx.needs_input_grad)
            ]
            out = rms_rope_reference(*inputs, ctx.eps)
            wrt = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return (
            *(next(grads) if t is not None and t.requires_grad else None for t in inputs),
            None,
        )


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


def _rms_rope_forward(x, scale, cos, sin, eps):
    if x.device.type == "cpu":
        return rms_rope_reference(x, scale, cos, sin, eps)
    if not x.is_cuda:
        raise ValueError(f"fused_rms_rope: unsupported device {x.device}")
    _check(x, scale, cos, sin)
    global _kernel
    if _kernel is None:
        _kernel = _build_kernel()
    B, H, S, D = x.shape
    out = torch.empty_like(x)  # x's strides if x is dense, else contiguous
    with_rope = cos is not None
    if with_rope and cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    dummy = out  # never read when its step is off
    grid = (H, (S + _BLOCK_S - 1) // _BLOCK_S, B)
    _kernel[grid](
        x, out,
        scale if scale is not None else dummy,
        cos if with_rope else dummy,
        sin if with_rope else dummy,
        S, cos.shape[0] if with_rope else 1, eps,
        *x.stride()[:3], *out.stride()[:3],
        cos.stride(0) if with_rope else 0, cos.stride(1) if with_rope else 0,
        D=D, HALF=D // 2, BLOCK_S=_BLOCK_S,
        WITH_NORM=scale is not None, WITH_ROPE=with_rope,
        num_warps=4,
    )
    fused_rms_rope.launches += 1
    return out


fused_rms_rope.launches = 0
