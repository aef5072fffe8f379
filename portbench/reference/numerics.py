"""Precision of the plain reference: every product in fp32, or in fp8.

The reference runs every matrix product through ``mm`` and passes every
activation it keeps (a linear's or an attention's output, a norm's output,
the residual stream after each block's additions) through ``act``. In
``fp32`` mode both are float32 and TF32 is off, so the products are exact
float32 arithmetic. In ``fp8`` mode (the control) each product's operands
are first rounded to float8 e4m3 with one scale per tensor, its largest
magnitude mapped to e4m3's largest finite value (448), as fp8 inference
does, and the product of the rounded values is taken in float32; each
kept activation is rounded the same way, as the program keeps its
activations in its dtype. The arithmetic inside a norm, the softmax, the
embeddings and the sampler's update stay float32 in both modes.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
MODES = ("fp32", "fp8")
_mode = "fp32"


def disable_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@contextlib.contextmanager
def precision(mode: str):
    """Run the enclosed reference code with products in ``mode``."""
    global _mode
    if mode not in MODES:
        raise ValueError(f"unknown precision {mode!r}; one of {MODES}")
    disable_tf32()
    saved, _mode = _mode, mode
    try:
        yield
    finally:
        _mode = saved


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under one per-tensor scale, returned as float32."""
    x = x.float()
    amax = x.abs().amax()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def operand(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return fp8_round(x) if _mode == "fp8" else x


def act(x: torch.Tensor) -> torch.Tensor:
    """A kept activation: float32, or rounded to e4m3 in fp8 mode."""
    return fp8_round(x) if _mode == "fp8" else x.float()


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (batched as torch.matmul) in the current mode."""
    return torch.matmul(operand(a), operand(b))


def linear(x: torch.Tensor, weight: torch.Tensor, bias=None) -> torch.Tensor:
    """x @ weight.T + bias, weight (out, in) as stored in the release."""
    y = mm(x, weight.t())
    return act(y if bias is None else y + bias.float())
