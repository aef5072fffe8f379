"""Weights made from the seed, on the device, in the release's names and
shapes (``reference/layout.py``), in the type they are served in.

Each network is one flat buffer filled by one uniform draw in [-1, 1) from
a device generator (in slices of 2^28 values), then cut into views, each
starting on a 256-byte boundary, and scaled in place by its kind: a linear
weight or bias to +-1/sqrt(fan_in), a norm weight to 1 +- 0.1, a norm bias
to +-0.1, a layer scale to [0.05, 0.3], an embedding table to +-0.5 (a
``head`` to a tenth of a linear's range). The
port and the reference read the same tensors.
"""

from __future__ import annotations

import math

import torch

from portbench.bench.traffic import derive
from portbench.reference import layout

ALIGN = 128  # elements: 256 bytes of bf16
SLICE = 1 << 28


def make_state(lay: layout.Layout, seed: int, device, dtype: torch.dtype) -> dict:
    sizes = [math.prod(shape) for shape, _ in lay.values()]
    total = sum(-(-n // ALIGN) * ALIGN for n in sizes)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for off in range(0, total, SLICE):
        n = min(SLICE, total - off)
        flat[off:off + n] = torch.rand(n, generator=gen, device=device).mul_(2).sub_(1)
    state, off = {}, 0
    for (name, (shape, kind)), n in zip(lay.items(), sizes):
        t = flat[off:off + n].view(shape)
        off += -(-n // ALIGN) * ALIGN
        if kind in ("linear", "bias", "head"):
            w_shape = lay[name[: -len("bias")] + "weight"][0] if name.endswith("bias") else shape
            t.mul_((0.1 if kind == "head" else 1.0) / math.sqrt(layout.fan_in(w_shape)))
        elif kind == "norm_w":
            t.mul_(0.1).add_(1.0)
        elif kind == "norm_b":
            t.mul_(0.1)
        elif kind == "scale":
            t.mul_(0.125).add_(0.175)
        elif kind == "embed":
            t.mul_(0.5)
        else:
            raise ValueError(f"unknown kind {kind!r} of {name}")
        state[name] = t
    return state


def make_states(layouts: dict[str, layout.Layout], seed: int, device, dtype: torch.dtype) -> dict:
    """{network: state dict}, each network's draw seeded by its name."""
    return {net: make_state(lay, derive(seed, f"weights:{net}"), device, dtype)
            for net, lay in layouts.items()}
