"""The optimizer of the JAX training loop, written as optax computes it.

``actionmesh_tpu/training/loop.py:make_optimizer`` chains
``optax.clip_by_global_norm`` and ``optax.adamw`` on a
``warmup_cosine_decay_schedule`` with init 0, wrapped in
``optax.MultiSteps`` for gradient accumulation. This module does the same
arithmetic on lists of torch tensors, in place, where ``torch.optim`` would
differ:

  * the schedule starts at 0, so the first update leaves the params as they
    are, and it counts optimizer updates, not micro-steps;
  * clipping scales by max/||g|| when ||g|| >= max, with no epsilon (unlike
    ``torch.nn.utils.clip_grad_norm_``);
  * AdamW's weight decay is added to the Adam direction before the learning
    rate (decoupled, every leaf decayed), bias corrections as optax;
  * gradient accumulation averages micro-batch gradients by Welford's
    update and applies one update every ``grad_accum`` micro-steps.

On a device mesh the params, moments and accumulator are the rank's
``shard_params`` slices and the gradients are summed over dp and sp
already (``parallel/mesh.py:sync_grads``); only the clip's global norm
needs the other ranks: it is the whole model's (``global_grad_norm``).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from actionmesh_tpu_torch.parallel.mesh import global_grad_norm
from actionmesh_tpu_torch.utils.tree import leaves, tree_map

# optax.adamw's defaults, which the JAX loop uses
B1, B2, EPS = 0.9, 0.999, 1e-8


def warmup_cosine_decay_schedule(
    init_value: float,
    peak_value: float,
    warmup_steps: int,
    decay_steps: int,
    end_value: float = 0.0,
    exponent: float = 1.0,
) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine to ``end_value`` at
    ``decay_steps`` (which counts the warmup), constant after."""
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"decay_steps={decay_steps} must exceed warmup_steps={warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine**exponent + alpha)

    return schedule


class AdamW:
    """Global-norm clip -> AdamW(schedule) [-> every-k gradient averaging].

    ``init(params)`` gives the state tree; ``update(grads, state, params)``
    takes lists of tensors in the params tree's leaf order and updates the
    params and the state in place. On a mesh, ``split`` marks the leaves
    cut over tp (``parallel/mesh.py:tp_split_leaves``), whose squares the
    global norm sums over tp.
    """

    def __init__(
        self,
        schedule: Callable[[int], float],
        clip_norm: float,
        weight_decay: float,
        grad_accum: int = 1,
    ):
        if grad_accum < 1:
            raise ValueError(f"grad_accum={grad_accum} must be >= 1")
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.weight_decay = weight_decay
        self.grad_accum = grad_accum

    def init(self, params) -> dict:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
        state = {"count": 0, "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}
        if self.grad_accum > 1:
            state.update(mini_step=0, gradient_step=0, acc_grads=tree_map(zeros, params))
        return state

    @torch.no_grad()
    def update(self, grads, state: dict, params, mesh=None, split=None) -> None:
        if self.grad_accum > 1:
            n = state["mini_step"]
            acc = leaves(state["acc_grads"])
            for a, g in zip(acc, grads):
                a.add_((g - a) / (n + 1))
            state["mini_step"] = (n + 1) % self.grad_accum
            if n != self.grad_accum - 1:
                return  # no update on this micro-step
            grads = acc
            state["gradient_step"] += 1

        gnorm = global_grad_norm(grads, mesh, split)
        if gnorm >= self.clip_norm:
            grads = [g / gnorm * self.clip_norm for g in grads]
        lr = self.schedule(state["count"])
        state["count"] += 1
        c1 = 1.0 - B1 ** state["count"]
        c2 = 1.0 - B2 ** state["count"]
        for p, g, mu, nu in zip(params, grads, leaves(state["mu"]), leaves(state["nu"])):
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            u = (mu / c1) / (torch.sqrt(nu / c2) + EPS) + self.weight_decay * p
            p.add_(u, alpha=-lr)
        if self.grad_accum > 1:
            for a in leaves(state["acc_grads"]):
                a.zero_()
