"""Rectified-flow training step for the Stage-I temporal denoiser.

Counterpart of ``actionmesh_tpu/training/flow_train.py``, same objective:
``x_sigma = (1 - sigma) x0 + sigma noise`` with velocity target
``v = x0 - noise``; ground-truth conditioning frames (mask 1) enter clean
and are left out of the loss; per-sample context dropout with probability
``p_uncond`` trains the unconditional CFG branch.

Params stay fp32 masters, cast for compute with the norm leaves kept fp32;
every block rematerialises (``torch.utils.checkpoint``) so the 33k-token
backward fits the card; attention takes the O(S)-memory flash backward
(kernels C and D on the card, the plain version on the CPU).

Random draws (sigma, noise, context dropout) come from an explicit CPU
``torch.Generator`` and are then moved to the device, so the card and the
CPU see the same numbers. They cannot be the numbers ``jax.random`` draws:
``flow_matching_loss_from_draws`` takes them as tensors, so a test can pass
JAX's own.

On a device mesh (``mesh=``) the params and the optimizer state are the
rank's ``shard_params`` slices. Every rank draws for the whole batch from
the same generator and passes whole tensors to ``denoiser_forward``, which
runs the rank's (batch, frame) shard and gathers the prediction, so the
sharded step sees the draws of the unsharded one (as JAX's GSPMD step
does) and every rank computes the same loss. ``make_step`` sums the
gradients over dp and sp (``sync_grads``) before the optimizer.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from actionmesh_tpu_torch.models.denoiser import DenoiserConfig, denoiser_forward
from actionmesh_tpu_torch.parallel.mesh import sync_grads, tp_split_leaves
from actionmesh_tpu_torch.utils.tree import leaves, map_with_path, tree_map

NUM_TRAIN_TIMESTEPS = 1000.0  # the sampler's diffusion-time scale


def sample_flow_sigma(gen: torch.Generator, batch: int, shift: float = 3.0) -> torch.Tensor:
    """Per-sample sigma in (0, 1]: uniform draws in [1e-4, 1) mapped through
    the inference schedule's shift transform."""
    u = torch.rand(batch, generator=gen, dtype=torch.float32) * (1.0 - 1e-4) + 1e-4
    return shift * u / (1.0 + (shift - 1.0) * u)


def draw_flow_noise(gen: torch.Generator, latent_shape, p_uncond: float, shift: float = 3.0) -> dict:
    """sigma (B,), noise (B,T,N,C) and the context-drop flags (B,), on the CPU."""
    B = latent_shape[0]
    sigma = sample_flow_sigma(gen, B, shift)
    noise = torch.randn(tuple(latent_shape), generator=gen, dtype=torch.float32)
    drop = torch.rand(B, generator=gen) < p_uncond
    return {"sigma": sigma, "noise": noise, "drop": drop}


def masked_velocity_mse(
    v_pred: torch.Tensor, v_target: torch.Tensor, mask: Optional[torch.Tensor]
) -> torch.Tensor:
    """Mean squared error over non-conditioning frames (mask (B, T), 1 =
    ground-truth frame, excluded). All-masked batches give 0, not NaN."""
    err = (v_pred.float() - v_target.float()) ** 2
    if mask is None:
        return err.mean()
    w = 1.0 - mask.float()
    num = torch.einsum("btnc,bt->", err, w)
    den = w.sum() * err.shape[2] * err.shape[3]
    return num / torch.clamp(den, min=1.0)


def cast_params_for_compute(params, dtype=torch.bfloat16):
    """Float leaves cast to ``dtype``; leaves under a key containing "norm"
    stay fp32 (the inference storage convention). Differentiable."""

    def cast(path: str, p: torch.Tensor) -> torch.Tensor:
        if "norm" in path or not p.is_floating_point():
            return p
        return p.to(dtype)

    return map_with_path(cast, params)


def flow_matching_loss_from_draws(
    params,
    cfg: DenoiserConfig,
    batch: dict,
    sigma: torch.Tensor,
    noise: torch.Tensor,
    drop: Optional[torch.Tensor],
    *,
    remat: bool = True,
    compute_dtype: Optional[torch.dtype] = None,
    mesh=None,
) -> torch.Tensor:
    """Rectified-flow MSE for one batch with the random draws given.

    batch: ``latents`` (B,T,N,C), ``context`` (B,T,S,D_ctx), ``framestep``
    (B,T), optional ``mask`` (B,T). sigma (B,), noise like latents, drop (B,)
    bool or None (no context dropout). Attention is the trainable one
    (JAX's ``auto_train``); ``remat`` recomputes each block in the backward.
    ``mesh``: whole batch and draws, ``shard_params`` params (see the
    module's note).
    """
    x0 = batch["latents"].float()
    mask = batch.get("mask")
    s = sigma[:, None, None, None]
    x_t = (1.0 - s) * x0 + s * noise
    v_target = x0 - noise
    if mask is not None:
        m = mask.float()[:, :, None, None]
        x_t = x_t * (1.0 - m) + x0 * m  # conditioning frames enter clean

    context = batch["context"]
    if drop is not None:
        context = context * (1.0 - drop.to(context.dtype))[:, None, None, None]

    fwd_params = params if compute_dtype is None else cast_params_for_compute(params, compute_dtype)
    in_dtype = fwd_params["proj_in"]["weight"].dtype
    v_pred = denoiser_forward(
        fwd_params, cfg, x_t.to(in_dtype), context.to(in_dtype), batch["framestep"],
        sigma * NUM_TRAIN_TIMESTEPS, mask, trainable=True, remat=remat, mesh=mesh,
    )
    return masked_velocity_mse(v_pred, v_target, mask)


def flow_matching_loss(
    params,
    cfg: DenoiserConfig,
    batch: dict,
    gen: torch.Generator,
    *,
    p_uncond: float = 0.1,
    shift: float = 3.0,
    **kwargs,
) -> torch.Tensor:
    """``flow_matching_loss_from_draws`` with sigma (of the ``shift``
    schedule), noise and the context drop drawn from the CPU generator
    ``gen``."""
    device = batch["latents"].device
    draws = draw_flow_noise(gen, batch["latents"].shape, p_uncond, shift)
    return flow_matching_loss_from_draws(
        params, cfg, batch,
        draws["sigma"].to(device), draws["noise"].to(device),
        draws["drop"].to(device) if p_uncond > 0.0 else None,
        **kwargs,
    )


def init_train_state(params, optimizer, ema_decay: Optional[float] = None) -> dict:
    """{'params', 'opt_state', 'step'[, 'ema_params']}. The params are
    copied to fp32 leaves that require grad; ``ema_decay`` adds an EMA
    shadow of them (pass the same value to ``make_train_step``). On a mesh
    pass the rank's ``shard_params`` slices: the moments, the accumulator
    and the EMA then take the same slices, as JAX's
    ``optimizer_state_shardings`` lays them out."""
    params = tree_map(lambda p: p.detach().to(torch.float32, copy=True).requires_grad_(True), params)
    state = {"params": params, "opt_state": optimizer.init(params), "step": 0}
    if ema_decay is not None:
        state["ema_params"] = tree_map(lambda p: p.detach().clone(), params)
    return state


def make_step(
    loss_fn,
    optimizer,
    *,
    prepare=None,
    ema_decay: Optional[float] = None,
    time_phases: bool = False,
    mesh=None,
    shardings=None,
):
    """The train step of every stage: ``(state, batch, gen) -> (state, loss)``.

    ``loss_fn(params, batch, aux)`` is the loss of the fp32 masters, with
    ``aux = prepare(batch, gen)`` computed without gradients where
    ``prepare`` is given (a teacher's targets), else ``aux = gen``. Then
    the gradients, the optimizer and the EMA update the state in place (JAX
    donates the state; here the buffers are reused). ``time_phases``
    synchronises the device around each phase and leaves their host-clock
    seconds in ``step.last_timing`` (``teacher_s`` for ``prepare``,
    ``forward_s``, ``backward_s``, ``update_s``). ``mesh`` with
    ``shardings`` (the spec tree the params were cut by): the gradients are
    summed over dp and sp before the optimizer, whose clip takes the whole
    model's norm.
    """
    split = None if mesh is None else tp_split_leaves(shardings, mesh)

    def clock(device) -> float:
        if time_phases and device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    def step(state: dict, batch: dict, gen: torch.Generator):
        params = leaves(state["params"])
        device = params[0].device
        timing = {}
        t0 = clock(device)
        aux = gen
        if prepare is not None:
            with torch.no_grad():
                aux = prepare(batch, gen)
            t_prepared = clock(device)
            timing["teacher_s"], t0 = t_prepared - t0, t_prepared
        loss = loss_fn(state["params"], batch, aux)
        t1 = clock(device)
        grads = torch.autograd.grad(loss, params)
        if mesh is not None:
            grads = sync_grads(grads, mesh)
        t2 = clock(device)
        with torch.no_grad():
            optimizer.update(grads, state["opt_state"], params, mesh=mesh, split=split)
            if ema_decay is not None:
                for e, p in zip(leaves(state["ema_params"]), params):
                    e.mul_(ema_decay).add_(p, alpha=1.0 - ema_decay)
        state["step"] += 1
        t3 = clock(device)
        if time_phases:
            step.last_timing = {**timing, "forward_s": t1 - t0, "backward_s": t2 - t1, "update_s": t3 - t2}
        return state, loss.detach()

    step.last_timing = None
    return step


def make_train_step(
    cfg: DenoiserConfig,
    optimizer,
    *,
    p_uncond: float = 0.1,
    shift: float = 3.0,
    compute_dtype: Optional[torch.dtype] = None,
    ema_decay: Optional[float] = None,
    time_phases: bool = False,
    mesh=None,
    shardings=None,
):
    """The Stage-I train step (``make_step``): the rectified-flow loss with
    remat of the fp32 masters, cast for compute to ``compute_dtype``, then
    clip, AdamW and the EMA. ``mesh`` and ``shardings``: ``make_step``'s."""

    def loss_fn(params, batch, gen):
        return flow_matching_loss(
            params, cfg, batch, gen, p_uncond=p_uncond, shift=shift, compute_dtype=compute_dtype,
            mesh=mesh,
        )

    return make_step(loss_fn, optimizer, ema_decay=ema_decay, time_phases=time_phases,
                     mesh=mesh, shardings=shardings)
