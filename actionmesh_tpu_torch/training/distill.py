"""Distillation recipes for the Stage-I temporal denoiser (and the Stage-0
DiT, which is the denoiser at T = 1).

Counterpart of ``actionmesh_tpu/training/distill.py``, the same two recipes:

  * **Guidance distillation**: the student regresses the teacher's
    CFG-guided velocity ``v_u + s (v_c - v_u)``, so inference runs one
    conditional forward a step instead of the two-branch CFG batch.
  * **Progressive distillation** on the additive rectified-flow Euler
    sampler: from ``x_t`` at an even schedule index ``j`` the teacher takes
    two Euler steps (conditioning frames re-frozen after each) and the
    student regresses the secant ``(x'' - x_t) / (dist_j + dist_{j+1})`` at
    ``ts[j]``, so it covers two teacher steps in one. The halved schedule
    is every second point of the full one, so an even ``num_teacher_steps``
    halves exactly; odd counts are refused.

The teacher runs without gradient (``torch.no_grad``) with the inference
attention (kernel A, as JAX's ``teacher_attn_impl="auto"``); only the
student takes the trainable attention and remat. Random draws come from an
explicit CPU ``torch.Generator``; the ``*_from_draws`` functions take them
as tensors, so a test can pass JAX's own. ``mesh=`` runs teacher and
student on the device mesh (``shard_params`` trees, whole batches and
draws on every rank, as ``training/flow_train.py`` does).
"""

from __future__ import annotations

from typing import Optional

import torch

from actionmesh_tpu_torch.models.denoiser import DenoiserConfig, denoiser_forward
from actionmesh_tpu_torch.sampling.flow_schedule import get_schedule
from actionmesh_tpu_torch.training.flow_train import (
    NUM_TRAIN_TIMESTEPS,
    cast_params_for_compute,
    make_step,
    masked_velocity_mse,
    sample_flow_sigma,
)

def _cast(params, compute_dtype: Optional[torch.dtype]):
    return params if compute_dtype is None else cast_params_for_compute(params, compute_dtype)


def _freeze_conditioning(x, x0, mask):
    """Conditioning frames (mask 1) stay clean, as the sampler freezes them."""
    if mask is None:
        return x
    m = mask.float()[:, :, None, None]
    return x * (1.0 - m) + x0 * m


@torch.no_grad()
def teacher_velocity(
    teacher_params,
    cfg: DenoiserConfig,
    x_t: torch.Tensor,
    context: torch.Tensor,
    framestep: torch.Tensor,
    diffusion_time: torch.Tensor,
    mask: Optional[torch.Tensor],
    *,
    guidance_scale: Optional[float],
    mesh=None,
) -> torch.Tensor:
    """The teacher's velocity (fp32), without gradient.

    With ``guidance_scale`` set: the reference two-branch batch (the
    unconditional branch zeroes the image context and keeps the latent
    mask; its cross-attention is skipped) aggregated as
    ``v_u + s (v_c - v_u)``. With None: one conditional forward.
    """
    in_dtype = teacher_params["proj_in"]["weight"].dtype
    if guidance_scale is None:
        v = denoiser_forward(
            teacher_params, cfg, x_t.to(in_dtype), context.to(in_dtype), framestep,
            diffusion_time, mask, mesh=mesh,
        )
        return v.float()
    B = x_t.shape[0]
    pred = denoiser_forward(
        teacher_params,
        cfg,
        torch.cat([x_t, x_t]).to(in_dtype),
        torch.cat([torch.zeros_like(context), context]).to(in_dtype),
        torch.cat([framestep, framestep]),
        torch.cat([diffusion_time, diffusion_time]),
        None if mask is None else torch.cat([mask, mask]),
        uncond_batch=B,
        mesh=mesh,
    ).float()
    uncond, cond = pred[:B], pred[B:]
    return uncond + guidance_scale * (cond - uncond)


def draw_guidance_noise(gen: torch.Generator, latent_shape, shift: float = 3.0) -> dict:
    """sigma (B,) of the shifted training density, then noise like the
    latents, on the CPU."""
    sigma = sample_flow_sigma(gen, latent_shape[0], shift)
    return {"sigma": sigma, "noise": torch.randn(tuple(latent_shape), generator=gen)}


def draw_progressive_noise(gen: torch.Generator, latent_shape, num_teacher_steps: int) -> dict:
    """An even schedule index j (B,) in [0, num_teacher_steps), then noise
    like the latents, on the CPU."""
    j = 2 * torch.randint(0, num_teacher_steps // 2, (latent_shape[0],), generator=gen)
    return {"j": j, "noise": torch.randn(tuple(latent_shape), generator=gen)}


def guidance_targets(
    teacher_params,
    cfg: DenoiserConfig,
    batch: dict,
    sigma: torch.Tensor,
    noise: torch.Tensor,
    *,
    guidance_scale: float = 7.5,
    mesh=None,
) -> dict:
    """The student's input and target for guidance distillation: x_t at
    sigma (conditioning frames clean), its diffusion time and the teacher's
    guided velocity there."""
    x0 = batch["latents"].float()
    mask = batch.get("mask")
    s = sigma[:, None, None, None]
    x_t = _freeze_conditioning((1.0 - s) * x0 + s * noise, x0, mask)
    t = sigma * NUM_TRAIN_TIMESTEPS
    v = teacher_velocity(
        teacher_params, cfg, x_t, batch["context"], batch["framestep"], t, mask,
        guidance_scale=guidance_scale, mesh=mesh,
    )
    return {"x_t": x_t, "t": t, "v": v}


def progressive_targets(
    teacher_params,
    cfg: DenoiserConfig,
    batch: dict,
    j: torch.Tensor,
    noise: torch.Tensor,
    *,
    num_teacher_steps: int = 30,
    teacher_guidance_scale: Optional[float] = None,
    shift: float = 3.0,
    mesh=None,
) -> dict:
    """The student's input and target for progressive distillation: x_t at
    ``ts[j]``, two teacher Euler steps from it, and their secant."""
    if num_teacher_steps % 2 != 0:
        raise ValueError(f"num_teacher_steps={num_teacher_steps} must be even")
    x0 = batch["latents"].float()
    device = x0.device
    mask = batch.get("mask")
    ts_np, dist_np = get_schedule(num_teacher_steps, int(NUM_TRAIN_TIMESTEPS), shift)
    ts = torch.as_tensor(ts_np, dtype=torch.float32, device=device)
    dist = torch.as_tensor(dist_np, dtype=torch.float32, device=device)
    j = j.to(device)
    t_j, t_j1 = ts[j], ts[j + 1]
    d_j, d_j1 = dist[j][:, None, None, None], dist[j + 1][:, None, None, None]

    sigma = (t_j / NUM_TRAIN_TIMESTEPS)[:, None, None, None]
    x_t = _freeze_conditioning((1.0 - sigma) * x0 + sigma * noise, x0, mask)
    kw = dict(guidance_scale=teacher_guidance_scale, mesh=mesh)
    v1 = teacher_velocity(teacher_params, cfg, x_t, batch["context"], batch["framestep"], t_j, mask, **kw)
    x1 = _freeze_conditioning(x_t + d_j * v1, x0, mask)
    v2 = teacher_velocity(teacher_params, cfg, x1, batch["context"], batch["framestep"], t_j1, mask, **kw)
    x2 = _freeze_conditioning(x1 + d_j1 * v2, x0, mask)
    return {"x_t": x_t, "t": t_j, "v": (x2 - x_t) / (d_j + d_j1)}


def student_loss(
    student_params,
    cfg: DenoiserConfig,
    batch: dict,
    targets: dict,
    *,
    remat: bool = True,
    compute_dtype: Optional[torch.dtype] = None,
    mesh=None,
) -> torch.Tensor:
    """MSE between the student's velocity at (x_t, t) and the target, over
    the non-conditioning frames."""
    fwd = _cast(student_params, compute_dtype)
    in_dtype = fwd["proj_in"]["weight"].dtype
    v_s = denoiser_forward(
        fwd, cfg, targets["x_t"].to(in_dtype), batch["context"].to(in_dtype),
        batch["framestep"], targets["t"], batch.get("mask"), trainable=True, remat=remat,
        mesh=mesh,
    )
    return masked_velocity_mse(v_s, targets["v"], batch.get("mask"))


def guidance_distill_loss_from_draws(
    student_params, teacher_params, cfg: DenoiserConfig, batch: dict,
    sigma: torch.Tensor, noise: torch.Tensor, *,
    guidance_scale: float = 7.5, compute_dtype: Optional[torch.dtype] = None, mesh=None,
) -> torch.Tensor:
    """Guidance distillation's loss with the draws given (sigma (B,),
    noise like the latents)."""
    targets = guidance_targets(
        _cast(teacher_params, compute_dtype), cfg, batch, sigma, noise, guidance_scale=guidance_scale,
        mesh=mesh,
    )
    return student_loss(student_params, cfg, batch, targets, compute_dtype=compute_dtype, mesh=mesh)


def progressive_distill_loss_from_draws(
    student_params, teacher_params, cfg: DenoiserConfig, batch: dict,
    j: torch.Tensor, noise: torch.Tensor, *,
    num_teacher_steps: int = 30, teacher_guidance_scale: Optional[float] = None,
    shift: float = 3.0, compute_dtype: Optional[torch.dtype] = None, mesh=None,
) -> torch.Tensor:
    """Progressive distillation's loss with the draws given (even schedule
    indices j (B,), noise like the latents)."""
    targets = progressive_targets(
        _cast(teacher_params, compute_dtype), cfg, batch, j, noise,
        num_teacher_steps=num_teacher_steps, teacher_guidance_scale=teacher_guidance_scale,
        shift=shift, mesh=mesh,
    )
    return student_loss(student_params, cfg, batch, targets, compute_dtype=compute_dtype, mesh=mesh)


def guidance_distill_loss(
    student_params, teacher_params, cfg: DenoiserConfig, batch: dict, gen: torch.Generator, *,
    compute_dtype: Optional[torch.dtype] = None, mesh=None, **kwargs,
) -> torch.Tensor:
    """Guidance distillation's loss with sigma and noise drawn from the CPU
    generator ``gen`` (``kwargs``: ``distill_targets_fn``'s)."""
    targets = distill_targets_fn(cfg, _cast(teacher_params, compute_dtype), mode="guidance",
                                 mesh=mesh, **kwargs)
    return student_loss(student_params, cfg, batch, targets(batch, gen), compute_dtype=compute_dtype,
                        mesh=mesh)


def progressive_distill_loss(
    student_params, teacher_params, cfg: DenoiserConfig, batch: dict, gen: torch.Generator, *,
    compute_dtype: Optional[torch.dtype] = None, mesh=None, **kwargs,
) -> torch.Tensor:
    """Progressive distillation's loss with j and noise drawn from the CPU
    generator ``gen`` (``kwargs``: ``distill_targets_fn``'s)."""
    targets = distill_targets_fn(cfg, _cast(teacher_params, compute_dtype), mode="progressive",
                                 mesh=mesh, **kwargs)
    return student_loss(student_params, cfg, batch, targets(batch, gen), compute_dtype=compute_dtype,
                        mesh=mesh)


def distill_targets_fn(
    cfg: DenoiserConfig,
    teacher_params,
    *,
    mode: str = "guidance",
    guidance_scale: float = 7.5,
    num_teacher_steps: int = 30,
    teacher_guidance_scale: Optional[float] = None,
    shift: float = 3.0,
    mesh=None,
):
    """``(batch, gen) -> targets`` of ``mode``, drawing from ``gen``, with
    the teacher tree as given (already cast for compute)."""
    if mode == "guidance":

        def targets(batch, gen):
            device = batch["latents"].device
            d = draw_guidance_noise(gen, batch["latents"].shape, shift)
            return guidance_targets(teacher_params, cfg, batch, d["sigma"].to(device),
                                    d["noise"].to(device), guidance_scale=guidance_scale, mesh=mesh)

    elif mode == "progressive":
        if num_teacher_steps % 2 != 0:
            raise ValueError(f"num_teacher_steps={num_teacher_steps} must be even")

        def targets(batch, gen):
            d = draw_progressive_noise(gen, batch["latents"].shape, num_teacher_steps)
            return progressive_targets(
                teacher_params, cfg, batch, d["j"], d["noise"].to(batch["latents"].device),
                num_teacher_steps=num_teacher_steps, teacher_guidance_scale=teacher_guidance_scale,
                shift=shift, mesh=mesh,
            )

    else:
        raise ValueError(f"unknown distillation mode: {mode!r}")
    return targets


def make_distill_step(
    cfg: DenoiserConfig,
    optimizer,
    teacher_params,
    *,
    mode: str = "guidance",
    guidance_scale: float = 7.5,
    num_teacher_steps: int = 30,
    teacher_guidance_scale: Optional[float] = None,
    shift: float = 3.0,
    compute_dtype: Optional[torch.dtype] = None,
    ema_decay: Optional[float] = None,
    time_phases: bool = False,
    mesh=None,
    shardings=None,
):
    """The distillation step, ``(state, batch, gen) -> (state, loss)``
    (``make_step`` with the teacher's targets as its gradient-free phase,
    ``teacher_s`` when timed). The teacher is cast to ``compute_dtype``
    once, here, not every step (the same numbers). ``mesh`` and
    ``shardings``: ``make_step``'s; the teacher is a ``shard_params`` tree
    of the same layout."""
    targets = distill_targets_fn(
        cfg, _cast(teacher_params, compute_dtype), mode=mode, guidance_scale=guidance_scale,
        num_teacher_steps=num_teacher_steps, teacher_guidance_scale=teacher_guidance_scale,
        shift=shift, mesh=mesh,
    )

    def loss_fn(params, batch, t):
        return student_loss(params, cfg, batch, t, compute_dtype=compute_dtype, mesh=mesh)

    return make_step(loss_fn, optimizer, prepare=targets, ema_decay=ema_decay, time_phases=time_phases,
                     mesh=mesh, shardings=shardings)
