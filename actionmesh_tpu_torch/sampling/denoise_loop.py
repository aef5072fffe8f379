"""Stage I flow-matching Euler sampler for one AR window.

Counterpart of ``actionmesh_tpu/sampling/denoise_loop.py``: a Python loop
over steps (PyTorch runs eagerly; JAX scans). The CFG branch batch and the
RoPE tables are built once per window. The schedule and the Euler update
are fp32; frames with mask=1 are frozen. ``split_cfg_batch`` runs the
guidance branches one at a time instead of as one batch. Under a device
mesh every rank runs the same loop on the same latents: each step's
``denoiser_forward(mesh=)`` splits the CFG branch batch over dp and the
window's frames over sp and gathers the prediction, so the guidance mix and
the Euler update see every branch and frame, and every rank's latents stay
the same.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from actionmesh_tpu_torch.models.denoiser import (
    DenoiserConfig,
    denoiser_forward,
    precompute_freqs_rot,
)
from actionmesh_tpu_torch.sampling.guidance import ClassifierFreeGuidance
from actionmesh_tpu_torch.utils.profiling import span


def get_noise(
    generator: torch.Generator,
    latent_shape: tuple[int, ...],
    batch_size: int,
    n_timesteps: int,
    corr_noise: float = 0.0,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """Noise with optional temporal correlation: a shared draw (B, 1, ...)
    then an independent one, from ``generator`` on its own device, moved to
    ``device``. A CPU generator gives the same noise on every device."""
    if not 0.0 <= corr_noise <= 1.0:
        raise ValueError(f"corr_noise must lie in [0, 1], got {corr_noise}")
    shape = (batch_size, n_timesteps) + tuple(latent_shape)
    same = torch.randn(
        (batch_size, 1) + tuple(latent_shape), generator=generator,
        dtype=dtype, device=generator.device,
    )
    ind = torch.randn(shape, generator=generator, dtype=dtype, device=generator.device)
    noise = math.sqrt(corr_noise) * same.expand(shape) + math.sqrt(1.0 - corr_noise) * ind
    return noise.to(device)


def denoise_window(
    params,
    dcfg: DenoiserConfig,
    guidance: ClassifierFreeGuidance,
    init_latent: torch.Tensor,
    context: torch.Tensor,
    mask: Optional[torch.Tensor],
    framestep: torch.Tensor,
    timesteps: torch.Tensor,
    distances: torch.Tensor,
    is_additive: bool = True,
    split_cfg_batch: bool = False,
    mesh=None,
) -> torch.Tensor:
    """Denoise one AR window.

    init_latent (B, T, N, D): conditioning latents where mask=1, noise
    elsewhere; context (B, T, S, Dc); mask (B, T); framestep (B, T);
    timesteps (steps+1,) and distances (steps,) fp32. Returns (B, T, N, D).

    ``split_cfg_batch``: run the guidance branches one after the other, each
    on its own slice of the RoPE tables, context, framestep and mask, and
    concatenate the predictions (the reference's low-RAM mode, reference
    ``scheduler.py:139-170``; ``actionmesh_tpu/sampling/denoise_loop.py``
    does the same), so only one branch's activations are live at a time.

    ``mesh``: a ``parallel/mesh.py`` device mesh and ``params`` this rank's
    ``shard_params`` slices; the inputs are the whole tensors, the same on
    every rank (the noise from one seeded generator), and so is the result.

    Each step runs in a ``stage1_step`` span (``utils/profiling.py``).
    """
    B, T, N, _ = init_latent.shape
    compute_dtype = init_latent.dtype
    _, context_g, mask_g, framestep_g = guidance.cfg_at_inference(
        init_latent, context, mask, framestep
    )
    unobserved = guidance.get_unobserved_mask(mask)
    freqs_rot = precompute_freqs_rot(dcfg, framestep_g, N)
    g = guidance.n_branches
    mask_f = mask_g.to(compute_dtype) if mask_g is not None else None
    timesteps = timesteps.to(torch.float32)
    distances = distances.to(torch.float32)

    latents = init_latent
    for i in range(distances.shape[0]):
        with span("stage1_step"):
            if split_cfg_batch and g > 1:
                preds = []
                for b in range(g):
                    sl = slice(b * B, (b + 1) * B)
                    preds.append(denoiser_forward(
                        params,
                        dcfg,
                        latents,
                        context_g[sl],
                        framestep_g[sl],
                        timesteps[i].expand(B),
                        mask=mask_f[sl] if mask_f is not None else None,
                        freqs_rot=tuple(f[sl] for f in freqs_rot),
                        mesh=mesh,
                    ))
                pred = torch.cat(preds, dim=0)
            else:
                hidden = torch.cat([latents] * g, dim=0)
                pred = denoiser_forward(
                    params,
                    dcfg,
                    hidden,
                    context_g,
                    framestep_g,
                    timesteps[i].expand(g * B),
                    mask=mask_f,
                    freqs_rot=freqs_rot,
                    uncond_batch=guidance.leading_uncond_image_branches * B,
                    mesh=mesh,
                )
            pred32 = guidance.aggregate_cfg(pred).float()
            lat32 = latents.float()
            sign = 1.0 if is_additive else -1.0
            stepped = (lat32 + sign * distances[i] * pred32).to(compute_dtype)
            if unobserved is not None:
                latents = torch.where(unobserved[..., None, None], stepped, latents)
            else:
                latents = stepped
    return latents
