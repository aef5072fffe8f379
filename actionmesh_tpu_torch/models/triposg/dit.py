"""TripoSG rectified-flow DiT (image -> 3D latent velocity).

Counterpart of ``actionmesh_tpu/models/triposg/dit.py``. The single-shape
DiT is the Stage-I denoiser (``models/denoiser.py``) at T = 1 with no
inflated (temporal) layers and so no RoPE: the same 21-block, width-2048
U-ViT with the diffusion-time token and DINOv2 cross-attention.
"""

from __future__ import annotations

from typing import Optional

import torch

from actionmesh_tpu_torch.models.denoiser import DenoiserConfig, denoiser_forward, init_denoiser
from actionmesh_tpu_torch.models.layers import Params


def triposg_dit_config(
    num_tokens: int = 2048,
    in_channels: int = 64,
    num_layers: int = 21,
    width: int = 2048,
    num_attention_heads: int = 16,
    cross_attention_dim: int = 1024,
    mlp_ratio: float = 4.0,
) -> DenoiserConfig:
    """Single-shape DiT = denoiser with no inflated (temporal) layers."""
    return DenoiserConfig(
        num_tokens_nominal=num_tokens,
        temporal_context_size=1,
        in_channels=in_channels,
        num_layers=num_layers,
        num_attention_heads=num_attention_heads,
        width=width,
        mlp_ratio=mlp_ratio,
        cross_attention_dim=cross_attention_dim,
        inflated_layers=(),  # no cross-frame attention, no RoPE
    )


def init_triposg_dit(
    gen: torch.Generator,
    cfg: DenoiserConfig,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> Params:
    return init_denoiser(gen, cfg, dtype=dtype, device=device)


def triposg_dit_forward(
    params: Params,
    cfg: DenoiserConfig,
    latents: torch.Tensor,
    context: torch.Tensor,
    diffusion_time: torch.Tensor,
    uncond_batch: int = 0,
    mesh=None,
) -> torch.Tensor:
    """One velocity prediction: latents (B, N, C), context (B, S, Dc),
    diffusion_time (B,) -> (B, N, C).

    ``uncond_batch``: leading batch entries whose context is all zero (the
    CFG unconditional branch); their cross-attention is skipped, as it
    reduces exactly to the out-projection bias. ``mesh``: as
    ``denoiser_forward``'s (whole tensors in and out, ``shard_params``
    weights).
    """
    B = latents.shape[0]
    out = denoiser_forward(
        params,
        cfg,
        latents[:, None],  # (B, 1, N, C): one "frame"
        context[:, None],
        framestep=torch.zeros((B, 1), dtype=torch.float32, device=latents.device),
        diffusion_time=diffusion_time,
        uncond_batch=uncond_batch,
        mesh=mesh,
    )
    return out[:, 0]
