"""Hunyuan3D-2.1's shape DiT as a configuration of the flow transformer.

tencent/Hunyuan3D-2.1, ``hunyuan3d-dit-v2-1/config.yaml`` and
``hy3dshape/models/denoisers/hunyuandit.py`` (``HunYuanDiTPlain``): the
Stage-I denoiser's code (``models/denoiser.py``) at T = 1 with no RoPE, as
TripoSG's DiT is. 21 blocks of width 2,048, 16 heads of 128, U-skips from
block 20 - l into block l > 10, a diffusion-time token ([cos | sin]
embedding, erf GELU), per-head rms-norm on q and k, q, k and v without
bias, layer norms at eps 1e-6, erf-GELU MLPs, cross-attention to DINOv2-L
at 518^2 (1,370 tokens of 1,024) and 4,096 latents of 64 channels. Its last
6 blocks (15..20) hold the sparse-expert feed-forward of
``hy3dshape/models/denoisers/moe_layers.py`` in place of the dense one: 8
experts of 2,048 -> 8,192 -> 2,048, a softmax router's top 2 a token
(weights not renormalised) and one shared expert of the same shape
(``models/layers.py:moe_feed_forward``). The forward is TripoSG's
(``models/triposg/dit.py:triposg_dit_forward``).
"""

from __future__ import annotations

from actionmesh_tpu_torch.models.denoiser import ExpertDenoiserConfig


def hunyuan3d_dit_config(
    num_tokens: int = 4096,
    in_channels: int = 64,
    num_layers: int = 21,
    width: int = 2048,
    num_attention_heads: int = 16,
    cross_attention_dim: int = 1024,
    mlp_ratio: float = 4.0,
    num_moe_layers: int = 6,
    num_experts: int = 8,
    moe_top_k: int = 2,
) -> ExpertDenoiserConfig:
    """The DiT at one frame; the last ``num_moe_layers`` blocks hold experts."""
    return ExpertDenoiserConfig(
        num_tokens_nominal=num_tokens,
        temporal_context_size=1,
        in_channels=in_channels,
        num_layers=num_layers,
        num_attention_heads=num_attention_heads,
        width=width,
        mlp_ratio=mlp_ratio,
        cross_attention_dim=cross_attention_dim,
        inflated_layers=(),
        gelu_approx=False,
        moe_layers=tuple(range(num_layers - num_moe_layers, num_layers)),
        num_experts=num_experts,
        moe_top_k=moe_top_k,
        norm_eps=1e-6,
        flip_sin_to_cos=True,
    )
