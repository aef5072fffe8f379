"""DINOv2 vision transformer (ViT-L/14), the Stage I conditioning encoder.

Counterpart of ``actionmesh_tpu/models/dinov2.py``: patch 14, width 1024,
24 layers, 16 heads, MLP x4, LayerScale, CLS token, learned position
embedding resampled to the input grid. The patch embedding is a linear over
flattened (P, P, 3) patches: the same product as the JAX conv, with no
cuDNN convolution and hence no TF32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from actionmesh_tpu_torch.models.layers import (
    Params,
    init_layer_norm,
    init_linear,
    layer_norm,
    linear,
)
from actionmesh_tpu_torch.ops.attention import dot_product_attention


@dataclasses.dataclass(frozen=True)
class DinoV2Config:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_ratio: int = 4
    patch_size: int = 14
    image_size: int = 518  # the checkpoint's position-embedding grid (37x37)
    layerscale_init: float = 1.0e-5
    eps: float = 1e-6


def init_dinov2(
    gen: torch.Generator,
    cfg: DinoV2Config,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> Params:
    """Random development weights drawn from ``gen``."""
    n_patches = (cfg.image_size // cfg.patch_size) ** 2
    w = cfg.hidden_size
    p = cfg.patch_size

    def block():
        return {
            "norm1": init_layer_norm(w, device),
            "attention": {
                name: init_linear(gen, w, w, dtype=dtype, device=device)
                for name in ("query", "key", "value", "output")
            },
            "layer_scale1": {
                "lambda1": torch.full((w,), cfg.layerscale_init, device=device)
            },
            "norm2": init_layer_norm(w, device),
            "mlp": {
                "fc1": init_linear(gen, w, w * cfg.mlp_ratio, dtype=dtype, device=device),
                "fc2": init_linear(gen, w * cfg.mlp_ratio, w, dtype=dtype, device=device),
            },
            "layer_scale2": {
                "lambda1": torch.full((w,), cfg.layerscale_init, device=device)
            },
        }

    def normal(shape):
        if torch.device(device or "cpu").type == "meta":  # a shape-only tree: meta randn costs seconds
            return torch.empty(shape, device=device)
        return torch.randn(shape, generator=gen, device=device) * 0.02

    return {
        "patch_embed": {
            # (W, P*P*3): the HWIO conv kernel flattened, as utils/weights.py makes it
            "weight": normal((w, p * p * 3)).to(dtype),
            "bias": torch.zeros(w, dtype=dtype, device=device),
        },
        "cls_token": torch.zeros((1, 1, w), device=device),
        "pos_embed": normal((1, n_patches + 1, w)),
        "blocks": [block() for _ in range(cfg.num_layers)],
        "norm": init_layer_norm(w, device),
    }


def resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) fp32 weights of ``jax.image.resize(..., "bicubic")`` on one axis.

    jax resamples with the Keys cubic kernel (a = -0.5) and, when
    downsampling, widens the kernel by in/out (antialiasing); weights are
    normalised per output sample. This is not
    ``F.interpolate(mode="bicubic")``, which uses a = -0.75.
    """
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(out_size) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(in_size)[:, None]) / kernel_scale
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = np.where(x >= 2.0, 0.0, w)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        w / np.where(total != 0, total, 1),
        0.0,
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    w = np.where(inside[None, :], w, 0.0)
    return np.ascontiguousarray(w.T.astype(np.float32))


def interpolate_pos_embed(pos_embed: torch.Tensor, grid: int) -> torch.Tensor:
    """Resample the (1, 1 + g*g, W) patch grid to ``grid`` x ``grid``."""
    src = int(math.sqrt(pos_embed.shape[1] - 1))
    if src == grid:
        return pos_embed
    r = torch.as_tensor(resize_matrix(src, grid), device=pos_embed.device)
    patch = pos_embed[0, 1:].float().reshape(src, src, -1)
    patch = torch.einsum("ia,abw->ibw", r, patch)
    patch = torch.einsum("jb,ibw->ijw", r, patch)
    return torch.cat(
        [pos_embed[:, :1], patch.reshape(1, grid * grid, -1).to(pos_embed.dtype)], dim=1
    )


def dinov2_forward(
    params: Params, cfg: DinoV2Config, pixel_values: torch.Tensor
) -> torch.Tensor:
    """pixel_values (B, H, W, 3) normalised -> last hidden state (B, S, W)."""
    B, H, W, _ = pixel_values.shape
    p = cfg.patch_size
    grid = H // p
    patches = (
        pixel_values[:, : grid * p, : grid * p]
        .reshape(B, grid, p, grid, p, 3)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(B, grid * grid, p * p * 3)
    )
    x = linear(params["patch_embed"], patches)

    cls = params["cls_token"].to(x.dtype).expand(B, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = x + interpolate_pos_embed(params["pos_embed"], grid).to(x.dtype)

    heads = cfg.num_heads
    dim_head = cfg.hidden_size // heads
    S = x.shape[1]
    for blk in params["blocks"]:
        h = layer_norm(blk["norm1"], x, eps=cfg.eps)
        q, k, v = (
            linear(blk["attention"][n], h).view(B, S, heads, dim_head).transpose(1, 2)
            for n in ("query", "key", "value")
        )
        att = dot_product_attention(q, k, v)
        att = linear(blk["attention"]["output"], att.transpose(1, 2).reshape(B, S, -1))
        x = x + att * blk["layer_scale1"]["lambda1"].to(att.dtype)
        h = layer_norm(blk["norm2"], x, eps=cfg.eps)
        h = linear(blk["mlp"]["fc2"], F.gelu(linear(blk["mlp"]["fc1"], h)))
        x = x + h * blk["layer_scale2"]["lambda1"].to(h.dtype)
    return layer_norm(params["norm"], x, eps=cfg.eps)
