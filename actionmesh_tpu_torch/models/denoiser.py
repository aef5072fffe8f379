"""Stage I: temporal 3D flow-matching denoiser (DiT).

Counterpart of ``actionmesh_tpu/models/denoiser.py``: 21 blocks, width 2048,
16 heads, MLP x4, 64-channel latents, cross-attention to DINOv2-L (1024);
U-Net long skips (blocks 0-9 push, 11-20 pop and concat); self-attention
inflated across frames (one attention over T*(N+1) = 32,784 tokens per CFG
branch); temporal RoPE from centred video timesteps; a per-frame
diffusion-time token, with the diffusion time zeroed on ground-truth frames.
Under a device mesh the batch (the CFG branches) splits over dp, the frames
over sp (the inflated self-attention then runs the ring) and the heads and
MLP columns over tp (``parallel/mesh.py``).

The same code is Hunyuan3D-2.1's shape DiT (``models/hunyuan3d/dit.py``)
at an ``ExpertDenoiserConfig``: its last blocks (``moe_layers``) hold a
sparse-expert feed-forward (``num_experts`` routed, ``moe_top_k`` a token,
plus a shared one), its layer norms take ``norm_eps`` 1e-6 and its time
embedding is [cos | sin] (``flip_sin_to_cos``). A ``DenoiserConfig`` has
none of these: the Stage-I denoiser and TripoSG's DiT run as before.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from actionmesh_tpu_torch.models.layers import (
    Params,
    flow_matching_block,
    init_flow_matching_block,
    init_layer_norm,
    init_linear,
    layer_norm,
    linear,
    row_parallel_linear,
)
from actionmesh_tpu_torch.ops.embeddings import (
    scale_timestep,
    sinusoidal_timestep_embedding,
)
from actionmesh_tpu_torch.ops.rotary import compute_rotary_embeddings
from actionmesh_tpu_torch.ops.tensor_ops import merge_batch_time, split_batch_time
from actionmesh_tpu_torch.parallel.mesh import (
    axis_size,
    copy_to_tp,
    gather_from,
    local_shard,
    share_grad,
    split_axes,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
    num_tokens_nominal: int = 2048
    temporal_context_size: int = 16
    in_channels: int = 64
    num_layers: int = 21
    num_attention_heads: int = 16
    width: int = 2048
    mlp_ratio: float = 4.0
    cross_attention_dim: int = 1024
    inflated_layers: tuple[int, ...] = tuple(range(21))
    gelu_approx: bool = True
    # no expert blocks, layer norms at eps 1e-5, a [sin | cos] time
    # embedding: class attributes here, fields of ExpertDenoiserConfig, so
    # that this config keeps the JAX package's fields
    moe_layers = ()
    num_experts = 0
    moe_top_k = 2
    norm_eps = 1e-5
    flip_sin_to_cos = False

    @property
    def width_per_head(self) -> int:
        return self.width // self.num_attention_heads

    @property
    def out_channels(self) -> int:
        return self.in_channels


@dataclasses.dataclass(frozen=True)
class ExpertDenoiserConfig(DenoiserConfig):
    """The flow transformer with Hunyuan3D-2.1's options: the blocks
    ``moe_layers`` hold ``num_experts`` routed experts (``moe_top_k`` a
    token) and a shared one in place of the dense feed-forward, the layer
    norms take ``norm_eps``, and ``flip_sin_to_cos`` orders the time
    embedding [cos | sin]."""

    moe_layers: tuple[int, ...] = ()
    num_experts: int = 0
    moe_top_k: int = 2
    norm_eps: float = 1e-5
    flip_sin_to_cos: bool = False


def init_denoiser(
    gen: torch.Generator,
    cfg: DenoiserConfig,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> Params:
    """Random development weights drawn from ``gen``."""
    if cfg.num_layers % 2 == 0:
        logger.warning(
            "num_layers=%d is even: U-skip pairing is asymmetric (layer 0's "
            "skip is unused); the reference architecture uses odd depths (21).",
            cfg.num_layers,
        )
    w = cfg.width
    return {
        "time_proj": {
            "linear_1": init_linear(gen, w, w * 4, dtype=dtype, device=device),
            "linear_2": init_linear(gen, w * 4, w, dtype=dtype, device=device),
        },
        "proj_in": init_linear(gen, cfg.in_channels, w, dtype=dtype, device=device),
        "blocks": [
            init_flow_matching_block(
                gen,
                dim=w,
                num_attention_heads=cfg.num_attention_heads,
                cross_attention_dim=cfg.cross_attention_dim,
                attention_qk_norm=True,
                attention_bias=False,
                ff_inner_dim=int(w * cfg.mlp_ratio),
                skip=layer > cfg.num_layers // 2,
                num_experts=cfg.num_experts if layer in cfg.moe_layers else 0,
                dtype=dtype,
                device=device,
            )
            for layer in range(cfg.num_layers)
        ],
        "norm_out": init_layer_norm(w, device),
        "proj_out": init_linear(gen, w, cfg.out_channels, dtype=dtype, device=device),
    }


def precompute_freqs_rot(
    cfg: DenoiserConfig, framestep: torch.Tensor, n_tokens: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE tables (B, T*(N+1), Dh) fp32 for the inflated sequence layout.

    framestep (B, T) are real video timesteps; each frame's centred value is
    shared by its N+1 tokens.
    """
    B, T = framestep.shape
    positions = merge_batch_time(scale_timestep(framestep, center=True, scale=False))
    cos, sin = compute_rotary_embeddings(cfg.width_per_head, positions)  # (B*T, Dh)
    cos = cos[:, None, :].expand(-1, n_tokens + 1, -1).reshape(B, T * (n_tokens + 1), -1)
    sin = sin[:, None, :].expand(-1, n_tokens + 1, -1).reshape(B, T * (n_tokens + 1), -1)
    return cos, sin


def denoiser_forward(
    params: Params,
    cfg: DenoiserConfig,
    hidden_states: torch.Tensor,
    context: torch.Tensor,
    framestep: torch.Tensor,
    diffusion_time: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    freqs_rot: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    uncond_batch: int = 0,
    trainable: bool = False,
    remat: bool = False,
    mesh=None,
) -> torch.Tensor:
    """One denoising step (velocity prediction).

    hidden_states (B, T, N, D_in); context (B, T, S, D_ctx); framestep (B, T);
    diffusion_time (B,); mask (B, T), 1 = ground-truth frame; ``uncond_batch``
    leading batch entries have all-zero context (their cross-attention is
    skipped). Returns (B, T, N, D_in).

    Training: ``trainable`` takes the attention with the O(S)-memory flash
    backward; ``remat`` recomputes each block in the backward pass
    (``torch.utils.checkpoint``, as ``jax.checkpoint`` in the JAX package),
    which runs every block's kernels a second time.

    ``mesh``: the inputs are the whole tensors, the same on every rank, and
    ``params`` this rank's ``shard_params`` slices. The rank runs its batch
    rows (dp) and its block of frames (sp), with the RoPE table rows of
    those frames, and every rank returns the whole, gathered prediction. An
    axis that does not divide B or T runs them all; ``uncond_batch`` is
    not used (the skip is off-mesh only). Under gradients (training) the
    gather's backward gives each rank the gradient of its own block, and a
    prediction that the ranks of an axis each computed whole passes a share
    of its gradient to each (``share_grad``), so that the parameter
    gradients summed over dp and sp (``sync_grads``) are the unsharded
    ones.
    """
    B, T, N, _ = hidden_states.shape
    if freqs_rot is None:
        freqs_rot = precompute_freqs_rot(cfg, framestep, N)
    b_axes = f_axes = ()
    if mesh is not None:
        b_axes = split_axes(B, mesh, ("dp",))
        f_axes = split_axes(T, mesh, ("sp",))

        def shard(x):  # (B, T, ...) or (B, T*(N+1), Dh): frame blocks are row blocks
            return local_shard(local_shard(x, 0, mesh, b_axes), 1, mesh, f_axes)

        hidden_states, context = shard(hidden_states), shard(context)
        mask = shard(mask) if mask is not None else None
        diffusion_time = local_shard(diffusion_time, 0, mesh, b_axes)
        freqs_rot = tuple(shard(f).contiguous() for f in freqs_rot)
        uncond_batch = 0
        B, T = hidden_states.shape[:2]

    x = linear(params["proj_in"], merge_batch_time(hidden_states))  # (B*T, N, W)
    compute_dtype = x.dtype

    # Diffusion-time token per frame, batch-major (B*T,), zeroed on GT frames.
    dt = diffusion_time.repeat_interleave(T)
    if mask is not None:
        dt = dt * (1.0 - merge_batch_time(mask).to(dt.dtype))
    dt_emb = sinusoidal_timestep_embedding(
        dt, cfg.width, flip_sin_to_cos=cfg.flip_sin_to_cos, downscale_freq_shift=0.0
    ).to(compute_dtype)
    # erf GELU here whatever gelu_approx says (actionmesh_tpu denoiser.py:210-212)
    dt_hidden = F.gelu(linear(params["time_proj"]["linear_1"], copy_to_tp(dt_emb, mesh)))
    if axis_size(mesh, "tp") > 1:
        dt_emb = row_parallel_linear(params["time_proj"]["linear_2"], dt_hidden, mesh)
    else:
        dt_emb = linear(params["time_proj"]["linear_2"], dt_hidden)
    x = torch.cat([dt_emb[:, None, :], x], dim=1)  # (B*T, N+1, W)

    context_merged = merge_batch_time(context).to(compute_dtype)

    skips = []
    half = cfg.num_layers // 2
    for layer, block_params in enumerate(params["blocks"]):
        skip = None if layer <= half else skips.pop()
        inflate = T if layer in cfg.inflated_layers else None

        def block(x, ctx, freqs, skip, _params=block_params, _inflate=inflate):
            return flow_matching_block(
                _params,
                x,
                num_attention_heads=cfg.num_attention_heads,
                encoder_hidden_states=ctx,
                freqs_rot=freqs,
                skip=skip,
                inflate_n_frames=_inflate,
                gelu_approx=cfg.gelu_approx,
                uncond_prefix=uncond_batch * T,  # batch-major merge_batch_time
                trainable=trainable,
                mesh=mesh,
                sequence_parallel=bool(f_axes),
                norm_eps=cfg.norm_eps,
                moe_top_k=cfg.moe_top_k,
            )

        args = (x, context_merged, freqs_rot if inflate is not None else None, skip)
        if remat:
            x = checkpoint(block, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(*args)
        if layer < half:
            skips.append(x)

    x = layer_norm(params["norm_out"], x, cfg.norm_eps)
    x = linear(params["proj_out"], x[:, -N:])  # drop the time token
    out = split_batch_time(x, T)
    if mesh is not None:
        out = gather_from(gather_from(out, 1, mesh, f_axes), 0, mesh, b_axes)
        out = share_grad(out, mesh, b_axes + f_axes)
    return out
