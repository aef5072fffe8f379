"""Stage II: temporal 3D autoencoder / deformation decoder.

Counterpart of ``actionmesh_tpu/models/autoencoder.py``: 16 self-attention
blocks (width 1024, 8 heads, RoPE over T*N latent tokens + T alpha tokens)
and one final cross-attention block whose queries are frequency-embedded
mesh vertices (+ normals). The T_out target timesteps are folded into the
batch axis, so one forward decodes all of them. The query embedder, the
final cross-attention block and the output head stay fp32, as in JAX.
For training, ``trainable`` takes every attention with the O(S)-memory
flash backward and ``remat`` recomputes each self-attention block in the
backward pass (``torch.utils.checkpoint``, as ``jax.checkpoint`` in JAX).
Under a device mesh the folded target batch splits over dp, the heads and
MLP columns over tp, and the [T*N | T] sequence over sp through the ring;
the vertex queries of the final block split over sp.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from actionmesh_tpu_torch.models.layers import (
    Params,
    flow_matching_block,
    init_flow_matching_block,
    init_layer_norm,
    init_linear,
    layer_norm,
    linear,
)
from actionmesh_tpu_torch.ops.embeddings import (
    frequency_embedding_out_dim,
    frequency_positional_embedding,
    scale_timestep,
    timestep_embedder,
)
from actionmesh_tpu_torch.ops.rotary import compute_rotary_embeddings
from actionmesh_tpu_torch.ops.tensor_ops import merge_batch_time, merge_time_tokens
from actionmesh_tpu_torch.parallel.mesh import (
    axis_size,
    gather_from,
    local_shard,
    split_axes,
)


@dataclasses.dataclass(frozen=True)
class AutoencoderConfig:
    temporal_context_size: int = 16
    in_channels: int = 3
    in_extra_channels: int = 3
    out_dim: int = 3
    latent_channels: int = 64
    width: int = 1024
    num_layers: int = 16
    num_attention_heads: int = 8
    embed_frequency: int = 8
    embed_include_pi: bool = False
    prediction_mode: str = "direct"  # direct | residual
    gelu_approx: bool = True

    @property
    def width_per_head(self) -> int:
        return self.width // self.num_attention_heads

    @property
    def query_input_dim(self) -> int:
        return (
            frequency_embedding_out_dim(self.in_channels, self.embed_frequency)
            + self.in_extra_channels
        )


def init_autoencoder(
    gen: torch.Generator,
    cfg: AutoencoderConfig,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> Params:
    """Random development weights; the final block and head are fp32."""
    self_blocks = [
        init_flow_matching_block(
            gen, dim=cfg.width, num_attention_heads=cfg.num_attention_heads,
            use_cross_attention=False, attention_qk_norm=False,
            attention_bias=False, dtype=dtype, device=device,
        )
        for _ in range(cfg.num_layers)
    ]
    cross_block = init_flow_matching_block(
        gen, dim=cfg.width, num_attention_heads=cfg.num_attention_heads,
        use_self_attention=False, cross_attention_dim=cfg.width,
        cross_attention_norm="layer_norm", attention_qk_norm=False,
        attention_bias=False, dtype=torch.float32, device=device,
    )
    f32 = torch.float32
    return {
        "blocks": self_blocks + [cross_block],
        "proj_query": init_linear(gen, cfg.query_input_dim, cfg.width, dtype=f32, device=device),
        "norm_out": init_layer_norm(cfg.width, device),
        "proj_out": init_linear(gen, cfg.width, cfg.out_dim, dtype=f32, device=device),
        "post_quant": init_linear(gen, cfg.latent_channels, cfg.width, dtype=dtype, device=device),
    }


def apply_displacement(
    cfg: AutoencoderConfig,
    vertex: torch.Tensor,
    displacement: torch.Tensor,
    scale: float = 1.0,
) -> torch.Tensor:
    """(B, V, 3) x (B, T_out, V, 3) -> deformed vertices clamped to [-scale, scale]."""
    if cfg.prediction_mode == "direct":
        return torch.clamp(displacement, -scale, scale)
    if cfg.prediction_mode == "residual":
        return torch.clamp(vertex[:, None] + displacement, -scale, scale)
    raise ValueError(f"Invalid prediction_mode: {cfg.prediction_mode}")


def embed_queries(cfg: AutoencoderConfig, query: torch.Tensor) -> torch.Tensor:
    """Frequency-embed vertex xyz (+ pass-through normals), fp32."""
    qf = query.float()
    embed = frequency_positional_embedding(
        qf[..., :3], num_freqs=cfg.embed_frequency, logspace=True,
        include_input=True, include_pi=cfg.embed_include_pi,
    )
    if cfg.in_extra_channels > 0:
        embed = torch.cat([embed, qf[..., 3:]], dim=-1)
    return embed


def autoencoder_forward(
    params: Params,
    cfg: AutoencoderConfig,
    latent: torch.Tensor,
    framestep: torch.Tensor,
    source_alpha: torch.Tensor,
    target_alphas: torch.Tensor,
    query: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
    trainable: bool = False,
    remat: bool = False,
    mesh=None,
) -> torch.Tensor:
    """Decode latents to per-vertex displacements for every target timestep.

    latent (B, T, N, D); framestep (B, T); source_alpha (B,); target_alphas
    (B, T_out) in normalised [0, 1] time; query (B, V, 3|6).
    Returns displacement (B, T_out, V, out_dim) in (-1, 1).

    Training: ``trainable`` routes every attention, the fp32 vertex
    cross-attention included, through the O(S)-memory flash backward
    (kernels C and D on the card); ``remat`` recomputes each self-attention
    block in the backward pass, which runs its kernels a second time.
    Neither changes the forward's output.

    ``mesh``: the inputs are the whole tensors, the same on every rank, and
    ``params`` this rank's ``shard_params`` slices; every rank returns the
    whole displacement. The folded (B*T_out) target batch splits over dp
    (JAX's ``constrain_target_batch``; T_out is padded with copies of the
    last target to a multiple of dp, as in JAX, and the copies dropped), the
    [T*N | T] sequence over sp when sp divides it (the self-attention as the
    ring), the heads over tp. The final block's vertex queries split over sp
    (V padded to a multiple of sp) against the gathered KV sequence. Under
    gradients the gathers differentiate (``gather_from``): the KV's backward
    sums the sp ranks' parts (each rank's vertex queries attend to all of
    it) and gives each rank its own rows; the output's gives each rank its
    own block. dp and sp always split the target batch and the vertices
    (both are padded), so the ranks' parameter gradients summed over dp and
    sp are the unsharded ones.
    """
    if target_alphas.ndim != 2 or source_alpha.ndim != 1:
        raise ValueError("target_alphas must be (B, T_out), source_alpha (B,)")
    T_out_real = target_alphas.shape[1]
    pad_t = (-T_out_real) % axis_size(mesh, "dp")
    if pad_t:
        target_alphas = torch.cat([target_alphas, target_alphas[:, -1:].expand(-1, pad_t)], dim=1)
    B, T, N, _ = latent.shape
    T_out = target_alphas.shape[1]
    V = query.shape[1]

    positions = merge_batch_time(scale_timestep(framestep, center=True, scale=False))
    latent_proj = merge_time_tokens(linear(params["post_quant"], latent.to(compute_dtype)))

    # RoPE tables over [T*N latent tokens | T alpha tokens]
    cos, sin = compute_rotary_embeddings(cfg.width_per_head, positions)
    cos = cos.reshape(B, T, -1)
    sin = sin.reshape(B, T, -1)
    cos = torch.cat([cos.repeat_interleave(N, dim=1), cos], dim=1)  # (B, S, Dh)
    sin = torch.cat([sin.repeat_interleave(N, dim=1), sin], dim=1)

    source_alphas = source_alpha[:, None].expand(B, T_out)
    alpha_embedded = timestep_embedder(
        source_alphas, target_alphas, frequency_embedding_size=cfg.width // 2
    ).to(compute_dtype)  # (B, T_out, W)

    # Fold T_out into the batch: [latent tokens (shared) | alpha token x T]
    latent_b = latent_proj[:, None].expand(B, T_out, T * N, cfg.width).reshape(
        B * T_out, T * N, cfg.width
    )
    alpha_b = alpha_embedded[:, :, None, :].expand(B, T_out, T, cfg.width).reshape(
        B * T_out, T, cfg.width
    )
    x = torch.cat([latent_b, alpha_b], dim=1)  # (B*T_out, S, W)

    # Tables are the same for every target: with B == 1 a 2-D table serves all.
    if B == 1:
        cos_b, sin_b = cos[0].contiguous(), sin[0].contiguous()
    else:
        cos_b = cos.repeat_interleave(T_out, dim=0)
        sin_b = sin.repeat_interleave(T_out, dim=0)

    t_axes = s_axes = v_axes = ()
    if mesh is not None:
        t_axes = split_axes(B * T_out, mesh, ("dp",))
        s_axes = split_axes(x.shape[1], mesh, ("sp",))
        v_axes = ("sp",) if axis_size(mesh, "sp") > 1 else ()
        x = local_shard(local_shard(x, 0, mesh, t_axes), 1, mesh, s_axes)
        if cos_b.ndim == 3:
            cos_b, sin_b = (local_shard(t, 0, mesh, t_axes) for t in (cos_b, sin_b))
        cos_b, sin_b = (local_shard(t, t.ndim - 2, mesh, s_axes).contiguous() for t in (cos_b, sin_b))

    def block(x, cos_b, sin_b, _params):
        return flow_matching_block(
            _params, x, num_attention_heads=cfg.num_attention_heads,
            freqs_rot=(cos_b, sin_b), gelu_approx=cfg.gelu_approx, trainable=trainable,
            mesh=mesh, sequence_parallel=bool(s_axes),
        )

    for block_params in params["blocks"][:-1]:
        if remat:
            x = checkpoint(block, x, cos_b, sin_b, block_params,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = block(x, cos_b, sin_b, block_params)

    # Final cross-attention with vertex queries (fp32 island)
    kv_cache = gather_from(x.float(), 1, mesh, s_axes, reduce=True)
    queries = linear(params["proj_query"], embed_queries(cfg, query))  # (B, V, W)
    queries_b = queries[:, None].expand(B, T_out, V, cfg.width).reshape(
        B * T_out, V, cfg.width
    )
    if mesh is not None:
        queries_b = local_shard(queries_b, 0, mesh, t_axes)
        if v_axes:  # pad V with zero queries to a multiple of sp; their rows are dropped
            pad_v = (-V) % axis_size(mesh, "sp")
            queries_b = local_shard(torch.nn.functional.pad(queries_b, (0, 0, 0, pad_v)), 1, mesh, v_axes)
    logits = flow_matching_block(
        params["blocks"][-1], queries_b, num_attention_heads=cfg.num_attention_heads,
        encoder_hidden_states=kv_cache, trainable=trainable, mesh=mesh,
    )
    logits = linear(params["proj_out"], layer_norm(params["norm_out"], logits))
    logits = logits * -1.0  # sign flip (reference temporal_autoencoder.py:160)
    displacement = 2.0 * torch.sigmoid(logits) - 1.0
    if mesh is not None:
        displacement = gather_from(gather_from(displacement, 1, mesh, v_axes)[:, :V], 0, mesh, t_axes)
    out = displacement.reshape(B, T_out, V, cfg.out_dim)
    return out[:, :T_out_real] if pad_t else out
