"""TripoSG vecset VAE: surface points -> 2048 x 64 latent -> SDF field.

Counterpart of ``actionmesh_tpu/models/triposg/vae.py``. The encoder
(``encode_moments``, ``encode_surface``) embeds the surface points, picks
``num_tokens`` queries by farthest point sampling (from a random presample
of 4x tokens when seeded), lets them cross-attend all points, runs its
self-attention stack and projects to the posterior's mean and log-variance.
The decoder maps the
latent set to width, runs a self-attention stack over it (``decode_kv``),
and arbitrary 3D query points cross-attend the decoded set to give one SDF
value each (``query_sdf``). The lattice queries of the extraction generate
their points on the device from their flat index or their integer lattice
ids, run in chunks of 2^18 points (one kernel-A launch each), and copy the
result to the host once per call. Their ``compute_dtype`` (bf16 for the
sign-only coarse passes) runs the query cross-attention in that dtype.

``init_triposg_vae`` builds the whole parameter tree, encoder included, so
that the weight bridge sees the JAX package's keys; the query-side
projections (``proj_query``, ``dec_cross_attn``, ``dec_proj_out``) stay fp32
whatever the model dtype.

Hunyuan3D-2.1's ShapeVAE decoder is this decoder at a ``ShapeVAEConfig``
(``models/hunyuan3d/pipeline.py``): 4,096 latents, 16 heads of 64, a
per-head layer norm on q and k in its self blocks and its query
cross-attention (``decoder_qk_norm``), biased attention output projections
(``decoder_out_bias``), its blocks' layer norms at ``decoder_norm_eps``, a
feed-forward after the query cross-attention (``decoder_query_mlp``: the
release's ``ResidualCrossAttentionBlock`` ``ln_3`` and ``mlp``), and
latents divided by ``scale_factor`` before the decoder.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from actionmesh_tpu_torch.models.layers import (
    Params,
    attention,
    feed_forward,
    flow_matching_block,
    init_attention,
    init_feed_forward,
    init_flow_matching_block,
    init_layer_norm,
    init_linear,
    layer_norm,
    linear,
)
from actionmesh_tpu_torch.ops.embeddings import (
    frequency_embedding_out_dim,
    frequency_positional_embedding,
)
from actionmesh_tpu_torch.ops.fps import farthest_point_sampling

QUERY_CHUNK = 1 << 18


@dataclasses.dataclass(frozen=True)
class TripoSGVAEConfig:
    in_channels: int = 3  # xyz (frequency-embedded)
    extra_channels: int = 3  # normals (passed through)
    latent_channels: int = 64
    num_tokens: int = 2048
    embed_frequency: int = 8
    embed_include_pi: bool = False
    encoder_width: int = 512
    encoder_layers: int = 8
    encoder_heads: int = 8
    decoder_width: int = 1024
    decoder_layers: int = 16
    decoder_heads: int = 8
    # class attributes here, fields of ShapeVAEConfig, so that this config
    # keeps the JAX package's fields
    decoder_qk_norm = False
    decoder_out_bias = False
    decoder_norm_eps = 1e-5
    decoder_query_mlp = False
    scale_factor = 1.0

    @property
    def point_feat_dim(self) -> int:
        return frequency_embedding_out_dim(self.in_channels, self.embed_frequency) + self.extra_channels


@dataclasses.dataclass(frozen=True)
class ShapeVAEConfig(TripoSGVAEConfig):
    """The decoder with Hunyuan3D-2.1's options: a per-head layer norm on q
    and k (``decoder_qk_norm``), biased attention output projections
    (``decoder_out_bias``), the epsilon of the decoder blocks' layer norms
    (``decoder_norm_eps``; the final ``dec_norm_out`` keeps 1e-5), a
    pre-norm erf-GELU feed-forward of 4x the width after the query
    cross-attention (``decoder_query_mlp``) and latents divided by
    ``scale_factor``."""

    decoder_qk_norm: bool = False
    decoder_out_bias: bool = False
    decoder_norm_eps: float = 1e-5
    decoder_query_mlp: bool = False
    scale_factor: float = 1.0


def init_triposg_vae(
    gen: torch.Generator,
    cfg: TripoSGVAEConfig,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> Params:
    """Random development weights drawn from ``gen`` (the JAX tree's keys)."""
    f32 = torch.float32

    def blocks(width, heads, n, qk_norm: bool | str = False, out_bias=False):
        return [
            init_flow_matching_block(
                gen, dim=width, num_attention_heads=heads, use_self_attention=True,
                use_cross_attention=False, attention_qk_norm=qk_norm, attention_bias=False,
                attention_out_bias=out_bias, dtype=dtype, device=device,
            )
            for _ in range(n)
        ]

    query_dim = frequency_embedding_out_dim(cfg.in_channels, cfg.embed_frequency)
    qk_norm = "layer_norm" if cfg.decoder_qk_norm else False
    params = {
        "proj_point": init_linear(gen, cfg.point_feat_dim, cfg.encoder_width, dtype=dtype, device=device),
        "enc_cross_attn": init_attention(
            gen, cfg.encoder_width, cfg.encoder_heads, cross_attention_dim=cfg.encoder_width,
            qk_norm=False, bias=False, out_bias=False, dtype=dtype, device=device,
        ),
        "enc_norm_cross": init_layer_norm(cfg.encoder_width, device),
        "enc_blocks": blocks(cfg.encoder_width, cfg.encoder_heads, cfg.encoder_layers),
        "enc_norm_out": init_layer_norm(cfg.encoder_width, device),
        "enc_proj_out": init_linear(
            gen, cfg.encoder_width, 2 * cfg.latent_channels, dtype=dtype, device=device
        ),
        "post_quant": init_linear(gen, cfg.latent_channels, cfg.decoder_width, dtype=dtype, device=device),
        "dec_blocks": blocks(cfg.decoder_width, cfg.decoder_heads, cfg.decoder_layers,
                             qk_norm, cfg.decoder_out_bias),
        "proj_query": init_linear(gen, query_dim, cfg.decoder_width, dtype=f32, device=device),
        "dec_cross_attn": init_attention(
            gen, cfg.decoder_width, cfg.decoder_heads, cross_attention_dim=cfg.decoder_width,
            cross_norm="layer_norm", qk_norm=qk_norm, bias=False,
            out_bias=cfg.decoder_out_bias,
            dtype=f32, device=device,
        ),
        "dec_norm_cross_q": init_layer_norm(cfg.decoder_width, device),
        "dec_norm_out": init_layer_norm(cfg.decoder_width, device),
        "dec_proj_out": init_linear(gen, cfg.decoder_width, 1, dtype=f32, device=device),
    }
    if cfg.decoder_query_mlp:
        params["dec_norm_ff"] = init_layer_norm(cfg.decoder_width, device)
        params["dec_ff"] = init_feed_forward(gen, cfg.decoder_width, 4 * cfg.decoder_width, f32, device)
    return params


def _embed_points(cfg: TripoSGVAEConfig, xyz: torch.Tensor) -> torch.Tensor:
    return frequency_positional_embedding(
        xyz.float(), num_freqs=cfg.embed_frequency, logspace=True,
        include_input=True, include_pi=cfg.embed_include_pi,
    )


def presample_size(cfg: TripoSGVAEConfig, n_points: int) -> int:
    """The FPS candidate pool of a seeded encode: 4x tokens, at most all points."""
    return min(cfg.num_tokens * 4, n_points)


def encode_moments(
    params: Params,
    cfg: TripoSGVAEConfig,
    surface: torch.Tensor,
    pre_idx: Optional[torch.Tensor] = None,
    start: Optional[torch.Tensor] = None,
    trainable: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """surface (B, N, 3+3) -> posterior (mean, logvar), each (B, K, C).

    ``pre_idx`` (M,): the random presample the FPS picks from (all N points
    when None); ``start`` (B,): FPS's first pick within it (index 0 when
    None). The JAX package draws both from its key; ``TripoSGPipeline.
    encode_to_latent`` draws them from a seeded generator. ``trainable``
    takes every attention with the flash backward (kernels C and D on the
    card), for training (``training/vae_train.py``).
    """
    xyz = surface[..., :3]
    feats = torch.cat([_embed_points(cfg, xyz), surface[..., 3:].float()], dim=-1)
    feats = linear(params["proj_point"], feats)  # (B, N, W)
    if pre_idx is not None:
        pre_idx = pre_idx.to(device=surface.device, dtype=torch.long)
        candidates, cand_feats = xyz[:, pre_idx], feats[:, pre_idx]
    else:
        candidates, cand_feats = xyz, feats
    _, idx = farthest_point_sampling(candidates, cfg.num_tokens, start=start)
    queries = torch.take_along_dim(cand_feats, idx[..., None], dim=1)
    x = queries + attention(
        params["enc_cross_attn"],
        layer_norm(params["enc_norm_cross"], queries),
        heads=cfg.encoder_heads,
        encoder_hidden_states=feats,
        trainable=trainable,
    )
    for block in params["enc_blocks"]:
        x = flow_matching_block(block, x, num_attention_heads=cfg.encoder_heads, trainable=trainable)
    moments = linear(params["enc_proj_out"], layer_norm(params["enc_norm_out"], x))
    mean, logvar = moments.chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


def encode_surface(
    params: Params,
    cfg: TripoSGVAEConfig,
    surface: torch.Tensor,
    pre_idx: Optional[torch.Tensor] = None,
    start: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """surface (B, N, 3+3) -> latent (B, num_tokens, latent_channels): the
    posterior's mean, or with ``noise`` (B, K, C) its sample
    mean + exp(logvar / 2) * noise."""
    mean, logvar = encode_moments(params, cfg, surface, pre_idx=pre_idx, start=start)
    if noise is None:
        return mean
    std = torch.exp(0.5 * logvar)
    return mean + std * noise.to(device=mean.device, dtype=mean.dtype)


def decode_kv(
    params: Params, cfg: TripoSGVAEConfig, latents: torch.Tensor, trainable: bool = False
) -> torch.Tensor:
    """Latent (B, K, C) -> decoded KV set (B, K, W). Query-independent.
    ``trainable``: as for ``encode_moments``."""
    if cfg.scale_factor != 1.0:
        latents = latents / cfg.scale_factor
    x = linear(params["post_quant"], latents)
    for block in params["dec_blocks"]:
        x = flow_matching_block(block, x, num_attention_heads=cfg.decoder_heads, trainable=trainable,
                                norm_eps=cfg.decoder_norm_eps)
    return x


def _query_core(
    params: Params,
    cfg: TripoSGVAEConfig,
    kv: torch.Tensor,
    points: torch.Tensor,
    trainable: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """SDF field query body: points (B, Q, 3) -> (B, Q) values (fp32).

    ``compute_dtype`` (e.g. bf16): the query cross-attention's four
    projections and its attention (kernel A's path of that dtype), and the
    feed-forward after it where the decoder has one, run in it, on the
    decoded set cast to it; the point embedding, ``proj_query``, the layer
    norms and ``dec_proj_out`` stay fp32, as does the residual. Only the
    coarse passes, which read signs, take it.
    """
    def cast(tree):
        return {key: {k: w.to(compute_dtype) for k, w in leaf.items()}
                if key in ("to_q", "to_k", "to_v", "to_out", "net_0", "net_2") else leaf  # norms stay fp32
                for key, leaf in tree.items()}

    attn_params = params["dec_cross_attn"]
    if compute_dtype is not None:
        attn_params = cast(attn_params)
    eps = cfg.decoder_norm_eps
    q = linear(params["proj_query"], _embed_points(cfg, points))
    h = q + attention(
        attn_params,
        layer_norm(params["dec_norm_cross_q"], q, eps),
        heads=cfg.decoder_heads,
        encoder_hidden_states=kv.to(compute_dtype or torch.float32),
        trainable=trainable,
        norm_eps=eps,
    ).float()
    if "dec_ff" in params:
        ff = cast(params["dec_ff"]) if compute_dtype is not None else params["dec_ff"]
        h = h + feed_forward(ff, layer_norm(params["dec_norm_ff"], h, eps)).float()
    out = linear(params["dec_proj_out"], layer_norm(params["dec_norm_out"], h))
    return out[..., 0]


def query_sdf(
    params: Params,
    cfg: TripoSGVAEConfig,
    kv: torch.Tensor,
    points: torch.Tensor,
    trainable: bool = False,
) -> torch.Tensor:
    """Query the SDF field: points (B, Q, 3) -> (B, Q) values (fp32).
    ``trainable``: as for ``encode_moments``."""
    return _query_core(params, cfg, kv, points, trainable=trainable)


def _query_chunk(
    params: Params,
    cfg: TripoSGVAEConfig,
    kv: torch.Tensor,
    pts: torch.Tensor,
    mesh=None,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """One flat chunk of points (Q, 3) -> (Q,) values.

    ``mesh``: the query axis is embarrassingly parallel, so the chunk splits
    over every rank of the mesh (JAX splits it over dp and the heads over
    tp; here each rank runs all heads of its Q / n_ranks points), and the
    values are all-gathered: every rank returns all Q. The VAE's weights are
    whole on every rank. A Q the ranks do not divide runs whole on each.
    """
    from actionmesh_tpu_torch.parallel.mesh import gather_shards, local_shard, split_axes

    axes = split_axes(pts.shape[0], mesh, mesh.mesh_dim_names) if mesh is not None else ()
    vals = _query_core(params, cfg, kv, local_shard(pts, 0, mesh, axes)[None],
                       compute_dtype=compute_dtype)[0]
    return gather_shards(vals, 0, mesh, axes)


def _lattice_points(lo, step, ijk: torch.Tensor) -> torch.Tensor:
    """lo + ijk * step in fp32 on ijk's device: (N, 3) int -> (N, 3) points."""
    lo = torch.as_tensor(np.asarray(lo, np.float32), device=ijk.device)
    step = torch.as_tensor(np.asarray(step, np.float32), device=ijk.device)
    return lo + ijk.float() * step


def query_sdf_grid_inside(
    params: Params,
    cfg: TripoSGVAEConfig,
    kv: torch.Tensor,
    lo,
    step,
    level: float,
    Rc: int,
    chunk: int = QUERY_CHUNK,
    regularizer: Optional[Callable] = None,
    compute_dtype: Optional[torch.dtype] = None,
    mesh=None,
) -> np.ndarray:
    """Inside mask (value < level) of the dense ``Rc**3`` lattice.

    The points of each chunk are generated on the device from their flat
    row-major (i, j, k) index; the int8 mask comes to the host once.
    ``regularizer`` is an optional ``(pts, vals) -> vals`` applied before
    the threshold; ``compute_dtype`` as for ``_query_core``; ``mesh`` as
    for ``_query_chunk``. Returns int8 (n_chunks * chunk,); entries past
    ``Rc**3`` are padding.
    """
    n_chunks = -(-Rc**3 // chunk)
    inside = torch.empty(n_chunks * chunk, dtype=torch.int8, device=kv.device)
    for ci in range(n_chunks):
        idx = ci * chunk + torch.arange(chunk, dtype=torch.int32, device=kv.device)
        ijk = torch.stack([idx // (Rc * Rc), (idx // Rc) % Rc, idx % Rc], dim=-1)
        pts = _lattice_points(lo, step, ijk)
        vals = _query_chunk(params, cfg, kv, pts, mesh, compute_dtype)
        if regularizer is not None:
            vals = regularizer(pts, vals)
        inside[ci * chunk : (ci + 1) * chunk] = vals < level
    return inside.cpu().numpy()


def query_sdf_at_ids(
    params: Params,
    cfg: TripoSGVAEConfig,
    kv: torch.Tensor,
    ijk: np.ndarray,
    lo,
    step,
    chunk: int = QUERY_CHUNK,
    regularizer: Optional[Callable] = None,
    compute_dtype: Optional[torch.dtype] = None,
    mesh=None,
) -> np.ndarray:
    """SDF values at lattice ids ``ijk`` (M, 3) int32, points lo + ijk * step.

    The ids go to the device in one copy and the fp32 values come back in
    one. ``M`` must be a multiple of ``chunk`` (the caller pads and discards
    the padded entries). ``compute_dtype`` as for ``_query_core``: only for
    callers that read signs (the band pass); the fine pass's values, which
    marching cubes interpolates, leave it None (fp32). ``mesh`` as for
    ``_query_chunk``.
    """
    if len(ijk) % chunk:
        raise ValueError(f"query_sdf_at_ids: {len(ijk)} ids, not a multiple of {chunk}")
    ids = torch.as_tensor(np.ascontiguousarray(ijk, np.int32), device=kv.device)
    vals_out = torch.empty(len(ids), dtype=torch.float32, device=kv.device)
    for c0 in range(0, len(ids), chunk):
        pts = _lattice_points(lo, step, ids[c0 : c0 + chunk])
        vals = _query_chunk(params, cfg, kv, pts, mesh, compute_dtype)
        if regularizer is not None:
            vals = regularizer(pts, vals)
        vals_out[c0 : c0 + chunk] = vals.float()
    return vals_out.cpu().numpy()
