"""Functional layers over parameter dicts (JAX key names, torch weights).

Counterpart of ``actionmesh_tpu/models/layers.py``. Parameters are the JAX
package's trees with torch tensors; a linear holds ``weight`` (out, in) and
optional ``bias`` (see ``utils/weights.py``). Precision policy as in JAX:
linears in the weights' dtype, layer norms, qk rms-norm, RoPE and softmax
in fp32.

Two JAX switches are not ported as switches: q, k and v are never
concatenated into one projection, and the cross-attention of CFG branches
with all-zero image context is skipped off a mesh (it is bitwise-exact).

``moe_feed_forward`` is the sparse-expert feed-forward of Hunyuan3D-2.1's
DiT, which the JAX package does not have: a softmax router's top-k of E
experts per token, each expert's rows run as one grouped product per
projection, and an always-on shared expert. It keeps the router's counts
and offsets on the device (no host synchronisation).

Under a device mesh (``parallel/mesh.py``) these functions take the rank's
local shard: activations whole over tp, the rank's batch rows and frames;
parameters cut by ``shard_params``. Column-parallel q/k/v and ``net_0`` give
the rank's heads and inner columns; row-parallel ``to_out`` and ``net_2``
are summed over tp (``row_parallel_linear``). A self-attention whose
sequence is split over sp (``sequence_parallel``) runs the ring. Under
gradients the column-parallel inputs go through ``copy_to_tp`` and the sums
through ``reduce_from_tp`` (``parallel/mesh.py``), so the backward sums
over tp what the forward split.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from actionmesh_tpu_torch.ops.attention import dot_product_attention
from actionmesh_tpu_torch.ops.rope_norm import fused_rms_rope
from actionmesh_tpu_torch.ops.tensor_ops import (
    flat_batch_to_flat_seq,
    flat_seq_to_flat_batch,
)
from actionmesh_tpu_torch.parallel.mesh import (
    axis_size,
    copy_to_tp,
    reduce_from_tp,
    tp_splits_heads,
)
from actionmesh_tpu_torch.utils.profiling import span

Params = dict


# ---------------------------------------------------------------------------
# Initializers (uniform +-1/sqrt(in), as torch.nn.Linear)
# ---------------------------------------------------------------------------

def init_linear(
    gen: torch.Generator,
    in_dim: int,
    out_dim: int,
    bias: bool = True,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> Params:
    bound = 1.0 / math.sqrt(in_dim)

    def uniform(shape):
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
        if u.is_meta:  # a shape-only tree: meta arithmetic costs seconds of set-up
            return u.to(dtype)
        return (u * (2 * bound) - bound).to(dtype)

    params = {"weight": uniform((out_dim, in_dim))}
    if bias:
        params["bias"] = uniform((out_dim,))
    return params


def init_layer_norm(dim: int, device: Optional[torch.device] = None) -> Params:
    return {
        "scale": torch.ones(dim, dtype=torch.float32, device=device),
        "bias": torch.zeros(dim, dtype=torch.float32, device=device),
    }


def init_rms_norm(dim: int, device: Optional[torch.device] = None) -> Params:
    return {"scale": torch.ones(dim, dtype=torch.float32, device=device)}


def init_feed_forward(gen, dim, inner_dim, dtype, device) -> Params:
    return {
        "net_0": init_linear(gen, dim, inner_dim, dtype=dtype, device=device),
        "net_2": init_linear(gen, inner_dim, dim, dtype=dtype, device=device),
    }


def init_moe_feed_forward(gen, dim, inner_dim, num_experts, dtype, device) -> Params:
    """Router ``gate`` (E, dim), no bias; the routed experts' two
    projections stacked over E (``weight`` (E, out, in), ``bias`` (E, out));
    the ``shared`` expert as ``init_feed_forward``."""
    experts = [init_feed_forward(gen, dim, inner_dim, dtype, device) for _ in range(num_experts)]
    return {
        "gate": {"weight": init_linear(gen, dim, num_experts, False, dtype, device)["weight"]},
        "experts": {
            net: {k: torch.stack([e[net][k] for e in experts]) for k in ("weight", "bias")}
            for net in ("net_0", "net_2")
        },
        "shared": init_feed_forward(gen, dim, inner_dim, dtype, device),
    }


def init_attention(
    gen: torch.Generator,
    query_dim: int,
    heads: int,
    cross_attention_dim: Optional[int] = None,
    qk_norm: bool | str = False,
    cross_norm: Optional[str] = None,
    bias: bool = False,
    out_bias: bool = True,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> Params:
    """``qk_norm``: True for a per-head rms-norm on q and k, ``"layer_norm"``
    for a per-head layer norm."""
    kv_dim = cross_attention_dim if cross_attention_dim is not None else query_dim
    dim_head = query_dim // heads
    params: Params = {
        "to_q": init_linear(gen, query_dim, query_dim, bias, dtype, device),
        "to_k": init_linear(gen, kv_dim, query_dim, bias, dtype, device),
        "to_v": init_linear(gen, kv_dim, query_dim, bias, dtype, device),
        "to_out": init_linear(gen, query_dim, query_dim, out_bias, dtype, device),
    }
    if qk_norm:
        init_norm = init_layer_norm if qk_norm == "layer_norm" else init_rms_norm
        params["norm_q"] = init_norm(dim_head, device)
        params["norm_k"] = init_norm(dim_head, device)
    if cross_norm == "layer_norm":
        params["norm_cross"] = init_layer_norm(kv_dim, device)
    return params


def init_flow_matching_block(
    gen: torch.Generator,
    dim: int,
    num_attention_heads: int,
    use_self_attention: bool = True,
    use_cross_attention: bool = True,
    cross_attention_dim: Optional[int] = None,
    cross_attention_norm: Optional[str] = None,
    attention_qk_norm: bool | str = True,
    attention_bias: bool = True,
    attention_out_bias: bool = True,
    ff_inner_dim: Optional[int] = None,
    skip: bool = False,
    num_experts: int = 0,
    dtype: torch.dtype = torch.float32,
    device: Optional[torch.device] = None,
) -> Params:
    """``num_experts`` > 0: the sparse-expert feed-forward ``moe`` in place
    of the dense ``ff``."""
    params: Params = {}
    if use_self_attention:
        params["norm_s_attn"] = init_layer_norm(dim, device)
        params["s_attn"] = init_attention(
            gen, dim, num_attention_heads, qk_norm=attention_qk_norm,
            bias=attention_bias, out_bias=attention_out_bias,
            dtype=dtype, device=device,
        )
    if use_cross_attention:
        params["norm_x_attn"] = init_layer_norm(dim, device)
        params["x_attn"] = init_attention(
            gen, dim, num_attention_heads,
            cross_attention_dim=cross_attention_dim,
            qk_norm=attention_qk_norm, cross_norm=cross_attention_norm,
            bias=attention_bias, out_bias=attention_out_bias,
            dtype=dtype, device=device,
        )
    params["norm_ff"] = init_layer_norm(dim, device)
    inner = ff_inner_dim if ff_inner_dim is not None else 4 * dim
    if num_experts:
        params["moe"] = init_moe_feed_forward(gen, dim, inner, num_experts, dtype, device)
    else:
        params["ff"] = init_feed_forward(gen, dim, inner, dtype, device)
    if skip:
        params["norm_skip"] = init_layer_norm(dim, device)
        params["linear_skip"] = init_linear(gen, 2 * dim, dim, True, dtype, device)
    return params


# ---------------------------------------------------------------------------
# Apply functions
# ---------------------------------------------------------------------------

def linear(params: Params, x: torch.Tensor) -> torch.Tensor:
    w = params["weight"]
    return F.linear(x.to(w.dtype), w, params.get("bias"))


def layer_norm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """fp32 layer norm, one-pass variance E[x^2] - E[x]^2 (as the JAX
    package computes it); returns x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    msq = (xf * xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(msq - mean * mean, min=0.0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def row_parallel_linear(params: Params, x: torch.Tensor, mesh) -> torch.Tensor:
    """A linear whose weight holds this rank's input columns: the partial
    products summed over tp, then the bias, added once."""
    w = params["weight"]
    y = reduce_from_tp(F.linear(x.to(w.dtype), w), mesh)
    b = params.get("bias")
    return y if b is None else y + b


def feed_forward(
    params: Params, x: torch.Tensor, gelu_approx: bool = False, mesh=None
) -> torch.Tensor:
    """Linear -> GELU (tanh approximation if ``gelu_approx``, else erf) -> Linear.

    ``mesh`` with tp > 1: ``net_0`` holds this rank's inner columns and
    ``net_2`` its rows (``shard_params``), summed over tp."""
    h = F.gelu(
        linear(params["net_0"], copy_to_tp(x, mesh)), approximate="tanh" if gelu_approx else "none"
    )
    if axis_size(mesh, "tp") > 1:
        return row_parallel_linear(params["net_2"], h, mesh)
    return linear(params["net_2"], h)


def moe_route(gate: torch.Tensor, h: torch.Tensor, top_k: int):
    """The router: softmax over E of ``h`` (n, W) against ``gate`` (E, W),
    in fp32, and each row's top ``top_k`` experts. Returns (scores (n, E),
    weights (n, k), experts (n, k)); the weights are the selected scores,
    not renormalised."""
    scores = torch.softmax(F.linear(h.float(), gate.float()), dim=-1)
    weights, experts = torch.topk(scores, top_k, dim=-1)
    return scores, weights, experts


def moe_dispatch(experts: torch.Tensor, num_experts: int):
    """The token-expert pairs ``experts`` (n, k) sorted by expert on the
    device (a stable sort). Returns (order: the flat pair indices in that
    order, so ``order // k`` is each row's token; expert_of_row; counts
    (E,) int64; offsets (E,) int32, where expert e's rows end). No host
    synchronisation: the counts are a scatter-add into E slots
    (``torch.bincount`` reads its input's maximum on the host)."""
    flat = experts.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.zeros(num_experts, dtype=torch.int64, device=flat.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    return order, flat.index_select(0, order), counts, torch.cumsum(counts, 0).to(torch.int32)


def grouped_linear(x: torch.Tensor, params: Params, offsets: torch.Tensor,
                   expert_of_row: torch.Tensor) -> torch.Tensor:
    """Rows of ``x`` (m, in) sorted by expert, expert e's rows ending at
    ``offsets[e]``, through each one's linear (``weight`` (E, out, in),
    ``bias`` (E, out)): one grouped product for all experts."""
    w = params["weight"]
    y = torch._grouped_mm(x.to(w.dtype), w.transpose(-2, -1), offs=offsets)
    return y + params["bias"].index_select(0, expert_of_row)


def moe_feed_forward(params: Params, x: torch.Tensor, top_k: int,
                     gelu_approx: bool = False) -> torch.Tensor:
    """Sparse-expert feed-forward on (..., W): every token's ``top_k``
    routed experts weighted by their router scores (not renormalised), plus
    the shared expert, computed once per token. No token is dropped.

    The token-expert pairs are sorted by expert on the device
    (``moe_dispatch``), the counts and offsets stay there, and each expert
    projection is one ``torch._grouped_mm`` over all experts. Runs in a
    ``moe`` span whose counter ``routed_rows`` is the rows each expert took
    (a device tensor (E,), read only after the call)."""
    shape = x.shape
    h = x.reshape(-1, shape[-1])
    with span("moe") as sp:
        gate = params["gate"]["weight"]
        _, weights, experts = moe_route(gate, h, top_k)
        order, expert_of_row, counts, offsets = moe_dispatch(experts, gate.shape[0])
        sp.counters["routed_rows"] = counts
        token = order // top_k
        hid = F.gelu(grouped_linear(h.index_select(0, token), params["experts"]["net_0"], offsets,
                                    expert_of_row), approximate="tanh" if gelu_approx else "none")
        out = grouped_linear(hid, params["experts"]["net_2"], offsets, expert_of_row)
        # each pair's weighted output back at its (token, choice) place: a
        # fixed order of the sum over choices, so the layer is deterministic
        routed = torch.empty(out.shape, dtype=torch.float32, device=out.device)
        routed[order] = out.float() * weights.reshape(-1)[order, None]
        y = routed.view(h.shape[0], top_k, -1).sum(1)
        y = y + feed_forward(params["shared"], h, gelu_approx=gelu_approx).float()
    return y.to(x.dtype).reshape(shape)


def attention(
    params: Params,
    hidden_states: torch.Tensor,
    heads: int,
    encoder_hidden_states: Optional[torch.Tensor] = None,
    freqs_rot: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    kv_mask: Optional[torch.Tensor] = None,
    uncond_prefix: int = 0,
    trainable: bool = False,
    mesh=None,
    sequence_parallel: bool = False,
    norm_eps: float = 1e-5,
) -> torch.Tensor:
    """Multi-head (self or cross) attention on (B, S, D) activations.

    Optional per-head rms qk-norm and half-layout RoPE on q and k (one fused
    kernel per tensor), or a per-head layer norm on q and k (``norm_q``
    with a ``bias``; no RoPE with it), flash attention, output projection.
    ``norm_eps``: the epsilon of the layer norms (``norm_cross``, a layer
    qk-norm). ``trainable``
    takes the attention with the O(S)-memory flash backward (JAX's
    ``attn_impl="auto_train"``).

    ``uncond_prefix``: leading batch entries whose ``encoder_hidden_states``
    are all zero (CFG branches without the image). With bias-free k/v
    projections and no ``norm_cross``, their k = v = 0, the softmax is
    uniform over zero values, and the output is exactly the out-projection
    bias, so their cross-attention is skipped (off a mesh only, as in JAX).

    ``mesh``: the rank's local activations and ``shard_params`` weights;
    with tp splitting the heads (``tp_splits_heads``) the rank runs
    ``heads / tp`` of them and ``to_out`` is summed over tp.
    ``sequence_parallel``: a self-attention whose (B, S) rows are this
    rank's S of the sp-split sequence, run as the ring over sp (trainable:
    its backward the ring over kernels C and D).
    """
    B, S, _ = hidden_states.shape
    if (
        mesh is None
        and encoder_hidden_states is not None
        and 0 < uncond_prefix < B
        and "norm_cross" not in params
        and "bias" not in params["to_k"]
        and "bias" not in params["to_v"]
    ):
        cond = attention(
            params,
            hidden_states[uncond_prefix:],
            heads,
            encoder_hidden_states[uncond_prefix:],
            freqs_rot=freqs_rot,
            kv_mask=kv_mask[uncond_prefix:] if kv_mask is not None else None,
            trainable=trainable,
            norm_eps=norm_eps,
        )
        out_bias = params["to_out"].get("bias")
        if out_bias is None:
            uncond = cond.new_zeros((uncond_prefix, S, cond.shape[-1]))
        else:
            uncond = out_bias.to(cond.dtype).expand(uncond_prefix, S, cond.shape[-1])
        return torch.cat([uncond, cond], dim=0)

    kv_src = hidden_states if encoder_hidden_states is None else encoder_hidden_states
    if encoder_hidden_states is not None and "norm_cross" in params:
        kv_src = layer_norm(params["norm_cross"], kv_src, norm_eps)

    split_heads = tp_splits_heads(heads, axis_size(mesh, "tp"))
    if split_heads:
        hidden_states = copy_to_tp(hidden_states, mesh)
        kv_src = hidden_states if encoder_hidden_states is None else copy_to_tp(kv_src, mesh)
    q = linear(params["to_q"], hidden_states)
    k = linear(params["to_k"], kv_src)
    v = linear(params["to_v"], kv_src)

    if split_heads:
        heads //= axis_size(mesh, "tp")
    dim_head = q.shape[-1] // heads
    # (B, S, H*Dh) -> (B, H, S, Dh) views
    q = q.view(B, S, heads, dim_head).transpose(1, 2)
    k = k.view(B, -1, heads, dim_head).transpose(1, 2)
    v = v.view(B, -1, heads, dim_head).transpose(1, 2)

    has_norm = "norm_q" in params
    if has_norm and "bias" in params["norm_q"]:
        q = layer_norm(params["norm_q"], q, norm_eps)
        k = layer_norm(params["norm_k"], k, norm_eps)
    elif has_norm or freqs_rot is not None:
        cos, sin = freqs_rot if freqs_rot is not None else (None, None)
        scale_q = scale_k = None
        if has_norm:
            scale_q, scale_k = params["norm_q"]["scale"], params["norm_k"]["scale"]
        if has_norm and split_heads:
            # one scale serves every head: under a head split each tp rank's
            # gradient of it is of its own heads, summed by copy_to_tp
            scale_q, scale_k = copy_to_tp(scale_q, mesh), copy_to_tp(scale_k, mesh)
        q = fused_rms_rope(q, scale_q, cos, sin)
        k = fused_rms_rope(k, scale_k, cos, sin)

    out = dot_product_attention(q, k, v, kv_mask=kv_mask, trainable=trainable, mesh=mesh,
                                sequence_parallel=sequence_parallel)
    out = out.transpose(1, 2).reshape(B, S, heads * dim_head)
    if split_heads:
        return row_parallel_linear(params["to_out"], out, mesh)
    return linear(params["to_out"], out)


def flow_matching_block(
    params: Params,
    hidden_states: torch.Tensor,
    num_attention_heads: int,
    encoder_hidden_states: Optional[torch.Tensor] = None,
    freqs_rot: Optional[tuple[torch.Tensor, torch.Tensor]] = None,
    skip: Optional[torch.Tensor] = None,
    inflate_n_frames: Optional[int] = None,
    gelu_approx: bool = False,
    uncond_prefix: int = 0,
    trainable: bool = False,
    mesh=None,
    sequence_parallel: bool = False,
    norm_eps: float = 1e-5,
    moe_top_k: int = 2,
) -> torch.Tensor:
    """Pre-norm transformer block with optional U-skip concat.

    ``norm_eps``: the layer norms' epsilon (the attentions' too). A block whose params hold
    ``moe`` runs ``moe_feed_forward`` (``moe_top_k`` experts a token) in
    place of the dense feed-forward (off a mesh only).

    With ``inflate_n_frames=T`` the self-attention runs over the cross-frame
    sequence (B, T*N, D) built from the per-frame layout (B*T, N, D);
    cross-attention and FF stay per frame. ``freqs_rot`` must match the
    self-attention layout.

    ``mesh``: local shards, as ``attention``. ``sequence_parallel``: the
    self-attention's sequence is split over sp, and its rows here are this
    rank's. Inflated, that means the rank holds T of the window's frames,
    a whole block of them (JAX's ``constrain_sp_layout``): an sp shard
    boundary falls on a frame boundary, so inflating and de-inflating stay
    local and the ring runs over the rank's T*N rows.
    """
    if "linear_skip" in params:
        if skip is None:
            raise ValueError("a skip block needs its U-skip input")
        cat = torch.cat([skip, hidden_states], dim=-1)
        hidden_states = layer_norm(params["norm_skip"], linear(params["linear_skip"], cat), norm_eps)

    if "s_attn" in params:
        normed = layer_norm(params["norm_s_attn"], hidden_states, norm_eps)
        if inflate_n_frames is not None:
            normed = flat_batch_to_flat_seq(normed, inflate_n_frames)
        att = attention(
            params["s_attn"], normed, heads=num_attention_heads, freqs_rot=freqs_rot,
            trainable=trainable, mesh=mesh, sequence_parallel=sequence_parallel, norm_eps=norm_eps,
        )
        if inflate_n_frames is not None:
            att = flat_seq_to_flat_batch(att, inflate_n_frames)
        hidden_states = hidden_states + att

    if "x_attn" in params:
        hidden_states = hidden_states + attention(
            params["x_attn"],
            layer_norm(params["norm_x_attn"], hidden_states, norm_eps),
            heads=num_attention_heads,
            encoder_hidden_states=encoder_hidden_states,
            uncond_prefix=uncond_prefix,
            trainable=trainable,
            mesh=mesh,
            norm_eps=norm_eps,
        )

    normed = layer_norm(params["norm_ff"], hidden_states, norm_eps)
    if "moe" in params:
        if mesh is not None:
            raise NotImplementedError("the sparse-expert feed-forward runs off a mesh only")
        return hidden_states + moe_feed_forward(params["moe"], normed, moe_top_k, gelu_approx)
    return hidden_states + feed_forward(params["ff"], normed, gelu_approx=gelu_approx, mesh=mesh)
