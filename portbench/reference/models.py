"""Plain PyTorch forward passes of the five networks, on release-named weights.

Written from the architecture, not from the port: every function reads a
state dict in the public checkpoints' names (``reference/layout.py``),
upcasts each weight to float32 where it is used, takes every matrix
product through ``numerics.mm`` and keeps every activation through
``numerics.act``, so that one switch runs the whole reference in fp32
(TF32 off) or in fp8 (the control). Attention is an exact
softmax over all keys, computed in blocks of queries so that it fits.
RoPE is the checkpoints' own interleaved layout, channels (2i, 2i+1) a
pair; rms-norm and layer norm are float32.

Architecture, as ActionMesh and TripoSG define it:
  * a flow block: [U-skip: layer norm of a linear over (skip, x)], pre-norm
    self-attention (per-head rms qk-norm, RoPE on inflated layers), pre-norm
    cross-attention to the image features (qk-norm), pre-norm GELU MLP;
  * the flow transformer (Stage-I denoiser; TripoSG DiT at one frame, no
    RoPE): a diffusion-time token per frame, U-skips from the first half of
    the blocks to the second, self-attention over all frames' tokens;
  * the Stage-II autoencoder: self blocks over [T*N latent tokens | T alpha
    tokens] with RoPE, then one fp32 cross block from embedded vertices;
  * the TripoSG VAE: a cross-attention encoder from FPS-picked surface
    points, a self-attention decoder and an SDF head on embedded points;
  * DINOv2 ViT-L/14 with layer scale.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import numerics
from portbench.reference.numerics import act
from portbench.reference.numerics import linear as _lin

NEG_INF = -1e30


def W(state: dict, name: str) -> torch.Tensor:
    return state[name].float()


def lin(state: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    b = state.get(f"{name}.bias")
    return _lin(x, W(state, f"{name}.weight"), None if b is None else b.float())


def layer_norm(state: dict, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return act(F.layer_norm(x.float(), (x.shape[-1],), W(state, f"{name}.weight"),
                            W(state, f"{name}.bias"), eps))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * weight.float()


def gelu(x: torch.Tensor, tanh: bool) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if tanh else "none")


# -- attention ----------------------------------------------------------------

def rope_tables(positions: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Interleaved RoPE tables (..., dim) for float positions (...,)."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=positions.device) / dim))
    ph = positions.float()[..., None] * inv
    return ph.cos().repeat_interleave(2, -1), ph.sin().repeat_interleave(2, -1)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Pairs (2i, 2i+1) rotated: x*cos + (-x_{2i+1}, x_{2i})*sin."""
    pairs = x.unflatten(-1, (-1, 2))
    rot = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
    return x * cos + rot * sin


def softmax_attention(q, k, v, block: int = 2048) -> torch.Tensor:
    """Exact softmax(q k^T / sqrt(D)) v over (B, H, S, D) float32, in blocks
    of queries."""
    scale = q.shape[-1] ** -0.5
    outs = []
    for q0 in range(0, q.shape[2], block):
        s = numerics.mm(q[:, :, q0:q0 + block], k.transpose(-1, -2)) * scale
        p = torch.softmax(s, dim=-1)
        del s
        outs.append(numerics.mm(p, v))
        del p
    return act(torch.cat(outs, dim=2))


def attention(state, name, x, heads, ctx=None, rope=None, qk_norm=False) -> torch.Tensor:
    """(B, S, W) -> (B, S, W); ``ctx`` (B, Sk, Wc) for cross-attention, with
    the layer norm ``<name>.norm_cross`` on it when the weights have one;
    ``rope`` (cos, sin) of shape (B, S, Dh) on q and k."""
    B, S, _ = x.shape
    kv = x if ctx is None else ctx
    if f"{name}.norm_cross.weight" in state:
        kv = layer_norm(state, f"{name}.norm_cross", kv)
    q, k, v = (lin(state, f"{name}.to_{n}", src) for n, src in (("q", x), ("k", kv), ("v", kv)))
    dh = q.shape[-1] // heads
    q, k, v = (t.view(B, -1, heads, dh).transpose(1, 2) for t in (q, k, v))
    if qk_norm:
        q = rms_norm(q, W(state, f"{name}.norm_q.weight"))
        k = rms_norm(k, W(state, f"{name}.norm_k.weight"))
    if rope is not None:
        cos, sin = (t[:, None] for t in rope)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
    o = softmax_attention(q, k, v).transpose(1, 2).reshape(B, S, -1)
    return lin(state, f"{name}.to_out.0", o)


# -- the flow block and the flow transformer ---------------------------------

def flow_block(state, name, x, heads, *, ctx=None, rope=None, skip=None, inflate=None,
               qk_norm=False, tanh=False, uncond=0) -> torch.Tensor:
    """One pre-norm block on (B*T, N, W) per-frame tokens. ``inflate`` = T
    runs the self-attention over each batch entry's T*N tokens. ``uncond``
    leading rows have an all-zero image context: their cross-attention,
    with bias-free k and v, is the out-projection's bias alone."""
    if skip is not None:
        x = layer_norm(state, f"{name}.norm_skip", lin(state, f"{name}.linear_skip",
                                                         torch.cat([skip, x], -1)))
    if f"{name}.s_attn.to_q.weight" in state:
        h = layer_norm(state, f"{name}.norm_s_attn", x)
        BT, N, Wd = h.shape
        if inflate:
            h = h.reshape(BT // inflate, inflate * N, Wd)
        h = attention(state, f"{name}.s_attn", h, heads, rope=rope, qk_norm=qk_norm)
        x = act(x + h.reshape(BT, N, Wd))
    if f"{name}.x_attn.to_q.weight" in state:
        h = layer_norm(state, f"{name}.norm_x_attn", x)
        out = attention(state, f"{name}.x_attn", h[uncond:], heads, ctx=ctx[uncond:],
                        qk_norm=qk_norm)
        if uncond:
            bias = W(state, f"{name}.x_attn.to_out.0.bias")
            out = torch.cat([bias.expand(uncond, h.shape[1], -1), out], 0)
        x = act(x + out)
    h = layer_norm(state, f"{name}.norm_ff", x)
    h = lin(state, f"{name}.ff.net.2", act(gelu(lin(state, f"{name}.ff.net.0.proj", h), tanh)))
    return act(x + h)


def sinusoidal(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[sin | cos] of t * 10000^(-i / (dim/2)), float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    args = t.float()[..., None] * freqs
    return torch.cat([args.sin(), args.cos()], -1)


def flow_transformer(state, cfg, latents, context, framestep, diffusion_time, mask=None,
                     inflated=True, uncond=0) -> torch.Tensor:
    """Velocity prediction. latents (B, T, N, C), context (B, T, S, Dc),
    framestep (B, T) video timesteps, diffusion_time (B,), mask (B, T) with
    1 on ground-truth frames (their diffusion time is 0); ``uncond`` leading
    batch entries carry an all-zero context. ``inflated``: every block's
    self-attention spans all T frames with RoPE on the centred video time
    (the Stage-I denoiser); otherwise each frame attends alone, without
    RoPE (the TripoSG DiT). Returns (B, T, N, C) float32."""
    B, T, N, C = latents.shape
    width, heads, n_layers = cfg["width"], cfg["num_attention_heads"], cfg["num_layers"]
    x = lin(state, "proj_in", latents.reshape(B * T, N, C))
    dt = diffusion_time.float().repeat_interleave(T)
    if mask is not None:
        dt = dt * (1.0 - mask.reshape(-1).float())
    temb = sinusoidal(dt, width)
    temb = lin(state, "time_proj.linear_2", gelu(lin(state, "time_proj.linear_1", temb), False))
    x = torch.cat([temb[:, None], x], 1)
    ctx = context.reshape(B * T, *context.shape[2:]).float()
    rope = None
    if inflated:
        pos = (framestep - framestep.amin(1, keepdim=True)).float()
        pos = pos[:, :, None].expand(B, T, N + 1).reshape(B, T * (N + 1))
        rope = rope_tables(pos, width // heads)
    tanh = cfg.get("gelu_approx", True)
    skips = []
    half = n_layers // 2
    for i in range(n_layers):
        skip = skips.pop() if i > half else None
        x = flow_block(state, f"blocks.{i}", x, heads, ctx=ctx, rope=rope, skip=skip,
                       inflate=T if inflated else None, qk_norm=True, tanh=tanh,
                       uncond=uncond * T)
        if i < half:
            skips.append(x)
    x = layer_norm(state, "norm_out", x)
    return lin(state, "proj_out", x[:, 1:]).reshape(B, T, N, C)


# -- Stage II ----------------------------------------------------------------

def frequency_embed(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[x, sin(x f), cos(x f)] with f = 2^0..2^(n-1), each block ordered by
    channel then frequency."""
    f = 2.0 ** torch.arange(n_freqs, dtype=torch.float32, device=x.device)
    e = (x.float()[..., None] * f).flatten(-2)
    return torch.cat([x.float(), e.sin(), e.cos()], -1)


def cos_sin_embed(t: torch.Tensor, dim: int) -> torch.Tensor:
    """[cos | sin] of t * 10000^(-i / (dim/2))."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                        device=t.device) / half)
    args = t.float()[..., None] * freqs
    return torch.cat([args.cos(), args.sin()], -1)


def autoencoder_tokens(state, cfg, latent, framestep, source_alpha, target_alpha):
    """The self-attention stack for ONE target time: latent (1, T, N, C),
    framestep (1, T), source_alpha and target_alpha scalars -> the final
    token set (1, T*N + T, W) float32."""
    _, T, N, _ = latent.shape
    width, heads = cfg["width"], cfg["num_attention_heads"]
    x = lin(state, "post_quant", latent.reshape(1, T * N, -1))
    a = torch.cat([cos_sin_embed(source_alpha.reshape(1), width // 2),
                   cos_sin_embed(target_alpha.reshape(1), width // 2)], -1)
    x = torch.cat([x, a[:, None].expand(1, T, width)], 1)
    pos = (framestep - framestep.amin(1, keepdim=True)).float()[0]
    pos = torch.cat([pos.repeat_interleave(N), pos])[None]
    rope = rope_tables(pos, width // heads)
    for i in range(cfg["num_layers"]):
        x = flow_block(state, f"blocks.{i}", x, heads, rope=rope, tanh=cfg.get("gelu_approx", True))
    return x


def autoencoder_vertices(state, cfg, tokens, vertices) -> torch.Tensor:
    """Deformed positions (V, 3) of ``vertices`` (V, 6: xyz, unit normal)
    for one target from its token set (1, S, W)."""
    n = cfg["num_layers"]
    q_in = torch.cat([frequency_embed(vertices[:, :3], cfg["embed_frequency"]),
                      vertices[:, 3:].float()], -1)
    q = lin(state, "proj_query", q_in)[None]
    h = flow_block(state, f"blocks.{n}", q, cfg["num_attention_heads"], ctx=tokens, tanh=False)
    logits = -lin(state, "proj_out", layer_norm(state, "norm_out", h))[0]
    disp = 2.0 * torch.sigmoid(logits) - 1.0
    if cfg.get("prediction_mode", "direct") == "residual":
        disp = vertices[:, :3].float() + disp
    return disp.clamp(-1.0, 1.0)


# -- TripoSG VAE ---------------------------------------------------------------

def vae_decode_tokens(state, cfg, latent) -> torch.Tensor:
    """Latent (1, K, C) -> the decoded set (1, K, Wd)."""
    x = lin(state, "post_quant", latent.float())
    for i in range(cfg["decoder_layers"]):
        x = flow_block(state, f"decoder.blocks.{i}", x, cfg["decoder_heads"], tanh=False)
    return x


def vae_sdf(state, cfg, tokens, points) -> torch.Tensor:
    """Raw field values (Q,) at points (Q, 3) from the decoded set."""
    q = lin(state, "decoder.proj_query", frequency_embed(points, cfg["embed_frequency"]))[None]
    h = q + attention(state, "decoder.cross_attn.attn",
                      layer_norm(state, "decoder.cross_attn.norm", q),
                      cfg["decoder_heads"], ctx=tokens)
    out = lin(state, "decoder.proj_out", layer_norm(state, "decoder.norm_out", h))
    return out[0, :, 0]


def farthest_points(xyz: torch.Tensor, k: int, start: int) -> torch.Tensor:
    """Indices (k,) of farthest point sampling over (M, 3) from ``start``;
    each pick is the first point of largest squared distance to the set."""
    pts = xyz.float()
    idx = torch.empty(k, dtype=torch.long, device=pts.device)
    idx[0] = start
    best = torch.full((pts.shape[0],), float("inf"), device=pts.device)
    for i in range(1, k):
        best = torch.minimum(best, (pts - pts[idx[i - 1]]).square().sum(-1))
        idx[i] = best.argmax()
    return idx


def vae_encode(state, cfg, surface, pre_idx, start, noise) -> torch.Tensor:
    """surface (N, 6) -> posterior sample (1, K, C): point features, FPS
    over the presample ``pre_idx`` from ``start``, one cross-attention from
    the picked points to all points, the self blocks, mean + std * noise."""
    xyz = surface[:, :3].float()
    feats = lin(state, "encoder.proj_in",
                torch.cat([frequency_embed(xyz, cfg["embed_frequency"]),
                           surface[:, 3:].float()], -1))
    cand, cand_feats = (xyz, feats) if pre_idx is None else (xyz[pre_idx], feats[pre_idx])
    picks = farthest_points(cand, cfg["num_tokens"], int(start))
    q = cand_feats[picks][None]
    x = q + attention(state, "encoder.cross_attn.attn",
                      layer_norm(state, "encoder.cross_attn.norm", q),
                      cfg["encoder_heads"], ctx=feats[None])
    for i in range(cfg["encoder_layers"]):
        x = flow_block(state, f"encoder.blocks.{i}", x, cfg["encoder_heads"], tanh=False)
    mom = lin(state, "encoder.proj_out", layer_norm(state, "encoder.norm_out", x))
    mean, logvar = mom.chunk(2, -1)
    return mean + torch.exp(0.5 * logvar.clamp(-30.0, 20.0)) * noise.float()


# -- DINOv2 --------------------------------------------------------------------

def bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) weights of an antialiased Keys-cubic (a = -0.5)
    resample of one axis, normalised per output sample."""
    inv = n_in / n_out
    ks = max(inv, 1.0)
    centre = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(centre[None, :] - np.arange(n_in)[:, None]) / ks
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = np.where(x >= 2.0, 0.0, w)
    tot = w.sum(0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, 1), 0.0)
    w = np.where(((centre >= -0.5) & (centre <= n_in - 0.5))[None, :], w, 0.0)
    return np.ascontiguousarray(w.T.astype(np.float32))


def dinov2(state, cfg, pixels) -> torch.Tensor:
    """pixels (B, 3, H, W) normalised -> last hidden state (B, 1 + g*g, W)."""
    p, width, heads = cfg["patch_size"], cfg["hidden_size"], cfg["num_heads"]
    eps = cfg.get("layer_norm_eps", 1e-6)
    B = pixels.shape[0]
    g = pixels.shape[-1] // p
    patches = F.unfold(pixels.float(), kernel_size=p, stride=p).transpose(1, 2)  # (B, g*g, 3*p*p)
    pw = W(state, "embeddings.patch_embeddings.projection.weight").reshape(width, -1)
    x = _lin(patches, pw, W(state, "embeddings.patch_embeddings.projection.bias"))
    x = torch.cat([W(state, "embeddings.cls_token").expand(B, 1, width), x], 1)
    pos = W(state, "embeddings.position_embeddings")
    src = int(round(math.sqrt(pos.shape[1] - 1)))
    grid = pos[0, 1:].reshape(src, src, width)
    if src != g:
        r = torch.as_tensor(bicubic_matrix(src, g), device=pos.device)
        grid = torch.einsum("jb,ibw->ijw", r, torch.einsum("ia,abw->ibw", r, grid))
    x = x + torch.cat([pos[:, :1], grid.reshape(1, g * g, width)], 1)
    S = x.shape[1]
    for i in range(cfg["num_layers"]):
        pre = f"encoder.layer.{i}"
        h = layer_norm(state, f"{pre}.norm1", x, eps)
        q, k, v = (lin(state, f"{pre}.attention.attention.{n}", h)
                   .view(B, S, heads, -1).transpose(1, 2) for n in ("query", "key", "value"))
        o = softmax_attention(q, k, v).transpose(1, 2).reshape(B, S, width)
        x = act(x + lin(state, f"{pre}.attention.output.dense", o) * W(state, f"{pre}.layer_scale1.lambda1"))
        h = layer_norm(state, f"{pre}.norm2", x, eps)
        h = lin(state, f"{pre}.mlp.fc2", act(gelu(lin(state, f"{pre}.mlp.fc1", h), False)))
        x = act(x + h * W(state, f"{pre}.layer_scale2.lambda1"))
    return layer_norm(state, "layernorm", x, eps)
