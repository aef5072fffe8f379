"""Plain PyTorch reference of Hunyuan3D-2.1's shape model, on release-named weights.

tencent/Hunyuan3D-2.1: the DiT (``hunyuan3d-dit-v2-1/config.yaml``;
``hy3dshape/models/denoisers/hunyuandit.py``, ``HunYuanDiTPlain``, and
``moe_layers.py``), the ShapeVAE's decoder and SDF query
(``hy3dshape/models/autoencoders``) and the conditioner's image
preparation. Written from the architecture, not from the port: like
``reference/models.py`` (whose helpers it uses) every weight is upcast to
float32 where it is used, every product goes through ``numerics`` (fp32
with TF32 off: its callers run it under ``numerics.precision``, which sets
``allow_tf32`` False; or fp8 for the control) and attention is an exact
softmax. It imports nothing of the port.

The DiT: ``x_embedder`` on the latents, a diffusion-time token from a
[cos | sin] embedding through ``t_embedder.mlp`` (erf GELU), 21 blocks of
[U-skip: ``skip_norm(skip_linear([skip, x]))``], self-attention, cross-
attention to the image tokens, a feed-forward, each pre-norm (LayerNorm
eps 1e-6) with per-head rms-norm on q and k; ``final_layer`` drops the
time token. The last ``num_moe_layers`` blocks' feed-forward is the
sparse-expert one: p = softmax(W_g h) over the experts, each token's top-k
experts weighted by their p (not renormalised) plus the shared expert,
computed here as a dense loop over experts on the tokens each one took.

The ShapeVAE's decoder: ``post_kl``, 16 blocks of self-attention (a
fused ``c_qkv``, each head's q, k and v channels in turn; a per-head
LayerNorm on q and k) and an erf-GELU MLP, pre-norm at eps 1e-6; the
geometry decoder's query: ``query_proj`` of the points' frequency
embedding, a cross-attention to the decoded set (``ln_1`` on the query,
``ln_2`` on the set, ``c_q``, a fused per-head ``c_kv``, the per-head
LayerNorm on q and k) and an MLP after it (``ln_3``, ``mlp``), then
``ln_post`` at torch's default eps 1e-5 and ``output_proj``.

Details the release's files would settle, chosen here and in the
configuration's ``assumed``:
  * the fused projections' order (per head, q k v / k v in turn) and
    ``ln_post``'s epsilon;
  * the time: sigma = 1 - t / 1000 of the shifted rectified-flow schedule
    (``pipeline.flow_schedule``) at shift 1, steps + 1 points, the Euler
    update x + (sigma' - sigma) v;
  * the conditioner's image: the anchor frame as the pipeline hands it to
    Stage 0 (cropped, RGB on white), its non-white box recentred with a
    0.15 border and resized once to 518^2 (bicubic, as ``pipeline.resize``).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import layout
from portbench.reference import models as R
from portbench.reference import pipeline as RP
from portbench.reference.numerics import act, linear

DIT_EPS = 1e-6
VAE_EPS = 1e-6
LN_POST_EPS = 1e-5
BORDER_RATIO = 0.15


# -- the release's names and shapes ------------------------------------------

def _ln(out: layout.Layout, name: str, dim: int) -> None:
    out[f"{name}.weight"] = ((dim,), "norm_w")
    out[f"{name}.bias"] = ((dim,), "norm_b")


def _lin(out: layout.Layout, name: str, n_in: int, n_out: int, bias: bool = True) -> None:
    out[f"{name}.weight"] = ((n_out, n_in), "linear")
    if bias:
        out[f"{name}.bias"] = ((n_out,), "bias")


def _ffn(out: layout.Layout, name: str, w: int, inner: int) -> None:
    _lin(out, f"{name}.net.0.proj", w, inner)
    _lin(out, f"{name}.net.2", inner, w)


def dit_layout(cfg: dict) -> layout.Layout:
    """``HunYuanDiTPlain``: ``width``, ``num_layers``, ``num_attention_heads``,
    ``in_channels``, ``cross_attention_dim``, ``mlp_ratio``,
    ``num_moe_layers``, ``num_experts``."""
    w, n, heads = cfg["width"], cfg["num_layers"], cfg["num_attention_heads"]
    inner, dh = int(w * cfg["mlp_ratio"]), w // heads
    out: layout.Layout = {}
    _lin(out, "x_embedder", cfg["in_channels"], w)
    _lin(out, "t_embedder.mlp.0", w, 4 * w)
    _lin(out, "t_embedder.mlp.2", 4 * w, w)
    for i in range(n):
        p = f"blocks.{i}"
        for j, kv in ((1, w), (2, cfg["cross_attention_dim"])):
            _ln(out, f"{p}.norm{j}", w)
            _lin(out, f"{p}.attn{j}.to_q", w, w, bias=False)
            _lin(out, f"{p}.attn{j}.to_k", kv, w, bias=False)
            _lin(out, f"{p}.attn{j}.to_v", kv, w, bias=False)
            out[f"{p}.attn{j}.q_norm.weight"] = ((dh,), "norm_w")
            out[f"{p}.attn{j}.k_norm.weight"] = ((dh,), "norm_w")
            _lin(out, f"{p}.attn{j}.out_proj", w, w)
        _ln(out, f"{p}.norm3", w)
        if n - i <= cfg["num_moe_layers"]:
            out[f"{p}.moe.gate.weight"] = ((cfg["num_experts"], w), "linear")
            for e in range(cfg["num_experts"]):
                _ffn(out, f"{p}.moe.experts.{e}", w, inner)
            _ffn(out, f"{p}.moe.shared_experts", w, inner)
        else:
            _lin(out, f"{p}.mlp.fc1", w, inner)
            _lin(out, f"{p}.mlp.fc2", inner, w)
        if i > n // 2:
            _ln(out, f"{p}.skip_norm", w)
            _lin(out, f"{p}.skip_linear", 2 * w, w)
    _ln(out, "final_layer.norm_final", w)
    _lin(out, "final_layer.linear", w, cfg["in_channels"])
    return out


def vae_layout(cfg: dict) -> layout.Layout:
    """The ShapeVAE's decoder side (Stage 0 runs no encoder): ``num_tokens``,
    ``latent_channels``, ``width``, ``layers``, ``heads``,
    ``embed_frequency``. Its SDF head ``output_proj`` is a ``head``, as
    TripoSG's is (``reference/layout.py``)."""
    w, heads = cfg["width"], cfg["heads"]
    dh = w // heads
    out: layout.Layout = {}
    _lin(out, "post_kl", cfg["latent_channels"], w)
    for i in range(cfg["layers"]):
        p = f"transformer.resblocks.{i}"
        _ln(out, f"{p}.ln_1", w)
        _lin(out, f"{p}.attn.c_qkv", w, 3 * w, bias=False)
        _ln(out, f"{p}.attn.attention.q_norm", dh)
        _ln(out, f"{p}.attn.attention.k_norm", dh)
        _lin(out, f"{p}.attn.c_proj", w, w)
        _ln(out, f"{p}.ln_2", w)
        _lin(out, f"{p}.mlp.c_fc", w, 4 * w)
        _lin(out, f"{p}.mlp.c_proj", 4 * w, w)
    g = "geo_decoder.cross_attn_decoder"
    _lin(out, "geo_decoder.query_proj", layout.frequency_dim(3, cfg["embed_frequency"]), w)
    _ln(out, f"{g}.ln_1", w)
    _ln(out, f"{g}.ln_2", w)
    _lin(out, f"{g}.attn.c_q", w, w, bias=False)
    _lin(out, f"{g}.attn.c_kv", w, 2 * w, bias=False)
    _ln(out, f"{g}.attn.attention.q_norm", dh)
    _ln(out, f"{g}.attn.attention.k_norm", dh)
    _lin(out, f"{g}.attn.c_proj", w, w)
    _ln(out, f"{g}.ln_3", w)
    _lin(out, f"{g}.mlp.c_fc", w, 4 * w)
    _lin(out, f"{g}.mlp.c_proj", 4 * w, w)
    _ln(out, "geo_decoder.ln_post", w)
    out["geo_decoder.output_proj.weight"] = ((1, w), "head")
    out["geo_decoder.output_proj.bias"] = ((1,), "head")
    return out


# -- attention -------------------------------------------------------------------

def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    B, S, _ = t.shape
    return t.view(B, S, heads, -1).transpose(1, 2)


def _attend(state, q, k, v, heads, out_name, q_norm, k_norm, layer_eps=None) -> torch.Tensor:
    """(B, Sq, W) queries, (B, Sk, W) keys and values -> out projection of
    the softmax attention, q and k normed per head by the norms named
    ``q_norm`` and ``k_norm``: rms-norms, or with ``layer_eps`` layer norms."""
    B, S, _ = q.shape
    q, k = _heads(q, heads), _heads(k, heads)
    if layer_eps is None:
        q, k = R.rms_norm(q, R.W(state, f"{q_norm}.weight")), R.rms_norm(k, R.W(state, f"{k_norm}.weight"))
    else:
        q, k = R.layer_norm(state, q_norm, q, layer_eps), R.layer_norm(state, k_norm, k, layer_eps)
    o = R.softmax_attention(q, k, _heads(v, heads)).transpose(1, 2).reshape(B, S, -1)
    return R.lin(state, out_name, o)


def dit_attention(state, name, x, heads, ctx=None) -> torch.Tensor:
    kv = x if ctx is None else ctx
    q, k, v = (R.lin(state, f"{name}.to_{n}", src) for n, src in (("q", x), ("k", kv), ("v", kv)))
    return _attend(state, q, k, v, heads, f"{name}.out_proj", f"{name}.q_norm", f"{name}.k_norm")


def _fused(t: torch.Tensor, heads: int, parts: int) -> list[torch.Tensor]:
    """A fused projection (B, S, heads * parts * d), each head's ``parts``
    blocks in turn -> ``parts`` tensors (B, S, heads * d)."""
    B, S, _ = t.shape
    t = t.view(B, S, heads, parts, -1)
    return [t[:, :, :, j].reshape(B, S, -1) for j in range(parts)]


# -- the DiT ---------------------------------------------------------------------

def _ffn_apply(state, name, h) -> torch.Tensor:
    return R.lin(state, f"{name}.net.2", act(R.gelu(R.lin(state, f"{name}.net.0.proj", h), False)))


def moe(state, name, h, top_k, route=None):
    """The sparse-expert feed-forward on tokens h (n, W): (output (n, W),
    router scores (n, E), the router's own top-k (n, k)). ``route`` (n, k):
    the experts to run each token through instead of its own top-k, each
    weighted by this router's score of it."""
    scores = torch.softmax(linear(h, R.W(state, f"{name}.gate.weight")), dim=-1)
    own = torch.topk(scores, top_k, dim=-1).indices
    top = own if route is None else route.to(h.device).long()
    weight = scores.gather(1, top)
    y = _ffn_apply(state, f"{name}.shared_experts", h).clone()
    for e in range(scores.shape[1]):
        hit = top == e
        rows = hit.any(1)
        if bool(rows.any()):
            w = (weight * hit).sum(1)[rows, None]
            y[rows] += w * _ffn_apply(state, f"{name}.experts.{e}", h[rows])
    return act(y), scores, own


def dit(state, cfg, x, ctx, t, uncond=0, route=None):
    """Velocity (B, N, C) float32 of latents x (B, N, C) at sigma t (B,)
    with image tokens ctx (B, S, Dc); the ``uncond`` leading rows see no
    image (their cross-attention, with bias-free k and v, is the out
    projection's bias). Returns (v, gates): one (scores, own top-k) an
    expert block, over the blocks' (B * (N + 1)) tokens; ``route``: a
    top-k an expert block to run the experts by (``moe``)."""
    B, N, _ = x.shape
    w, L, heads = cfg["width"], cfg["num_layers"], cfg["num_attention_heads"]
    h = R.lin(state, "x_embedder", x.float())
    temb = R.cos_sin_embed(t, w)
    temb = R.lin(state, "t_embedder.mlp.2", R.gelu(R.lin(state, "t_embedder.mlp.0", temb), False))
    h = torch.cat([temb[:, None], h], 1)
    ctx = ctx.float()
    skips, gates = [], []
    half = L // 2
    for i in range(L):
        p = f"blocks.{i}"
        if i > half:
            h = R.layer_norm(state, f"{p}.skip_norm",
                             R.lin(state, f"{p}.skip_linear", torch.cat([skips.pop(), h], -1)), DIT_EPS)
        h = act(h + dit_attention(state, f"{p}.attn1", R.layer_norm(state, f"{p}.norm1", h, DIT_EPS),
                                  heads))
        hn = R.layer_norm(state, f"{p}.norm2", h, DIT_EPS)
        out = dit_attention(state, f"{p}.attn2", hn[uncond:], heads, ctx=ctx[uncond:])
        if uncond:
            bias = R.W(state, f"{p}.attn2.out_proj.bias")
            out = torch.cat([bias.expand(uncond, hn.shape[1], -1), out], 0)
        h = act(h + out)
        hn = R.layer_norm(state, f"{p}.norm3", h, DIT_EPS)
        if f"{p}.moe.gate.weight" in state:
            r = None if route is None else route[len(gates)]
            y, scores, own = moe(state, f"{p}.moe", hn.reshape(-1, w), cfg["moe_top_k"], r)
            gates.append((scores, own))
            y = y.view(hn.shape)
        else:
            y = R.lin(state, f"{p}.mlp.fc2", act(R.gelu(R.lin(state, f"{p}.mlp.fc1", hn), False)))
        h = act(h + y)
        if i < half:
            skips.append(h)
    h = R.layer_norm(state, "final_layer.norm_final", h, DIT_EPS)
    return R.lin(state, "final_layer.linear", h[:, 1:]), gates


def schedule(steps: int, shift: float, train_steps: int = 1000):
    """(sigma (steps + 1,), Euler distances (steps,)) float32."""
    ts, dist = RP.flow_schedule(steps, train_steps, shift)
    return 1.0 - ts / train_steps, dist


# -- the ShapeVAE decoder ----------------------------------------------------------

def vae_tokens(state, cfg, latent) -> torch.Tensor:
    """Latent (1, K, C) -> the decoded set (1, K, W)."""
    heads = cfg["heads"]
    x = R.lin(state, "post_kl", latent.float() / cfg["scale_factor"])
    for i in range(cfg["layers"]):
        p = f"transformer.resblocks.{i}.attn"
        hn = R.layer_norm(state, f"transformer.resblocks.{i}.ln_1", x, VAE_EPS)
        q, k, v = _fused(R.lin(state, f"{p}.c_qkv", hn), heads, 3)
        x = act(x + _attend(state, q, k, v, heads, f"{p}.c_proj", f"{p}.attention.q_norm",
                            f"{p}.attention.k_norm", VAE_EPS))
        hn = R.layer_norm(state, f"transformer.resblocks.{i}.ln_2", x, VAE_EPS)
        m = f"transformer.resblocks.{i}.mlp"
        x = act(x + R.lin(state, f"{m}.c_proj", act(R.gelu(R.lin(state, f"{m}.c_fc", hn), False))))
    return x


def vae_sdf(state, cfg, tokens, points) -> torch.Tensor:
    """Raw field values (Q,) at points (Q, 3) from the decoded set."""
    g = "geo_decoder.cross_attn_decoder"
    q = R.lin(state, "geo_decoder.query_proj", R.frequency_embed(points, cfg["embed_frequency"]))[None]
    kv = R.layer_norm(state, f"{g}.ln_2", tokens, VAE_EPS)
    k, v = _fused(R.lin(state, f"{g}.attn.c_kv", kv), cfg["heads"], 2)
    qq = R.lin(state, f"{g}.attn.c_q", R.layer_norm(state, f"{g}.ln_1", q, VAE_EPS))
    h = act(q + _attend(state, qq, k, v, cfg["heads"], f"{g}.attn.c_proj",
                        f"{g}.attn.attention.q_norm", f"{g}.attn.attention.k_norm", VAE_EPS))
    hn = R.layer_norm(state, f"{g}.ln_3", h, VAE_EPS)
    h = act(h + R.lin(state, f"{g}.mlp.c_proj", act(R.gelu(R.lin(state, f"{g}.mlp.c_fc", hn), False))))
    out = R.lin(state, "geo_decoder.output_proj",
                R.layer_norm(state, "geo_decoder.ln_post", h, LN_POST_EPS))
    return out[0, :, 0]


# -- the conditioner ---------------------------------------------------------------

def recenter(image: np.ndarray, border_ratio: float = BORDER_RATIO) -> np.ndarray:
    """RGB uint8 on white -> a square of the longer side: the non-white
    box resized to int(side (1 - border_ratio)) on its longer side, centred
    on white."""
    rgb = image[..., :3]
    ys, xs = np.nonzero((rgb != 255).any(-1))
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    side = max(rgb.shape[0], rgb.shape[1])
    s = int(side * (1 - border_ratio)) / max(y1 - y0, x1 - x0)
    h, w = max(1, int((y1 - y0) * s)), max(1, int((x1 - x0) * s))
    out = np.full((side, side, 3), 255, np.uint8)
    top, left = (side - h) // 2, (side - w) // 2
    out[top:top + h, left:left + w] = RP.resize(np.ascontiguousarray(rgb[y0:y1, x0:x1]), h, w)
    return out


def conditioner_pixels(image: np.ndarray, size: int) -> torch.Tensor:
    """(1, 3, size, size) float32 normalised pixels of the conditioner."""
    img = RP.resize(recenter(image), size, size).astype(np.float32) / 255.0
    return torch.from_numpy((img - RP.MEAN) / RP.STD).permute(2, 0, 1)[None].contiguous()


def conditioner(state, cfg, image: np.ndarray, device) -> torch.Tensor:
    """The image tokens (1, 1 + (size / patch)^2, W) of the conditioner's DINOv2."""
    return R.dinov2(state, cfg, conditioner_pixels(image, cfg["image_size"]).to(device))
