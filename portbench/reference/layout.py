"""The release checkpoints' tensor names and shapes, from a configuration.

Each function returns ``{name: (shape, kind)}`` in the layout the public
checkpoints use (torch names, linear weights (out, in)): the Stage-I
denoiser and the Stage-II autoencoder of facebook/ActionMesh, the shape
transformer and the VAE of VAST-AI/TripoSG, and facebook/dinov2-large in
Hugging Face's ``Dinov2Model`` names. ``kind`` says how the benchmark
draws the tensor (``bench/weights.py``): ``linear`` and ``bias`` uniform
in +-1/sqrt(fan_in), ``head`` a tenth of that, ``norm_w`` near 1,
``norm_b`` near 0, ``scale`` a small positive layer scale, ``embed`` a
small table. The TripoSG SDF head (``decoder.proj_out``) is a ``head``:
the port shapes a random-weight field into a sphere perturbed by
0.12 * tanh(value) (``models/stage0.py``), and a full-scale head makes
that surface's size, and with it the extraction's and the mesh
processing's work, change from seed to seed. The reference
(``reference/models.py``) reads these names; the port reads the same
tensors through its own checkpoint converters. A model family
(``families/<family>.py``) tables its networks' layouts from these.
"""

from __future__ import annotations

Layout = dict[str, tuple[tuple[int, ...], str]]


def _linear(out: Layout, name: str, n_in: int, n_out: int, bias: bool = True) -> None:
    out[f"{name}.weight"] = ((n_out, n_in), "linear")
    if bias:
        out[f"{name}.bias"] = ((n_out,), "bias")


def _norm(out: Layout, name: str, dim: int, bias: bool = True) -> None:
    out[f"{name}.weight"] = ((dim,), "norm_w")
    if bias:
        out[f"{name}.bias"] = ((dim,), "norm_b")


def _attention(out: Layout, name: str, dim: int, heads: int, kv_dim: int, qk_norm: bool,
               out_bias: bool, norm_cross: bool = False) -> None:
    _linear(out, f"{name}.to_q", dim, dim, bias=False)
    _linear(out, f"{name}.to_k", kv_dim, dim, bias=False)
    _linear(out, f"{name}.to_v", kv_dim, dim, bias=False)
    _linear(out, f"{name}.to_out.0", dim, dim, bias=out_bias)
    if qk_norm:
        _norm(out, f"{name}.norm_q", dim // heads, bias=False)
        _norm(out, f"{name}.norm_k", dim // heads, bias=False)
    if norm_cross:
        _norm(out, f"{name}.norm_cross", kv_dim)


def _block(out: Layout, name: str, dim: int, heads: int, *, self_attn: bool = True,
           cross_dim: int | None = None, qk_norm: bool = False, out_bias: bool = True,
           norm_cross: bool = False, skip: bool = False, mlp_ratio: float = 4.0) -> None:
    if self_attn:
        _norm(out, f"{name}.norm_s_attn", dim)
        _attention(out, f"{name}.s_attn", dim, heads, dim, qk_norm, out_bias)
    if cross_dim is not None:
        _norm(out, f"{name}.norm_x_attn", dim)
        _attention(out, f"{name}.x_attn", dim, heads, cross_dim, qk_norm, out_bias, norm_cross)
    _norm(out, f"{name}.norm_ff", dim)
    inner = int(dim * mlp_ratio)
    _linear(out, f"{name}.ff.net.0.proj", dim, inner)
    _linear(out, f"{name}.ff.net.2", inner, dim)
    if skip:
        _norm(out, f"{name}.norm_skip", dim)
        _linear(out, f"{name}.linear_skip", 2 * dim, dim)


def flow_transformer(cfg: dict) -> Layout:
    """The Stage-I denoiser and the TripoSG DiT (one layout): ``width``,
    ``num_layers``, ``num_attention_heads``, ``in_channels``,
    ``cross_attention_dim``, ``mlp_ratio``."""
    w, n = cfg["width"], cfg["num_layers"]
    out: Layout = {}
    _linear(out, "time_proj.linear_1", w, 4 * w)
    _linear(out, "time_proj.linear_2", 4 * w, w)
    _linear(out, "proj_in", cfg["in_channels"], w)
    for i in range(n):
        _block(out, f"blocks.{i}", w, cfg["num_attention_heads"],
               cross_dim=cfg["cross_attention_dim"], qk_norm=True, skip=i > n // 2,
               mlp_ratio=cfg.get("mlp_ratio", 4.0))
    _norm(out, "norm_out", w)
    _linear(out, "proj_out", w, cfg["in_channels"])
    return out


def frequency_dim(n_in: int, n_freqs: int) -> int:
    return n_in * (2 * n_freqs + 1)


def autoencoder(cfg: dict) -> Layout:
    """The Stage-II autoencoder: ``num_layers`` self blocks and one final
    cross block whose queries are embedded vertices."""
    w, h, n = cfg["width"], cfg["num_attention_heads"], cfg["num_layers"]
    out: Layout = {}
    for i in range(n):
        _block(out, f"blocks.{i}", w, h)
    _block(out, f"blocks.{n}", w, h, self_attn=False, cross_dim=w, norm_cross=True)
    q_in = frequency_dim(cfg["in_channels"], cfg["embed_frequency"]) + cfg["in_extra_channels"]
    _linear(out, "proj_query", q_in, w)
    _norm(out, "norm_out", w)
    _linear(out, "proj_out", w, cfg["out_dim"])
    _linear(out, "post_quant", cfg["latent_channels"], w)
    return out


def triposg_vae(cfg: dict) -> Layout:
    """The TripoSG vecset VAE: encoder, decoder and SDF head."""
    ew, dw = cfg["encoder_width"], cfg["decoder_width"]
    emb = frequency_dim(3, cfg["embed_frequency"])
    out: Layout = {}
    _linear(out, "encoder.proj_in", emb + 3, ew)
    _attention(out, "encoder.cross_attn.attn", ew, cfg["encoder_heads"], ew, False, False)
    _norm(out, "encoder.cross_attn.norm", ew)
    for i in range(cfg["encoder_layers"]):
        _block(out, f"encoder.blocks.{i}", ew, cfg["encoder_heads"], out_bias=False)
    _norm(out, "encoder.norm_out", ew)
    _linear(out, "encoder.proj_out", ew, 2 * cfg["latent_channels"])
    _linear(out, "post_quant", cfg["latent_channels"], dw)
    for i in range(cfg["decoder_layers"]):
        _block(out, f"decoder.blocks.{i}", dw, cfg["decoder_heads"], out_bias=False)
    _linear(out, "decoder.proj_query", emb, dw)
    _attention(out, "decoder.cross_attn.attn", dw, cfg["decoder_heads"], dw, False, False,
               norm_cross=True)
    _norm(out, "decoder.cross_attn.norm", dw)
    _norm(out, "decoder.norm_out", dw)
    out["decoder.proj_out.weight"] = ((1, dw), "head")
    out["decoder.proj_out.bias"] = ((1,), "head")
    return out


def dinov2(cfg: dict) -> Layout:
    """Hugging Face ``Dinov2Model`` (facebook/dinov2-large)."""
    w, p = cfg["hidden_size"], cfg["patch_size"]
    grid = cfg["image_size"] // p
    inner = w * cfg["mlp_ratio"]
    out: Layout = {
        "embeddings.cls_token": ((1, 1, w), "embed"),
        "embeddings.position_embeddings": ((1, grid * grid + 1, w), "embed"),
        "embeddings.patch_embeddings.projection.weight": ((w, 3, p, p), "linear"),
        "embeddings.patch_embeddings.projection.bias": ((w,), "bias"),
    }
    for i in range(cfg["num_layers"]):
        pre = f"encoder.layer.{i}"
        _norm(out, f"{pre}.norm1", w)
        for name in ("query", "key", "value"):
            _linear(out, f"{pre}.attention.attention.{name}", w, w)
        _linear(out, f"{pre}.attention.output.dense", w, w)
        out[f"{pre}.layer_scale1.lambda1"] = ((w,), "scale")
        _norm(out, f"{pre}.norm2", w)
        _linear(out, f"{pre}.mlp.fc1", w, inner)
        _linear(out, f"{pre}.mlp.fc2", inner, w)
        out[f"{pre}.layer_scale2.lambda1"] = ((w,), "scale")
    _norm(out, "layernorm", w)
    return out


def fan_in(shape: tuple[int, ...]) -> int:
    """Inputs per output of a linear or conv weight (out, in, ...)."""
    n = 1
    for s in shape[1:]:
        n *= s
    return n
