"""Hunyuan3D-2.1's checkpoint names -> the port's parameter trees.

The release ships one checkpoint with three parts: the DiT (``model.``),
the ShapeVAE (``vae.``) and the conditioner's DINOv2
(``conditioner.main_image_encoder.model.``). The port reads each part as a
safetensors directory of its own with that prefix taken off
(``<dir>/dit``, ``<dir>/vae``, ``<dir>/conditioner``), the layout of the
other families under ``weights_dir``. Names as in ``hy3dshape``:

  DiT      ``x_embedder``, ``t_embedder.mlp.{0,2}``, ``blocks.<i>.{norm1,
           attn1, norm2, attn2, norm3, mlp.{fc1,fc2}, skip_linear,
           skip_norm}``, an attention's ``to_q``, ``to_k``, ``to_v``,
           ``q_norm``, ``k_norm``, ``out_proj``; an expert block's
           ``moe.gate``, ``moe.experts.<e>.net.{0.proj,2}`` and
           ``moe.shared_experts.net.{0.proj,2}``; ``final_layer.{norm_final,
           linear}``.
  ShapeVAE the decoder side: ``post_kl``, ``transformer.resblocks.<i>.{ln_1,
           attn.c_qkv, attn.attention.{q_norm,k_norm}, attn.c_proj, ln_2,
           mlp.c_fc, mlp.c_proj}`` (``c_qkv`` fused per head: each head's
           q, k, v channels in turn), and ``geo_decoder.{query_proj,
           cross_attn_decoder.{ln_1, ln_2, attn.c_q, attn.c_kv,
           attn.attention.{q_norm,k_norm}, attn.c_proj, ln_3, mlp.c_fc,
           mlp.c_proj}, ln_post, output_proj}`` (``c_kv`` fused per head
           as ``c_qkv``; the q and k norms are layer norms, with biases).
  DINOv2   Hugging Face's ``Dinov2Model`` names (``utils/weights.py``).

The trees are shape-checked against the port's initialisers at the given
configurations before they are returned.
"""

from __future__ import annotations

from pathlib import Path

import torch

from actionmesh_tpu_torch.models.denoiser import ExpertDenoiserConfig, init_denoiser
from actionmesh_tpu_torch.models.dinov2 import DinoV2Config
from actionmesh_tpu_torch.models.triposg.vae import ShapeVAEConfig, init_triposg_vae
from actionmesh_tpu_torch.utils import weights as W

VAE_KEYS = ("post_quant", "dec_blocks", "proj_query", "dec_cross_attn", "dec_norm_cross_q",
            "dec_norm_ff", "dec_ff", "dec_norm_out", "dec_proj_out")


def _t(state: dict, key: str, dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(state[key]).to(dtype)


def _linear(state: dict, name: str, dtype: torch.dtype) -> dict:
    out = {"weight": _t(state, f"{name}.weight", dtype)}
    if f"{name}.bias" in state:
        out["bias"] = _t(state, f"{name}.bias", dtype)
    return out


def _norm(state: dict, name: str) -> dict:
    out = {"scale": _t(state, f"{name}.weight", torch.float32)}
    if f"{name}.bias" in state:
        out["bias"] = _t(state, f"{name}.bias", torch.float32)
    return out


def _dit_attention(state: dict, name: str, dtype: torch.dtype) -> dict:
    return {"to_q": _linear(state, f"{name}.to_q", dtype),
            "to_k": _linear(state, f"{name}.to_k", dtype),
            "to_v": _linear(state, f"{name}.to_v", dtype),
            "to_out": _linear(state, f"{name}.out_proj", dtype),
            "norm_q": _norm(state, f"{name}.q_norm"),
            "norm_k": _norm(state, f"{name}.k_norm")}


def _ffn(state: dict, name: str, dtype: torch.dtype) -> dict:
    return {"net_0": _linear(state, f"{name}.net.0.proj", dtype),
            "net_2": _linear(state, f"{name}.net.2", dtype)}


def _moe(state: dict, name: str, num_experts: int, dtype: torch.dtype) -> dict:
    experts = [_ffn(state, f"{name}.experts.{e}", dtype) for e in range(num_experts)]
    return {"gate": {"weight": _t(state, f"{name}.gate.weight", dtype)},
            "experts": {net: {k: torch.stack([e[net][k] for e in experts]) for k in ("weight", "bias")}
                        for net in ("net_0", "net_2")},
            "shared": _ffn(state, f"{name}.shared_experts", dtype)}


def _check(converted, expected, what: str, state: dict):
    problems = W.tree_shape_mismatches(converted, expected)
    if problems:
        raise ValueError(f"{what}: converted checkpoint does not match the configuration "
                         f"({len(problems)} problems):\n  " + "\n  ".join(problems[:40])
                         + "\n" + W.describe_state_dict(state))
    return converted


def convert_dit(state: dict, cfg: ExpertDenoiserConfig, dtype: torch.dtype = torch.bfloat16) -> dict:
    """``HunYuanDiTPlain``'s state dict -> the denoiser tree of ``cfg``."""
    blocks = []
    try:
        for i in range(cfg.num_layers):
            p = f"blocks.{i}"
            b = {"norm_s_attn": _norm(state, f"{p}.norm1"),
                 "s_attn": _dit_attention(state, f"{p}.attn1", dtype),
                 "norm_x_attn": _norm(state, f"{p}.norm2"),
                 "x_attn": _dit_attention(state, f"{p}.attn2", dtype),
                 "norm_ff": _norm(state, f"{p}.norm3")}
            if i in cfg.moe_layers:
                b["moe"] = _moe(state, f"{p}.moe", cfg.num_experts, dtype)
            else:
                b["ff"] = {"net_0": _linear(state, f"{p}.mlp.fc1", dtype),
                           "net_2": _linear(state, f"{p}.mlp.fc2", dtype)}
            if i > cfg.num_layers // 2:
                b["norm_skip"] = _norm(state, f"{p}.skip_norm")
                b["linear_skip"] = _linear(state, f"{p}.skip_linear", dtype)
            blocks.append(b)
        converted = {
            "time_proj": {"linear_1": _linear(state, "t_embedder.mlp.0", dtype),
                          "linear_2": _linear(state, "t_embedder.mlp.2", dtype)},
            "proj_in": _linear(state, "x_embedder", dtype),
            "blocks": blocks,
            "norm_out": _norm(state, "final_layer.norm_final"),
            "proj_out": _linear(state, "final_layer.linear", dtype),
        }
    except KeyError as e:
        raise KeyError(f"Hunyuan3D-2.1 DiT key missing: {e}.\n" + W.describe_state_dict(state)) from e
    expected = init_denoiser(torch.Generator(), cfg, dtype=dtype, device=torch.device("meta"))
    return _check(converted, expected, "Hunyuan3D-2.1 DiT", state)


def _split_heads(w: torch.Tensor, heads: int, parts: int) -> list[torch.Tensor]:
    """A fused per-head projection (heads * parts * d, in), each head's
    ``parts`` blocks of d rows in turn -> ``parts`` (heads * d, in)."""
    per = w.reshape(heads, parts, -1, w.shape[-1])
    return [per[:, j].reshape(-1, w.shape[-1]).contiguous() for j in range(parts)]


def _vae_self_attention(state: dict, name: str, heads: int, dtype: torch.dtype) -> dict:
    q, k, v = _split_heads(_t(state, f"{name}.c_qkv.weight", dtype), heads, 3)
    return {"to_q": {"weight": q}, "to_k": {"weight": k}, "to_v": {"weight": v},
            "to_out": _linear(state, f"{name}.c_proj", dtype),
            "norm_q": _norm(state, f"{name}.attention.q_norm"),
            "norm_k": _norm(state, f"{name}.attention.k_norm")}


def convert_vae(state: dict, cfg: ShapeVAEConfig, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The ShapeVAE's decoder side -> the decoder keys of the TripoSG VAE
    tree at ``cfg`` (the query side fp32, as TripoSG's)."""
    f32, h = torch.float32, cfg.decoder_heads
    g = "geo_decoder.cross_attn_decoder"
    try:
        blocks = []
        for i in range(cfg.decoder_layers):
            p = f"transformer.resblocks.{i}"
            blocks.append({"norm_s_attn": _norm(state, f"{p}.ln_1"),
                           "s_attn": _vae_self_attention(state, f"{p}.attn", h, dtype),
                           "norm_ff": _norm(state, f"{p}.ln_2"),
                           "ff": {"net_0": _linear(state, f"{p}.mlp.c_fc", dtype),
                                  "net_2": _linear(state, f"{p}.mlp.c_proj", dtype)}})
        k, v = _split_heads(_t(state, f"{g}.attn.c_kv.weight", f32), h, 2)
        converted = {
            "post_quant": _linear(state, "post_kl", dtype),
            "dec_blocks": blocks,
            "proj_query": _linear(state, "geo_decoder.query_proj", f32),
            "dec_cross_attn": {"to_q": _linear(state, f"{g}.attn.c_q", f32),
                               "to_k": {"weight": k}, "to_v": {"weight": v},
                               "to_out": _linear(state, f"{g}.attn.c_proj", f32),
                               "norm_q": _norm(state, f"{g}.attn.attention.q_norm"),
                               "norm_k": _norm(state, f"{g}.attn.attention.k_norm"),
                               "norm_cross": _norm(state, f"{g}.ln_2")},
            "dec_norm_cross_q": _norm(state, f"{g}.ln_1"),
            "dec_norm_ff": _norm(state, f"{g}.ln_3"),
            "dec_ff": {"net_0": _linear(state, f"{g}.mlp.c_fc", f32),
                       "net_2": _linear(state, f"{g}.mlp.c_proj", f32)},
            "dec_norm_out": _norm(state, "geo_decoder.ln_post"),
            "dec_proj_out": _linear(state, "geo_decoder.output_proj", f32),
        }
    except KeyError as e:
        raise KeyError(f"Hunyuan3D-2.1 ShapeVAE key missing: {e}.\n" + W.describe_state_dict(state)) from e
    full = init_triposg_vae(torch.Generator(), cfg, dtype=dtype, device=torch.device("meta"))
    return _check(converted, {k: full[k] for k in VAE_KEYS}, "Hunyuan3D-2.1 ShapeVAE", state)


def convert_conditioner(state: dict, cfg: DinoV2Config, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The conditioner's DINOv2-L (Hugging Face names) -> the port's tree."""
    return W.params_from_jax(W.convert_dinov2(state, cfg, dtype))


def load(path: str | Path, dit_cfg: ExpertDenoiserConfig, vae_cfg: ShapeVAEConfig,
         cond_cfg: DinoV2Config, dtype: torch.dtype = torch.bfloat16, device=None):
    """(DiT, VAE decoder, conditioner) trees from ``path/{dit,vae,conditioner}``
    on ``device``."""
    path = Path(path)
    trees = (convert_dit(W.load_safetensors_dir(path / "dit"), dit_cfg, dtype),
             convert_vae(W.load_safetensors_dir(path / "vae"), vae_cfg, dtype),
             convert_conditioner(W.load_safetensors_dir(path / "conditioner"), cond_cfg, dtype))
    return tuple(W.params_from_jax(t, device) for t in trees)
