"""Synthetic reference-layout checkpoints for the tests and ``chip_smoke.py``.

Not part of the port's runtime: it writes checkpoints, it never reads them.
``reference_state_dict`` is the inverse of the converters in
``actionmesh_tpu_torch/utils/weights.py`` (and of
``models/rmbg.py:convert_rmbg_weights``): it names a tree's tensors as the
reference checkpoints do (torch Linear ``weight`` (out, in), OIHW convs,
the q/k rows back in the interleaved RoPE order, RMBG's convs with an
identity BatchNorm beside them), so that converting its output gives the
tree back. ``write_checkpoint`` stores such a state dict as safetensors
(sharded with an index above ``shard_bytes``) with its config.json.
``shape_vae_sdf`` and ``brightness_rmbg`` rewrite random weights so that a
mesh and a matte come out of them: a TripoSG VAE whose field is a sphere,
an RMBG whose matte follows the frame's brightness.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from actionmesh_tpu_torch.models import rmbg as rmbg_module
from actionmesh_tpu_torch.ops.rotary import rope_half_permutation
from actionmesh_tpu_torch.utils import safetensors
from actionmesh_tpu_torch.utils.tree import named_leaves

FAMILIES = ("denoiser", "autoencoder", "triposg_dit", "triposg_vae", "dinov2", "rmbg")

# the TripoSG VAE tree's top-level keys -> the checkpoint's prefixes
_VAE_PREFIXES = {
    "proj_point": "encoder.proj_in",
    "enc_cross_attn": "encoder.cross_attn.attn",
    "enc_norm_cross": "encoder.cross_attn.norm",
    "enc_blocks": "encoder.blocks",
    "enc_norm_out": "encoder.norm_out",
    "enc_proj_out": "encoder.proj_out",
    "post_quant": "post_quant",
    "dec_blocks": "decoder.blocks",
    "proj_query": "decoder.proj_query",
    "dec_cross_attn": "decoder.cross_attn.attn",
    "dec_norm_cross_q": "decoder.cross_attn.norm",
    "dec_norm_out": "decoder.norm_out",
    "dec_proj_out": "decoder.proj_out",
}


def _block_name(name: str) -> str:
    """A flow-block tree path -> its checkpoint name."""
    parts = name.split(".")
    if parts[-1] == "scale":  # layer and rms norms
        parts[-1] = "weight"
    out = []
    for p in parts:
        if p == "net_0":
            out += ["net", "0", "proj"]
        elif p == "net_2":
            out += ["net", "2"]
        elif p == "to_out":
            out += ["to_out", "0"]
        else:
            out.append(p)
    return ".".join(out)


def _unpermute(t: torch.Tensor, heads: int) -> torch.Tensor:
    """Rows (or entries) of a q/k projection from the half RoPE layout back
    to the interleaved one, within each head."""
    dh = t.shape[0] // heads
    inv = torch.as_tensor(np.argsort(rope_half_permutation(dh)), device=t.device)
    return t.reshape(heads, dh, *t.shape[1:])[:, inv].reshape(t.shape)


def _flow_state(params, heads: int = 0) -> dict[str, torch.Tensor]:
    """Denoiser / DiT / autoencoder trees (blocks of flow-matching blocks).
    With ``heads``, the self-attention q/k rows and their rms scales are
    un-permuted (the converters permute them)."""
    out = {}
    for name, t in named_leaves(params):
        if heads and any(f".s_attn.{p}." in name for p in ("to_q", "to_k")):
            t = _unpermute(t, heads)
        elif heads and any(f".s_attn.{p}." in name for p in ("norm_q", "norm_k")):
            t = _unpermute(t, 1)  # one head-dim vector, shared by the heads
        out[_block_name(name)] = t
    return out


def _dinov2_state(params) -> dict[str, torch.Tensor]:
    out = {}
    for name, t in named_leaves(params):
        parts = name.split(".")
        if parts[0] == "patch_embed":
            if parts[1] == "weight":  # (W, P*P*3) from HWIO -> OIHW
                p = int(round((t.shape[1] // 3) ** 0.5))
                t = t.reshape(t.shape[0], p, p, 3).permute(0, 3, 1, 2)
            out[f"embeddings.patch_embeddings.projection.{parts[1]}"] = t
        elif parts[0] == "cls_token":
            out["embeddings.cls_token"] = t
        elif parts[0] == "pos_embed":
            out["embeddings.position_embeddings"] = t
        elif parts[0] == "norm":
            out["layernorm." + ("weight" if parts[1] == "scale" else "bias")] = t
        else:  # blocks.i....
            i, rest = parts[1], parts[2:]
            if rest[-1] == "scale":
                rest[-1] = "weight"
            if rest[0] == "attention":
                rest = (["attention", "output", "dense"] if rest[1] == "output"
                        else ["attention", "attention", rest[1]]) + rest[2:]
            out[".".join(["encoder", "layer", i] + rest)] = t
    w = params["cls_token"].shape[-1]
    out["embeddings.mask_token"] = torch.zeros((1, w), device=params["cls_token"].device)
    return out


def _rmbg_state(tree) -> dict[str, torch.Tensor]:
    out = {}

    def conv(prefix, p, bn=None):
        out[f"{prefix}.weight"] = p["kernel"].permute(3, 2, 0, 1).contiguous()
        out[f"{prefix}.bias"] = p["bias"]
        if bn is not None:
            n = p["bias"].shape[0]
            dev = p["bias"].device
            out[f"{bn}.weight"] = torch.ones(n, device=dev)
            out[f"{bn}.bias"] = torch.zeros(n, device=dev)
            out[f"{bn}.running_mean"] = torch.zeros(n, device=dev)
            out[f"{bn}.running_var"] = torch.ones(n, device=dev)
            out[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=dev)

    for name, sub in tree.items():
        if "kernel" in sub:
            conv(name, sub)
        else:
            for conv_name, p in sub.items():
                conv(f"{name}.{conv_name}.conv_s1", p, f"{name}.{conv_name}.bn_s1")
    return out


def reference_state_dict(family: str, params, heads: int = 0) -> dict[str, torch.Tensor]:
    """The reference checkpoint's state dict for ``params``: the port's tree
    for every family but ``rmbg``, whose tree is the JAX layout (HWIO
    kernels) that ``convert_rmbg_weights`` gives. ``heads``: the denoiser's
    or autoencoder's attention heads (their self-attention q/k rows go back
    to the interleaved RoPE order)."""
    if family in ("denoiser", "autoencoder"):
        return _flow_state(params, heads)
    if family == "triposg_dit":
        return _flow_state(params)
    if family == "triposg_vae":
        out = {}
        for key, sub in params.items():
            for name, t in _flow_state({"x": sub}).items():
                out[_VAE_PREFIXES[key] + name[1:]] = t
        return out
    if family == "dinov2":
        return _dinov2_state(params)
    if family == "rmbg":
        return _rmbg_state(params)
    raise ValueError(f"unknown family {family!r}; one of {FAMILIES}")


def write_checkpoint(
    directory: str | Path,
    state: dict[str, torch.Tensor],
    dtype: Optional[torch.dtype] = None,
    config: Optional[dict] = None,
    shard_bytes: Optional[int] = None,
) -> int:
    """Write ``state`` (floating tensors cast to ``dtype`` if given) as
    ``model.safetensors`` or, above ``shard_bytes``, as shards with their
    index, plus ``config.json``. Returns the bytes of tensor data written."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    if dtype is not None:
        state = {k: v.to(dtype) if v.is_floating_point() else v for k, v in state.items()}
    total = sum(v.numel() * v.element_size() for v in state.values())
    if shard_bytes is not None and total > shard_bytes:
        safetensors.save_sharded(state, directory, shard_bytes)
    else:
        safetensors.save_file(state, directory / "model.safetensors", {"format": "pt"})
    if config is not None:
        (directory / "config.json").write_text(json.dumps(config, indent=1))
    return total


def shape_vae_sdf(state: dict[str, torch.Tensor], cfg, level: float = 2.85) -> dict[str, torch.Tensor]:
    """Make a TripoSG VAE state dict's SDF head a rounded sphere, whatever
    the latent: the field is -t / sqrt(1 + t^2) with t = cos x + cos y +
    cos z - ``level`` (inside negative; ``level`` 2.85 gives radius ~0.55).

    Random decoder weights give a noise field whose zero set is no surface
    a mesh pipeline can use. Here the decoder's cross-attention output
    projection is zero (so the query does not see the latent set), the
    query projection puts t on one direction u of the width and a constant
    on an orthogonal one, b, and after the output layer norm the head reads
    the u component back. Every tensor keeps its name, shape and dtype.
    """
    W = cfg.decoder_width
    F_ = cfg.embed_frequency
    dev = state["decoder.proj_query.weight"].device
    j = torch.arange(W, device=dev)
    u = 1.0 - 2.0 * (j % 2).float()  # +1, -1, ...
    b = 1.0 - 2.0 * ((j // 2) % 2).float()  # +1, +1, -1, -1, ...: orthogonal to u
    w_q = torch.zeros_like(state["decoder.proj_query.weight"], dtype=torch.float32)
    for d in range(3):  # cos(p_d * 1): after the 3 inputs and the 3 F sines
        w_q[:, 3 + 3 * F_ + d * F_] = u
    out = dict(state)

    def put(name, value):
        out[name] = value.to(state[name].dtype)

    put("decoder.proj_query.weight", w_q)
    put("decoder.proj_query.bias", -level * u + b)
    put("decoder.cross_attn.attn.to_out.0.weight", torch.zeros_like(state["decoder.cross_attn.attn.to_out.0.weight"]))
    put("decoder.norm_out.weight", torch.ones(W, device=dev))
    put("decoder.norm_out.bias", torch.zeros(W, device=dev))
    put("decoder.proj_out.weight", -u[None] / W)
    put("decoder.proj_out.bias", torch.zeros(1, device=dev))
    return out


def brightness_rmbg(state: dict) -> dict:
    """An RMBG state dict whose matte follows the frame's brightness.

    A random ISNet's matte saturates: on the synthetic frames it marks ~99%
    of the pixels foreground (a CPU probe at 256² and 1024²), so the
    refinement has no object to find. Here every conv of the state is zero
    except a brightness path: conv_in writes (R + G + B) / 3 + 1 into its
    channel 0, each RSU's input conv carries channel 0 on (RSU stages add
    their input conv's output to the rest, which is zero), the decoder
    stages take it from their skip half, and side1 reads 20 (b - c) with
    c = -0.4 (the frames' black background is -0.5 after normalisation).
    Names, shapes and dtypes stay the release's.
    """
    out = {k: torch.zeros_like(v) if v.is_floating_point() and not k.split(".")[-2].startswith("bn_s1")
           else v for k, v in state.items()}

    def tap(name, o, i, value=1.0):
        out[name][o, i, 1, 1] = value

    for c in range(3):
        tap("conv_in.weight", 0, c, 1.0 / 3.0)
    out["conv_in.bias"][0] = 1.0
    for name, kind, cin, mid, cout in rmbg_module.STAGES + rmbg_module.DSTAGES:
        # decoder stages: channel 0 of the skip input (the second half)
        src = cin // 2 if name.endswith("d") else 0
        tap(f"{name}.rebnconvin.conv_s1.weight", 0, src)
    tap("side1.weight", 0, 0, 20.0)
    out["side1.bias"][0] = -20.0 * (1.0 - 0.4)
    return out
