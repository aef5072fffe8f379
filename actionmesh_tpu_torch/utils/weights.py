"""Weight bridge between JAX parameter pytrees / npz checkpoints and the port.

The port keeps the JAX package's parameter trees (nested dicts and lists,
same key names) with torch tensors at the leaves, with one change: a JAX
linear ``kernel`` of shape (in, out) becomes a torch ``weight`` of shape
(out, in), the layout ``torch.nn.functional.linear`` takes. A 4-D HWIO conv
kernel (the DINOv2 patch embedding) becomes the (out, kh*kw*in) weight of
the equivalent linear over flattened patches. q/k projection columns are
already in the half-RoPE permutation and are not touched. The TripoSG trees
cross the same way (the DiT's is the denoiser's tree; the VAE's keeps its
fp32 query-side leaves fp32): every leaf keeps its dtype. ``params_to_jax``
and ``save_npz`` go the other way, so trained weights load in the JAX
package (``actionmesh_tpu.utils.weights.load_params``).

The checkpoint converters (``convert_denoiser``, ``convert_autoencoder``,
``convert_dinov2``, ``convert_triposg_dit``, ``convert_triposg_vae``) map a
reference state dict (torch names, read by ``utils/safetensors.py``) to the
JAX package's tree, leaf for leaf as its converters do: kernels (in, out),
conv kernels HWIO, the same fp32 islands, the same roundings, q/k
projection columns in the half-RoPE permutation. ``verify_converted`` holds
the result against the port's own ``init_*`` built on the meta device;
``load_*`` read, convert, verify and bridge to the port's layout.
"""

from __future__ import annotations

import json
import re
from collections import Counter
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from actionmesh_tpu_torch.utils import safetensors
from actionmesh_tpu_torch.utils.tree import named_leaves

BF16_SUFFIX = "::bf16"  # actionmesh_tpu/utils/weights.py:save_params


def _to_tensor(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _kernel_to_weight(kernel: np.ndarray, device) -> torch.Tensor:
    k = _to_tensor(kernel, device)
    if k.ndim == 2:  # linear (in, out)
        return k.t().contiguous()
    if k.ndim == 4:  # conv HWIO (kh, kw, in, out)
        return k.reshape(-1, k.shape[-1]).t().contiguous()
    raise ValueError(f"unsupported kernel rank {k.ndim}")


def params_from_jax(tree, device: Optional[torch.device] = None):
    """Convert a JAX params pytree (numpy or tensor leaves) to the port's."""
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            if key == "kernel":
                out["weight"] = _kernel_to_weight(value, device)
            else:
                out[key] = params_from_jax(value, device)
        return out
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return _to_tensor(tree, device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """CPU numpy copy; bf16 comes back as its uint16 bit patterns."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def params_to_jax(tree):
    """The port's params -> a JAX params tree of numpy leaves.

    Inverse of ``params_from_jax`` for linears: ``weight`` (out, in) becomes
    ``kernel`` (in, out). bf16 leaves come back as uint16 bit patterns (numpy
    has no bf16); ``save_npz`` marks them. A conv weight comes back in the
    equivalent linear's (kh*kw*in, out) layout, not HWIO.
    """
    if isinstance(tree, dict):
        out = {}
        for key, value in tree.items():
            if key == "weight":
                out["kernel"] = _to_numpy(value.t())
            else:
                out[key] = params_to_jax(value)
        return out
    if isinstance(tree, (list, tuple)):
        return [params_to_jax(v) for v in tree]
    return _to_numpy(tree)


def save_npz(params, path: str | Path) -> None:
    """Write the port's params, or a tree in the JAX layout (a converter's
    output), in the layout of the JAX package's ``save_params``: dotted
    keys, JAX kernels, and bf16 leaves as uint16 bit patterns under a
    ``::bf16`` key suffix. ``load_npz`` and the JAX ``load_params`` both
    read it."""
    dtypes = {
        name[: -len("weight")] + "kernel" if name.endswith("weight") else name: leaf.dtype
        for name, leaf in named_leaves(params)
    }
    flat = {}
    for name, value in named_leaves(params_to_jax(params)):
        if dtypes[name] == torch.bfloat16:
            name += BF16_SUFFIX
        flat[name] = value
    np.savez(path, **flat)


def check_finite(tree) -> None:
    """Raise naming every floating leaf (bf16 included) with inf or nan."""
    bad = []

    def visit(node, name):
        if isinstance(node, dict):
            for k, v in node.items():
                visit(v, f"{name}{k}.")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                visit(v, f"{name}{i}.")
        elif node.is_floating_point():
            n = int((~torch.isfinite(node.float())).sum())
            if n:
                bad.append(f"{name[:-1]}: {n}/{node.numel()} non-finite ({node.dtype})")

    visit(tree, "")
    if bad:
        raise ValueError(
            "checkpoint contains non-finite values:\n  " + "\n  ".join(bad)
        )


def load_npz(path: str | Path, device: Optional[torch.device] = None):
    """Read an npz written by ``actionmesh_tpu.utils.weights.save_params``.

    bfloat16 leaves are stored there as uint16 bit patterns under a
    ``::bf16`` key suffix. Every float leaf is checked to be finite.
    """
    root: dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            value = flat[key]
            if key.endswith(BF16_SUFFIX):
                key = key[: -len(BF16_SUFFIX)]
                value = value.view(np.int16)
                leaf = torch.from_numpy(value.copy()).view(torch.bfloat16)
            else:
                leaf = torch.from_numpy(np.array(value))
            parts = key.split(".")
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = leaf

    def listify(node):
        if isinstance(node, dict):
            keys = list(node)
            if keys and all(k.isdigit() for k in keys):
                return [listify(node[str(i)]) for i in range(len(keys))]
            return {k: listify(v) for k, v in node.items()}
        return node

    tree = listify(root)
    check_finite(tree)
    return params_from_jax(tree, device)


# ---------------------------------------------------------------------------
# Reference checkpoints (safetensors, torch names) -> the JAX package's tree
# ---------------------------------------------------------------------------

def load_safetensors_dir(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of a checkpoint directory (shards through their index)
    or file, each floating one checked to be finite (bf16 included)."""
    return safetensors.load_dir(path)


# config.json keys with no architecture in them: Hugging Face / diffusers
# metadata and the reference's torch-only runtime switches
CONFIG_META_KEYS = frozenset({
    "_class_name", "_name_or_path", "_diffusers_version", "transformers_version",
    "architectures", "model_type", "torch_dtype", "dtype", "_commit_hash", "use_cache",
    "clear_autocast", "compile_blocks", "compile_mode", "verbose",
})


def read_config(directory: str | Path) -> dict:
    """A checkpoint directory's config.json; {} when it has none."""
    path = Path(directory) / "config.json"
    return json.loads(path.read_text()) if path.exists() else {}


def check_config_keys(raw: dict, recognized, what: str) -> None:
    """Raise on a config.json key that is neither mapped nor metadata: a
    defaulted hyperparameter would build a wrong model that converts
    cleanly and fails only as bad output."""
    unknown = sorted(set(raw) - set(recognized) - CONFIG_META_KEYS)
    if unknown:
        known = {k: raw[k] for k in sorted(set(raw) & set(recognized))}
        raise ValueError(
            f"{what} config.json has keys this mapping does not recognize: {unknown}. "
            f"Recognized keys found: {known}. Refusing to silently default: extend the "
            "mapping after checking the reference architecture."
        )


def _state_tensor(state: dict, key: str) -> torch.Tensor:
    return _to_tensor(state[key], None)


def _linear(state: dict, prefix: str, dtype: torch.dtype) -> dict:
    out = {"kernel": _state_tensor(state, f"{prefix}.weight").t().to(dtype)}
    if f"{prefix}.bias" in state:
        out["bias"] = _state_tensor(state, f"{prefix}.bias").to(dtype)
    return out


def _layer_norm(state: dict, prefix: str) -> dict:
    return {
        "scale": _state_tensor(state, f"{prefix}.weight").to(torch.float32),
        "bias": _state_tensor(state, f"{prefix}.bias").to(torch.float32),
    }


def _rms_norm(state: dict, prefix: str) -> dict:
    return {"scale": _state_tensor(state, f"{prefix}.weight").to(torch.float32)}


def _permute_head_channels(tree: dict, heads: int, perm: np.ndarray) -> dict:
    """Permute the per-head output channels of a q/k projection: kernel
    (in, H*Dh) columns and bias, within each head, by ``perm`` (the
    interleaved -> half RoPE layout). Scores are unchanged, as q and k get
    the same permutation."""
    idx = torch.as_tensor(perm, dtype=torch.long)
    k = tree["kernel"]
    out = {"kernel": k.reshape(k.shape[0], heads, -1)[:, :, idx].reshape(k.shape)}
    if "bias" in tree:
        b = tree["bias"]
        out["bias"] = b.reshape(heads, -1)[:, idx].reshape(b.shape)
    return out


def _check_fused_qkv(state: dict, prefix: str) -> None:
    """Diagnose a checkpoint that ships a fused qkv tensor (or a transposed
    one) where split to_q/to_k/to_v weights are expected, before a bare
    KeyError would."""
    if f"{prefix}.to_q.weight" in state:
        return
    for fused in (f"{prefix}.qkv.weight", f"{prefix}.to_qkv.weight"):
        if fused not in state:
            continue
        shape = tuple(state[fused].shape)
        hint = ""
        if len(shape) == 2:
            rows, cols = shape
            if rows == 3 * cols:
                hint = (
                    f" Layout looks like torch fused (3*dim, dim)={shape}; split rows into "
                    f"thirds (q, k, v) and re-save as {prefix}.to_{{q,k,v}}.weight."
                )
            elif cols == 3 * rows:
                hint = (
                    f" Layout {shape} is TRANSPOSED fused qkv ((dim, 3*dim) instead of "
                    "torch's (3*dim, dim)); transpose, then split rows into q/k/v."
                )
        raise ValueError(
            f"{prefix}: checkpoint ships a FUSED qkv tensor '{fused}' {shape} where split "
            f"{prefix}.to_q/.to_k/.to_v weights are expected (the reference stores them "
            f"split and fuses at runtime).{hint}"
        )


def _attention(
    state: dict, prefix: str, dtype: torch.dtype, fp32: bool = False, rope_half_heads: int = 0
) -> dict:
    from actionmesh_tpu_torch.ops.rotary import rope_half_permutation

    adtype = torch.float32 if fp32 else dtype
    _check_fused_qkv(state, prefix)
    out = {
        "to_q": _linear(state, f"{prefix}.to_q", adtype),
        "to_k": _linear(state, f"{prefix}.to_k", adtype),
        "to_v": _linear(state, f"{prefix}.to_v", adtype),
        "to_out": _linear(state, f"{prefix}.to_out.0", adtype),
    }
    if f"{prefix}.norm_q.weight" in state:
        out["norm_q"] = _rms_norm(state, f"{prefix}.norm_q")
        out["norm_k"] = _rms_norm(state, f"{prefix}.norm_k")
    if f"{prefix}.norm_cross.weight" in state:
        out["norm_cross"] = _layer_norm(state, f"{prefix}.norm_cross")
    if rope_half_heads:
        perm = rope_half_permutation(out["to_q"]["kernel"].shape[1] // rope_half_heads)
        out["to_q"] = _permute_head_channels(out["to_q"], rope_half_heads, perm)
        out["to_k"] = _permute_head_channels(out["to_k"], rope_half_heads, perm)
        # the per-head rms-norm scales are in head-dim channel order
        for name in ("norm_q", "norm_k"):
            if name in out:
                out[name] = {"scale": out[name]["scale"][torch.as_tensor(perm, dtype=torch.long)]}
    return out


def _flow_block(
    state: dict, prefix: str, dtype: torch.dtype, fp32: bool = False, rope_half_heads: int = 0
) -> dict:
    adtype = torch.float32 if fp32 else dtype
    out: dict = {}
    # the presence checks below key on to_q.weight: a fused-qkv checkpoint
    # must be diagnosed, not have its attention silently dropped
    _check_fused_qkv(state, f"{prefix}.s_attn")
    _check_fused_qkv(state, f"{prefix}.x_attn")
    if f"{prefix}.s_attn.to_q.weight" in state:
        out["norm_s_attn"] = _layer_norm(state, f"{prefix}.norm_s_attn")
        # self-attention gets RoPE: its q/k go to the half channel layout
        out["s_attn"] = _attention(
            state, f"{prefix}.s_attn", dtype, fp32, rope_half_heads=rope_half_heads
        )
    if f"{prefix}.x_attn.to_q.weight" in state:
        out["norm_x_attn"] = _layer_norm(state, f"{prefix}.norm_x_attn")
        out["x_attn"] = _attention(state, f"{prefix}.x_attn", dtype, fp32)
    out["norm_ff"] = _layer_norm(state, f"{prefix}.norm_ff")
    out["ff"] = {
        "net_0": _linear(state, f"{prefix}.ff.net.0.proj", adtype),
        "net_2": _linear(state, f"{prefix}.ff.net.2", adtype),
    }
    if f"{prefix}.linear_skip.weight" in state:
        out["norm_skip"] = _layer_norm(state, f"{prefix}.norm_skip")
        out["linear_skip"] = _linear(state, f"{prefix}.linear_skip", adtype)
    return out


# -- verification against the configured architecture -------------------------


def tree_shape_mismatches(converted, expected, path: str = "") -> list[str]:
    """Every missing key, extra key and shape mismatch of ``converted``
    against ``expected`` (trees of anything with a ``shape``), one line each.
    A wrong but present hyperparameter converts name for name; this catches
    it before a forward pass can make garbage of it."""
    out: list[str] = []
    if isinstance(expected, dict) or isinstance(converted, dict):
        if not isinstance(converted, dict):
            return [f"{path or '<root>'}: expected mapping, got {type(converted).__name__}"]
        if not isinstance(expected, dict):
            return [f"{path or '<root>'}: expected {type(expected).__name__}, got mapping"]
        for k in sorted(set(expected) | set(converted)):
            sub = f"{path}.{k}" if path else str(k)
            if k not in converted:
                out.append(f"{sub}: MISSING from checkpoint conversion")
            elif k not in expected:
                out.append(f"{sub}: UNEXPECTED (model has no such parameter)")
            else:
                out += tree_shape_mismatches(converted[k], expected[k], sub)
        return out
    if isinstance(expected, (list, tuple)) or isinstance(converted, (list, tuple)):
        if not isinstance(converted, (list, tuple)) or not isinstance(expected, (list, tuple)):
            return [f"{path}: list/leaf structure mismatch"]
        if len(converted) != len(expected):
            out.append(f"{path}: {len(converted)} entries, model expects {len(expected)}")
        for i, (c, e) in enumerate(zip(converted, expected)):
            out += tree_shape_mismatches(c, e, f"{path}[{i}]")
        return out
    cs, es = tuple(getattr(converted, "shape", ())), tuple(getattr(expected, "shape", ()))
    if cs != es:
        out.append(f"{path}: checkpoint shape {cs}, model expects {es}")
    return out


def _jax_layout_shapes(tree):
    """The JAX-layout shapes of a port tree: a linear ``weight`` (out, in)
    is the ``kernel`` (in, out); the conv weight (out, kh*kw*in) keeps its
    flattened shape (``verify_converted`` flattens the converted HWIO
    kernel the same way)."""
    if isinstance(tree, dict):
        return {
            ("kernel" if k == "weight" else k): (
                torch.empty(tuple(v.shape[::-1]), device="meta") if k == "weight" else _jax_layout_shapes(v)
            )
            for k, v in tree.items()
        }
    if isinstance(tree, (list, tuple)):
        return [_jax_layout_shapes(v) for v in tree]
    return tree


def _flatten_conv_kernels(tree):
    """HWIO conv kernels (kh, kw, in, out) as (kh*kw*in, out), the port's
    flattened patch-embedding layout, for the shape check."""
    if isinstance(tree, dict):
        return {
            k: (v.reshape(-1, v.shape[-1]) if k == "kernel" and v.ndim == 4 else _flatten_conv_kernels(v))
            for k, v in tree.items()
        }
    if isinstance(tree, (list, tuple)):
        return [_flatten_conv_kernels(v) for v in tree]
    return tree


def verify_converted(converted: dict, init_thunk: Callable[[torch.device], dict], family: str) -> dict:
    """Raise with a full structural report unless ``converted`` (the JAX
    layout) matches the model the config describes: the shapes of
    ``init_thunk(torch.device("meta"))``, the port's own initialiser."""
    expected = _jax_layout_shapes(init_thunk(torch.device("meta")))
    problems = tree_shape_mismatches(_flatten_conv_kernels(converted), expected)
    if problems:
        more = f"\n  ... {len(problems) - 40} more" if len(problems) > 40 else ""
        raise ValueError(
            f"{family}: converted checkpoint does not match the configured architecture "
            f"({len(problems)} problems):\n  " + "\n  ".join(problems[:40]) + more
        )
    return converted


def describe_state_dict(state: dict, max_lines: int = 60) -> str:
    """Human-readable summary of a state dict: keys grouped into families
    (``blocks.N.foo.weight`` -> ``blocks.*.foo.weight``) with count and
    shape, the numeric index range (the likely layer count) and the most
    common square linear widths. The converters' error reports end with it."""
    families: dict[str, tuple[int, tuple]] = {}
    layer_ids: set[int] = set()
    for k, v in state.items():
        fam = re.sub(r"\.\d+\.", ".*.", k)
        shape = tuple(v.shape)
        cnt, _ = families.get(fam, (0, shape))
        families[fam] = (cnt + 1, shape)
        for m in re.finditer(r"\.(\d+)\.", k):
            layer_ids.add(int(m.group(1)))
    lines = [f"{len(state)} tensors, {len(families)} key families"]
    if layer_ids:
        lines.append(
            f"numeric indices 0..{max(layer_ids)} (=> likely {max(layer_ids) + 1} layers)"
        )
    widths = [s[-1] for _, (_, s) in families.items() if len(s) == 2 and s[0] == s[-1]]
    if widths:
        lines.append(f"square linear widths: {Counter(widths).most_common(3)}")
    for fam in sorted(families)[:max_lines]:
        cnt, shape = families[fam]
        lines.append(f"  {fam}  x{cnt}  {shape}")
    if len(families) > max_lines:
        lines.append(f"  ... {len(families) - max_lines} more families")
    return "\n".join(lines)


# -- the converters -------------------------------------------------------------


def convert_denoiser(state: dict, cfg, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The Stage-I denoiser (facebook/ActionMesh ``denoiser``) -> JAX tree."""
    try:
        converted = {
            "time_proj": {
                "linear_1": _linear(state, "time_proj.linear_1", dtype),
                "linear_2": _linear(state, "time_proj.linear_2", dtype),
            },
            "proj_in": _linear(state, "proj_in", dtype),
            "blocks": [
                _flow_block(state, f"blocks.{i}", dtype, rope_half_heads=cfg.num_attention_heads)
                for i in range(cfg.num_layers)
            ],
            "norm_out": _layer_norm(state, "norm_out"),
            "proj_out": _linear(state, "proj_out", dtype),
        }
    except KeyError as e:
        raise KeyError(
            f"Stage-I denoiser key mapping mismatch: missing {e}.\n"
            "Checkpoint structure:\n" + describe_state_dict(state)
        ) from e
    from actionmesh_tpu_torch.models.denoiser import init_denoiser

    verify_converted(
        converted, lambda dev: init_denoiser(torch.Generator(), cfg, dtype, dev), "stage1_denoiser"
    )
    return converted


def convert_autoencoder(state: dict, cfg, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The Stage-II autoencoder -> JAX tree. The final cross-attention
    block, proj_query, norm_out and proj_out stay fp32 (the reference's fp32
    island)."""
    n = cfg.num_layers
    try:
        blocks = [
            _flow_block(state, f"blocks.{i}", dtype, rope_half_heads=cfg.num_attention_heads)
            for i in range(n)
        ]
        # the final cross-attention block: no RoPE, no permutation
        blocks.append(_flow_block(state, f"blocks.{n}", dtype, fp32=True))
        converted = {
            "blocks": blocks,
            "proj_query": _linear(state, "proj_query", torch.float32),
            "norm_out": _layer_norm(state, "norm_out"),
            "proj_out": _linear(state, "proj_out", torch.float32),
            "post_quant": _linear(state, "post_quant", dtype),
        }
    except KeyError as e:
        raise KeyError(
            f"Stage-II autoencoder key mapping mismatch: missing {e}.\n"
            "Checkpoint structure:\n" + describe_state_dict(state)
        ) from e
    from actionmesh_tpu_torch.models.autoencoder import init_autoencoder

    verify_converted(
        converted, lambda dev: init_autoencoder(torch.Generator(), cfg, dtype, dev),
        "stage2_autoencoder",
    )
    return converted


def convert_dinov2(state: dict, cfg, dtype: torch.dtype = torch.bfloat16) -> dict:
    """A Hugging Face ``Dinov2Model`` state dict (facebook/dinov2-large) ->
    JAX tree (patch embedding as an HWIO conv kernel)."""

    def block(i: int) -> dict:
        p = f"encoder.layer.{i}"
        return {
            "norm1": _layer_norm(state, f"{p}.norm1"),
            "attention": {
                "query": _linear(state, f"{p}.attention.attention.query", dtype),
                "key": _linear(state, f"{p}.attention.attention.key", dtype),
                "value": _linear(state, f"{p}.attention.attention.value", dtype),
                "output": _linear(state, f"{p}.attention.output.dense", dtype),
            },
            "layer_scale1": {
                "lambda1": _state_tensor(state, f"{p}.layer_scale1.lambda1").to(torch.float32)
            },
            "norm2": _layer_norm(state, f"{p}.norm2"),
            "mlp": {
                "fc1": _linear(state, f"{p}.mlp.fc1", dtype),
                "fc2": _linear(state, f"{p}.mlp.fc2", dtype),
            },
            "layer_scale2": {
                "lambda1": _state_tensor(state, f"{p}.layer_scale2.lambda1").to(torch.float32)
            },
        }

    try:
        proj = _state_tensor(state, "embeddings.patch_embeddings.projection.weight")  # OIHW
        converted = {
            "patch_embed": {
                "kernel": proj.permute(2, 3, 1, 0).to(dtype),
                "bias": _state_tensor(state, "embeddings.patch_embeddings.projection.bias").to(dtype),
            },
            "cls_token": _state_tensor(state, "embeddings.cls_token").to(torch.float32),
            "pos_embed": _state_tensor(state, "embeddings.position_embeddings").to(torch.float32),
            "blocks": [block(i) for i in range(cfg.num_layers)],
            "norm": _layer_norm(state, "layernorm"),
        }
    except KeyError as e:
        raise KeyError(
            f"DINOv2 key mapping mismatch: missing {e}.\n"
            "Checkpoint structure:\n" + describe_state_dict(state)
        ) from e
    from actionmesh_tpu_torch.models.dinov2 import init_dinov2

    verify_converted(
        converted, lambda dev: init_dinov2(torch.Generator(), cfg, dtype=dtype, device=dev), "dinov2"
    )
    return converted


def convert_triposg_dit(state: dict, cfg, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The TripoSG shape transformer -> JAX tree: the denoiser's layout
    (the Stage-I denoiser is an inflation of this DiT), no RoPE."""
    try:
        converted = {
            "time_proj": {
                "linear_1": _linear(state, "time_proj.linear_1", dtype),
                "linear_2": _linear(state, "time_proj.linear_2", dtype),
            },
            "proj_in": _linear(state, "proj_in", dtype),
            "blocks": [_flow_block(state, f"blocks.{i}", dtype) for i in range(cfg.num_layers)],
            "norm_out": _layer_norm(state, "norm_out"),
            "proj_out": _linear(state, "proj_out", dtype),
        }
    except KeyError as e:
        raise KeyError(
            f"TripoSG transformer key mapping mismatch: {e}.\n"
            "The mapping assumes the ActionMesh denoiser layout (the Stage-I model is an "
            "inflation of this DiT). Checkpoint structure:\n" + describe_state_dict(state)
        ) from e
    from actionmesh_tpu_torch.models.triposg.dit import init_triposg_dit

    verify_converted(
        converted, lambda dev: init_triposg_dit(torch.Generator(), cfg, dtype=dtype, device=dev),
        "triposg_dit",
    )
    return converted


def convert_triposg_vae(state: dict, cfg, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The TripoSG vecset VAE (encoder, decoder, SDF head) -> JAX tree; the
    query side (proj_query, the decoder's cross-attention, proj_out) fp32."""

    def first_prefix(*candidates: str) -> str:
        for c in candidates:
            if any(k.startswith(c) for k in state):
                return c
        raise KeyError(
            f"None of {candidates} found. Available prefixes: "
            f"{sorted({k.split('.')[0] for k in state})}"
        )

    f32 = torch.float32
    try:
        enc = first_prefix("encoder", "enc")
        dec = first_prefix("decoder", "dec")
        converted = {
            "proj_point": _linear(state, f"{enc}.proj_in", dtype),
            "enc_cross_attn": _attention(state, f"{enc}.cross_attn.attn", dtype),
            "enc_norm_cross": _layer_norm(state, f"{enc}.cross_attn.norm"),
            "enc_blocks": [_flow_block(state, f"{enc}.blocks.{i}", dtype) for i in range(cfg.encoder_layers)],
            "enc_norm_out": _layer_norm(state, f"{enc}.norm_out"),
            "enc_proj_out": _linear(state, f"{enc}.proj_out", dtype),
            "post_quant": _linear(state, "post_quant", dtype),
            "dec_blocks": [_flow_block(state, f"{dec}.blocks.{i}", dtype) for i in range(cfg.decoder_layers)],
            "proj_query": _linear(state, f"{dec}.proj_query", f32),
            "dec_cross_attn": _attention(state, f"{dec}.cross_attn.attn", dtype, fp32=True),
            "dec_norm_cross_q": _layer_norm(state, f"{dec}.cross_attn.norm"),
            "dec_norm_out": _layer_norm(state, f"{dec}.norm_out"),
            "dec_proj_out": _linear(state, f"{dec}.proj_out", f32),
        }
    except KeyError as e:
        raise KeyError(
            f"TripoSG VAE key mapping mismatch: {e}.\n"
            "Fix the prefix table in convert_triposg_vae against this checkpoint "
            "structure:\n" + describe_state_dict(state)
        ) from e
    from actionmesh_tpu_torch.models.triposg.vae import init_triposg_vae

    verify_converted(
        converted, lambda dev: init_triposg_vae(torch.Generator(), cfg, dtype=dtype, device=dev),
        "triposg_vae",
    )
    return converted


def load_denoiser(path: str | Path, cfg, dtype: torch.dtype = torch.bfloat16, device=None):
    """Read, convert and verify the Stage-I denoiser checkpoint; the port's params."""
    return params_from_jax(convert_denoiser(load_safetensors_dir(path), cfg, dtype), device)


def load_autoencoder(path: str | Path, cfg, dtype: torch.dtype = torch.bfloat16, device=None):
    """Read, convert and verify the Stage-II autoencoder checkpoint; the port's params."""
    return params_from_jax(convert_autoencoder(load_safetensors_dir(path), cfg, dtype), device)


def load_dinov2(path: str | Path, cfg, dtype: torch.dtype = torch.bfloat16, device=None):
    """Read, convert and verify a DINOv2 checkpoint; the port's params."""
    return params_from_jax(convert_dinov2(load_safetensors_dir(path), cfg, dtype), device)
