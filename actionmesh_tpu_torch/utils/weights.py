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
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

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
    """Write the port's params in the layout of the JAX package's
    ``save_params``: dotted keys, JAX kernels, and bf16 leaves as uint16 bit
    patterns under a ``::bf16`` key suffix. ``load_npz`` and the JAX
    ``load_params`` both read it."""
    dtypes = {name: leaf.dtype for name, leaf in named_leaves(params)}
    flat = {}
    for name, value in named_leaves(params_to_jax(params)):
        src = name[: -len("kernel")] + "weight" if name.endswith("kernel") else name
        if dtypes[src] == torch.bfloat16:
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
