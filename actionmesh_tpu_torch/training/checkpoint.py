"""Train-state checkpoints and inference export.

Counterpart of ``actionmesh_tpu/training/checkpoint.py``. The whole train
state (params, Adam moments and counts, step, EMA shadow) goes into one
``.npz`` with one entry per leaf, named by its dotted path
(``opt_state.mu.blocks.3.ff.net_0.weight``), written leaf by leaf (a
full-width state is ~23 GB; no second host copy of it is made) to a
temporary file that is then renamed over the target, so a crash never
leaves a half-written checkpoint. Restore fills a template state built the
same way (``init_train_state``) in place, checking names and shapes.

``export_for_inference`` writes ``denoiser.npz``, ``autoencoder.npz``,
``dit.npz`` or ``vae.npz`` (JAX's four stage names) in the JAX
``save_params`` layout (``utils/weights.save_npz``), so the JAX package's
``load_params`` and the port's ``load_npz`` both read it.
"""

from __future__ import annotations

import os
import zipfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from actionmesh_tpu_torch.utils.tree import named_leaves


def _state_leaves(state: dict):
    """(name, leaf) of the tensors and integer counters of a train state."""
    for name, leaf in named_leaves(state):
        if not isinstance(leaf, (torch.Tensor, int)):
            raise TypeError(f"train state leaf {name} is a {type(leaf).__name__}")
        yield name, leaf


def save_train_state(state: dict, path: str | Path) -> Path:
    """Atomically write every leaf of ``state`` to the npz at ``path``."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.tmp")
    with zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, leaf in _state_leaves(state):
            if isinstance(leaf, torch.Tensor):
                arr = leaf.detach().cpu().numpy()
            else:
                arr = np.asarray(leaf, dtype=np.int64)
            with zf.open(f"{name}.npy", "w", force_zip64=True) as fh:
                np.lib.format.write_array(fh, arr, allow_pickle=False)
    os.replace(tmp, path)
    return path


def restore_train_state(path: str | Path, template: dict) -> dict:
    """Fill ``template`` (a state of the same model and optimizer) in place
    from ``save_train_state`` output; raise on a missing, extra or
    mis-shaped leaf."""
    with np.load(path) as archive:
        stored = set(archive.files)
        wanted = dict(_state_leaves(template))
        if stored != set(wanted):
            raise ValueError(
                f"checkpoint {path} does not match the train state: missing "
                f"{sorted(set(wanted) - stored)[:5]}, extra {sorted(stored - set(wanted))[:5]}"
            )
        for name, leaf in wanted.items():
            arr = archive[name]
            if not isinstance(leaf, torch.Tensor):
                _set_path(template, name, int(arr))
                continue
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"{name}: checkpoint shape {tuple(arr.shape)} != state shape {tuple(leaf.shape)}"
                )
            with torch.no_grad():
                leaf.copy_(torch.from_numpy(arr))
    return template


def _set_path(tree, dotted: str, value) -> None:
    *parents, last = dotted.split(".")
    for key in parents:
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    tree[last] = value


# stage -> the file the inference loaders read (JAX's names)
EXPORT_NAMES = {
    "flow": "denoiser.npz",
    "decoder": "autoencoder.npz",
    "stage0_dit": "dit.npz",
    "stage0_vae": "vae.npz",
}


def export_for_inference(
    state: dict,
    path: str | Path,
    *,
    stage: str = "flow",
    compute_dtype: Optional[torch.dtype] = torch.bfloat16,
) -> Path:
    """Write the params of ``stage`` as ``path/<EXPORT_NAMES[stage]>`` for
    inference: the EMA shadow where kept, matmul weights cast to
    ``compute_dtype``, norm leaves left fp32."""
    from actionmesh_tpu_torch.training.flow_train import cast_params_for_compute
    from actionmesh_tpu_torch.utils.weights import save_npz

    if stage not in EXPORT_NAMES:
        raise ValueError(f"stage must be one of {sorted(EXPORT_NAMES)}, got {stage!r}")
    params = state.get("ema_params", state["params"])
    if compute_dtype is not None:
        params = cast_params_for_compute(params, compute_dtype)
    out_dir = Path(path)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / EXPORT_NAMES[stage]
    save_npz(params, out)
    return out
