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

On a device mesh (``mesh`` with the ``shardings`` spec tree the params were
cut by) the rank's tp slices of the params, moments, accumulator and EMA
are gathered leaf by leaf and rank 0 writes the full tree, the same file
an unsharded run writes; restore reads the full tree on every rank and
keeps the rank's slices, so a run resumes at any layout.
"""

from __future__ import annotations

import os
import zipfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from actionmesh_tpu_torch.parallel.mesh import (
    axis_index,
    axis_size,
    gather_params,
    gather_shards,
    is_writer,
    on_writer,
)
from actionmesh_tpu_torch.utils.tree import named_leaves


def _state_leaves(state: dict):
    """(name, leaf) of the tensors and integer counters of a train state."""
    for name, leaf in named_leaves(state):
        if not isinstance(leaf, (torch.Tensor, int)):
            raise TypeError(f"train state leaf {name} is a {type(leaf).__name__}")
        yield name, leaf


def _tp_dims(state: dict, shardings, mesh) -> dict:
    """{state leaf name: the dim it is cut along over tp} on a tp mesh: every
    sub-tree of the state shaped as the params tree (the params, the EMA,
    and whatever the optimizer keeps per param) is cut as ``shardings``
    says, as JAX's ``optimizer_state_shardings`` lays the state out."""
    if shardings is None or axis_size(mesh, "tp") == 1:
        return {}
    specs = list(named_leaves(shardings))
    names = [n for n, _ in specs]
    dims = {}

    def visit(tree, prefix: str) -> None:
        if [n for n, _ in named_leaves(tree)] == names:
            dims.update({prefix + n: d for n, d in specs if d is not None})
        elif isinstance(tree, dict):
            for key, sub in tree.items():
                visit(sub, f"{prefix}{key}.")

    visit(state, "")
    return dims


def save_train_state(state: dict, path: str | Path, mesh=None, shardings=None) -> Path:
    """Atomically write every leaf of ``state`` to the npz at ``path``.

    On a mesh every rank calls it (the tp gathers are collectives) and
    rank 0 writes the full tree; the others wait until the file is in
    place."""
    path = Path(path)
    dims = _tp_dims(state, shardings, mesh)
    writes = is_writer()
    tmp = path.with_name(f".{path.name}.tmp")
    zf = None
    if writes:
        path.parent.mkdir(parents=True, exist_ok=True)
        zf = zipfile.ZipFile(tmp, "w", zipfile.ZIP_STORED, allowZip64=True)
    try:
        for name, leaf in _state_leaves(state):
            if isinstance(leaf, torch.Tensor):
                if name in dims:
                    leaf = gather_shards(leaf.detach(), dims[name], mesh, ("tp",))
                arr = leaf.detach().cpu().numpy() if writes else None
            else:
                arr = np.asarray(leaf, dtype=np.int64)
            if writes:
                with zf.open(f"{name}.npy", "w", force_zip64=True) as fh:
                    np.lib.format.write_array(fh, arr, allow_pickle=False)
    finally:
        if zf is not None:
            zf.close()
    on_writer(lambda: os.replace(tmp, path))
    return path


def restore_train_state(path: str | Path, template: dict, mesh=None, shardings=None) -> dict:
    """Fill ``template`` (a state of the same model and optimizer) in place
    from ``save_train_state`` output; raise on a missing, extra or
    mis-shaped leaf. On a mesh each rank reads the full tree and keeps its
    tp slices of the leaves ``shardings`` cuts."""
    dims = _tp_dims(template, shardings, mesh)
    tp, r = axis_size(mesh, "tp"), axis_index(mesh, "tp")
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
            if name in dims and arr.shape[dims[name]] == leaf.shape[dims[name]] * tp:
                n = leaf.shape[dims[name]]
                arr = arr[(slice(None),) * dims[name] + (slice(r * n, (r + 1) * n),)]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"{name}: checkpoint shape {tuple(arr.shape)} != state shape {tuple(leaf.shape)}"
                )
            with torch.no_grad():
                leaf.copy_(torch.from_numpy(np.ascontiguousarray(arr)))
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
    mesh=None,
    shardings=None,
) -> Path:
    """Write the params of ``stage`` as ``path/<EXPORT_NAMES[stage]>`` for
    inference: the EMA shadow where kept, matmul weights cast to
    ``compute_dtype``, norm leaves left fp32. On a mesh the full tree
    (gathered over tp; every rank calls it), written by rank 0."""
    from actionmesh_tpu_torch.training.flow_train import cast_params_for_compute
    from actionmesh_tpu_torch.utils.weights import save_npz

    if stage not in EXPORT_NAMES:
        raise ValueError(f"stage must be one of {sorted(EXPORT_NAMES)}, got {stage!r}")
    params = state.get("ema_params", state["params"])
    if mesh is not None and shardings is not None:
        params = gather_params(params, shardings, mesh)
    if compute_dtype is not None:
        params = cast_params_for_compute(params, compute_dtype)
    out_dir = Path(path)
    out = out_dir / EXPORT_NAMES[stage]

    def write() -> None:
        out_dir.mkdir(parents=True, exist_ok=True)
        save_npz(params, out)

    on_writer(write)
    return out
