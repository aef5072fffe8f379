"""Device mesh, parameter layout and shard helpers over ``torch.distributed``.

Counterpart of ``actionmesh_tpu/parallel/mesh.py``. The program is SPMD: one
process per card (NCCL), or per CPU rank in the tests (gloo), every rank
running the same code on its own shard. The mesh has up to three axes:

  * ``dp``: data parallel over the batch (the CFG branches of Stage I and
    Stage 0, the folded target batch of Stage II, the SDF query chunks);
  * ``tp``: tensor parallel over attention heads and the feed-forward inner
    dim, Megatron-style: column-parallel ``to_q/k/v`` and ``net_0``,
    row-parallel ``to_out`` and ``net_2`` followed by an all-reduce over
    ``tp`` (the bias added once, after it);
  * ``sp``: sequence parallel over frames; the inflated self-attention then
    runs a ring over ``sp`` (``ops/attention.py:ring_attention_local``).

Functions that take ``mesh`` at the model level (``denoise_window``,
``denoiser_forward``, ``autoencoder_forward``, ``flow_sample``,
``dot_product_attention``, ``fused_rms_rope``) take and return whole
tensors, the same on every rank, as their JAX counterparts take and return
global arrays; inside, each rank computes its shard (``local_shard``) and the
results are gathered back (``gather_shards``). The layers below them
(``models/layers.py``) work on the rank's local shard. An axis that does not
divide the dimension it would split leaves that dimension whole on every
rank of the axis (the same work on each), as in JAX.

Parameters are the JAX package's trees with torch tensors; a spec tree
(``denoiser_param_shardings``, ``autoencoder_param_shardings``) gives for
each leaf the torch dim it splits over ``tp`` (None: replicated), and
``shard_params`` cuts this rank's slices out of the full tree, which every
rank first builds or loads alike.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("dp", "tp", "sp")


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

def mesh_shape(
    n_devices: int, dp: Optional[int] = None, tp: Optional[int] = None, sp: Optional[int] = None
) -> tuple[int, ...]:
    """(dp, tp) or, with ``sp``, (dp, tp, sp): JAX ``make_mesh``'s defaults
    and asserts. Without dp and tp: dp = 2 (the CFG branches) when the
    devices left after sp are even and more than one, the rest tp."""
    sp_size = 1 if sp is None else sp
    inner = n_devices // sp_size
    assert inner * sp_size == n_devices, "sp must divide n_devices"
    if dp is None and tp is None:
        dp = 2 if inner % 2 == 0 and inner > 1 else 1
        tp = inner // dp
    elif dp is None:
        dp = inner // tp
    elif tp is None:
        tp = inner // dp
    assert dp * tp * sp_size == n_devices, f"dp*tp*sp must equal n_devices ({n_devices})"
    return (dp, tp) if sp is None else (dp, tp, sp_size)


def make_mesh(
    n_devices: Optional[int] = None,
    dp: Optional[int] = None,
    tp: Optional[int] = None,
    sp: Optional[int] = None,
):
    """A ``DeviceMesh`` with dim names ("dp", "tp") or ("dp", "tp", "sp")
    over every rank of the initialised process group (``mesh_shape`` gives
    its shape), on "cuda" under NCCL, else on "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices != world:
        raise ValueError(f"make_mesh: a mesh spans every rank ({world}), not {n_devices}")
    shape = mesh_shape(n_devices, dp, tp, sp)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES[: len(shape)])


def default_mesh():
    """``make_mesh()`` when torch.distributed is initialised with more than
    one rank (JAX's "more than one device"), else None."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        return make_mesh()
    return None


def layout(mesh) -> dict[str, int]:
    """{axis name: size} of ``mesh`` ({} for None)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, name: str) -> int:
    """Size of axis ``name``; 1 without a mesh or without that axis."""
    return layout(mesh).get(name, 1)


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate on axis ``name`` (0 where the size is 1)."""
    return mesh.get_local_rank(name) if axis_size(mesh, name) > 1 else 0


def shard_count(mesh, axes: Sequence[str]) -> int:
    return math.prod(axis_size(mesh, a) for a in axes)


def shard_index(mesh, axes: Sequence[str]) -> int:
    """This rank's shard over ``axes``, the first axis the major one (JAX's
    ("dp", "sp") order)."""
    index = 0
    for a in axes:
        index = index * axis_size(mesh, a) + axis_index(mesh, a)
    return index


def local_shard(x: torch.Tensor, dim: int, mesh, axes: Sequence[str]) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``axes`` (a view); the
    dim must divide (see ``split_axes``)."""
    n = shard_count(mesh, axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"local_shard: dim {dim} of {tuple(x.shape)} does not split {n} ways")
    size = x.shape[dim] // n
    return x.narrow(dim, shard_index(mesh, axes) * size, size)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` of ``group`` along ``dim``, in rank order."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def gather_shards(x: torch.Tensor, dim: int, mesh, axes: Sequence[str]) -> torch.Tensor:
    """The inverse of ``local_shard``: the whole tensor on every rank."""
    for a in reversed(tuple(axes)):  # the minor axis first
        if axis_size(mesh, a) > 1:
            x = all_gather(x, dim, mesh.get_group(a))
    return x


def split_axes(n: int, mesh, axes: Sequence[str]) -> tuple[str, ...]:
    """``axes`` (those of size > 1) if their product divides ``n``, else ():
    a dimension an axis does not divide stays whole on every rank."""
    axes = tuple(a for a in axes if axis_size(mesh, a) > 1)
    return axes if axes and n % shard_count(mesh, axes) == 0 else ()


def attention_split(mesh, B: int, H: int, Sq: int, Sk: int, ring: bool = True):
    """How a whole (B, H, Sq|Sk, D) attention operand splits over the mesh:
    (batch axes, heads over tp, sequence over sp). JAX
    ``_sharded_attention``'s rule: batch over dp, heads over tp, the
    sequence over sp when Sq == Sk and sp divides it (``ring``; JAX
    ``_fused_sharded`` asks only that sp divide S); without the sequence
    split, the batch over (dp, sp) or sp when they divide it (per-frame
    attention). An axis that does not divide leaves its dimension whole."""
    dp, sp = axis_size(mesh, "dp"), axis_size(mesh, "sp")
    b_axes = split_axes(B, mesh, ("dp",))
    heads = bool(split_axes(H, mesh, ("tp",)))
    seq = sp > 1 and Sq % sp == 0 and Sk % sp == 0 and (Sq == Sk or not ring)
    if not seq and sp > 1:
        if b_axes and B % (dp * sp) == 0:
            b_axes = ("dp", "sp")
        elif not b_axes and B % sp == 0:
            b_axes = ("sp",)
    return b_axes, heads, seq


def all_reduce_sum(x: torch.Tensor, mesh, name: str) -> torch.Tensor:
    """Sum ``x`` (in place) over axis ``name``; returns it."""
    if axis_size(mesh, name) > 1:
        dist.all_reduce(x, group=mesh.get_group(name))
    return x


def broadcast_object(obj, src: int = 0):
    """``obj`` as rank ``src`` holds it, on every rank (pickled)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def init_distributed(device_type: str = "cuda") -> torch.device:
    """Join the process group ``torchrun`` describes (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR/PORT in the environment) and return this rank's
    device. On "cuda" the rank's card (LOCAL_RANK) becomes the current device
    before any CUDA work and the backend is NCCL; on "cpu" gloo."""
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: CUDA is not available (use device_type='cpu')")
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(
                f"init_distributed: LOCAL_RANK {local_rank} but {torch.cuda.device_count()} card(s)"
            )
        torch.cuda.set_device(local_rank)
        device = torch.device("cuda", local_rank)
    else:
        device = torch.device("cpu")
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            rank=int(os.environ["RANK"]),
            world_size=int(os.environ["WORLD_SIZE"]),
        )
    return device


# ---------------------------------------------------------------------------
# Parameter layout
# ---------------------------------------------------------------------------

# torch linears hold weight (out, in): column-parallel splits dim 0 (and the
# bias), row-parallel dim 1 (its bias is added after the all-reduce)
COL = {"weight": 0, "bias": 0}
ROW = {"weight": 1, "bias": None}


def tp_splits_heads(heads: int, tp: int) -> bool:
    """Whether an attention of ``heads`` heads splits its heads over a tp
    axis of size ``tp`` (else its weights replicate and every tp rank runs
    all heads). The layers and the spec trees both decide by this."""
    return tp > 1 and heads % tp == 0


def _attention_spec(split: bool):
    """Megatron col -> row; None (every leaf replicated) when tp does not
    divide the heads. A split over a tp axis of size 1 is the whole leaf."""
    if not split:
        return None
    return {"to_q": COL, "to_k": COL, "to_v": COL, "to_out": ROW}


def _block_spec(split: bool) -> dict:
    return {"s_attn": _attention_spec(split), "x_attn": _attention_spec(split),
            "ff": {"net_0": COL, "net_2": ROW}}


def _prune_to(spec, params):
    """The spec for every leaf of ``params`` (dicts and lists): the spec's
    entry where it has one, None (replicated) where not."""
    if isinstance(params, dict):
        return {k: _prune_to(spec.get(k) if isinstance(spec, dict) else None, v)
                for k, v in params.items()}
    if isinstance(params, list):
        specs = spec if isinstance(spec, list) and len(spec) == len(params) else [spec] * len(params)
        return [_prune_to(s, p) for s, p in zip(specs, params)]
    return spec if isinstance(spec, int) else None


def _check_inner(params: dict, key: str, tp: int) -> None:
    """Raise if tp does not divide a column-parallel inner dim: the layers
    reduce after every row-parallel linear under tp."""
    inner = params[key]["weight"].shape[0]
    if tp > 1 and inner % tp:
        raise ValueError(f"tp={tp} does not divide the inner dim {inner} of {key}")


def denoiser_param_shardings(params: dict, mesh, heads: int) -> dict:
    """Spec tree of the Stage-I denoiser (and the TripoSG DiT): attention and
    feed-forward Megatron col -> row, the time MLP col -> row, the rest
    replicated. ``heads``: the attention head count (``tp_splits_heads``)."""
    tp = axis_size(mesh, "tp")
    for block in params["blocks"]:
        _check_inner(block["ff"], "net_0", tp)
    _check_inner(params["time_proj"], "linear_1", tp)
    spec = {
        "time_proj": {"linear_1": COL, "linear_2": ROW},
        "blocks": [_block_spec(heads % tp == 0)] * len(params["blocks"]),
    }
    return _prune_to(spec, params)


def autoencoder_param_shardings(params: dict, mesh, heads: int) -> dict:
    """Spec tree of the Stage-II autoencoder: its blocks as the denoiser's,
    the query projection, head and post-quant replicated."""
    tp = axis_size(mesh, "tp")
    for block in params["blocks"]:
        _check_inner(block["ff"], "net_0", tp)
    spec = {"blocks": [_block_spec(heads % tp == 0)] * len(params["blocks"])}
    return _prune_to(spec, params)


def shard_params(params, shardings, mesh):
    """This rank's local slices of the full tree ``params``: each leaf whose
    spec is a dim is cut along it over ``tp`` (a fresh tensor, so the full
    one can be freed), the others kept. A dim that tp does not divide keeps
    the leaf whole, as in JAX."""
    tp, r = axis_size(mesh, "tp"), axis_index(mesh, "tp")
    if isinstance(params, dict):
        return {k: shard_params(v, shardings[k], mesh) for k, v in params.items()}
    if isinstance(params, list):
        return [shard_params(p, s, mesh) for p, s in zip(params, shardings)]
    if shardings is None or tp == 1 or params.shape[shardings] % tp:
        return params
    n = params.shape[shardings] // tp
    return params.narrow(shardings, r * n, n).clone(memory_format=torch.contiguous_format)
