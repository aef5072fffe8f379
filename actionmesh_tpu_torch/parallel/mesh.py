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
``denoiser_forward``, ``autoencoder_forward``, ``flow_sample`` and the
trainers' losses) take and return whole tensors, the same on every rank, as
their JAX counterparts take and return global arrays; inside, each rank
computes its shard (``local_shard``) and the results are gathered back
(``gather_shards``). The layers below them (``models/layers.py``) and
``dot_product_attention(mesh=)`` work on the rank's local shard. An axis
that does not divide the dimension it would split leaves that dimension
whole on every rank of the axis (the same work on each), as in JAX.

Training differentiates through the mesh with the collectives of the
Megatron recipe, written as ``torch.autograd.Function``s: ``copy_to_tp``
(identity, its gradient summed over tp) on the input of every
column-parallel linear, ``reduce_from_tp`` (summed over tp, the gradient
passed through) after every row-parallel one, and ``gather_from`` for the
gathers (the backward takes the rank's own block, or sums the blocks first
where the ranks' gradients differ). The loss is then the same scalar on
every rank, each rank's parameter gradients hold the part of its own
(batch, frame) shard, and ``sync_grads`` sums them over dp and sp, never
over tp. Without gradients the in-place collectives run, as at inference.

Parameters are the JAX package's trees with torch tensors; a spec tree
(``denoiser_param_shardings``, ``autoencoder_param_shardings``) gives for
each leaf the torch dim it splits over ``tp`` (None: replicated), and
``shard_params`` cuts this rank's slices out of the full tree, which every
rank first builds or loads alike.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional, Sequence

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


def all_reduce_sum(x: torch.Tensor, mesh, name: str) -> torch.Tensor:
    """Sum ``x`` (in place) over axis ``name``; returns it."""
    if axis_size(mesh, name) > 1:
        dist.all_reduce(x, group=mesh.get_group(name))
    return x


# ---------------------------------------------------------------------------
# Collectives that autograd differentiates
# ---------------------------------------------------------------------------

def _summed(g: torch.Tensor, mesh, axes: Sequence[str]) -> torch.Tensor:
    """A contiguous copy of ``g`` summed over ``axes`` (autograd may hand
    the same gradient buffer to several functions, so it is not reduced in
    place)."""
    g = g.clone(memory_format=torch.contiguous_format)
    for a in axes:
        all_reduce_sum(g, mesh, a)
    return g


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.mesh, ("tp",)), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _summed(x, mesh, ("tp",))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axes, reduce):
        ctx.dim, ctx.mesh, ctx.axes, ctx.reduce = dim, mesh, axes, reduce
        return gather_shards(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce:
            g = _summed(g, ctx.mesh, ctx.axes)
        return local_shard(g, ctx.dim, ctx.mesh, ctx.axes), None, None, None, None


class _ShareGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def _differentiated(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """The input of a column-parallel linear: ``x`` as it is, its gradient
    (the sum of the rank's heads' or columns' parts) summed over tp."""
    if axis_size(mesh, "tp") > 1 and _differentiated(x):
        return _CopyToTP.apply(x, mesh)
    return x


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    """A row-parallel linear's partial products summed over tp (in place
    without gradients, as at inference); the gradient passes through."""
    if axis_size(mesh, "tp") == 1:
        return x
    if _differentiated(x):
        return _ReduceFromTP.apply(x, mesh)
    return all_reduce_sum(x, mesh, "tp")


def gather_from(x: torch.Tensor, dim: int, mesh, axes: Sequence[str], reduce: bool = False) -> torch.Tensor:
    """``gather_shards`` that autograd differentiates. The backward gives
    the rank its own block of the gradient: as it arrives where every rank
    computes the same from the gathered tensor (the loss), or summed over
    ``axes`` first with ``reduce`` (a reduce-scatter), where the ranks use
    it differently (Stage II's KV, attended by each rank's vertex
    queries)."""
    axes = tuple(a for a in axes if axis_size(mesh, a) > 1)
    if axes and _differentiated(x):
        return _GatherFrom.apply(x, dim, mesh, axes, reduce)
    return gather_shards(x, dim, mesh, axes)


def share_grad(x: torch.Tensor, mesh, split: Sequence[str]) -> torch.Tensor:
    """A model's gathered output, computed whole by every rank of each dp
    or sp axis not in ``split`` (one that does not divide what it would
    split): its gradient is divided by their sizes, so that ``sync_grads``'
    sum over dp and sp counts that work once."""
    copies = math.prod(axis_size(mesh, a) for a in ("dp", "sp") if a not in split)
    if copies > 1 and _differentiated(x):
        return _ShareGrad.apply(x, 1.0 / copies)
    return x


def sync_grads(grads: Sequence[torch.Tensor], mesh) -> list:
    """Sum each rank's parameter gradients over the dp and sp axes (in
    place, dp first), never over tp: a tp rank's gradient is of its own
    slices, or of a replicated leaf that every tp rank computed whole."""
    grads = list(grads)
    for a in ("dp", "sp"):
        if axis_size(mesh, a) > 1:
            group = mesh.get_group(a)
            works = [dist.all_reduce(g, group=group, async_op=True) for g in grads]
            for w in works:
                w.wait()
    return grads


def global_grad_norm(grads: Sequence[torch.Tensor], mesh=None, split: Optional[Sequence[bool]] = None):
    """The l2 norm of the whole model's gradient: the squares of the
    leaves that ``split`` marks (cut over tp, ``tp_split_leaves``) summed
    over tp, the replicated leaves counted once. Off a tp mesh, the sum in
    leaf order."""
    if split is None or axis_size(mesh, "tp") == 1:
        return torch.sqrt(sum(g.float().square().sum() for g in grads))
    sq = [g.float().square().sum() for g in grads]
    zero = sq[0].new_zeros(())
    cut = sum((s for s, c in zip(sq, split) if c), zero)
    whole = sum((s for s, c in zip(sq, split) if not c), zero)
    return torch.sqrt(whole + all_reduce_sum(cut, mesh, "tp"))


def is_writer() -> bool:
    """Whether this process writes a run's files and prints its messages:
    rank 0 of the process group, or the one process where there is none."""
    return not dist.is_initialized() or dist.get_rank() == 0


def on_writer(fn: Callable[[], None]) -> None:
    """``fn()`` (files the other ranks may then read) on the writer; every
    rank of the group calls it and waits until the writer is done."""
    if is_writer():
        fn()
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


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


def _spec_leaves(tree):
    """The leaves of a spec tree in the params tree's leaf order (dict keys
    in insertion order, as ``utils/tree.py`` walks them)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _spec_leaves(t)
    else:
        yield tree


def tp_split_leaves(shardings, mesh) -> list:
    """Per leaf of a spec tree, in leaf order: whether ``shard_params``
    cut it over tp (the spec functions give a dim only where tp divides
    it)."""
    tp = axis_size(mesh, "tp")
    return [tp > 1 and s is not None for s in _spec_leaves(shardings)]


def gather_params(local, shardings, mesh):
    """The inverse of ``shard_params``: the full tree on every rank, each
    cut leaf gathered over tp (a collective: every rank calls it)."""
    if isinstance(local, dict):
        return {k: gather_params(v, shardings[k], mesh) for k, v in local.items()}
    if isinstance(local, list):
        return [gather_params(p, s, mesh) for p, s in zip(local, shardings)]
    if shardings is None or axis_size(mesh, "tp") == 1:
        return local
    return gather_shards(local.detach(), shardings, mesh, ("tp",))


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
