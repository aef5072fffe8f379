"""Nearest-neighbour argmin: the wrapper of the Hopper kernel in
``csrc/nn_argmin.cu`` (kernel E), its plain PyTorch version and a plain
model of the kernel's arithmetic.

Kernel E replaces ``actionmesh_tpu/ops/nn_argmin.py:nn_argmin`` (the Pallas
TPU kernel) and meets its contract: for each x point the index of the
nearest y point, x (R, N, C) and y (R, M, C) with C <= 8, cast to fp32, no
gradient, (R, N) int32 out, ties to the smallest index. It is the inner
loop of gradient ICP (``actionbench/icp.py``). It computes its distance
tiles on the TF32 tensor cores in split precision (3xTF32); see the note at
the top of the CUDA source. On CPU tensors ``nn_argmin`` runs
``nn_argmin_reference``; on CUDA tensors it launches the kernel or raises.
``nn_argmin.launches`` counts kernel launches. ``nn_argmin_model`` repeats
the kernel's arithmetic (split, packing, tiles) for the tests and the
card's checks; no path calls it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

_lib = None


def _library():
    global _lib
    if _lib is None:
        from actionmesh_tpu_torch.utils.cuda_build import load_library

        lib = load_library("nn_argmin")
        lib.nn_argmin.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.nn_argmin.restype = ctypes.c_int
        lib.nn_argmin_workspace.argtypes = [ctypes.c_int] * 3
        lib.nn_argmin_workspace.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def nn_argmin_reference(x: torch.Tensor, y: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """The plain version, as the JAX package's CPU path computes it
    (``actionbench/icp.py:_nn_indices``): ``|x|^2 - 2 x.y + |y|^2`` through a
    batched matrix product, one (R, chunk, M) block of x rows at a time, and
    the first minimum of each row. ``chunk`` bounds the block's memory."""
    x = x.detach().float()
    y = y.detach().float()
    y_sq = (y * y).sum(-1)  # (R, M)
    out = []
    for x_chunk in x.split(chunk, dim=1):
        x_sq = (x_chunk * x_chunk).sum(-1)  # (R, c)
        cross = torch.bmm(x_chunk, y.transpose(1, 2))  # (R, c, M)
        d = x_sq[..., None] - 2.0 * cross + y_sq[:, None, :]
        out.append(d.argmin(-1).to(torch.int32))
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# A plain model of the kernel's arithmetic (tests and card checks only)
# ---------------------------------------------------------------------------

TILE = 128  # y points a tile of the kernel's sweep


def kernel_channels(C: int) -> int:
    """The channels the kernel is built for: C <= 3 as 3, else 8 (the
    wrapper pads with zeros, which add nothing to a distance)."""
    return 3 if C <= 3 else 8


OFFSET_SCALE = 1.0 + 2.0**-8  # the row offset is |x|^2 times it


def packed_depth(cp: int) -> int:
    """K: three segments of cp + 2 columns, rounded up to 8 (16 at 3, 32 at 8)."""
    return -(-3 * (cp + 2) // 8) * 8


def _fma_chain_sq(v: torch.Tensor) -> torch.Tensor:
    """sum of v_c^2 over the last axis as the kernel's fmaf chain: one fp32
    rounding a step (fp32 (..., C) -> fp32 (...))."""
    s = torch.zeros(v.shape[:-1], dtype=torch.float32)
    for c in range(v.shape[-1]):
        s = (v[..., c].double() ** 2 + s.double()).float()
    return s


def packed_operands(x: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's packed A (R, N, K) and B (R, M, K), fp32, from x and y
    padded to ``kernel_channels``: with a = [-2x, 1, s_x] and b = [y, |y|^2,
    1] (|y|^2 and |x|^2 as fp32 FMA chains over the channels, s_x = |x|^2
    times ``OFFSET_SCALE``, so that a.b = |x - y|^2 + |x|^2 / 256 > 0) and
    C1 = C + 2 columns each, A = [a_hi | a_lo | a_hi] and B = [b_lo | b_hi |
    b_hi], zero-padded to K, a multiple of 8. hi is ``tf32_split``'s, to the
    bit; lo as the tensor core reads it (its top 19 bits)."""
    from actionmesh_tpu_torch.ops.flash_attention import _tensor_core_view, tf32_split

    cp = kernel_channels(x.shape[-1])
    x = F.pad(x.float(), (0, cp - x.shape[-1]))
    y = F.pad(y.float(), (0, cp - y.shape[-1]))
    s_x = (_fma_chain_sq(x).double() * OFFSET_SCALE).float()
    one_x, one_y = torch.ones_like(x[..., :1]), torch.ones_like(y[..., :1])
    a = torch.cat([-2.0 * x, one_x, s_x[..., None]], dim=-1)
    b = torch.cat([y, _fma_chain_sq(y)[..., None], one_y], dim=-1)
    (a_hi, a_lo), (b_hi, b_lo) = tf32_split(a), tf32_split(b)
    a_lo, b_lo = _tensor_core_view(a_lo), _tensor_core_view(b_lo)
    k = packed_depth(cp)
    A = F.pad(torch.cat([a_hi, a_lo, a_hi], dim=-1), (0, k - 3 * (cp + 2)))
    B = F.pad(torch.cat([b_lo, b_hi, b_hi], dim=-1), (0, k - 3 * (cp + 2)))
    return A, B


def fma_distances(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """|y|^2 - 2 x.y as the kernel's CUDA cores form it inside the winning
    tile: the |y|^2 FMA chain, then one fmaf(-2 x_c, y_c, d) a channel, each
    rounded once to fp32. x (R, N, C), y (R, M, C) -> (R, N, M)."""
    d = _fma_chain_sq(y)[:, None, :].expand(-1, x.shape[1], -1)
    for c in range(x.shape[-1]):
        d = ((-2.0 * x[..., c]).double()[..., None] * y[..., c].double()[:, None, :] + d.double()).float()
    return d


def nn_argmin_model(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The kernel's result as its arithmetic gives it. The tensor-core pass:
    distances A.B^T of the packed operands, each product exact and the sum
    rounded once to fp32 (the tensor core's own sums truncate instead,
    within a few fp32 ulps), swept in tiles of ``TILE`` points; a tile's
    minimum replaces the row's best only if strictly smaller, so the winning
    tile is the first that holds the smallest distance. Then the first
    nearest point inside that tile by ``fma_distances``. (R, N) int32."""
    x, y = x.detach().cpu().float(), y.detach().cpu().float()
    A, B = packed_operands(x, y)
    d = torch.bmm(A.double(), B.double().transpose(1, 2)).float()  # (R, N, M)
    R, N, M = d.shape
    n_tiles = -(-M // TILE)
    d = F.pad(d, (0, n_tiles * TILE - M), value=float("inf"))
    tile_min = d.view(R, N, n_tiles, TILE).min(-1).values  # (R, N, n_tiles)
    win = (tile_min == tile_min.min(-1, keepdim=True).values).int().argmax(-1)  # first such tile
    cp = kernel_channels(x.shape[-1])
    xp, yp = F.pad(x, (0, cp - x.shape[-1])), F.pad(y, (0, cp - y.shape[-1]))
    dd = F.pad(fma_distances(xp, yp), (0, n_tiles * TILE - M), value=float("inf"))
    dd = dd.view(R, N, n_tiles, TILE).gather(2, win[..., None, None].expand(-1, -1, 1, TILE))[:, :, 0]
    first = (dd == dd.min(-1, keepdim=True).values).int().argmax(-1)
    return (win * TILE + first).to(torch.int32)


def _check(x: torch.Tensor, y: torch.Tensor) -> None:
    if not (x.is_cuda and y.is_cuda) or x.device != y.device:
        raise ValueError("nn_argmin: x and y must be CUDA tensors on one device")
    if x.ndim != 3 or y.ndim != 3 or x.shape[0] != y.shape[0] or x.shape[2] != y.shape[2]:
        raise ValueError(
            f"nn_argmin: x {tuple(x.shape)} and y {tuple(y.shape)} must be (R, N, C) and (R, M, C)"
        )
    R, N, C = x.shape
    if not 1 <= C <= 8:
        raise ValueError(f"nn_argmin: {C} channels; the kernel takes 1 to 8")
    if R == 0 or N == 0 or y.shape[1] == 0:
        raise ValueError(f"nn_argmin: empty input x {tuple(x.shape)}, y {tuple(y.shape)}")
    if R > 65535:  # grid y
        raise ValueError(f"nn_argmin: {R} problems, above 65535")


def nn_argmin(x: torch.Tensor, y: torch.Tensor, chunk: int = 2048) -> torch.Tensor:
    """For each x point the argmin-distance index into y. No gradient.

    x (R, N, C), y (R, M, C), C <= 8, any float dtype (computed in fp32) ->
    (R, N) int32; ties resolve to the smallest index. ``chunk`` is the plain
    version's block of x rows (CPU only); the kernel needs none.
    """
    if x.device.type == "cpu":
        return nn_argmin_reference(x, y, chunk=chunk)
    _check(x, y)
    C = x.shape[2]
    cp = kernel_channels(C)
    x, y = x.detach().float(), y.detach().float()
    if cp != C:
        x, y = F.pad(x, (0, cp - C)), F.pad(y, (0, cp - C))
    x, y = x.contiguous(), y.contiguous()
    R, N, _ = x.shape
    M = y.shape[1]
    out = torch.empty((R, N), dtype=torch.int32, device=x.device)
    # the pre-pass's packed y, sized by the library
    lib = _library()
    ws = torch.empty(lib.nn_argmin_workspace(R, M, cp), dtype=torch.float32, device=x.device)
    err = lib.nn_argmin(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), ws.data_ptr(), R, N, M, cp,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"nn_argmin launch failed: CUDA error {err}")
    nn_argmin.launches += 1
    return out


nn_argmin.launches = 0
