"""Nearest-neighbour argmin: the wrapper of the Hopper kernel in
``csrc/nn_argmin.cu`` (kernel E) and its plain PyTorch version.

Kernel E replaces ``actionmesh_tpu/ops/nn_argmin.py:nn_argmin`` (the Pallas
TPU kernel) and meets its contract: for each x point the index of the
nearest y point, x (R, N, C) and y (R, M, C) with C <= 8, cast to fp32, no
gradient, (R, N) int32 out, ties to the smallest index. It is the inner
loop of gradient ICP (``actionbench/icp.py``). See the note at the top of
the CUDA source for its design. On CPU tensors ``nn_argmin`` runs
``nn_argmin_reference``; on CUDA tensors it launches the kernel or raises.
``nn_argmin.launches`` counts kernel launches.
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
        lib.nn_argmin.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.nn_argmin.restype = ctypes.c_int
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
    cp = 3 if C <= 3 else 8  # channels the kernel is built for; zeros add nothing
    x = F.pad(x.detach().float(), (0, cp - C)).contiguous()
    y = F.pad(y.detach().float(), (0, cp - C)).contiguous()
    R, N, _ = x.shape
    out = torch.empty((R, N), dtype=torch.int32, device=x.device)
    err = _library().nn_argmin(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), R, N, y.shape[1], cp,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"nn_argmin launch failed: CUDA error {err}")
    nn_argmin.launches += 1
    return out


nn_argmin.launches = 0
