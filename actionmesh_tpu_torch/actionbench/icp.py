"""Gradient ICP in PyTorch: rigid + anisotropic-scale alignment.

Counterpart of ``actionbench/icp.py``. K independent alignment problems,
each from 24 canonical rotation inits, are optimised as one batch of
K * 24 transforms by Adam over (translation, 6D rotation, scale) on the
symmetric chamfer loss. Correspondences come from the nearest-neighbour
argmin (``ops/nn_argmin.py``: kernel E on the card), refreshed without
gradient every ``nn_every`` Adam steps. The best transform of each problem
is tracked on the device; the loop makes no host sync until the end.

Returns an affine ``Transform`` (``s * p @ R + T``, row vectors, as
pytorch3d's Transform3d) of the best rotation basin per problem.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from actionmesh_tpu_torch.ops.nn_argmin import nn_argmin

# optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8), which the JAX package uses
B1, B2, EPS = 0.9, 0.999, 1e-8


def euler_angles_to_matrix_xyz(angles: np.ndarray) -> np.ndarray:
    """pytorch3d ``euler_angles_to_matrix`` with convention 'XYZ':
    R = X(a0) @ Y(a1) @ Z(a2), each the standard axis rotation."""

    def rx(t):
        c, s = np.cos(t), np.sin(t)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    def ry(t):
        c, s = np.cos(t), np.sin(t)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    def rz(t):
        c, s = np.cos(t), np.sin(t)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    return np.stack([rx(a[0]) @ ry(a[1]) @ rz(a[2]) for a in angles])


def canonical_rotation_matrices() -> np.ndarray:
    """The 24 axis-aligned orientation inits, (24, 3, 3) float64."""
    deg = np.pi / 180
    azim = np.array([0] * 4 + [90] * 4 + [180] * 4 + [270] * 4 + [0] * 4 + [90] * 4, np.float64) * deg
    elev = np.array([0] * 16 + [90] * 2 + [-90] * 2 + [90] * 2 + [-90] * 2, np.float64) * deg
    roll = np.array([0, 90, 180, 270] * 4 + [0, 90] * 4, np.float64) * deg
    return euler_angles_to_matrix_xyz(np.stack([azim, elev, roll], axis=-1))


def rotation_6d_to_matrix(r6d: torch.Tensor) -> torch.Tensor:
    """Gram-Schmidt 6D rotation parameterization (Zhou et al.), rows b1, b2, b3."""
    a1, a2 = r6d[..., :3], r6d[..., 3:]
    b1 = a1 / torch.linalg.vector_norm(a1, dim=-1, keepdim=True)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / torch.linalg.vector_norm(b2, dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


@dataclasses.dataclass
class Transform:
    """Affine transform p' = s * p @ R + T (row-vector convention)."""

    R: np.ndarray  # (K, 3, 3)
    T: np.ndarray  # (K, 3)
    s: np.ndarray  # (K, 3)

    def transform_points(self, points: np.ndarray) -> np.ndarray:
        """points (K|1, N, 3) or (N, 3) -> transformed, batched over K."""
        points = np.asarray(points, np.float64)
        if points.ndim == 2:
            points = points[None]
        K = len(self.R)
        if points.shape[0] == 1 and K > 1:
            points = np.broadcast_to(points, (K,) + points.shape[1:])
        elif points.shape[0] != K and K == 1:
            return np.einsum("tnd,de->tne", self.s[0] * points, self.R[0]) + self.T[0]
        return np.einsum("knd,kde->kne", self.s[:, None, :] * points, self.R) + self.T[:, None, :]


def _matmul3(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """a (R, ..., 3) @ m (R, 3, 3), written out: a 3-wide contraction is three
    broadcast multiply-adds, cheaper than a batched GEMM of that depth."""
    shape = (m.shape[0],) + (1,) * (a.ndim - 2) + (3,)
    return (
        a[..., 0:1] * m[:, 0].reshape(shape)
        + a[..., 1:2] * m[:, 1].reshape(shape)
        + a[..., 2:3] * m[:, 2].reshape(shape)
    )


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` rounded to fp32 as optax computes it. Adam's
    first step moves each parameter by lr * ((1 - b1) / c1) / sqrt((1 - b2) / c2)
    (for |g| >> eps); optax's fp32 corrections make that factor 1 - 6.6e-6,
    and a correction rounded otherwise shifts every parameter by that much
    of lr, a drift that ICP's discrete correspondences can amplify."""
    return float(np.float32(1.0) - np.float32(float(np.float32(decay)) ** count))


def _apply(params: dict, rot: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    return _matmul3(params["s"][:, None, :] * pts, rot) + params["T"][:, None, :]


def gradient_icp_multi(
    pc_pred: np.ndarray,
    pc_gt: np.ndarray,
    lr: float = 0.01,
    n_iter: int = 200,
    nn_every: int = 1,
    device: str | torch.device = "cuda",
) -> Transform:
    """Best rigid+scale alignment for K independent problems, 24 rotation
    inits each, as one batched Adam loop on ``device``. pc_pred (K, N, 3),
    pc_gt (K, M, 3).

    Exactly ``n_iter`` Adam steps: full rounds of ``nn_every`` steps, each
    after a correspondence refresh, then one shorter round for the
    remainder. Each refresh is two nearest-neighbour calls (pred -> gt,
    gt -> pred).
    """
    if not (pc_pred.ndim == 3 and pc_gt.ndim == 3 and len(pc_pred) == len(pc_gt)):
        raise ValueError(f"pc_pred {pc_pred.shape} and pc_gt {pc_gt.shape} must be (K, N, 3), (K, M, 3)")
    device = torch.device(device)
    K = len(pc_pred)
    r_init = torch.as_tensor(canonical_rotation_matrices(), dtype=torch.float32, device=device)
    n_rots = r_init.shape[0]
    R = K * n_rots
    pred = torch.as_tensor(np.asarray(pc_pred, np.float32), device=device)
    gt = torch.as_tensor(np.asarray(pc_gt, np.float32), device=device)
    # (K, N, 3) -> (K * n_rots, N, 3): each problem repeated for its inits
    pred_b = pred[:, None].expand(K, n_rots, *pred.shape[1:]).reshape(R, *pred.shape[1:])
    gt_b = gt[:, None].expand(K, n_rots, *gt.shape[1:]).reshape(R, *gt.shape[1:])
    r_init_b = r_init.repeat(K, 1, 1)
    # the plain version's (R, chunk, M) fp32 distance block stays ~<2 GB for any K
    nn_chunk = max(128, (2048 // K) // 128 * 128)

    params = {
        "T": torch.zeros((R, 3), device=device),
        "r6d": torch.tensor([[1.0, 0.0, 0.0, 0.0, 1.0, 0.0]], device=device).repeat(R, 1),
        "s": torch.ones((R, 3), device=device),
    }
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    best = {
        "R": torch.eye(3, device=device).repeat(K, 1, 1),
        "T": torch.zeros((K, 3), device=device),
        "s": torch.ones((K, 3), device=device),
    }
    best_loss = torch.full((K,), float("inf"), device=device)
    offsets = torch.arange(K, device=device) * n_rots
    count = 0

    def rotations(p):
        return _matmul3(r_init_b, rotation_6d_to_matrix(p["r6d"]))

    def adam_step(nn_ab_gt, pred_ba):
        nonlocal count, best_loss
        p = {k: v.requires_grad_() for k, v in params.items()}
        rot = rotations(p)
        moved = _apply(p, rot, pred_b)
        moved_ba = _apply(p, rot, pred_ba)
        losses = ((moved - nn_ab_gt).square().sum(-1).mean(-1)
                  + (gt_b - moved_ba).square().sum(-1).mean(-1))
        grads = torch.autograd.grad(losses.sum(), [p[k] for k in params])
        with torch.no_grad():
            count += 1
            c1, c2 = _bias_correction(B1, count), _bias_correction(B2, count)
            for (k, v), g in zip(params.items(), grads):
                mu[k] = (1.0 - B1) * g + B1 * mu[k]
                nu[k] = (1.0 - B2) * (g * g) + B2 * nu[k]
                params[k] = v.detach() - lr * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + EPS))
            # per-problem best: R before the step, T and s after it, as the
            # reference records them
            min_loss, arg = losses.detach().reshape(K, n_rots).min(dim=1)
            arg = arg + offsets
            improved = min_loss < best_loss
            for k, new in (("R", rot.detach()[arg]), ("T", params["T"][arg]), ("s", params["s"][arg])):
                best[k] = torch.where(improved.reshape((K,) + (1,) * (new.ndim - 1)), new, best[k])
            best_loss = torch.minimum(best_loss, min_loss)

    def round_(steps):
        # refresh correspondences at the current transform, no gradient; both
        # gathers are hoisted out of the steps (the transform is pointwise, so
        # moving the gathered pred subset equals gathering the moved cloud)
        with torch.no_grad():
            moved = _apply(params, rotations(params), pred_b)
            idx_ab = nn_argmin(moved, gt_b, chunk=nn_chunk).long()
            idx_ba = nn_argmin(gt_b, moved, chunk=nn_chunk).long()
            nn_ab_gt = torch.gather(gt_b, 1, idx_ab[..., None].expand(-1, -1, 3))
            pred_ba = torch.gather(pred_b, 1, idx_ba[..., None].expand(-1, -1, 3))
        for _ in range(steps):
            adam_step(nn_ab_gt, pred_ba)

    rounds, rem_steps = divmod(n_iter, nn_every)
    for _ in range(rounds):
        round_(nn_every)
    if rem_steps:
        round_(rem_steps)
    return Transform(**{k: v.cpu().double().numpy() for k, v in best.items()})


def gradient_icp(
    pc_pred: np.ndarray,
    pc_gt: np.ndarray,
    lr: float = 0.01,
    n_iter: int = 200,
    nn_every: int = 1,
    device: str | torch.device = "cuda",
) -> Transform:
    """Best rigid+scale alignment of pc_pred (N, 3) onto pc_gt (M, 3) over 24
    rotation inits (single-problem wrapper around gradient_icp_multi)."""
    return gradient_icp_multi(
        pc_pred[None], pc_gt[None], lr=lr, n_iter=n_iter, nn_every=nn_every, device=device
    )
