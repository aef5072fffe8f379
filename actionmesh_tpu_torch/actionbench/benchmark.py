"""ActionBench metrics core: CD-3D / CD-4D / CD-Motion.

Counterpart of ``actionbench/benchmark.py``:
  * CD-3D: per-frame gradient ICP, then the mean chamfer over frames;
  * CD-4D: frame 0's alignment applied to every frame;
  * CD-M: motion chamfer on synchronized barycentric samples.
ICP runs on ``device`` (``icp.py``); sampling and the scipy KDTree chamfer
(``actionbench/chamfer.py``, shared with the JAX package) run on the host.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from actionbench.chamfer import compute_chamfer_score, compute_motion_chamfer_score
from actionbench.sample_point_cloud import sample_point_cloud
from actionmesh_tpu_torch.actionbench.icp import Transform, gradient_icp_multi
from actionmesh_tpu_torch.actionbench.sample_mesh import sample_meshes
from actionmesh_tpu_torch.io.mesh import Mesh


def compute_chamfer_3d_4d(
    gt_pc: np.ndarray,
    pred_meshes: list[Mesh],
    device: str = "cuda",
    is_4D: bool = False,
    n_pts_icp: int = 10_000,
    n_pts_chamfer: int = 100_000,
    seed: int = 44,
    icp_iters: int = 200,
    icp_nn_every: int = 1,
    icp_lr: float = 0.01,
    seconds: Optional[dict] = None,
) -> tuple[float, float, float]:
    """Returns (cd_3d, cd_4d, cd_motion); cd_motion is 0.0 unless is_4D.

    All T per-frame alignments run as one batch of T * 24 transforms. If
    ``seconds`` is a dict, the host-clock seconds of sampling, ICP (ended by
    the copy of its result to the host) and chamfer are added to it under
    those keys.
    """
    clock = {"sampling": 0.0, "icp": 0.0, "chamfer": 0.0}
    t0 = time.perf_counter()

    def lap(key):
        nonlocal t0
        t1 = time.perf_counter()
        clock[key] += t1 - t0
        t0 = t1

    n_ts = len(pred_meshes)
    gt_pc = np.asarray(gt_pc, np.float32)
    pred_pc = sample_meshes(pred_meshes, n_pts=n_pts_chamfer, synchronized=False, seed=seed)
    pred_pc_icp = sample_point_cloud(pred_pc, n_pts=n_pts_icp, seed=seed)
    gt_pc_icp = sample_point_cloud(gt_pc, n_pts=n_pts_icp, seed=seed)
    lap("sampling")

    icp_3d = gradient_icp_multi(
        pc_pred=pred_pc_icp, pc_gt=gt_pc_icp, lr=icp_lr, n_iter=icp_iters,
        nn_every=icp_nn_every, device=device,
    )
    lap("icp")
    # The unified 4D alignment optimises exactly frame 0's (gt, pred) pair,
    # which is frame 0's per-frame result: reuse it.
    icp_u4d = Transform(R=icp_3d.R[:1], T=icp_3d.T[:1], s=icp_3d.s[:1])

    pred_aligned_3d = icp_3d.transform_points(pred_pc)
    pred_aligned_u4d = icp_u4d.transform_points(pred_pc)
    cd_3d = float(np.mean([
        compute_chamfer_score(gt=gt_pc[k], pred=pred_aligned_3d[k]) for k in range(n_ts)
    ]))
    cd_4d = float(np.mean([
        compute_chamfer_score(gt=gt_pc[k], pred=pred_aligned_u4d[k]) for k in range(n_ts)
    ]))
    lap("chamfer")

    cd_motion = 0.0
    if is_4D:
        pred_pc_4d = sample_meshes(pred_meshes, n_pts=n_pts_chamfer, synchronized=True, seed=seed)
        lap("sampling")
        pred_aligned_4d = icp_u4d.transform_points(pred_pc_4d)
        cd_motion = compute_motion_chamfer_score(preds=pred_aligned_4d, gts=gt_pc)
        lap("chamfer")

    if seconds is not None:
        for key, value in clock.items():
            seconds[key] = seconds.get(key, 0.0) + value
    return cd_3d, cd_4d, cd_motion
