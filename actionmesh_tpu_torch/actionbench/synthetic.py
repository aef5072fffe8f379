"""Synthetic ActionBench suite: GT vs perturbed GT through the full evaluator.

Counterpart of ``scripts/synthetic_actionbench.py``. It checks the metric
stack end to end (dataset layout, CSV and resume, synchronized sampling,
gradient ICP, chamfer and motion chamfer) on animated meshes with known
ground truth and perturbations of known expected behaviour:

  identity   pred == GT mesh              -> CD at the sampling floor
  rigid      fixed rot + aniso-scale + shift -> ICP must undo it (near floor)
  noise_XX   vertex jitter sigma = 0.0XX  -> CD grows monotonically with sigma

Writes {out}/gt/{uid}/surfaces.npy and {out}/pred/{uid}/mesh_*.glb, runs
the evaluator, and writes {out}/report.json with per-class means and the
two sanity checks.

Usage (from the repository root):
    python -m actionmesh_tpu_torch.actionbench.synthetic --out DIR [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np

from actionmesh_tpu_torch.io.mesh import Mesh
from actionmesh_tpu_torch.models.stage0 import make_uv_sphere

METRICS = ("cd_3d", "cd_4d", "cd_motion")


def _rot(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def animated_mesh_sequence(uid_seed: int, n_frames: int) -> list[Mesh]:
    """Deforming blob: asymmetric harmonic bumps + bend + slow rigid motion.

    Asymmetric on purpose (mixed 2/3/5-fold harmonics on distinct axes, an
    anisotropic base), so ICP has one global alignment: a symmetric fixture
    lets frame-0 ICP pick a symmetry-equivalent rotation that is wrong for
    the later, bent frames.
    """
    rng = np.random.default_rng(uid_seed)
    base = make_uv_sphere(n_lat=48, n_lon=64)
    v0 = base.vertices * (np.array([0.7, 0.5, 0.6]) + 0.1 * rng.random(3))
    phase = rng.random(3) * 2 * np.pi
    axis = rng.normal(size=3)
    meshes = []
    for t in range(n_frames):
        a = t / max(n_frames - 1, 1)
        # non-rigid: mixed-order harmonics, no rotational symmetry
        th = np.arctan2(v0[:, 1], v0[:, 0])
        ph = np.arctan2(v0[:, 2], np.linalg.norm(v0[:, :2], axis=1))
        bump = (
            0.10 * np.sin(3 * th + phase[0] + 2 * np.pi * a)
            + 0.06 * np.sin(2 * ph + phase[1] + 4 * np.pi * a)
            + 0.04 * np.sin(5 * th + 3 * ph + phase[2])
        )
        verts = v0 * (1 + bump[:, None])
        # bend: x-dependent rotation about z
        ang = 0.5 * a * verts[:, 0]
        ca, sa = np.cos(ang), np.sin(ang)
        verts = np.stack(
            [verts[:, 0], ca * verts[:, 1] - sa * verts[:, 2], sa * verts[:, 1] + ca * verts[:, 2]],
            axis=1,
        )
        # slow rigid drift
        verts = verts @ _rot(axis, 0.3 * a).T + np.array([0.1 * a, 0.05 * a, 0.0])
        meshes.append(Mesh(verts, base.faces.copy()))
    return meshes


def tracked_gt_points(meshes: list[Mesh], n_pts: int, seed: int) -> np.ndarray:
    """(T, n_pts, 6) tracked surface points and normals: frame-0
    barycentrics replayed on every frame."""
    rng = np.random.default_rng(seed)
    _, areas = meshes[0].face_normals_and_areas()
    cdf = np.cumsum(areas) / areas.sum()
    face_ids = np.searchsorted(cdf, rng.random(n_pts))
    u, v = rng.random(n_pts), rng.random(n_pts)
    flip = u + v > 1
    u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
    w = 1 - u - v
    out = []
    for m in meshes:
        tri = m.vertices[m.faces[face_ids]]  # (n, 3, 3)
        pts = u[:, None] * tri[:, 0] + v[:, None] * tri[:, 1] + w[:, None] * tri[:, 2]
        nrm, _ = m.face_normals_and_areas()
        out.append(np.concatenate([pts, nrm[face_ids]], axis=1))
    return np.stack(out).astype(np.float32)


def _perturb_rigid(meshes, rng):
    """Rotate, then scale, then translate: the inverse lies inside the ICP's
    alignment family ``s * p @ R + T`` (scale first). A scale-before-rotation
    perturbation would not be exactly invertible there and would leave a
    chamfer residual that is the fixture's, not the ICP's."""
    R = _rot(rng.normal(size=3), 0.6)
    scale = np.array([1.15, 0.9, 1.05])
    t = np.array([0.3, -0.2, 0.15])
    return [Mesh((m.vertices @ R) * scale + t, m.faces.copy()) for m in meshes]


def _perturb_noise(meshes, rng, sigma):
    return [Mesh(m.vertices + rng.normal(0, sigma, m.vertices.shape), m.faces.copy()) for m in meshes]


PERTURBATIONS = {
    "identity": lambda meshes, rng: meshes,
    "rigid": _perturb_rigid,
    "noise_02": lambda meshes, rng: _perturb_noise(meshes, rng, 0.02),
    "noise_05": lambda meshes, rng: _perturb_noise(meshes, rng, 0.05),
}


def build_dataset(out: Path, n_frames: int, n_pts_gt: int = 50_000, per_kind: int = 2) -> list[str]:
    """Write ``per_kind`` samples of every perturbation class under ``out``."""
    uids = []
    for i, (kind, perturb) in enumerate(PERTURBATIONS.items()):
        for rep in range(per_kind):
            uid = f"{kind}_{rep}"
            seed = 1000 * i + rep
            meshes = animated_mesh_sequence(seed, n_frames)
            gt = tracked_gt_points(meshes, n_pts_gt, seed=seed + 7)
            gt_dir = out / "gt" / uid
            gt_dir.mkdir(parents=True, exist_ok=True)
            np.save(gt_dir / "surfaces.npy", gt)
            pred_dir = out / "pred" / uid
            pred_dir.mkdir(parents=True, exist_ok=True)
            rng = np.random.default_rng(seed + 13)
            for t, m in enumerate(perturb(meshes, rng)):
                m.export(pred_dir / f"mesh_{t:02d}.glb")
            uids.append(uid)
    return uids


def per_kind_means(samples) -> dict:
    """Mean metrics of the successful samples, by class (uid "<kind>_<rep>")."""
    by_kind: dict[str, list] = {}
    for s in samples:
        if s.status == "success":
            by_kind.setdefault(s.uid.rsplit("_", 1)[0], []).append(s)
    return {
        kind: {m: float(np.mean([getattr(s, m) for s in group])) for m in METRICS}
        for kind, group in sorted(by_kind.items())
    }


def sanity_checks(per_kind: dict) -> dict:
    """identity <= rigid (recovered by ICP) and identity < noise_02 < noise_05."""
    return {
        "rigid_recovered": per_kind["rigid"]["cd_3d"] < 2 * per_kind["identity"]["cd_3d"] + 0.01,
        "noise_monotonic": per_kind["identity"]["cd_3d"]
        < per_kind["noise_02"]["cd_3d"]
        < per_kind["noise_05"]["cd_3d"],
    }


def main(argv=None) -> dict:
    from actionmesh_tpu_torch.actionbench.evaluate_dataset import evaluate_dataset

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=str, required=True, help="dataset, CSV and report directory")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--icp-iters", type=int, default=200)
    ap.add_argument("--skip-build", action="store_true")
    ap.add_argument("--per-kind", type=int, default=2, help="samples per perturbation class")
    ap.add_argument("--nn-every", type=int, default=1,
                    help="ICP correspondence refresh interval; 1 = the evaluator's exact default")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s")

    out = Path(args.out)
    t0 = time.time()
    if not args.skip_build:
        uids = build_dataset(out, args.frames, per_kind=args.per_kind)
        print(f"built {len(uids)} samples in {time.time() - t0:.0f} s")

    results = evaluate_dataset(
        gt_root=str(out / "gt"),
        pred_root=str(out / "pred"),
        output_csv=str(out / f"results_nn{args.nn_every}.csv"),
        device=args.device,
        icp_iters=args.icp_iters,
        icp_nn_every=args.nn_every,
    )
    per_kind = per_kind_means(results.samples)
    report = {
        "n_samples": len(results.samples),
        "n_success": sum(s.status == "success" for s in results.samples),
        "per_kind": per_kind,
        "wall_seconds": time.time() - t0,
        "icp_nn_every": args.nn_every,
        "device": args.device,
    }
    report["checks"] = checks = sanity_checks(per_kind)
    (out / "report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    if not all(checks.values()):
        raise SystemExit(f"metric-stack sanity failed: {checks}")
    return report


if __name__ == "__main__":
    main()
