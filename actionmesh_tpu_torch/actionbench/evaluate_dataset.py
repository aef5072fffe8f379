"""Dataset evaluation CLI: 3D/4D metrics with CSV resume.

Counterpart of ``actionbench/evaluate_dataset.py``: per-sample fault
isolation, the CSV written after every sample, resume from the CSV with
failed samples retried, and a summary JSON. The CSV has the JAX package's
columns in its order and is read and written with the ``csv`` module (no
pandas); NaN is an empty cell, so either package resumes from the other's
file.

Usage (from the repository root):
    python -m actionmesh_tpu_torch.actionbench.evaluate_dataset \
        --gt_root /path/to/gt --pred_root /path/to/pred \
        --output_csv results.csv [--device cuda]

Expected structure:
    GT:   {gt_root}/{uid}/surfaces.npy   (T, N, 6) tracked point clouds
    Pred: {pred_root}/{uid}/mesh_*.glb
"""

from __future__ import annotations

import argparse
import csv
import json
import logging
import math
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from actionmesh_tpu_torch.actionbench.benchmark import compute_chamfer_3d_4d
from actionmesh_tpu_torch.io.mesh import Mesh, load_glb
from actionmesh_tpu_torch.io.video_input import natsorted

logger = logging.getLogger(__name__)

COLUMNS = ("uid", "cd_3d", "cd_4d", "cd_motion", "n_frames", "status", "error_message")
METRICS = ("cd_3d", "cd_4d", "cd_motion")


@dataclass
class SampleResult:
    uid: str
    cd_3d: float = float("nan")
    cd_4d: float = float("nan")
    cd_motion: float = float("nan")
    n_frames: int = 0
    status: str = "pending"
    error_message: str = ""
    # host-clock seconds by phase (sampling, icp, chamfer); not in the CSV
    seconds: dict = field(default_factory=dict, compare=False)


@dataclass
class DatasetResults:
    samples: list[SampleResult] = field(default_factory=list)

    def add(self, result: SampleResult) -> None:
        self.samples.append(result)

    def summary(self) -> dict:
        success = [s for s in self.samples if s.status == "success"]
        n_total, n_success = len(self.samples), len(success)
        summary = {
            "n_total": n_total,
            "n_success": n_success,
            "n_failed": n_total - n_success,
            "success_rate": n_success / n_total if n_total else 0.0,
        }
        for key in METRICS:
            # the mean pandas takes: NaN cells skipped
            values = [getattr(s, key) for s in success if not math.isnan(getattr(s, key))]
            summary[f"{key}_mean"] = float(np.mean(values)) if values else float("nan")
        return summary


def resolve_device(device: str) -> torch.device:
    """The device to run ICP on; asking for CUDA without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: CUDA is not available (use --device cpu)")
    return dev


def find_uids(gt_root: Path, pred_root: Path, mesh_pattern: str = "mesh_*.glb") -> list[str]:
    gt_uids = {p.parent.name for p in gt_root.glob("*/surfaces.npy")}
    pred_uids = {p.relative_to(pred_root).parts[0] for p in pred_root.glob(f"*/{mesh_pattern}")}
    common = gt_uids & pred_uids
    logger.info("Found %d GT, %d pred, %d common", len(gt_uids), len(pred_uids), len(common))
    if not gt_uids:
        raise FileNotFoundError(f"No GT samples found in {gt_root}. Expected */surfaces.npy files.")
    if not pred_uids:
        raise FileNotFoundError(f"No predictions found in {pred_root}. Expected */{mesh_pattern}.")
    if not common:
        raise ValueError("No common UIDs between GT and predictions.")
    if gt_uids - pred_uids:
        logger.warning("Missing predictions: %d", len(gt_uids - pred_uids))
    if pred_uids - gt_uids:
        logger.warning("Missing GT: %d", len(pred_uids - gt_uids))
    return sorted(common)


def load_gt_surfaces(gt_path: Path) -> np.ndarray:
    return np.asarray(np.load(gt_path)[..., :3], np.float32)


def load_pred_meshes(
    pred_dir: Path, n_frames: int | None = None, pattern: str = "mesh_*.glb"
) -> list[Mesh]:
    mesh_files = natsorted(pred_dir.glob(pattern))
    if not mesh_files:
        raise FileNotFoundError(f"No mesh files found in {pred_dir}")
    if n_frames is not None:
        if len(mesh_files) < n_frames:
            raise ValueError(f"Not enough meshes: found {len(mesh_files)}, need {n_frames}")
        mesh_files = mesh_files[:n_frames]
    return [load_glb(p) for p in mesh_files]


def evaluate_sample(
    uid: str,
    gt_root: Path,
    pred_root: Path,
    device: str = "cuda",
    n_pts_icp: int = 10_000,
    n_pts_chamfer: int = 100_000,
    seed: int = 44,
    mesh_pattern: str = "mesh_*.glb",
    is_4d: bool = True,
    icp_iters: int = 200,
    icp_nn_every: int = 1,
) -> SampleResult:
    result = SampleResult(uid=uid)
    try:
        gt_path = gt_root / uid / "surfaces.npy"
        pred_dir = pred_root / uid
        if not gt_path.exists():
            result.status = "error"
            result.error_message = f"GT not found: {gt_path}"
            return result
        if not pred_dir.exists():
            result.status = "error"
            result.error_message = f"Pred dir not found: {pred_dir}"
            return result

        gt_pc = load_gt_surfaces(gt_path)
        result.n_frames = gt_pc.shape[0]
        try:
            pred_meshes = load_pred_meshes(pred_dir, n_frames=result.n_frames, pattern=mesh_pattern)
        except (FileNotFoundError, ValueError) as e:
            result.status = "error"
            result.error_message = str(e)
            return result

        result.cd_3d, result.cd_4d, result.cd_motion = compute_chamfer_3d_4d(
            gt_pc=gt_pc, pred_meshes=pred_meshes, device=device, is_4D=is_4d,
            n_pts_icp=n_pts_icp, n_pts_chamfer=n_pts_chamfer, seed=seed,
            icp_iters=icp_iters, icp_nn_every=icp_nn_every, seconds=result.seconds,
        )
        result.status = "success"
    except Exception as e:  # per-sample fault isolation
        result.status = "error"
        result.error_message = str(e)
        logger.error("[%s] Error: %s", uid, e)
    return result


def _cell(value) -> str:
    if isinstance(value, float):
        return "" if math.isnan(value) else repr(value)
    return str(value)


def _float(cell: str) -> float:
    return float(cell) if cell else float("nan")


def load_existing_results(output_csv: Path) -> dict[str, SampleResult]:
    if not output_csv.exists():
        return {}
    results = {}
    with open(output_csv, newline="") as f:
        for row in csv.DictReader(f):
            results[row["uid"]] = SampleResult(
                uid=row["uid"],
                cd_3d=_float(row["cd_3d"]),
                cd_4d=_float(row["cd_4d"]),
                cd_motion=_float(row["cd_motion"]),
                n_frames=int(float(row["n_frames"])),
                status=row["status"],
                error_message=row.get("error_message") or "",
            )
    return results


def save_results(results: DatasetResults, output_path: Path) -> None:
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(COLUMNS)
        for s in results.samples:
            writer.writerow([_cell(getattr(s, c)) for c in COLUMNS])
    with open(output_path.with_suffix(".summary.json"), "w") as f:
        json.dump(results.summary(), f, indent=2)


def evaluate_dataset(
    gt_root: str,
    pred_root: str,
    output_csv: str | None = None,
    device: str = "cuda",
    n_pts_icp: int = 10_000,
    n_pts_chamfer: int = 100_000,
    seed: int = 44,
    mesh_pattern: str = "mesh_*.glb",
    recompute: bool = False,
    is_4d: bool = True,
    icp_iters: int = 200,
    icp_nn_every: int = 1,
) -> DatasetResults:
    """Evaluate all samples; resumable via the output CSV."""
    device = resolve_device(device)
    gt_root = Path(gt_root)
    pred_root = Path(pred_root)
    output_path = Path(output_csv) if output_csv else None

    uids = find_uids(gt_root, pred_root, mesh_pattern)

    existing: dict[str, SampleResult] = {}
    if output_path and not recompute:
        existing = load_existing_results(output_path)
        if existing:
            n_done = sum(1 for r in existing.values() if r.status == "success")
            logger.info("Loaded %d existing results (%d successful).", len(existing), n_done)

    results = DatasetResults()
    for i, uid in enumerate(uids):
        if uid in existing and not recompute:
            prev = existing[uid]
            if prev.status == "success":
                results.add(prev)
                continue
            logger.info("[%s] Retrying previously failed sample", uid)

        logger.info("Evaluating %s (%d/%d)", uid, i + 1, len(uids))
        result = evaluate_sample(
            uid=uid, gt_root=gt_root, pred_root=pred_root, device=device,
            n_pts_icp=n_pts_icp, n_pts_chamfer=n_pts_chamfer, seed=seed,
            mesh_pattern=mesh_pattern, is_4d=is_4d, icp_iters=icp_iters,
            icp_nn_every=icp_nn_every,
        )
        results.add(result)
        if result.status == "success":
            logger.info(
                "[%s] CD_3D=%.3f, CD_4D=%.3f, CD_Motion=%.3f | %s", uid, result.cd_3d,
                result.cd_4d, result.cd_motion,
                ", ".join(f"{k} {v:.2f} s" for k, v in result.seconds.items()),
            )
        if output_path:
            save_results(results, output_path)

    if output_path:
        save_results(results, output_path)
        logger.info("Results saved to: %s", output_path)
    return results


def print_summary(results: DatasetResults) -> None:
    summary = results.summary()
    print("\n" + "=" * 60)
    print("EVALUATION SUMMARY")
    print("=" * 60)
    print("\nSamples:")
    print(f"  Total:   {summary['n_total']}")
    print(f"  Success: {summary['n_success']}")
    print(f"  Failed:  {summary['n_failed']}")
    print(f"  Rate:    {summary['success_rate']:.1%}")
    if summary["n_success"] > 0:
        print("\nMetrics (mean):")
        print(f"  CD_3D:     {summary['cd_3d_mean']:.3f}")
        print(f"  CD_4D:     {summary['cd_4d_mean']:.3f}")
        print(f"  CD_Motion: {summary['cd_motion_mean']:.3f}")
    failed = [s for s in results.samples if s.status != "success"]
    if failed:
        print(f"\nFailed samples ({len(failed)}):")
        for s in failed:
            print(f"  [{s.uid}] {s.status}: {s.error_message}")
    print("=" * 60 + "\n")


def build_args() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Evaluate 3D/4D reconstruction metrics across a dataset")
    parser.add_argument("--gt_root", type=str, required=True)
    parser.add_argument("--pred_root", type=str, required=True)
    parser.add_argument("--output_csv", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="where ICP runs: cuda (kernel E) or cpu (plain version)")
    parser.add_argument("--n_pts_icp", type=int, default=10_000)
    parser.add_argument("--n_pts_chamfer", type=int, default=100_000)
    parser.add_argument("--seed", type=int, default=44)
    parser.add_argument("--mesh_pattern", type=str, default="mesh_*.glb")
    parser.add_argument("--recompute", action="store_true")
    parser.add_argument(
        "--3d-only", action="store_true", dest="three_d_only",
        help="Compute 3D metrics only (skip 4D/motion metrics)",
    )
    return parser


def main(argv=None) -> DatasetResults:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s")
    args = build_args().parse_args(argv)
    results = evaluate_dataset(
        gt_root=args.gt_root,
        pred_root=args.pred_root,
        output_csv=args.output_csv,
        device=args.device,
        n_pts_icp=args.n_pts_icp,
        n_pts_chamfer=args.n_pts_chamfer,
        seed=args.seed,
        mesh_pattern=args.mesh_pattern,
        recompute=args.recompute,
        is_4d=not args.three_d_only,
    )
    print_summary(results)
    return results


if __name__ == "__main__":
    main()
