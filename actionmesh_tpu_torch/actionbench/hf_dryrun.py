"""ActionBench dry run on the Hugging Face layout, with no download.

Counterpart of ``scripts/actionbench_hf_dryrun.py``. It writes a byte-layout
clone of the ``facebook/actionbench`` tree, ``<out>/actionbench/data/{uid}/``
holding ``surfaces.npy`` (T, V, 6) tracked surface points and the sample's
RGBA frames ``rgba_%02d.png`` side by side, then:

  1. predictions: ``--pred pipeline`` (the default) runs the video->4D path
     on each sample directory as the CLI does (``run_actionmesh``: the
     production loader, which must skip ``surfaces.npy`` and natsort the
     PNGs, the pipeline and the mesh export) into
     ``<out>/predictions/{uid}/``; ``--pred gt`` exports the scene meshes
     themselves (the identity floor: it checks the layout and the evaluator
     alone);
  2. the port's evaluator through its command line
     (``actionbench/evaluate_dataset.py:main``) with ``--gt_root
     <out>/actionbench/data``.

The scenes are the synthetic suite's deforming blobs
(``synthetic.animated_mesh_sequence``), rendered shaded with coverage alpha
by the preview renderer. The report goes to ``<out>/report.json``.

Usage (from the repository root):
    python -m actionmesh_tpu_torch.actionbench.hf_dryrun --out DIR [--n 4]
        [--pred pipeline|gt] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from actionmesh_tpu_torch.actionbench import evaluate_dataset
from actionmesh_tpu_torch.actionbench.synthetic import animated_mesh_sequence, tracked_gt_points
from actionmesh_tpu_torch.io.png import write_png
from actionmesh_tpu_torch.render.cameras import get_uniform_cameras
from actionmesh_tpu_torch.render.renderer import Renderer

N_GT_POINTS = 4096


def scene(seed: int, i: int, n_frames: int):
    return animated_mesh_sequence(seed * 100_003 + i, n_frames)


def build_hf_clone(root: Path, n_samples: int, seed: int, n_frames: int = 16,
                   image_size: int = 256) -> list[str]:
    """<root>/actionbench/data/{uid}/{surfaces.npy, rgba_%02d.png}."""
    renderer = Renderer(image_size=image_size, mode="shaded")
    camera = get_uniform_cameras(1)[0]
    uids = []
    for i in range(n_samples):
        uid = f"objaverse_{seed:03d}{i:04d}"  # an opaque uid, like the HF set's
        meshes = scene(seed, i, n_frames)
        d = root / "actionbench" / "data" / uid
        d.mkdir(parents=True, exist_ok=True)
        np.save(d / "surfaces.npy",
                tracked_gt_points(meshes, N_GT_POINTS, seed=seed * 100_003 + i + 7))
        for t, mesh in enumerate(meshes):
            write_png(d / f"rgba_{t:02d}.png", renderer.render(mesh, camera, return_alpha=True))
        uids.append(uid)
    return uids


def predict_gt(root: Path, uids: list[str], seed: int, n_frames: int = 16) -> Path:
    """Identity-floor predictions: the scene meshes themselves."""
    pred_root = root / "predictions"
    for i, uid in enumerate(uids):
        d = pred_root / uid
        d.mkdir(parents=True, exist_ok=True)
        for t, mesh in enumerate(scene(seed, i, n_frames)):
            mesh.export(d / f"mesh_{t:02d}.glb")
    return pred_root


def predict_pipeline(root: Path, uids: list[str], seed: int, pipeline, n_frames: int = 16) -> Path:
    """The video->4D path over each sample directory, as the CLI runs it."""
    from actionmesh_tpu_torch.inference.video_to_animated_mesh import run_actionmesh

    pred_root = root / "predictions"
    for uid in uids:
        result = run_actionmesh(pipeline, input=str(root / "actionbench" / "data" / uid),
                                output_dir=str(pred_root / uid), seed=seed, render=False)
        if len(result["meshes"]) != n_frames:
            raise RuntimeError(
                f"{uid}: {len(result['meshes'])} meshes for {n_frames} frames; the loader "
                "must pick up the rgba_*.png frames and nothing else"
            )
    return pred_root


def run_evaluator(root: Path, pred_root: Path, device: str, n_pts_icp: int,
                  n_pts_chamfer: int) -> dict:
    """The evaluator's documented command line, on the clone's data root."""
    csv = root / "results.csv"
    evaluate_dataset.main([
        "--pred_root", str(pred_root),
        "--gt_root", str(root / "actionbench" / "data"),
        "--output_csv", str(csv),
        "--device", device,
        "--n_pts_icp", str(n_pts_icp),
        "--n_pts_chamfer", str(n_pts_chamfer),
    ])
    return json.loads(csv.with_suffix(".summary.json").read_text())


def main(argv=None) -> dict:
    from actionmesh_tpu_torch.pipeline import ActionMeshPipeline

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=str, required=True, help="clone, predictions and report directory")
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pred", choices=["pipeline", "gt"], default="pipeline")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--n_pts_icp", type=int, default=2048)
    ap.add_argument("--n_pts_chamfer", type=int, default=4096)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s - %(levelname)s - %(message)s")
    device = evaluate_dataset.resolve_device(args.device)

    root = Path(args.out)
    t0 = time.time()
    uids = build_hf_clone(root, args.n, args.seed)
    if args.pred == "gt":
        pred_root = predict_gt(root, uids, args.seed)
    else:
        pipeline = ActionMeshPipeline(device=device, weights_dir=None)
        pred_root = predict_pipeline(root, uids, args.seed, pipeline)
        del pipeline
        if device.type == "cuda":
            torch.cuda.empty_cache()
    summary = run_evaluator(root, pred_root, args.device, args.n_pts_icp, args.n_pts_chamfer)
    report = {
        "layout": "actionbench/data/{uid}/{surfaces.npy, rgba_%02d.png}",
        "n_samples": args.n,
        "pred_mode": args.pred,
        "evaluator": "actionmesh_tpu_torch.actionbench.evaluate_dataset command line",
        "device": str(device),
        "summary": summary,
        "seconds": time.time() - t0,
    }
    (root / "report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
