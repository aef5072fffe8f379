"""Prepare Stage-I training clips from videos (a self-distillation pass).

Counterpart of ``scripts/prepare_clips.py``. Runs the inference pipeline's
front half (preprocessing, the Stage-0 anchor, DINOv2 conditioning, Stage-I
denoising) over a directory of videos and writes each result as one
training clip npz in the ``training/data.py`` layout: ``latents`` (T, N, C),
``context`` (T, S, D), ``framestep`` (T,), rows in timestep order. The
output directory feeds ``python -m actionmesh_tpu_torch.train --stage flow
--data-dir`` directly.

Inputs follow the CLI's conventions (``io/video_input.load_frames``): each
clip is a video file or a directory of frames.

Example:
  python -m actionmesh_tpu_torch.prepare_clips --input /data/videos --out /data/clips \\
      --weights-dir pretrained_weights --max-frames 31 [--device cpu]

``--device`` defaults to the card and raises without one. An input that
cannot be read is reported and skipped; an error of the pipeline itself
propagates.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch


@torch.no_grad()
def prepare_clip(pipe, inp, out_path, *, seed: int = 44) -> dict:
    """Run preprocessing + Stage 0 + conditioning + Stage I on one input
    (``ActionMeshInput``) and write the clip npz. Returns a small stats dict."""
    from actionmesh_tpu_torch.io.video_input import ActionMeshInput
    from actionmesh_tpu_torch.training.data import write_clip

    inp = ActionMeshInput(frames=list(inp.frames), timesteps=inp.timesteps.copy())
    inp.frames = pipe.background_removal.process_images(inp.frames)
    inp.frames = pipe.image_process.process_images(inp.frames)

    latent_bank, _ = pipe.init_banks_from_anchor(inp, seed)
    context = pipe.encode_all_frames(inp)  # (T, S, D), input-frame order
    latent_bank = pipe.generate_3d_latents(inp, context=context, latent_bank=latent_bank, seed=seed)
    ts = latent_bank.get_ordered_timesteps()
    latents = latent_bank.get(ts)[0].float().cpu().numpy()
    context = context.float().cpu().numpy()
    # context rows follow input-frame order; reorder them to the bank's
    # sorted timesteps so that row t of every array describes one frame
    order = np.argsort(inp.timesteps.astype(np.float32), kind="stable")
    if not np.allclose(inp.timesteps.astype(np.float32)[order], ts):
        raise RuntimeError(
            f"latent-bank timesteps {ts} do not match input timesteps {inp.timesteps}: "
            "windowing dropped or duplicated frames"
        )
    write_clip(out_path, latents, context[order], ts)
    return {
        "frames": int(latents.shape[0]),
        "tokens": int(latents.shape[1]),
        "channels": int(latents.shape[2]),
        "context_tokens": int(context.shape[1]),
    }


def iter_inputs(root: Path):
    """Clip sources under ``root``: frame directories (any directory holding
    images) and video files; a root that is itself a clip yields just it."""
    exts = {".mp4", ".mov", ".avi", ".webm", ".mkv", ".gif"}
    img_exts = {".png", ".jpg", ".jpeg", ".webp"}

    def is_frame_dir(d: Path) -> bool:
        return any(f.suffix.lower() in img_exts for f in d.iterdir() if f.is_file())

    if root.is_file() or is_frame_dir(root):
        yield root
        return
    for child in sorted(root.iterdir()):
        if child.is_file() and child.suffix.lower() in exts:
            yield child
        elif child.is_dir() and is_frame_dir(child):
            yield child


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--input", required=True, help="video file/frame dir, or a directory of them")
    p.add_argument("--out", required=True, help="output clip directory")
    p.add_argument("--config-name", default="actionmesh")
    p.add_argument("--weights-dir", default=None)
    p.add_argument("--max-frames", type=int, default=31)
    p.add_argument("--stage-1-steps", type=int, default=None)
    p.add_argument("--seed", type=int, default=44)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None, pipe=None) -> int:
    """The CLI; ``pipe`` replaces the ActionMeshPipeline it would build."""
    from actionmesh_tpu_torch.io.video_input import load_frames
    from actionmesh_tpu_torch.pipeline import ActionMeshPipeline

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("prepare_clips: CUDA is not available (use --device cpu)")
    sources = list(iter_inputs(Path(args.input)))
    if not sources:
        print(f"error: no videos or frame dirs under {args.input}", file=sys.stderr)
        return 2
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if pipe is None:
        pipe = ActionMeshPipeline(config_name=args.config_name, weights_dir=args.weights_dir,
                                  device=device)
    if args.stage_1_steps is not None:
        pipe.cfg.scheduler.num_inference_steps = args.stage_1_steps

    done = skipped = unreadable = 0
    for src in sources:
        out_path = out_dir / f"{src.stem}.npz"
        if out_path.exists() and not args.overwrite:
            skipped += 1
            continue
        t0 = time.perf_counter()
        try:
            inp = load_frames(str(src), max_frames=args.max_frames)
        except (OSError, ValueError) as exc:  # an input that cannot be read: report it, go on
            print(f"UNREADABLE {src.name}: {exc}", file=sys.stderr)
            unreadable += 1
            continue
        stats = prepare_clip(pipe, inp, out_path, seed=args.seed)
        done += 1
        print(
            f"{src.name}: {stats['frames']} frames x {stats['tokens']} tokens "
            f"-> {out_path.name} ({time.perf_counter() - t0:.1f} s)",
            flush=True,
        )
    print(f"prepared {done}, skipped {skipped} existing, unreadable {unreadable}")
    return 0 if unreadable == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
