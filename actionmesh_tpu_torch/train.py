"""Train the Stage-I denoiser (rectified flow) with the PyTorch port.

    python -m actionmesh_tpu_torch.train --synthetic --size tiny --steps 3 --device cpu
    python -m actionmesh_tpu_torch.train --data-dir /data/clips --size production \\
        --window 16 --batch 2 --compute-dtype bfloat16 --device cuda

The twin of ``scripts/train.py --stage flow --model denoiser``, with the same
flags and defaults (less ``--model`` and ``--mesh``): a clip-directory dataset (each ``.npz``: latents
(T,N,C), context (T,S,D), framestep (T,); see ``training/data.py``) or
synthetic clips, warmup + cosine AdamW, EMA, a JSONL loss log, atomic
resumable checkpoints and an optional export of the (EMA) weights as
``denoiser.npz``. ``--device`` defaults to cuda and raises without a card;
``--device cpu`` runs on the CPU.
Synthetic clips are written under ``--out``; at ``--size production``
their context has DINOv2-L's 257 tokens. The decoder and distillation
stages are not ported yet (ROADMAP Queue 1) and are refused.
"""

from __future__ import annotations

import argparse
import itertools
import sys
from pathlib import Path

import torch

from actionmesh_tpu_torch.models.denoiser import DenoiserConfig

NOT_PORTED = "is not ported to PyTorch yet (ROADMAP Queue 1)"


def build_args() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--stage", choices=("flow", "decoder", "distill"), default="flow")
    p.add_argument("--data-dir", help="directory of clip .npz files")
    p.add_argument("--synthetic", action="store_true", help="train on generated synthetic clips")
    p.add_argument("--size", choices=("tiny", "production"), default="tiny",
                   help="model architecture preset")
    p.add_argument("--window", type=int, default=8, help="frames per example")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup", type=int, default=None, help="default: steps//10")
    p.add_argument("--clip-norm", type=float, default=1.0)
    p.add_argument("--grad-accum", type=int, default=1,
                   help="average gradients over N micro-batches per optimizer update")
    p.add_argument("--eval-fraction", type=float, default=0.0,
                   help="hold out this fraction of windows for eval (0 = off)")
    p.add_argument("--eval-every", type=int, default=100, help="eval cadence in steps")
    p.add_argument("--eval-batches", type=int, default=4, help="held-out batches to average")
    p.add_argument("--profile-steps", metavar="A:B", default=None,
                   help="capture a torch.profiler trace over micro-steps [A, B)")
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--ema-decay", type=float, default=0.999)
    p.add_argument("--p-uncond", type=float, default=0.1)
    p.add_argument("--compute-dtype", choices=("bfloat16",), default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--ckpt-every", type=int, default=500)
    p.add_argument("--out", default="train_out")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--export-inference", metavar="DIR",
                   help="after training, export the (EMA) params as DIR/denoiser.npz")
    p.add_argument("--time-phases", action="store_true",
                   help="log synchronised forward/backward/update seconds per step")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda, which raises without a card; "
                        "cpu runs on the CPU)")
    return p


def flow_model_config(size: str) -> DenoiserConfig:
    if size == "production":
        return DenoiserConfig()
    return DenoiserConfig(
        num_tokens_nominal=8,
        temporal_context_size=8,
        in_channels=4,
        num_layers=3,
        num_attention_heads=4,
        width=32,
        mlp_ratio=2.0,
        cross_attention_dim=16,
        inflated_layers=(0, 1, 2),
    )


def run(args: argparse.Namespace):
    """Train as the flags say; returns (final state, log records, loop config)."""
    from actionmesh_tpu_torch.training.data import (
        ClipWindowDataset,
        flow_batches,
        split_windows,
        synthesize_clip_dir,
    )
    from actionmesh_tpu_torch.training.loop import TrainLoopConfig, run_flow_training

    if args.stage != "flow":
        raise SystemExit(f"error: --stage {args.stage} {NOT_PORTED}")
    if not args.synthetic and not args.data_dir:
        raise SystemExit("error: pass --data-dir or --synthetic")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available (use --device cpu)")

    profile_steps = None
    if args.profile_steps:
        a, _, b = args.profile_steps.partition(":")
        profile_steps = (int(a), int(b))
    loop_cfg = TrainLoopConfig(
        total_steps=args.steps,
        peak_lr=args.lr,
        warmup_steps=args.warmup if args.warmup is not None else args.steps // 10,
        clip_norm=args.clip_norm,
        weight_decay=args.weight_decay,
        grad_accum=args.grad_accum,
        ema_decay=args.ema_decay,
        p_uncond=args.p_uncond,
        compute_dtype=args.compute_dtype,
        seed=args.seed,
        log_every=args.log_every,
        ckpt_every=args.ckpt_every,
        eval_every=args.eval_every,
        out_dir=args.out,
        resume=not args.no_resume,
        profile_steps=profile_steps,
        time_phases=args.time_phases,
    )
    model_cfg = flow_model_config(args.size)
    # inference AR windows condition on 1..window-1 banked frames, so training
    # covers that mask family; eval pins one conditioning frame
    n_cond = (1, args.window - 1) if args.window > 2 else 1
    if args.synthetic:
        data_dir = synthesize_clip_dir(
            Path(args.out) / "synthetic_clips",
            n_clips=max(4, args.batch * 2),
            frames=max(args.window, 8),
            tokens=model_cfg.num_tokens_nominal,
            channels=model_cfg.in_channels,
            context_tokens=257 if args.size == "production" else 3,
            context_dim=model_cfg.cross_attention_dim,
            seed=args.seed,
        )
    else:
        data_dir = Path(args.data_dir)
    dataset = ClipWindowDataset(data_dir, window=args.window)
    eval_set = None
    if args.eval_fraction > 0:
        dataset, eval_ds = split_windows(dataset, args.eval_fraction, seed=args.seed)
        eval_set = list(itertools.islice(
            flow_batches(eval_ds, min(args.batch, len(eval_ds)), seed=0, epochs=1, n_cond_frames=1),
            args.eval_batches,
        ))
    print(
        f"flow training on {device}: {len(dataset)} windows "
        f"({dataset.skipped_clips} clips too short), batch {args.batch}, "
        f"{args.steps} steps -> {args.out}"
        + (f", eval on {len(eval_set)} held-out batches" if eval_set else ""),
        flush=True,
    )
    state, history = run_flow_training(
        model_cfg,
        flow_batches(dataset, args.batch, seed=args.seed, n_cond_frames=n_cond),
        loop_cfg,
        device=device,
        on_log=echo,
        eval_batches=eval_set,
    )
    if args.export_inference:
        from actionmesh_tpu_torch.training.checkpoint import export_for_inference

        print(f"exported inference checkpoint: {export_for_inference(state, args.export_inference)}")
    return state, history, loop_cfg


def echo(rec: dict) -> None:
    if "eval_loss" in rec:
        print(f"step {rec['step']:6d}  EVAL loss {rec['eval_loss']:.6f}", flush=True)
        return
    rate = rec.get("stage_steps_per_s")
    print(
        f"step {rec['step']:6d}  loss {rec['loss']:.6f}"
        + (f"  ({rate:.3f} steps/s)" if rate else ""),
        flush=True,
    )


def main(argv=None) -> int:
    state, history, _ = run(build_args().parse_args(argv))
    losses = [h["loss"] for h in history if "loss" in h]
    print(f"done: step {state['step']}, final loss {losses[-1] if losses else float('nan'):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
