"""Train an ActionMesh stage with the PyTorch port.

    python -m actionmesh_tpu_torch.train --synthetic --size tiny --steps 3 --device cpu
    python -m actionmesh_tpu_torch.train --data-dir /data/clips --size production \\
        --window 16 --batch 2 --compute-dtype bfloat16 --device cuda
    python -m actionmesh_tpu_torch.train --stage decoder --data-dir /data/clips \\
        --tracks-dir /data/gt --size production --window 8 --batch 2
    python -m actionmesh_tpu_torch.train --stage distill --distill-mode progressive \\
        --teacher CKPT_DIR --data-dir /data/clips --size production
    python -m actionmesh_tpu_torch.train --model stage0 --data-dir /data/anchors
    torchrun --nproc-per-node 4 -m actionmesh_tpu_torch.train --synthetic \
        --size production --window 16 --batch 2 --mesh dp=2,tp=2 --compute-dtype bfloat16

The twin of ``scripts/train.py``, with its flags and defaults: ``--stage
flow`` (rectified flow) trains the Stage-I denoiser,
or with ``--model stage0`` the Stage-0 TripoSG DiT on single-frame windows
with no conditioning frames; ``--stage decoder`` trains the Stage-II
decoder on clips paired with tracked vertex surfaces (``--tracks-dir``,
``{uid}/surfaces.npy``, (T, V, 6), positions in (-1, 1)), padded to
``--vertex-bucket``; ``--stage distill`` distills a teacher (``--teacher
DIR`` holding ``denoiser.npz``, or ``dit.npz`` with ``--model stage0``; a
random one with ``--synthetic``) by guidance or progressive distillation.
Clip directories hold one ``.npz`` per clip: latents (T,N,C), context
(T,S,D), framestep (T,) (see ``training/data.py``). Warmup + cosine AdamW,
EMA (flow, distill), a JSONL loss log, atomic resumable checkpoints, and
``--export-inference DIR`` writes ``denoiser.npz``, ``dit.npz`` or
``autoencoder.npz`` that JAX's ``load_params`` reads. ``--device``
defaults to cuda and raises without a card; ``--device cpu`` runs on the
CPU. Synthetic clips are written under ``--out``; at ``--size
production`` their context has DINOv2-L's 257 tokens. Synthetic decoder
batches take their latent shape from the model config (at ``--size
tiny`` JAX's values: T 4, N 8, C 4, 3 targets, 16 vertices).

``--mesh dp=2,tp=2[,sp=2]`` trains on a device mesh (``parallel/mesh.py``):
run it under ``torchrun`` with one process per card (NCCL; ``--device cpu``
runs gloo ranks on the CPU). Each rank joins the process group that
torchrun describes, holds its tp slices of the params and moments and its
dp share of every batch; rank 0 writes the log and full-tree checkpoints
and exports. Without a process group ``--mesh`` raises; it never trains
unsharded in its place.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from actionmesh_tpu_torch.models.autoencoder import AutoencoderConfig
from actionmesh_tpu_torch.models.denoiser import DenoiserConfig
from actionmesh_tpu_torch.parallel.mesh import is_writer, on_writer


def parse_mesh(spec: str) -> dict:
    """'dp=2,tp=4[,sp=2]' -> make_mesh kwargs (``scripts/train.py``'s rules
    and error text)."""
    kwargs = {}
    for part in spec.split(","):
        axis, _, size = part.partition("=")
        if axis not in ("dp", "tp", "sp") or not size.isdigit():
            raise argparse.ArgumentTypeError(f"bad mesh spec {spec!r}; expected e.g. dp=2,tp=4")
        kwargs[axis] = int(size)
    return kwargs


def build_args() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--stage", choices=("flow", "decoder", "distill"), default="flow")
    p.add_argument("--model", choices=("denoiser", "stage0"), default="denoiser",
                   help="flow/distill stages: the Stage-I temporal denoiser (default) or the "
                        "Stage-0 TripoSG DiT (T=1 anchor-latent windows, teacher dit.npz, "
                        "exports dit.npz)")
    p.add_argument("--distill-mode", choices=("guidance", "progressive"), default="guidance",
                   help="distill stage: collapse the CFG pair (guidance) or halve the Euler "
                        "step count (progressive; even teacher counts only)")
    p.add_argument("--teacher", help="distill stage: directory containing denoiser.npz (dit.npz "
                                     "with --model stage0); omit with --synthetic to distill a "
                                     "random teacher")
    p.add_argument("--guidance-scale", type=float, default=7.5,
                   help="distill stage (guidance mode): teacher CFG scale to bake in")
    p.add_argument("--teacher-steps", type=int, default=30,
                   help="distill stage (progressive mode): teacher schedule length")
    p.add_argument("--data-dir", help="directory of clip .npz files")
    p.add_argument("--tracks-dir", help="decoder stage: directory of {uid}/surfaces.npy vertex "
                                        "tracks paired with --data-dir clips by uid")
    p.add_argument("--vertex-bucket", type=int, default=4096,
                   help="decoder stage: pad per-mesh vertex counts to this bucket")
    p.add_argument("--synthetic", action="store_true", help="train on generated synthetic data")
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
                   help="after training, export the (EMA) params for inference under DIR")
    p.add_argument("--time-phases", action="store_true",
                   help="log synchronised forward/backward/update seconds per step")
    p.add_argument("--mesh", type=parse_mesh, default=None,
                   help="shard over a device mesh, e.g. dp=2,tp=4 (omit: single device); "
                        "one rank per card under torchrun")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda, which raises without a card; "
                        "cpu runs on the CPU)")
    return p


def flow_model_config(size: str, model: str = "denoiser") -> DenoiserConfig:
    """The flow/distill stages' model: the Stage-I denoiser, or the Stage-0
    TripoSG DiT (the denoiser at T = 1)."""
    if model == "stage0":
        from actionmesh_tpu_torch.models.triposg.dit import triposg_dit_config

        if size == "production":
            return triposg_dit_config()
        return triposg_dit_config(
            num_tokens=8, in_channels=4, num_layers=3, num_attention_heads=4, width=32,
            cross_attention_dim=16,
        )
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


def decoder_model_config(size: str) -> AutoencoderConfig:
    if size == "production":
        return AutoencoderConfig()
    return AutoencoderConfig(
        temporal_context_size=8, latent_channels=4, width=32, num_layers=2, num_attention_heads=4,
    )


def synthetic_decoder_batches(batch: int, seed: int, T=4, N=8, C=4, T_out=3, V=16):
    """Endless synthetic decoder batches: smooth per-vertex tracks with two
    padded bucket rows per sample (the vertex mask); the numbers of JAX's
    ``scripts/train.py:synthetic_decoder_batches`` at the same shapes."""
    rng = np.random.default_rng(seed)
    while True:
        alphas = np.linspace(0.25, 1.0, T_out, dtype=np.float32)
        query = rng.uniform(-1, 1, (batch, V, 6)).astype(np.float32)
        drift = rng.normal(size=(batch, 1, V, 3)).astype(np.float32) * 0.2
        positions = np.tanh(query[:, None, :, :3] + drift * alphas[None, :, None, None]).astype(np.float32)
        mask = np.ones((batch, V), np.float32)
        mask[:, -2:] = 0.0
        yield {
            "latents": rng.normal(size=(batch, T, N, C)).astype(np.float32),
            "framestep": np.tile(np.arange(T, dtype=np.float32)[None], (batch, 1)),
            "source_alpha": np.zeros((batch,), np.float32),
            "target_alphas": np.tile(alphas[None], (batch, 1)),
            "query": query,
            "positions": positions,
            "vertex_mask": mask,
        }


def synthetic_decoder_shapes(args: argparse.Namespace, cfg: AutoencoderConfig) -> dict:
    """T, N, C, T_out, V of the synthetic decoder batches: JAX's at --size
    tiny; at production the window, 2048 latent tokens, the model's latent
    channels and the vertex bucket (JAX's fixed C = 4 does not fit the
    production model's 64)."""
    if args.size == "tiny":
        return {}
    return {"T": args.window, "N": 2048, "C": cfg.latent_channels, "T_out": args.window - 1,
            "V": args.vertex_bucket}


def run(args: argparse.Namespace):
    """Train as the flags say; returns (final state, log records, loop config)."""
    from actionmesh_tpu_torch.training.loop import TrainLoopConfig

    if not args.synthetic and not args.data_dir:
        raise SystemExit("error: pass --data-dir or --synthetic")
    if args.stage == "decoder" and not args.synthetic and not args.tracks_dir:
        raise SystemExit(
            "error: decoder stage needs --tracks-dir (ActionBench-layout vertex tracks) "
            "alongside --data-dir, or --synthetic"
        )
    if args.stage == "distill" and not (args.teacher or args.synthetic):
        raise SystemExit("error: distill stage needs --teacher (or --synthetic)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available (use --device cpu)")
    mesh = None
    if args.mesh:
        from actionmesh_tpu_torch.parallel.mesh import init_distributed, make_mesh

        if "RANK" not in os.environ and not dist.is_initialized():
            raise RuntimeError("--mesh needs a process group: run under torchrun, one rank per card")
        device = init_distributed(device.type)
        mesh = make_mesh(**args.mesh)

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
    if args.stage == "decoder":
        stage_name = "decoder"
    else:
        stage_name = "stage0_dit" if args.model == "stage0" else "flow"
    export = (stage_name, args.export_inference) if args.export_inference else None
    run_stage = _run_decoder if args.stage == "decoder" else _run_flow_or_distill
    state, history = run_stage(args, loop_cfg, device, mesh, export)
    if export:
        from actionmesh_tpu_torch.training.checkpoint import EXPORT_NAMES

        say(f"exported inference checkpoint: {Path(args.export_inference) / EXPORT_NAMES[stage_name]}")
    return state, history, loop_cfg


def _run_flow_or_distill(args: argparse.Namespace, loop_cfg, device: torch.device, mesh=None, export=None):
    from actionmesh_tpu_torch.training.data import (
        ClipWindowDataset,
        flow_batches,
        split_windows,
        synthesize_clip_dir,
    )
    from actionmesh_tpu_torch.training.loop import run_distillation, run_flow_training

    model_cfg = flow_model_config(args.size, args.model)
    # The Stage-0 DiT trains on single-frame windows with no conditioning
    # prefix (an anchor latent has no banked frames). Inference AR windows
    # condition on 1..window-1 banked frames, so training covers that mask
    # family; eval pins one conditioning frame.
    if args.model == "stage0":
        args.window = 1
    n_cond = 0 if args.model == "stage0" else ((1, args.window - 1) if args.window > 2 else 1)
    n_cond_eval = 0 if args.model == "stage0" else 1
    if args.synthetic:
        data_dir = Path(args.out) / "synthetic_clips"
        on_writer(lambda: synthesize_clip_dir(
            data_dir,
            n_clips=max(4, args.batch * 2),
            frames=max(args.window, 8),
            tokens=model_cfg.num_tokens_nominal,
            channels=model_cfg.in_channels,
            context_tokens=257 if args.size == "production" else 3,
            context_dim=model_cfg.cross_attention_dim,
            seed=args.seed,
        ))
    else:
        data_dir = Path(args.data_dir)
    dataset = ClipWindowDataset(data_dir, window=args.window)
    eval_set = None
    if args.eval_fraction > 0:
        dataset, eval_ds = split_windows(dataset, args.eval_fraction, seed=args.seed)
        eval_set = list(itertools.islice(
            flow_batches(eval_ds, min(args.batch, len(eval_ds)), seed=0, epochs=1,
                         n_cond_frames=n_cond_eval),
            args.eval_batches,
        ))
    say(
        f"{args.stage} training of the {args.model} on {device}: {len(dataset)} windows "
        f"({dataset.skipped_clips} clips too short), batch {args.batch}, "
        f"{args.steps} steps -> {args.out}"
        + (f", eval on {len(eval_set)} held-out batches" if eval_set else "")
        + (f", mesh {dict(args.mesh)}" if mesh is not None else "")
    )
    batches = flow_batches(dataset, args.batch, seed=args.seed, n_cond_frames=n_cond)
    if args.stage == "flow":
        return run_flow_training(
            model_cfg, batches, loop_cfg, device=device, on_log=echo, eval_batches=eval_set,
            mesh=mesh, export=export,
        )
    if args.teacher:
        from actionmesh_tpu_torch.utils.weights import load_npz

        teacher_file = "dit.npz" if args.model == "stage0" else "denoiser.npz"
        teacher = load_npz(Path(args.teacher) / teacher_file, device=device)
    else:
        from actionmesh_tpu_torch.models.denoiser import init_denoiser

        teacher = init_denoiser(torch.Generator(device).manual_seed(args.seed + 7), model_cfg, device=device)
    say(
        f"distillation ({args.distill_mode}): "
        + (f"CFG scale {args.guidance_scale} -> single forward" if args.distill_mode == "guidance"
           else f"{args.teacher_steps} -> {args.teacher_steps // 2} steps")
    )
    return run_distillation(
        model_cfg, teacher, batches, loop_cfg, mode=args.distill_mode,
        guidance_scale=args.guidance_scale, num_teacher_steps=args.teacher_steps,
        device=device, on_log=echo, eval_batches=eval_set, mesh=mesh, export=export,
    )


def _run_decoder(args: argparse.Namespace, loop_cfg, device: torch.device, mesh=None, export=None):
    from actionmesh_tpu_torch.training.data import DecoderTrackDataset, decoder_batches, split_windows
    from actionmesh_tpu_torch.training.loop import run_decoder_training

    model_cfg = decoder_model_config(args.size)
    eval_set = None
    if args.synthetic:
        say(f"decoder training (synthetic) on {device}: batch {args.batch}, {args.steps} steps "
            f"-> {args.out}")
        batches = synthetic_decoder_batches(args.batch, args.seed,
                                            **synthetic_decoder_shapes(args, model_cfg))
    else:
        dataset = DecoderTrackDataset(args.data_dir, args.tracks_dir, window=args.window)
        if args.eval_fraction > 0:
            dataset, eval_ds = split_windows(dataset, args.eval_fraction, seed=args.seed)
            eval_set = list(itertools.islice(
                decoder_batches(eval_ds, min(args.batch, len(eval_ds)),
                                vertex_bucket=args.vertex_bucket, seed=0, epochs=1),
                args.eval_batches,
            ))
        say(
            f"decoder training on {device}: {len(dataset)} windows ({dataset.skipped_clips} "
            f"clips too short), batch {args.batch}, bucket {args.vertex_bucket}, "
            f"{args.steps} steps -> {args.out}"
        )
        batches = decoder_batches(dataset, args.batch, vertex_bucket=args.vertex_bucket, seed=args.seed)
    return run_decoder_training(
        model_cfg, batches, loop_cfg, device=device, on_log=echo, eval_batches=eval_set, mesh=mesh,
        export=export,
    )


def say(text: str) -> None:
    """Print once: on the writer (rank 0 when a process group is up)."""
    if is_writer():
        print(text, flush=True)


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
    say(f"done: step {state['step']}, final loss {losses[-1] if losses else float('nan'):.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
