"""Closed-loop quality experiment: build -> (stage0) -> train -> (distill) -> eval.

Counterpart of ``scripts/closed_loop.py`` (library:
``training/closed_loop.py``), with the same phases, flags and defaults.
Phases:

  build           generate scenes, renders, ground truth, training clips/tracks
  stage0          train the Stage-0 VAE on exact TSDF and the DiT on its anchor
                  latents; re-encode the clips through the trained VAE
  train           train the Stage-I denoiser and Stage-II decoder; export
  distill         guidance-distill, then progressive-halve the trained teacher
  distill-stage0  the same rounds for the Stage-0 DiT
  eval            run the pipeline per variant on the held-out scenes and score
                  it with the ActionBench harness; writes ``--root/--report-name``

Usage:
  python -m actionmesh_tpu_torch.closed_loop all --root outputs/closed_loop
  python -m actionmesh_tpu_torch.closed_loop eval --root outputs/closed_loop \\
      --variants random,trained [--device cpu]

Everything is written under ``--root`` (the report included); ``--device``
defaults to the card and raises without one. A variant's failure propagates:
only a video -> 4D scene whose Stage 0 decodes a degenerate anchor is
skipped, and the report counts it (``n_samples - n_success``).
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
import time
from pathlib import Path

import torch

logger = logging.getLogger("closed_loop")


def _spec_from_args(args):
    """CascadeSpec with optional --spec key=value overrides."""
    from actionmesh_tpu_torch.training.closed_loop import CascadeSpec

    def parse(v: str):
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                continue
        return v

    overrides = {}
    for kv in getattr(args, "spec", None) or []:
        k, v = kv.split("=", 1)
        overrides[k] = parse(v)
    return CascadeSpec(**overrides)


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("closed_loop: CUDA is not available (use --device cpu)")
    return device


def phase_build(root: Path, args) -> dict:
    from actionmesh_tpu_torch.training.closed_loop import build_dataset

    spec = _spec_from_args(args)
    t0 = time.time()
    uids = build_dataset(root, spec, n_train=args.n_train, n_eval=args.n_eval, seed=args.seed,
                         device=_device(args))
    logger.info("build: %d train / %d eval scenes in %.0fs",
                len(uids["train"]), len(uids["eval"]), time.time() - t0)
    return uids


def _eval_batches(make_iter, n: int) -> list[dict]:
    """Up to n fixed held-out batches."""
    out = []
    it = make_iter()
    for _ in range(n):
        try:
            out.append(next(it))
        except StopIteration:
            break
    return out


def _best_or_final(state, train_dir: Path):
    """The best-held-out-eval checkpoint's state where kept, else ``state``."""
    best = Path(train_dir) / "ckpt_best.npz"
    if best.exists():
        from actionmesh_tpu_torch.training.checkpoint import restore_train_state

        logger.info("exporting best-eval checkpoint %s", best)
        return restore_train_state(best, state)
    return state


def _invalidate_stale_train_state(root: Path) -> None:
    """Remove Stage-I/II train state fit to a superseded latent definition:
    after the stage0 phase re-encodes the clips, a resumable train loop would
    otherwise resume from (and immediately finish at) its final step, and a
    later distill or eval would read stale exports."""
    fresh = {"train_vae", "ckpt_stage0"}  # what the calling stage0 phase just wrote
    for pattern in ("train_flow*", "train_decoder*", "train_dit*", "distill_*", "ckpt*"):
        for stale in sorted(root.glob(pattern)):
            if stale.is_dir() and stale.name not in fresh:
                shutil.rmtree(stale)
                logger.info("removed stale train state %s (latents re-encoded)", stale.name)


class _DatasetView:
    """Index-subset view over a ClipWindowDataset (split by uid)."""

    def __init__(self, ds, indices):
        self._ds = ds
        self._indices = indices
        self.window = ds.window

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, i):
        return self._ds[self._indices[i]]


def _stage0_views(root: Path, split: dict):
    """(train view, eval view, eval window count) of the clips_stage0 windows."""
    from actionmesh_tpu_torch.training.data import ClipWindowDataset

    ds = ClipWindowDataset(root / "clips_stage0", window=1)
    eval_uids = set(split["eval"])
    train_idx = [i for i, w in enumerate(ds._windows) if w.clip.stem not in eval_uids]
    eval_idx = [i for i, w in enumerate(ds._windows) if w.clip.stem in eval_uids]
    return _DatasetView(ds, train_idx), _DatasetView(ds, eval_idx), len(eval_idx)


def _log_evals(what: str, steps: int, seconds: float, logs: list, fmt: str = ".5f", best: bool = True):
    evals = [l["eval_loss"] for l in logs if "eval_loss" in l]
    last = min(evals) if best and evals else (evals[-1] if evals else None)
    logger.info("%s: %d steps in %.0fs; eval loss %s -> %s", what, steps, seconds,
                format(evals[0], fmt) if evals else "n/a", format(last, fmt) if evals else "n/a")


def phase_stage0(root: Path, args) -> None:
    """Train Stage 0 from scratch: the VAE on exact anchor TSDF, then the
    image -> latent DiT on the trained VAE's anchor latents; the Stage-I
    clips are re-encoded so the cascade shares one latent definition. After
    it, ``train`` retrains Stage I/II on the new latents and ``eval
    --variants video`` drives the video -> 4D entry end to end."""
    from actionmesh_tpu_torch.models.triposg.pipeline import TripoSGPipeline
    from actionmesh_tpu_torch.training.checkpoint import export_for_inference
    from actionmesh_tpu_torch.training.closed_loop import (
        CascadeSpec,
        MeanEncodeVAE,
        build_sdf_dataset,
        load_sdf_dataset,
        make_conditioning_stack,
        reencode_clips,
        tiny_stack_dit_config,
        write_stage0_clips,
    )
    from actionmesh_tpu_torch.training.data import flow_batches
    from actionmesh_tpu_torch.training.loop import TrainLoopConfig, run_flow_training, run_vae_training
    from actionmesh_tpu_torch.training.vae_train import sdf_batches

    device = _device(args)
    spec = CascadeSpec.load(root / "spec.json")
    split = json.loads((root / "split.json").read_text())
    ckpt_dir = root / "ckpt_stage0"

    # 1. exact-TSDF supervision pools
    t0 = time.time()
    build_sdf_dataset(root, spec, split["train"] + split["eval"], build_seed=args.seed)
    logger.info("sdf pools: %.0fs", time.time() - t0)

    # 2. VAE: TSDF regression + KL
    train_scenes = load_sdf_dataset(root, split["train"])
    eval_scenes = load_sdf_dataset(root, split["eval"])
    q = args.vae_query_points
    vcfg = TrainLoopConfig(
        total_steps=args.vae_steps, peak_lr=args.lr, warmup_steps=min(200, args.vae_steps // 10),
        ema_decay=None, eval_every=max(1, args.vae_steps // 20), keep_best_eval=True,
        log_every=50, ckpt_every=max(100, args.vae_steps // 4), out_dir=str(root / "train_vae"),
        seed=args.seed,
    )
    eval_b = list(sdf_batches(eval_scenes, len(eval_scenes), q, seed=123, epochs=1))
    t0 = time.time()
    vstate, vlogs = run_vae_training(
        spec.vae_config(), sdf_batches(train_scenes, args.batch, q, seed=args.seed), vcfg,
        device=device, kl_weight=args.kl_weight, eval_batches=eval_b,
    )
    vstate = _best_or_final(vstate, root / "train_vae")
    export_for_inference(vstate, ckpt_dir, stage="stage0_vae", compute_dtype=None)
    _log_evals("vae", args.vae_steps, time.time() - t0, vlogs)
    (root / "train_vae_log.json").write_text(json.dumps(vlogs))

    # 3. re-encode the clips and the anchor latents through the trained VAE
    image_encoder, _ = make_conditioning_stack(spec, device)
    trained = TripoSGPipeline(
        dit_params=None,  # the encode needs no DiT
        vae_params=vstate["params"], image_encoder=image_encoder,
        dit_cfg=tiny_stack_dit_config(spec), vae_cfg=spec.vae_config(),
        dtype=torch.float32, device=device,
    )
    vae = MeanEncodeVAE(trained)
    t0 = time.time()
    reencode_clips(root, spec, vae, build_seed=args.seed)
    write_stage0_clips(root, spec, vae, split["train"] + split["eval"])
    logger.info("re-encode: %.0fs", time.time() - t0)
    _invalidate_stale_train_state(root)

    # 4. Stage-0 DiT: image -> anchor-latent rectified flow, the eval
    # scenes' anchors held out
    train_view, eval_view, n_eval = _stage0_views(root, split)
    dit_cfg = TrainLoopConfig(
        total_steps=args.dit_steps, peak_lr=args.lr, warmup_steps=min(200, args.dit_steps // 10),
        ema_decay=0.999, p_uncond=0.1, eval_every=max(1, args.dit_steps // 20), keep_best_eval=True,
        log_every=50, ckpt_every=max(100, args.dit_steps // 4), out_dir=str(root / "train_dit"),
        seed=args.seed,
    )
    deval_b = _eval_batches(
        lambda: flow_batches(eval_view, min(args.batch, n_eval), seed=123, n_cond_frames=0, epochs=1),
        args.eval_batches,
    )
    t0 = time.time()
    dstate, dlogs = run_flow_training(
        spec.stage0_dit_config(),
        flow_batches(train_view, min(args.batch, len(train_view)), seed=args.seed, n_cond_frames=0),
        dit_cfg, device=device, eval_batches=deval_b,
    )
    dstate = _best_or_final(dstate, root / "train_dit")
    export_for_inference(dstate, ckpt_dir, stage="stage0_dit", compute_dtype=None)
    _log_evals("stage0 dit", args.dit_steps, time.time() - t0, dlogs, ".4f")
    (root / "train_dit_log.json").write_text(json.dumps(dlogs))


def phase_train(root: Path, args) -> None:
    from actionmesh_tpu_torch.training.checkpoint import export_for_inference, restore_train_state
    from actionmesh_tpu_torch.training.closed_loop import CascadeSpec
    from actionmesh_tpu_torch.training.data import (
        ClipWindowDataset,
        DecoderTrackDataset,
        decoder_batches,
        flow_batches,
    )
    from actionmesh_tpu_torch.training.loop import (
        TrainLoopConfig,
        run_decoder_training,
        run_flow_training,
    )

    device = _device(args)
    spec = CascadeSpec.load(root / "spec.json")
    ckpt_dir = root / args.ckpt_name
    suffix = "" if args.ckpt_name == "ckpt" else f"_{args.ckpt_name}"

    # Stage I: rectified flow over the full AR conditioning-mask family
    ds = ClipWindowDataset(root / "clips_train", window=spec.window, stride=spec.window_stride)
    eval_ds = ClipWindowDataset(root / "clips_eval", window=spec.window, stride=spec.window_stride)
    batches = flow_batches(ds, args.batch, seed=args.seed, n_cond_frames=(1, spec.window - 1))
    eval_b = _eval_batches(
        lambda: flow_batches(eval_ds, args.batch, seed=123, n_cond_frames=1, epochs=1),
        args.eval_batches,
    )
    cfg = TrainLoopConfig(
        total_steps=args.flow_steps, peak_lr=args.lr, warmup_steps=min(200, args.flow_steps // 10),
        ema_decay=0.999, p_uncond=0.1, eval_every=max(1, args.flow_steps // 20), keep_best_eval=True,
        log_every=50, ckpt_every=max(100, args.flow_steps // 4),
        out_dir=str(root / f"train_flow{suffix}"), seed=args.seed,
    )
    t0 = time.time()
    state, logs = run_flow_training(spec.denoiser_config(), batches, cfg, device=device, eval_batches=eval_b)
    state = _best_or_final(state, root / f"train_flow{suffix}")
    export_for_inference(state, ckpt_dir, stage="flow", compute_dtype=None)
    _log_evals("flow", args.flow_steps, time.time() - t0, logs, ".4f", best=False)
    (root / f"train_flow{suffix}_log.json").write_text(json.dumps(logs))

    # Stage II: decoder regression
    dds = DecoderTrackDataset(root / "clips_train", root / "tracks", window=spec.window,
                              stride=spec.window_stride)
    deval = DecoderTrackDataset(root / "clips_eval", root / "tracks", window=spec.window,
                                stride=spec.window_stride)
    dbatches = decoder_batches(dds, args.batch, vertex_bucket=spec.track_points, seed=args.seed)
    deval_b = _eval_batches(
        lambda: decoder_batches(deval, args.batch, vertex_bucket=spec.track_points, seed=123, epochs=1),
        args.eval_batches,
    )
    select_chamfer = args.decoder_select_chamfer
    dcfg = TrainLoopConfig(
        total_steps=args.decoder_steps, peak_lr=args.lr,
        warmup_steps=min(200, args.decoder_steps // 10), ema_decay=None,
        eval_every=max(1, args.decoder_steps // 20), keep_best_eval=True,
        best_metric="eval_score" if select_chamfer else "eval_loss",
        track_best_metrics=("eval_loss",) if select_chamfer else (),
        log_every=50, ckpt_every=max(100, args.decoder_steps // 4),
        out_dir=str(root / f"train_decoder{suffix}"), seed=args.seed,
    )
    t0 = time.time()
    dstate, dlogs = run_decoder_training(
        spec.autoencoder_config(), dbatches, dcfg, device=device, eval_batches=deval_b,
        eval_chamfer=select_chamfer,
    )
    if select_chamfer:
        # three decoder exports from one run: final, chamfer-best, MSE-best,
        # each beside the flow checkpoint exported above
        export_for_inference(dstate, ckpt_dir, stage="decoder", compute_dtype=None)
        ddir = root / f"train_decoder{suffix}"
        for best_name, out_name in (("ckpt_best.npz", "ckpt_cd"), ("ckpt_best_eval_loss.npz", "ckpt_mse")):
            src = ddir / best_name
            if not src.exists():
                logger.warning("no %s: no %s export", src, out_name)
                continue
            out = root / out_name
            export_for_inference(restore_train_state(src, dstate), out, stage="decoder", compute_dtype=None)
            shutil.copy(ckpt_dir / "denoiser.npz", out / "denoiser.npz")
    else:
        dstate = _best_or_final(dstate, root / f"train_decoder{suffix}")
        export_for_inference(dstate, ckpt_dir, stage="decoder", compute_dtype=None)
    _log_evals("decoder", args.decoder_steps, time.time() - t0, dlogs, best=False)
    (root / f"train_decoder{suffix}_log.json").write_text(json.dumps(dlogs))


def _distill_loop_cfg(root: Path, args, out_name: str):
    from actionmesh_tpu_torch.training.loop import TrainLoopConfig

    steps = args.distill_steps
    return TrainLoopConfig(
        total_steps=steps, peak_lr=args.lr / 2, warmup_steps=min(100, steps // 10), ema_decay=0.999,
        log_every=50, ckpt_every=max(100, steps // 2), out_dir=str(root / out_name), seed=args.seed,
    )


def phase_distill(root: Path, args) -> None:
    """Teacher (the trained flow checkpoint) -> guidance student ->
    progressive halving (16 -> 8 steps), optionally once more (8 -> 4)."""
    from actionmesh_tpu_torch.training.checkpoint import export_for_inference
    from actionmesh_tpu_torch.training.closed_loop import CascadeSpec
    from actionmesh_tpu_torch.training.data import ClipWindowDataset, flow_batches
    from actionmesh_tpu_torch.training.loop import run_distillation
    from actionmesh_tpu_torch.utils.weights import load_npz

    device = _device(args)
    spec = CascadeSpec.load(root / "spec.json")
    teacher = load_npz(root / "ckpt" / "denoiser.npz", device)
    ds = ClipWindowDataset(root / "clips_train", window=spec.window, stride=spec.window_stride)

    def make_batches(seed):
        return flow_batches(ds, args.batch, seed=seed, n_cond_frames=(1, spec.window - 1))

    rounds = [("distill_guidance", dict(mode="guidance", guidance_scale=spec.guidance_scale)),
              ("distill_progressive", dict(mode="progressive", num_teacher_steps=spec.num_inference_steps,
                                           teacher_guidance_scale=None))]
    if args.extra_progressive:
        rounds.append(("distill_progressive4", dict(mode="progressive",
                                                    num_teacher_steps=spec.num_inference_steps // 2,
                                                    teacher_guidance_scale=None)))
    exports = {"distill_progressive": "ckpt_distilled", "distill_progressive4": "ckpt_distilled4"}
    student = teacher
    for i, (name, kw) in enumerate(rounds):
        t0 = time.time()
        state, _ = run_distillation(
            spec.denoiser_config(), student, make_batches(args.seed + i),
            _distill_loop_cfg(root, args, name), device=device, **kw,
        )
        student = state.get("ema_params", state["params"])
        logger.info("%s: %.0fs", name, time.time() - t0)
        if name in exports:
            out = root / exports[name]
            export_for_inference(state, out, stage="flow", compute_dtype=None)
            # the distilled presets share the trained decoder
            shutil.copy(root / "ckpt" / "autoencoder.npz", out / "autoencoder.npz")


def phase_distill_stage0(root: Path, args) -> None:
    """Distill the trained Stage-0 DiT: a guidance round, then progressive
    halvings of the anchor sampler's steps (stage0_steps -> /2 -> /4),
    exported as ckpt_stage0_distilled8 and ckpt_stage0_distilled with the
    stage0 VAE beside each."""
    from actionmesh_tpu_torch.training.checkpoint import export_for_inference
    from actionmesh_tpu_torch.training.closed_loop import CascadeSpec
    from actionmesh_tpu_torch.training.data import flow_batches
    from actionmesh_tpu_torch.training.loop import run_distillation
    from actionmesh_tpu_torch.utils.weights import load_npz

    device = _device(args)
    spec = CascadeSpec.load(root / "spec.json")
    split = json.loads((root / "split.json").read_text())
    teacher = load_npz(root / "ckpt_stage0" / "dit.npz", device)
    train_view, _, _ = _stage0_views(root, split)

    def make_batches(seed):
        return flow_batches(train_view, min(args.batch, len(train_view)), seed=seed, n_cond_frames=0)

    rounds = [
        ("s0distill_guidance", dict(mode="guidance", guidance_scale=spec.stage0_guidance), None),
        ("s0distill_progressive8", dict(mode="progressive", num_teacher_steps=spec.stage0_steps,
                                        teacher_guidance_scale=None), "ckpt_stage0_distilled8"),
        ("s0distill_progressive4", dict(mode="progressive", num_teacher_steps=spec.stage0_steps // 2,
                                        teacher_guidance_scale=None), "ckpt_stage0_distilled"),
    ]
    student = teacher
    for i, (name, kw, export_name) in enumerate(rounds):
        t0 = time.time()
        state, _ = run_distillation(
            spec.stage0_dit_config(), student, make_batches(args.seed + i),
            _distill_loop_cfg(root, args, name), device=device, **kw,
        )
        student = state.get("ema_params", state["params"])
        if export_name:
            out = root / export_name
            export_for_inference(state, out, stage="stage0_dit", compute_dtype=None)
            shutil.copy(root / "ckpt_stage0" / "vae.npz", out / "vae.npz")
        logger.info("stage0 %s: %.0fs", name, time.time() - t0)


# Stage-I distilled sampling: 4 or 8 guidance-free Euler steps.
_S1_DISTILLED = {
    "cf_guidance.guidance_at_inference": [[1, 1]],
    "cf_guidance.guidance_scales": [],
}
# Stage-0 distilled sampling at closed-loop scale: guidance-free anchor
# generation at spec.stage0_steps // 4 Euler steps (the None is resolved from
# the run's spec in phase_eval).
_S0_DISTILLED = {
    "stage_0.num_inference_steps": None,
    "stage_0.guidance_scale": 0.0,
}

VARIANTS = {
    # name -> (ckpt subdir or None, extra config updates[, stage0 subdir])
    # "oracle" feeds ground-truth latents to the trained decoder
    "oracle": ("ckpt", {}),
    "oracle_cd": ("ckpt_cd", {}),
    "oracle_mse": ("ckpt_mse", {}),
    "trained_cd": ("ckpt_cd", {}),
    "trained_mse": ("ckpt_mse", {}),
    "random": (None, {}),
    "trained": ("ckpt", {}),
    # the video -> 4D entry: Stage 0 generates the anchor (needs ckpt_stage0)
    "video": ("ckpt", {}),
    "video_random": (None, {}),
    "trained_short": ("ckpt_short", {}),
    "trained_best": ("ckpt_best", {}),
    "trained_mixed": ("ckpt_mixed", {}),
    "distilled": ("ckpt_distilled", {"scheduler.num_inference_steps": 8, **_S1_DISTILLED}),
    "distilled4": ("ckpt_distilled4", {"scheduler.num_inference_steps": 4, **_S1_DISTILLED}),
    "video_distilled": ("ckpt_distilled", {"scheduler.num_inference_steps": 8, **_S1_DISTILLED}),
    "video_distilled4": ("ckpt_distilled4", {"scheduler.num_inference_steps": 4, **_S1_DISTILLED}),
    # the teacher Stage I with the distilled anchor generator
    "video_s0distilled": ("ckpt", dict(_S0_DISTILLED), "ckpt_stage0_distilled"),
    # both stages distilled (the turbo serving configuration at this scale)
    "video_turbo": (
        "ckpt_distilled4",
        {"scheduler.num_inference_steps": 4, **_S1_DISTILLED, **_S0_DISTILLED},
        "ckpt_stage0_distilled",
    ),
}


def phase_eval(root: Path, args) -> dict:
    from actionmesh_tpu_torch.training.closed_loop import (
        CascadeSpec,
        evaluate_predictions,
        make_pipeline,
        run_inference,
        run_inference_oracle,
        run_inference_video,
    )

    device = _device(args)
    spec = CascadeSpec.load(root / "spec.json")
    uids = json.loads((root / "split.json").read_text())["eval"]
    # once the stage0 phase has run, every variant conditions through the
    # trained VAE (the clips were re-encoded with it)
    default_stage0 = root / "ckpt_stage0"
    default_stage0 = default_stage0 if default_stage0.exists() else None
    report = {}
    for name in args.variants.split(","):
        if name not in VARIANTS:
            raise ValueError(f"unknown variant {name!r}; known: {sorted(VARIANTS)}")
        ckpt_sub, extra, *rest = VARIANTS[name]
        extra = dict(extra)
        if extra.get("stage_0.num_inference_steps", "unset") is None:
            extra["stage_0.num_inference_steps"] = max(1, spec.stage0_steps // 4)
        stage0_dir = root / rest[0] if rest else default_stage0
        ckpt = root / ckpt_sub if ckpt_sub else None
        if ckpt is not None and not ckpt.exists():
            logger.warning("variant %s: no checkpoint at %s, not run", name, ckpt)
            continue
        if rest and not Path(stage0_dir).exists():
            logger.warning("variant %s: no stage0 checkpoint at %s, not run", name, stage0_dir)
            continue
        t0 = time.time()
        video_mode = name.startswith("video")
        pipe = make_pipeline(spec, ckpt_dir=ckpt, extra_updates=extra, stage0_dir=stage0_dir,
                             video_mode=video_mode, device=device)
        pred_dir = root / f"pred_{name}"
        if pred_dir.exists():
            shutil.rmtree(pred_dir)  # a skipped scene must not score an older run's meshes
        if video_mode:
            run_inference_video(root, pipe, uids, pred_dir, spec, seed=args.seed + 44)
        elif name.startswith("oracle"):
            run_inference_oracle(root, pipe, uids, pred_dir, spec, build_seed=args.seed,
                                 seed=args.seed + 44)
        else:
            run_inference(root, pipe, uids, pred_dir, spec, seed=args.seed + 44)
        del pipe
        t_infer = time.time() - t0
        t0 = time.time()
        metrics = evaluate_predictions(root, pred_dir, root / f"results_{name}.csv", uids,
                                       icp_iters=args.icp_iters, device=str(device))
        metrics["infer_seconds"] = t_infer
        metrics["eval_seconds"] = time.time() - t0
        report[name] = metrics
        logger.info("variant %s: %s", name, metrics)

    out = root / args.report_name
    payload = {"spec": json.loads((root / "spec.json").read_text()), "n_eval_scenes": len(uids),
               "variants": report}
    if out.exists():  # merge: keep the variants of earlier eval invocations
        payload["variants"] = {**json.loads(out.read_text()).get("variants", {}), **report}
    out.write_text(json.dumps(payload, indent=2))
    logger.info("wrote %s", out)
    return report


PHASES = ("build", "stage0", "train", "distill", "distill-stage0", "eval", "all")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phase", choices=PHASES)
    ap.add_argument("--root", type=str, default="outputs/closed_loop")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-train", type=int, default=48)
    ap.add_argument("--n-eval", type=int, default=8)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--flow-steps", type=int, default=4000)
    ap.add_argument("--decoder-steps", type=int, default=4000)
    ap.add_argument("--distill-steps", type=int, default=1500)
    ap.add_argument("--vae-steps", type=int, default=3000)
    ap.add_argument("--dit-steps", type=int, default=2000)
    ap.add_argument("--vae-query-points", type=int, default=1024)
    ap.add_argument("--kl-weight", type=float, default=1e-4)
    ap.add_argument("--spec", action="append", default=[],
                    help="CascadeSpec field override key=value (build phase)")
    ap.add_argument("--eval-batches", type=int, default=4)
    ap.add_argument("--icp-iters", type=int, default=200)
    ap.add_argument("--variants", type=str, default="random,trained")
    ap.add_argument("--ckpt-name", type=str, default="ckpt",
                    help="checkpoint subdir written by the train phase")
    ap.add_argument("--extra-progressive", action="store_true",
                    help="distill one more halving (8 -> 4 steps)")
    ap.add_argument("--decoder-select-chamfer", action="store_true",
                    help="chamfer-aware decoder checkpoint selection: eval with chamfer-proxy "
                    "metrics, export final / chamfer-best / MSE-best decoders (ckpt, ckpt_cd, ckpt_mse)")
    ap.add_argument("--report-name", type=str, default="CLOSED_LOOP.json",
                    help="the report's file name under --root")
    return ap


def main(argv=None) -> dict:
    """Run the phase(s); returns the eval report (empty without eval)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    root = Path(args.root)
    seconds, report = {}, {}
    for phase, run, when in (
        ("build", phase_build, ("build", "all")),
        ("stage0", phase_stage0, ("stage0",)),
        ("train", phase_train, ("train", "all")),
        ("distill", phase_distill, ("distill",)),
        ("distill-stage0", phase_distill_stage0, ("distill-stage0",)),
        ("eval", phase_eval, ("eval", "all")),
    ):
        if args.phase in when:
            t0 = time.time()
            out = run(root, args)
            seconds[phase] = time.time() - t0
            if phase == "eval":
                report = out
    logger.info("phase seconds: %s", seconds)
    return report


if __name__ == "__main__":
    main()
