"""Training loop: optimizer schedule, step loop, logging, checkpoints.

Counterpart of ``actionmesh_tpu/training/loop.py``: ``TrainLoopConfig``,
``make_optimizer`` (``training/optim.py``), the shared ``_run_loop`` and the
four stages ``run_flow_training`` (Stage I, or the Stage-0 DiT),
``run_decoder_training`` (Stage II), ``run_vae_training`` (the Stage-0
TripoSG VAE on exact TSDF) and ``run_distillation``. Same
contract: a JSONL log (``log.jsonl``) with ``stage_steps_per_s``, a
checkpoint every ``ckpt_every`` steps and at the end (``ckpt_latest.npz``),
resume from it, held-out eval (``keep_best_eval`` also keeps
``ckpt_best.npz`` and ``ckpt_best_{metric}.npz`` with their record in
``best_eval.json``), and a profiler trace over ``profile_steps``
(``torch.profiler`` in place of ``jax.profiler``). Losses are fetched from
the device only at log boundaries.

``mesh=`` (``parallel/mesh.py:make_mesh``; every rank runs the same call)
trains on a device mesh, as JAX's loop: the params, moments, accumulator
and EMA are the rank's ``shard_params`` slices (``denoiser_param_shardings``
or ``autoencoder_param_shardings``), every rank reads the same batches and
the model-level functions split them over dp (and the frames over sp),
and rank 0 alone writes ``log.jsonl``, the eval record and the
checkpoints, each a full tree (``training/checkpoint.py``). The eval runs
on the mesh. ``run_vae_training`` takes no mesh, as in JAX.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from actionmesh_tpu_torch.models.autoencoder import AutoencoderConfig, init_autoencoder
from actionmesh_tpu_torch.models.denoiser import DenoiserConfig, init_denoiser
from actionmesh_tpu_torch.parallel.mesh import (
    autoencoder_param_shardings,
    denoiser_param_shardings,
    is_writer,
    shard_params,
)
from actionmesh_tpu_torch.training.checkpoint import (
    export_for_inference,
    restore_train_state,
    save_train_state,
)
from actionmesh_tpu_torch.training.data import DevicePrefetcher, to_device
from actionmesh_tpu_torch.training.flow_train import (
    cast_params_for_compute,
    flow_matching_loss,
    init_train_state,
    make_train_step,
)
from actionmesh_tpu_torch.training.optim import AdamW, warmup_cosine_decay_schedule
from actionmesh_tpu_torch.utils.tree import tree_map

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class TrainLoopConfig:
    """Hyperparameters of the outer loop (the architecture is the model
    config passed alongside)."""

    total_steps: int = 1000  # micro-steps (batches consumed), see grad_accum
    peak_lr: float = 1e-4
    warmup_steps: int = 100
    final_lr_ratio: float = 0.1  # the cosine decays peak_lr -> peak_lr * ratio
    clip_norm: float = 1.0
    weight_decay: float = 0.01
    grad_accum: int = 1  # optimizer updates every grad_accum micro-steps
    ema_decay: Optional[float] = 0.999  # per optimizer update (flow, distill)
    p_uncond: float = 0.1  # CFG context dropout (flow stage only)
    shift: float = 3.0  # sigma-schedule shift (flow and distill)
    compute_dtype: Optional[str] = None  # None = fp32; "bfloat16"
    seed: int = 0
    log_every: int = 10
    ckpt_every: int = 500
    eval_every: int = 0  # 0 = no held-out evaluation
    # also keep ckpt_best.npz, the state at the lowest held-out best_metric
    keep_best_eval: bool = False
    # the eval record's key that selects ckpt_best.npz (the decoder's
    # chamfer eval adds eval_cd, eval_motion and eval_score)
    best_metric: str = "eval_loss"
    # and ckpt_best_{key}.npz for each of these keys
    track_best_metrics: tuple = ()
    out_dir: str = "train_out"
    resume: bool = True
    profile_steps: Optional[tuple[int, int]] = None  # [start, end) micro-steps, to out_dir/profile
    time_phases: bool = False  # synchronised forward/backward/update seconds per step

    def __post_init__(self):
        if self.total_steps < 1:
            raise ValueError(f"total_steps={self.total_steps} must be >= 1")
        if self.warmup_steps >= self.total_steps:
            raise ValueError(
                f"warmup_steps={self.warmup_steps} must be < total_steps={self.total_steps}"
            )
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum={self.grad_accum} must be >= 1")


def make_optimizer(cfg: TrainLoopConfig) -> AdamW:
    """Global-norm clip -> AdamW on a warmup + cosine schedule that counts
    optimizer updates (``total_steps // grad_accum``), as the JAX loop."""
    updates = max(1, cfg.total_steps // cfg.grad_accum)
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=cfg.peak_lr,
        warmup_steps=min(cfg.warmup_steps, max(0, updates - 1)),
        decay_steps=updates,
        end_value=cfg.peak_lr * cfg.final_lr_ratio,
    )
    return AdamW(schedule, cfg.clip_norm, cfg.weight_decay, grad_accum=cfg.grad_accum)


def loop_ema_decay(cfg: TrainLoopConfig) -> Optional[float]:
    """Per-micro-step EMA decay, so that the decay per optimizer update is
    ``cfg.ema_decay`` whatever ``grad_accum`` is."""
    if cfg.ema_decay is None:
        return None
    return float(cfg.ema_decay ** (1.0 / cfg.grad_accum))


def compute_dtype(cfg: TrainLoopConfig) -> Optional[torch.dtype]:
    return None if cfg.compute_dtype is None else getattr(torch, cfg.compute_dtype)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of micro-step ``step``: a function of (seed, step)
    only, so a resumed run draws what an uninterrupted one would."""
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def _run_loop(
    state: dict,
    step_fn: Callable,
    batches: Iterator[dict],
    cfg: TrainLoopConfig,
    device: torch.device,
    *,
    mesh=None,
    shardings=None,
    on_log: Optional[Callable[[dict], None]] = None,
    eval_fn: Optional[Callable[[dict], "float | dict"]] = None,
    export: Optional[tuple[str, "str | Path"]] = None,
) -> tuple[dict, list[dict]]:
    """Prefetch, step, log JSONL, checkpoint; resumes from ``state['step']``.
    ``eval_fn(state)`` gives the eval loss or a dict of eval metrics.
    ``export`` (stage, directory) writes the inference checkpoint of the
    final state (``export_for_inference``, compute dtype bf16) after the
    last train checkpoint. On a mesh every rank keeps the history and takes
    the same decisions (the losses and eval records are the same on every
    rank); rank 0 writes the files and calls ``on_log``."""
    out_dir = Path(cfg.out_dir)
    writes = is_writer()
    if writes:
        out_dir.mkdir(parents=True, exist_ok=True)
    log_path = out_dir / "log.jsonl"
    start = int(state["step"])
    history: list[dict] = []
    prefetch = DevicePrefetcher(batches, device)
    pending: list[tuple[int, torch.Tensor, Optional[dict]]] = []
    t0 = time.perf_counter()

    def write(rec: dict) -> None:
        history.append(rec)
        if not writes:
            return
        with log_path.open("a") as fh:
            fh.write(json.dumps(rec) + "\n")
        if on_log is not None:
            on_log(rec)

    def save(name: str) -> None:
        save_train_state(state, out_dir / name, mesh, shardings)

    def flush() -> None:
        nonlocal t0
        if not pending:
            return
        losses = [float(l) for _, l, _ in pending]  # one sync for the lot
        dt = time.perf_counter() - t0
        rate = len(pending) / dt if dt > 0 else None
        for (s, _, timing), loss in zip(pending, losses):
            write({"step": s, "loss": loss, "stage_steps_per_s": rate, **(timing or {})})
        pending.clear()
        t0 = time.perf_counter()

    last_eval = -1
    # the best eval values persist across a resume, so that a first
    # post-resume eval does not overwrite a better ckpt_best.npz
    best_path = out_dir / "best_eval.json"
    best_eval: dict[str, float] = {}
    if cfg.resume and best_path.exists():
        try:
            best_eval = {k: float(v) for k, v in json.loads(best_path.read_text()).items()}
        except (ValueError, OSError):
            logger.warning("could not parse %s; best-eval tracking resets", best_path)

    def run_eval(step: int) -> None:
        nonlocal last_eval
        if step == last_eval:
            return
        last_eval = step
        flush()
        res = eval_fn(state)
        rec = {"step": step, **(res if isinstance(res, dict) else {"eval_loss": res})}
        if cfg.keep_best_eval:
            selectors = [(cfg.best_metric, "ckpt_best.npz")] + [
                (k, f"ckpt_best_{k}.npz") for k in cfg.track_best_metrics if k != cfg.best_metric
            ]
            for key, name in selectors:
                if key in rec and rec[key] < best_eval.get(key, float("inf")):
                    best_eval[key] = rec[key]
                    save(name)
                    if writes:
                        tmp = out_dir / ".best_eval.json"
                        tmp.write_text(json.dumps(best_eval))
                        os.replace(tmp, best_path)
                    if key == cfg.best_metric:
                        rec["best"] = True
        write(rec)

    profiler = None
    try:
        for step in range(start, cfg.total_steps):
            try:
                batch = next(prefetch)
            except StopIteration:
                break  # finite dataset exhausted: checkpoint and return
            if cfg.profile_steps and step == cfg.profile_steps[0]:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=activities)
                profiler.__enter__()
            state, loss = step_fn(state, batch, step_generator(cfg.seed, step))
            if profiler is not None and step + 1 >= cfg.profile_steps[1]:
                _stop_profiler(profiler, out_dir, device)
                profiler = None
            pending.append((step + 1, loss, getattr(step_fn, "last_timing", None)))
            if (step + 1) % cfg.log_every == 0:
                flush()
            if eval_fn is not None and cfg.eval_every and (step + 1) % cfg.eval_every == 0:
                run_eval(step + 1)
            if cfg.ckpt_every and (step + 1) % cfg.ckpt_every == 0:
                flush()
                save("ckpt_latest.npz")
    finally:
        if profiler is not None:
            _stop_profiler(profiler, out_dir, device)
        prefetch.close()
    flush()
    if eval_fn is not None and cfg.eval_every:
        run_eval(int(state["step"]))
    save("ckpt_latest.npz")
    if export is not None:
        export_for_inference(state, export[1], stage=export[0], mesh=mesh, shardings=shardings)
    return state, history


def _stop_profiler(profiler, out_dir: Path, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.__exit__(None, None, None)
    if not is_writer():
        return
    trace_dir = out_dir / "profile"
    trace_dir.mkdir(parents=True, exist_ok=True)
    profiler.export_chrome_trace(str(trace_dir / "trace.json"))


def _train_device(device, who: str) -> torch.device:
    """The given device, else the card; raises where there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: CUDA is not available (use --device cpu)")
        device = torch.device("cuda")
    return torch.device(device)


def _initial_state(params, optimizer, cfg: TrainLoopConfig, ema_decay: Optional[float],
                   mesh=None, shardings=None) -> dict:
    """A fresh train state of ``params``, or ``out_dir/ckpt_latest.npz``
    restored into it when resuming (re-cut to this mesh's slices)."""
    state = init_train_state(params, optimizer, ema_decay=ema_decay)
    ckpt = Path(cfg.out_dir) / "ckpt_latest.npz"
    if cfg.resume and ckpt.exists():
        state = restore_train_state(ckpt, state, mesh, shardings)
        logger.info("resumed from %s at step %d", ckpt, state["step"])
    return state


def _sharded(params, mesh, shardings_fn, heads: int):
    """(the rank's slices of ``params``, their spec tree) on ``mesh``;
    (params, None) without one."""
    if mesh is None:
        return params, None
    shardings = shardings_fn(params, mesh, heads)
    return shard_params(params, shardings, mesh), shardings


def run_flow_training(
    model_cfg: DenoiserConfig,
    batches: Iterator[dict],
    cfg: TrainLoopConfig,
    *,
    device: Optional[torch.device] = None,
    params=None,
    on_log: Optional[Callable[[dict], None]] = None,
    eval_batches: Optional[list[dict]] = None,
    mesh=None,
    export: Optional[tuple[str, "str | Path"]] = None,
) -> tuple[dict, list[dict]]:
    """Train the Stage-I denoiser with the rectified-flow objective.

    ``batches`` yields numpy dicts in the ``training/data.flow_batches``
    layout. Params are drawn from ``cfg.seed`` unless given. Resumes from
    ``out_dir/ckpt_latest.npz`` when present (``cfg.resume``).
    ``eval_batches`` (held-out numpy batches) adds ``eval_loss`` records
    every ``cfg.eval_every`` steps: the loss of the EMA weights (when kept)
    with fixed draws and no context dropout. Runs on the card unless
    ``device`` says otherwise, and raises where there is none. ``mesh``:
    see the module's note (the full params are drawn or given alike on
    every rank, then cut). ``export`` (stage, directory): the final state's
    inference checkpoint, written after the last train checkpoint while the
    spec tree is in hand (``_run_loop``). Returns (final state, log).
    """
    device = _train_device(device, "run_flow_training")
    if params is None:
        params = init_denoiser(torch.Generator(device).manual_seed(cfg.seed), model_cfg, device=device)
    params, shardings = _sharded(params, mesh, denoiser_param_shardings, model_cfg.num_attention_heads)
    optimizer = make_optimizer(cfg)
    state = _initial_state(params, optimizer, cfg, cfg.ema_decay, mesh, shardings)
    del params
    step_fn = make_train_step(
        model_cfg,
        optimizer,
        p_uncond=cfg.p_uncond,
        shift=cfg.shift,
        compute_dtype=compute_dtype(cfg),
        ema_decay=loop_ema_decay(cfg),
        time_phases=cfg.time_phases,
        mesh=mesh,
        shardings=shardings,
    )

    eval_fn = None
    if eval_batches:
        held_out = [to_device(b, device) for b in eval_batches]

        @torch.no_grad()
        def eval_fn(current: dict) -> float:
            eval_params = current.get("ema_params", current["params"])
            losses = [
                flow_matching_loss(
                    eval_params, model_cfg, b, step_generator(cfg.seed + 1, i),
                    p_uncond=0.0, shift=cfg.shift, remat=False,
                    compute_dtype=compute_dtype(cfg), mesh=mesh,
                )
                for i, b in enumerate(held_out)
            ]
            return float(sum(float(l) for l in losses) / len(losses))

    return _run_loop(state, step_fn, batches, cfg, device, mesh=mesh, shardings=shardings,
                     on_log=on_log, eval_fn=eval_fn, export=export)


def run_decoder_training(
    model_cfg: AutoencoderConfig,
    batches: Iterator[dict],
    cfg: TrainLoopConfig,
    *,
    device: Optional[torch.device] = None,
    params=None,
    on_log: Optional[Callable[[dict], None]] = None,
    eval_batches: Optional[list[dict]] = None,
    eval_chamfer: bool = False,
    mesh=None,
    export: Optional[tuple[str, "str | Path"]] = None,
) -> tuple[dict, list[dict]]:
    """Train the Stage-II decoder with the masked position MSE (the loop
    contract of ``run_flow_training``; batches in the
    ``training/decoder_train.decoder_loss`` layout; no EMA).

    ``eval_chamfer`` adds the chamfer-proxy metrics to every held-out eval
    record: ``eval_cd``, ``eval_motion`` and their sum ``eval_score`` (CD
    and CD-M weigh equally on the reference's leaderboard); with
    ``cfg.best_metric="eval_score"`` they select ``ckpt_best.npz``. Runs on
    the card unless ``device`` says otherwise, and raises where there is
    none. ``mesh``: ``run_flow_training``'s, with
    ``autoencoder_param_shardings``.
    """
    from actionmesh_tpu_torch.training.decoder_train import (
        decoder_eval_metrics,
        make_decoder_train_step,
    )

    device = _train_device(device, "run_decoder_training")
    if params is None:
        params = init_autoencoder(torch.Generator(device).manual_seed(cfg.seed), model_cfg, device=device)
    params, shardings = _sharded(params, mesh, autoencoder_param_shardings, model_cfg.num_attention_heads)
    optimizer = make_optimizer(cfg)
    state = _initial_state(params, optimizer, cfg, None, mesh, shardings)
    del params
    step_fn = make_decoder_train_step(
        model_cfg, optimizer, compute_dtype=compute_dtype(cfg), time_phases=cfg.time_phases,
        mesh=mesh, shardings=shardings,
    )

    eval_fn = None
    if eval_batches:
        held_out = [to_device(b, device) for b in eval_batches]

        def eval_fn(current: dict) -> dict:
            per_batch = [
                decoder_eval_metrics(current["params"], model_cfg, b, compute_dtype=compute_dtype(cfg),
                                     with_chamfer=eval_chamfer, mesh=mesh)
                for b in held_out
            ]
            out = {k: sum(m[k] for m in per_batch) / len(per_batch) for k in per_batch[0]}
            if eval_chamfer:
                out["eval_score"] = out["eval_cd"] + out["eval_motion"]
            return out

    return _run_loop(state, step_fn, batches, cfg, device, mesh=mesh, shardings=shardings,
                     on_log=on_log, eval_fn=eval_fn, export=export)


def run_vae_training(
    model_cfg,
    batches: Iterator[dict],
    cfg: TrainLoopConfig,
    *,
    device: Optional[torch.device] = None,
    params=None,
    kl_weight: float = 1e-4,
    on_log: Optional[Callable[[dict], None]] = None,
    eval_batches: Optional[list[dict]] = None,
) -> tuple[dict, list[dict]]:
    """Train the TripoSG vecset VAE (a ``TripoSGVAEConfig``) with TSDF
    supervision (``training/vae_train.py``; batches carry ``surface``,
    ``points`` and ``tsdf``, as ``sdf_batches`` yields them). The loop
    contract of ``run_flow_training``, with no EMA; the held-out eval
    reports the TSDF MSE of the posterior mean (deterministic FPS) as
    ``eval_loss``. Params are drawn from ``cfg.seed`` unless given. Runs on
    the card unless ``device`` says otherwise, and raises where there is
    none.
    """
    from actionmesh_tpu_torch.models.triposg.vae import init_triposg_vae
    from actionmesh_tpu_torch.training.vae_train import make_vae_train_step, vae_loss

    device = _train_device(device, "run_vae_training")
    if params is None:
        params = init_triposg_vae(torch.Generator(device).manual_seed(cfg.seed), model_cfg, device=device)
    optimizer = make_optimizer(cfg)
    state = _initial_state(params, optimizer, cfg, None)
    del params
    step_fn = make_vae_train_step(
        model_cfg, optimizer, kl_weight=kl_weight, time_phases=cfg.time_phases
    )

    eval_fn = None
    if eval_batches:
        held_out = [to_device(b, device) for b in eval_batches]

        @torch.no_grad()
        def eval_fn(current: dict) -> float:
            losses = [
                vae_loss(current["params"], model_cfg, b, None, kl_weight=kl_weight,
                         trainable=False)[1]["mse"]
                for b in held_out
            ]
            return float(sum(float(l) for l in losses) / len(losses))

    return _run_loop(state, step_fn, batches, cfg, device, on_log=on_log, eval_fn=eval_fn)


def run_distillation(
    model_cfg: DenoiserConfig,
    teacher_params,
    batches: Iterator[dict],
    cfg: TrainLoopConfig,
    *,
    mode: str = "guidance",
    guidance_scale: float = 7.5,
    num_teacher_steps: int = 30,
    teacher_guidance_scale: Optional[float] = None,
    device: Optional[torch.device] = None,
    student_params=None,
    on_log: Optional[Callable[[dict], None]] = None,
    eval_batches: Optional[list[dict]] = None,
    mesh=None,
    export: Optional[tuple[str, "str | Path"]] = None,
) -> tuple[dict, list[dict]]:
    """Distill a Stage-I (or Stage-0 DiT) teacher into a cheaper student
    (``training/distill.py``).

    ``mode`` "guidance" regresses the teacher's CFG-guided velocity into one
    conditional forward; "progressive" halves an even ``num_teacher_steps``.
    The student starts from the teacher (the warm start) unless
    ``student_params`` is given, and keeps an EMA (``loop_ema_decay``).
    ``eval_batches`` reports the same loss on held-out batches with fixed
    draws. The loop contract is ``run_flow_training``'s; runs on the card
    unless ``device`` says otherwise, and raises where there is none.
    ``mesh``: teacher and student are cut alike and the teacher runs on the
    mesh without gradients.
    """
    from actionmesh_tpu_torch.training.distill import (
        distill_targets_fn,
        make_distill_step,
        student_loss,
    )

    device = _train_device(device, "run_distillation")
    teacher_params = tree_map(lambda p: p.detach().to(device), teacher_params)
    heads = model_cfg.num_attention_heads
    teacher_params, shardings = _sharded(teacher_params, mesh, denoiser_param_shardings, heads)
    if student_params is not None:
        student_params = _sharded(student_params, mesh, denoiser_param_shardings, heads)[0]
    optimizer = make_optimizer(cfg)
    state = _initial_state(
        teacher_params if student_params is None else student_params, optimizer, cfg, cfg.ema_decay,
        mesh, shardings,
    )
    del student_params
    # the teacher cast for compute once; the step's own cast of it is then a no-op
    if compute_dtype(cfg) is not None:
        teacher_params = cast_params_for_compute(teacher_params, compute_dtype(cfg))
    kw = dict(mode=mode, guidance_scale=guidance_scale, num_teacher_steps=num_teacher_steps,
              teacher_guidance_scale=teacher_guidance_scale, shift=cfg.shift, mesh=mesh)
    step_fn = make_distill_step(
        model_cfg, optimizer, teacher_params, compute_dtype=compute_dtype(cfg),
        ema_decay=loop_ema_decay(cfg), time_phases=cfg.time_phases, shardings=shardings, **kw,
    )

    eval_fn = None
    if eval_batches:
        held_out = [to_device(b, device) for b in eval_batches]
        targets = distill_targets_fn(model_cfg, teacher_params, **kw)

        @torch.no_grad()
        def eval_fn(current: dict) -> float:
            eval_params = current.get("ema_params", current["params"])
            losses = [
                student_loss(eval_params, model_cfg, b, targets(b, step_generator(cfg.seed + 1, i)),
                             remat=False, compute_dtype=compute_dtype(cfg), mesh=mesh)
                for i, b in enumerate(held_out)
            ]
            return float(sum(float(l) for l in losses) / len(losses))

    return _run_loop(state, step_fn, batches, cfg, device, mesh=mesh, shardings=shardings,
                     on_log=on_log, eval_fn=eval_fn, export=export)
