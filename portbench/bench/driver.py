"""One run of one cell: set-up, warm-up, the measured window, the check.

Set-up (timed from the process's start, ``setup_s``): the cell's traffic
from the seed, the weights of the model family's networks
(``families/<family>.py``) made on the device from the seed, the pipeline
the family builds on them, and a warm-up of one clip at the cell's shapes
with one Stage-0 step and one Stage-I step. The window (``window.closed_loop``)
then runs clips back to back, the same in every run. Without ``trace`` the
end-to-end metrics report. With it the per-layer readers do: the stage
seconds and ``clip_mfu`` from the window's clips, as untraced runs time
them, and the device's metrics and the breakdown from one more clip that
a torch.profiler session covers after the window (the profiler slows the
host-bound layers). The first clip of the window is the one checked
(``check.run``), after the window has closed, the peak memory has been
read and the pipeline has been freed.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import time
from pathlib import Path

import torch

from portbench.bench import check, manifest, port, tracing, traffic, window
from portbench.bench.weights import make_states

BF16_PEAK = 989e12  # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)


def log(t_start: float, what: str) -> None:
    print(f"portbench {time.perf_counter() - t_start:9.3f}s {what}", file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def clip_seed(seed: int, i: int) -> int:
    """The pipeline's sampling seed of clip i (below 2^31: the pipeline
    seeds numpy's legacy generator with it)."""
    return traffic.derive(seed, f"clip:{i}") % (2**31 - 1)


def run(root: Path, name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device=None, control: bool = False) -> dict:
    """One run; ``control`` also reads the control's numbers (the fp8
    reference in the program's place) into the result's ``control``."""
    device = torch.device(device or "cuda")
    man = manifest.load(root)
    wl = manifest.workload(man, name)
    cfg = manifest.config(man, wl["config"], root)
    mix = manifest.traffic(wl["traffic"], root)
    limits = manifest.checks(name, root)
    family = manifest.family(cfg["family"], root)
    mode = mix["mode"]

    frames = traffic.frames(mix, seed)
    mesh = traffic.mesh(mix, seed) if mode == "video_mesh" else None
    states = make_states(family.layouts(cfg["model"], family.networks(mode)), seed, device,
                         port.DTYPES[cfg["dtype"]])
    log(t_start, "weights made")
    pipe = family.build(cfg, states, mode, device)
    log(t_start, "pipeline built")
    plan = check.plan(cfg, mix, limits, seed, family)
    hooks = port.Hooks(pipe, plan, family)
    inp = port.make_input(frames)
    mesh_in = port.make_mesh(*mesh) if mesh is not None else None

    port.run_clip(pipe, mode, inp, mesh_in, seed=clip_seed(seed, -1), stage_0_steps=1,
                  stage_1_steps=1)
    _sync(device)
    log(t_start, "warm-up done")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    phases, stage0 = [], []

    def one_clip(i: int) -> None:
        with hooks.record() if i == 0 else contextlib.nullcontext():
            port.run_clip(pipe, mode, inp, mesh_in, seed=clip_seed(seed, i))
            _sync(device)
        phases.append(dict(pipe.phase_seconds))
        stage0.append(dict(pipe.stage0_seconds))
        log(t_start, "clip %d: %s" % (i, " ".join(
            f"{k}={v:.3f}" for k, v in {**phases[-1], **stage0[-1]}.items())))

    setup_s = time.perf_counter() - t_start
    win = window.closed_loop(one_clip, seconds)
    log(t_start, f"window closed: {win['clips']} clip(s), {win['window_s']:.3f}s")
    if trace:
        hooks.install_spans()
        with tracing.profiler() as prof, torch.profiler.record_function("portbench.clip"):
            port.run_clip(pipe, mode, inp, mesh_in, seed=clip_seed(seed, win["clips"]))
            _sync(device)
        log(t_start, "profiled clip: %s" % " ".join(
            f"{k}={v:.3f}" for k, v in {**pipe.phase_seconds, **pipe.stage0_seconds}.items()))
    cap = hooks.cap
    first = cap["s2"][0]  # Stage II's first call: the anchor mesh of the checked clip
    vertices = first["query"].shape[1]
    log(t_start, f"anchor mesh: {vertices} vertices, {len(first['mesh']['faces'])} faces")
    record = {
        "clips": win["clips"], "window_s": win["window_s"], "setup_s": setup_s,
        "phase_seconds": phases, "stage0_seconds": stage0, "peak_flops": BF16_PEAK,
        "flops_per_clip": manifest.work_model(cfg["family"], root).flops_per_clip(cfg, mix, vertices),
        "trace": tracing.reduce(prof) if trace else None,
        "attn_kept": {i: int(t.sum()) for i, t in getattr(hooks, "attn_masks", {}).items()},
    }
    tr = record["trace"]
    if trace:
        log(t_start, f"trace reduced: {tr['n_device_events']} device events, "
                     f"{tr['n_matched']} matched to a launch, {len(tr['attn'])} attention calls")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    hooks.remove()
    del pipe, hooks
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    vals, ctrl = check.run(cfg, states, cap, frames, plan, device, family, with_control=control)
    log(t_start, "check done")
    lim = limits["limits"]
    compared = {k: {"value": v, "limit": lim[k]} for k, v in vals.items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    metrics = {}
    for m in manifest.metrics_of(man, name, per_layer=trace):
        value = manifest.metric_reader(m["name"], root)(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": win["clips"], "failed": 0 if correct else 1,
           "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    if ctrl is not None:
        out["control"] = ctrl
    out["compared"] = compared
    return out
