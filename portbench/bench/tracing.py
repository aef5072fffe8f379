"""The traced run's profiled clip: one torch.profiler session over one
clip after the measured window, reduced in memory to what the per-layer
readers and the breakdown need. No trace file is written.

From the profiler's raw events: the device's busy intervals (every
kernel, copy and set on the card, the ranges' own device-side annotations
left out) and their union; each attention span (``port.ATTN_SPAN``) with
its shape, dtype and the device time of every kernel launched under it; the
host's spans (every ``record_function`` range: the pipeline's windows and
the benchmark's layer spans), to name each idle gap of the device by the
innermost span open on the host at its middle.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

from portbench.bench.port import ATTN_SPAN


@contextlib.contextmanager
def profiler():
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts,
                 record_shapes=False, with_stack=False, profile_memory=False) as prof:
        yield prof


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def gaps(busy: list[tuple[float, float]], start: float, end: float) -> list[tuple[float, float]]:
    """The idle intervals of [start, end] between the merged busy ones."""
    out, t = [], start
    for s, e in busy:
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]


def innermost(spans: list[tuple[float, float, str]], t: float) -> str:
    """The shortest host span containing time t ("host" if none)."""
    best, name = None, "host"
    for s, e, n in spans:
        if s <= t <= e and (best is None or e - s < best):
            best, name = e - s, n
    return name


def _is_launch(name: str) -> bool:
    """A CUDA runtime or driver call on the host (cudaLaunchKernel,
    cuLaunchKernel, cudaMemcpyAsync, ...)."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def reduce(prof) -> dict:
    """The profiler's raw events -> {"busy_s", "window_s", "device_ops",
    "idle_gaps", "attn": [(tag, device_s)], "n_device_events"}, in seconds.

    A device event belongs to the host call that launched it through the
    correlation id CUPTI gives both; an attention call's device time is
    every device event launched while its span was open. The window is
    the span of the profiled clip ("portbench.clip")."""
    cuda = torch.autograd.DeviceType.CUDA
    host_spans, device, launches = [], [], {}
    annotation = set()
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == cuda:
            if not ev.is_user_annotation():
                device.append((ev.start_ns(), ev.end_ns(), name,
                               (ev.correlation_id(), ev.linked_correlation_id())))
        elif ev.is_user_annotation():
            annotation.add(name)
            host_spans.append((ev.start_ns(), ev.end_ns(), name))
        elif _is_launch(name):
            launches[ev.correlation_id()] = ev.start_ns()
    device = [d for d in device if d[2] not in annotation]
    clips = [(s, e) for s, e, n in host_spans if n == "portbench.clip"]
    spans = clips or [(s, e) for s, e, _ in host_spans] or [(s, e) for s, e, _, _ in device] or [(0, 0)]
    window = (min(s for s, _ in spans), max(e for _, e in spans))
    busy = union([(s, e) for s, e, _, _ in device])
    busy_ns = sum(min(e, window[1]) - max(s, window[0]) for s, e in busy
                  if e > window[0] and s < window[1])
    by_name: dict[str, float] = defaultdict(float)
    for s, e, n, _ in device:
        by_name[n] += e - s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps(busy, *window), key=lambda g: g[0] - g[1])[:10]
    layer_spans = [sp for sp in host_spans if not sp[2].startswith(ATTN_SPAN)]
    attn = sorted(sp for sp in host_spans if sp[2].startswith(ATTN_SPAN + ":"))
    starts = [s for s, _, _ in attn]
    attn_ns = [0] * len(attn)
    matched = 0
    for s, e, _, (corr, linked) in device:
        t = launches.get(corr, launches.get(linked))
        if t is None:
            continue
        matched += 1
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= attn[i][1]:
            attn_ns[i] += e - s
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (window[1] - window[0]) / 1e9,
        "device_ops": [[n, ns / 1e9] for n, ns in top],
        "idle_gaps": [[innermost(layer_spans, (s + e) / 2), (e - s) / 1e9] for s, e in idle],
        "attn": [(n[len(ATTN_SPAN) + 1:], ns / 1e9) for (_, _, n), ns in zip(attn, attn_ns)],
        "n_device_events": len(device),
        "n_matched": matched,
    }
