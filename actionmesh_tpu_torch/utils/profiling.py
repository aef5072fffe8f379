"""Spans, the call's recorder, and torch.profiler traces.

Counterpart of ``actionmesh_tpu/utils/profiling.py``. ``span(name)`` marks a
host region: a ``record_function`` range for torch.profiler, an NVTX range
once CUDA is up, and a ``Span`` record in the recorder of the call in
progress. The recorder is ambient: one per top-level call, found through a
context variable; a span opened while none is active starts one and is
that call's root, so every span of one pipeline call shares its ``call``
id, whichever object opened it. A span's start and end are Unix-epoch
nanoseconds, the clock torch.profiler stamps its host and CUDA events
with: one ``time.time_ns()`` anchor a call plus ``perf_counter_ns``
offsets, so the in-memory spans line up with a device trace of the same
call. The recorder is always on; a span costs two clock reads, a list
append and the range enter and exit.

``tree_seconds(root)`` reads the seconds below a span by dotted path; the
pipeline's ``phase_seconds`` and ``stage0_seconds`` are views of it. A
span's ``counters`` hold the program's counts inside it (the SDF chunks
each extraction pass queried). ``profile_to(log_dir)`` records CPU and
CUDA activity of the enclosed region into a Chrome trace under
``log_dir`` (chrome://tracing or Perfetto reads it).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import logging
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Optional

import torch

logger = logging.getLogger(__name__)

_CALL_IDS = itertools.count(1)


@dataclasses.dataclass(eq=False)
class Span:
    """One host region of a call: ``parent`` is the index of the enclosing
    span in ``recorder.spans`` (-1 for the call's root), ``start_ns`` and
    ``end_ns`` Unix-epoch nanoseconds (``end_ns`` 0 while open)."""

    name: str
    parent: int
    call: int
    start_ns: int
    recorder: "Recorder" = dataclasses.field(repr=False)
    end_ns: int = 0
    counters: dict = dataclasses.field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class Recorder:
    """The spans of one top-level call, in the order they opened."""

    def __init__(self):
        self.call = next(_CALL_IDS)
        self.spans: list[Span] = []
        self._open: list[int] = []  # the indices of the open spans, innermost last
        self._epoch_ns = time.time_ns()
        self._perf_ns = time.perf_counter_ns()

    def now_ns(self) -> int:
        return self._epoch_ns + time.perf_counter_ns() - self._perf_ns


_RECORDER: contextvars.ContextVar[Optional[Recorder]] = contextvars.ContextVar(
    "actionmesh_span_recorder", default=None
)


@contextlib.contextmanager
def span(name: str):
    """Mark the enclosed host region as ``name`` (see the module doc) and
    yield its ``Span``, whose ``end_ns`` is stamped when the region ends."""
    rec = _RECORDER.get()
    token = None
    if rec is None:
        rec = Recorder()
        token = _RECORDER.set(rec)
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            # stamped inside the range, so a profiler's first-event set-up
            # falls outside the span
            sp = Span(name, rec._open[-1] if rec._open else -1, rec.call, rec.now_ns(), rec)
            rec._open.append(len(rec.spans))
            rec.spans.append(sp)
            try:
                yield sp
            finally:
                sp.end_ns = rec.now_ns()
                rec._open.pop()
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
        if token is not None:
            _RECORDER.reset(token)


def tree_seconds(root: Span) -> dict[str, tuple[float, float]]:
    """Every span below ``root`` by its dotted path from there ->
    (seconds, own seconds: those outside its child spans), each summed over
    the spans of that path."""
    spans = root.recorder.spans
    start = spans.index(root)
    paths = {start: ""}
    total: dict[str, float] = defaultdict(float)
    inner: dict[int, float] = defaultdict(float)
    for i in range(start + 1, len(spans)):
        sp = spans[i]
        if sp.parent not in paths:
            break  # opened after root closed
        paths[i] = f"{paths[sp.parent]}.{sp.name}" if paths[sp.parent] else sp.name
        total[paths[i]] += sp.seconds
        inner[sp.parent] += sp.seconds
    own: dict[str, float] = defaultdict(float)
    for i, path in paths.items():
        if path:
            own[path] += spans[i].seconds - inner[i]
    return {path: (total[path], own[path]) for path in total}


@contextlib.contextmanager
def profile_to(log_dir: str | Path):
    """Record a torch.profiler trace of the enclosed region (CPU activity,
    and CUDA activity when a card is present) and write it as a Chrome trace
    ``trace_<pid>_<ns>.json`` into ``log_dir``. Yields the profiler, whose
    ``events()`` the caller may read after the region."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    logger.info("Profiler trace written to %s", path)
