"""Tracing and profiling hooks on torch.profiler.

Counterpart of ``actionmesh_tpu/utils/profiling.py``: ``trace(name)`` marks
a host region in the trace (the pipeline marks every Stage-I and Stage-II
window: ``stage1_window_<i>``, ``stage2_window_<i>``), ``profile_to(log_dir)``
records CPU and CUDA activity of the enclosed region into a Chrome trace
under ``log_dir`` (chrome://tracing or Perfetto reads it).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from pathlib import Path

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(name: str):
    """Mark the enclosed host region as ``name``: a ``record_function`` range
    for torch.profiler and, once CUDA is initialised, an NVTX range for
    CUDA's own tools."""
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


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
