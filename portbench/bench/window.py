"""The measured window: clips back to back (closed loop, one client).

The window opens when the first clip after the warm-up starts and closes
when the first clip that ends at or after ``seconds`` ends; ``clip_s`` is
the whole window divided by the clips completed in it.
"""

from __future__ import annotations

import time
from typing import Callable


def closed_loop(run_clip: Callable[[int], None], seconds: float,
                clock: Callable[[], float] = time.perf_counter) -> dict:
    """Run ``run_clip(i)`` for i = 0, 1, ... until a clip ends at or after
    ``seconds`` from the start. Returns the window's start on ``clock``, its
    length, each clip's end (s from the start) and the clip count."""
    start = clock()
    ends: list[float] = []
    while True:
        run_clip(len(ends))
        ends.append(clock() - start)
        if ends[-1] >= seconds:
            break
    return {"start": start, "window_s": ends[-1], "clips": len(ends), "ends": ends}


def clip_seconds(window: dict) -> float:
    return window["window_s"] / window["clips"]
