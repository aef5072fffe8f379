"""Training data: clip datasets, window batching, host-to-device prefetch.

Numpy copies of ``actionmesh_tpu/training/data.py`` (the card's machine has
no jax, so the port cannot import that module), same on-disk format: one
``.npz`` per clip with ``latents`` (T_clip, N, C), ``context`` (T_clip, S, D)
and ``framestep`` (T_clip,). Training examples are ``window``-frame slices;
the first ``n_cond_frames`` of each are marked as ground-truth conditioning
(mask 1).

``split_windows`` gives each view an empty clip cache of its own (the JAX
version sets the cache to None, which ``_load`` then fails on).
``DevicePrefetcher`` takes the place of the JAX one: a thread copies each
batch into pinned host memory and on to the device with ``non_blocking``
copies on a side stream, overlapping the copy with the running step.
"""

from __future__ import annotations

import copy
import queue
import threading
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch


def write_clip(
    path: str | Path, latents: np.ndarray, context: np.ndarray, framestep: np.ndarray
) -> None:
    """Write one training clip in the canonical npz layout."""
    latents, context, framestep = map(np.asarray, (latents, context, framestep))
    if latents.ndim != 3 or context.ndim != 3 or framestep.ndim != 1:
        raise ValueError(
            f"clip arrays must be (T,N,C)/(T,S,D)/(T,): got "
            f"{latents.shape}/{context.shape}/{framestep.shape}"
        )
    if not (latents.shape[0] == context.shape[0] == framestep.shape[0]):
        raise ValueError(
            f"frame-count mismatch: latents T={latents.shape[0]}, "
            f"context T={context.shape[0]}, framestep T={framestep.shape[0]}"
        )
    np.savez(path, latents=latents, context=context, framestep=framestep)


def synthesize_clip_dir(
    out_dir: str | Path,
    *,
    n_clips: int = 4,
    frames: int = 8,
    tokens: int = 8,
    channels: int = 4,
    context_tokens: int = 3,
    context_dim: int = 16,
    seed: int = 0,
) -> Path:
    """A deterministic synthetic clip directory: low-rank latents moving
    smoothly in time, with matching per-frame context features."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_clips):
        base = rng.normal(size=(tokens, channels)).astype(np.float32)
        drift = rng.normal(size=(tokens, channels)).astype(np.float32)
        t = np.linspace(0.0, 1.0, frames, dtype=np.float32)[:, None, None]
        latents = base[None] * np.cos(2 * np.pi * t) + drift[None] * t
        context = rng.normal(size=(frames, context_tokens, context_dim)).astype(np.float32) * 0.5
        framestep = np.arange(frames, dtype=np.float32)
        write_clip(out / f"clip_{i:04d}.npz", latents, context, framestep)
    return out


@dataclass(frozen=True)
class _Window:
    clip: Path
    start: int


class ClipWindowDataset:
    """Index of fixed-length frame windows over a directory of clip npz
    files; clips shorter than ``window`` are skipped (``skipped_clips``)."""

    def __init__(self, data_dir: str | Path, window: int, stride: int = 1):
        if window < 1 or stride < 1:
            raise ValueError(f"window={window} and stride={stride} must be >= 1")
        self.data_dir = Path(data_dir)
        self.window = window
        clips = sorted(self.data_dir.glob("*.npz"))
        if not clips:
            raise FileNotFoundError(f"no .npz clips under {self.data_dir}")
        self._windows: list[_Window] = []
        self.skipped_clips = 0
        for clip in clips:
            with np.load(clip) as z:
                frames = z["latents"].shape[0]
            if frames < window:
                self.skipped_clips += 1
                continue
            for start in range(0, frames - window + 1, stride):
                self._windows.append(_Window(clip, start))
        if not self._windows:
            raise ValueError(f"no clip under {self.data_dir} has >= {window} frames")
        # a few decoded clips: shuffled batches draw windows across clips
        self._cache: "OrderedDict[Path, dict]" = OrderedDict()
        self._cache_clips = 8

    def __len__(self) -> int:
        return len(self._windows)

    def _load(self, path: Path) -> dict:
        hit = self._cache.get(path)
        if hit is not None:
            self._cache.move_to_end(path)
            return hit
        with np.load(path) as z:
            clip = {k: z[k] for k in ("latents", "context", "framestep")}
        self._cache[path] = clip
        if len(self._cache) > self._cache_clips:
            self._cache.popitem(last=False)
        return clip

    def __getitem__(self, idx: int) -> dict:
        w = self._windows[idx]
        clip = self._load(w.clip)
        sl = slice(w.start, w.start + self.window)
        return {k: clip[k][sl] for k in ("latents", "context", "framestep")}


def split_windows(dataset: ClipWindowDataset, eval_fraction: float = 0.1, seed: int = 0):
    """Random disjoint (train, eval) split of a window dataset: two views
    sharing the files, each with an empty clip cache of its own."""
    n = len(dataset)
    n_eval = max(1, int(round(n * eval_fraction)))
    if n_eval >= n:
        raise ValueError(
            f"eval_fraction={eval_fraction} leaves no training windows (dataset has {n})"
        )
    order = np.random.default_rng(seed).permutation(n)

    def view(indices):
        v = copy.copy(dataset)
        v._windows = [dataset._windows[int(i)] for i in sorted(indices)]
        v._cache = OrderedDict()
        return v

    return view(order[n_eval:]), view(order[:n_eval])


def flow_batches(
    dataset: ClipWindowDataset,
    batch_size: int,
    *,
    seed: int = 0,
    n_cond_frames: "int | tuple[int, int]" = 1,
    epochs: Optional[int] = None,
) -> Iterator[dict]:
    """Shuffled numpy batches forever (or for ``epochs`` passes): latents
    (B,T,N,C), context (B,T,S,D), framestep (B,T), mask (B,T) with a prefix
    of ``n_cond_frames`` frames = 1; an ``(lo, hi)`` range draws each row's
    prefix length uniformly. Incomplete trailing batches are dropped."""
    if batch_size < 1:
        raise ValueError(f"batch_size={batch_size} must be >= 1")
    if len(dataset) < batch_size:
        raise ValueError(f"dataset has {len(dataset)} windows < batch_size {batch_size}")
    rng = np.random.default_rng(seed)
    T = dataset.window
    if isinstance(n_cond_frames, tuple):
        lo_c, hi_c = n_cond_frames
        if not (0 <= lo_c <= hi_c < T):
            raise ValueError(
                f"n_cond_frames range {n_cond_frames} must satisfy 0 <= lo <= hi < window={T}"
            )
    else:
        lo_c = hi_c = int(n_cond_frames)

    def make_mask() -> np.ndarray:
        counts = rng.integers(lo_c, hi_c + 1, size=(batch_size,))
        return (np.arange(T)[None, :] < counts[:, None]).astype(np.float32)

    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(dataset))
        for lo in range(0, len(order) - batch_size + 1, batch_size):
            items = [dataset[int(i)] for i in order[lo : lo + batch_size]]
            yield {
                "latents": np.stack([it["latents"] for it in items]),
                "context": np.stack([it["context"] for it in items]),
                "framestep": np.stack([it["framestep"] for it in items]).astype(np.float32),
                "mask": make_mask(),
            }
        epoch += 1


def to_device(batch: dict, device: torch.device, non_blocking: bool = False) -> dict:
    """numpy batch -> torch tensors on ``device`` (through pinned memory
    when copying to a GPU without blocking)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda" and non_blocking:
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=non_blocking)
    return out


class DevicePrefetcher:
    """Iterate ``batches`` as tensors on ``device``, up to ``DEPTH``
    batches ahead. A daemon thread copies each batch to the device (on a
    side CUDA stream, non-blocking from pinned memory); the consumer's
    stream waits for that copy before the batch is used. Order is kept;
    worker exceptions re-raise at ``__next__``; ``close()`` stops the
    worker."""

    _DONE = object()
    DEPTH = 2

    def __init__(self, batches: Iterator[dict], device: torch.device):
        self._device = torch.device(device)
        self._stream = torch.cuda.Stream(self._device) if self._device.type == "cuda" else None
        self._queue: queue.Queue = queue.Queue(maxsize=self.DEPTH)
        self._stop = threading.Event()
        self._source = batches
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self) -> None:
        try:
            for batch in self._source:
                if self._stop.is_set():
                    return
                if self._stream is None:
                    item = (to_device(batch, self._device), None)
                else:
                    with torch.cuda.stream(self._stream):
                        moved = to_device(batch, self._device, non_blocking=True)
                        done = torch.cuda.Event()
                        done.record(self._stream)
                    item = (moved, done)
                if not self._put(item):
                    return
            self._put(self._DONE)
        except BaseException as exc:  # surfaces at the consumer
            self._put(exc)

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        while True:
            try:
                item = self._queue.get(timeout=0.1)
                break
            except queue.Empty:
                if self._stop.is_set() or not self._thread.is_alive():
                    raise StopIteration
        if item is self._DONE:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        batch, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(done)
            for t in batch.values():
                t.record_stream(stream)  # the side stream's allocation is used here
        return batch

    def close(self) -> None:
        self._stop.set()
        try:  # free one slot so a blocked worker sees the stop flag
            self._queue.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):
        self.close()
