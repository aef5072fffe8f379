"""Training data: clip datasets, window batching, host-to-device prefetch.

Numpy copies of ``actionmesh_tpu/training/data.py`` (the card's machine has
no jax, so the port cannot import that module), same on-disk format: one
``.npz`` per clip with ``latents`` (T_clip, N, C), ``context`` (T_clip, S, D)
and ``framestep`` (T_clip,). Training examples are ``window``-frame slices;
the first ``n_cond_frames`` of each are marked as ground-truth conditioning
(mask 1).

``DecoderTrackDataset`` and ``decoder_batches`` pair clips with tracked
vertex surfaces for Stage-II decoder training. ``split_windows`` works on
both datasets and gives each view an empty cache of its own (the JAX
version sets the flow dataset's cache to None, which ``_load`` then fails
on).
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


def split_windows(dataset, eval_fraction: float = 0.1, seed: int = 0):
    """Random disjoint (train, eval) split of a window dataset
    (``ClipWindowDataset`` or ``DecoderTrackDataset``): two views sharing
    the files, each with an empty cache of its own."""
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


def synthesize_track_dir(
    out_dir: str | Path,
    *,
    n_clips: int = 4,
    frames: int = 8,
    tokens: int = 8,
    channels: int = 4,
    vertices: int = 16,
    seed: int = 0,
) -> tuple[Path, Path]:
    """A deterministic synthetic decoder dataset: ``out_dir/clips/{uid}.npz``
    (smooth low-rank latents; a one-token zero context, which the decoder
    does not read) and ``out_dir/tracks/{uid}/surfaces.npy``: points drifting
    smoothly inside (-1, 1) with unit normals. Clip i tracks
    ``vertices - i * vertices // 8`` points (at least 1), so batches pad to
    the bucket. Returns (clips dir, tracks dir)."""
    out = Path(out_dir)
    clips, tracks = out / "clips", out / "tracks"
    clips.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, frames, dtype=np.float32)
    for i in range(n_clips):
        uid = f"clip_{i:04d}"
        base = rng.normal(size=(tokens, channels)).astype(np.float32)
        drift = rng.normal(size=(tokens, channels)).astype(np.float32)
        latents = base[None] * np.cos(2 * np.pi * t)[:, None, None] + drift[None] * t[:, None, None]
        write_clip(clips / f"{uid}.npz", latents, np.zeros((frames, 1, 1), np.float32),
                   np.arange(frames, dtype=np.float32))
        V = max(1, vertices - i * vertices // 8)
        points = rng.uniform(-0.7, 0.7, (V, 3)).astype(np.float32)
        motion = rng.normal(size=(V, 3)).astype(np.float32) * 0.1
        positions = np.tanh(points[None] + motion[None] * np.sin(np.pi * t)[:, None, None])
        normals = rng.normal(size=(V, 3)).astype(np.float32)
        normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
        (tracks / uid).mkdir(parents=True, exist_ok=True)
        surfaces = np.concatenate([positions, np.broadcast_to(normals, positions.shape)], axis=-1)
        np.save(tracks / uid / "surfaces.npy", surfaces.astype(np.float32))
    return clips, tracks


class DecoderTrackDataset:
    """Stage-I clips paired with tracked ground-truth surfaces, for Stage-II
    decoder training.

    ``clips_dir/{uid}.npz`` (the clip format above; only ``latents`` and
    ``framestep`` are read) and ``tracks_dir/{uid}/surfaces.npy``, (T, V, 6)
    positions + normals per tracked vertex (the ActionBench ground-truth
    layout), positions in the decoder's (-1, 1). Only uids present in both
    directories index; their frame counts must match.
    """

    def __init__(self, clips_dir: str | Path, tracks_dir: str | Path, window: int, stride: int = 1):
        if window < 2:
            raise ValueError(f"window={window} must be >= 2 (anchor + targets)")
        self.window = window
        clips_dir, tracks_dir = Path(clips_dir), Path(tracks_dir)
        clip_uids = {p.stem for p in clips_dir.glob("*.npz")}
        track_uids = {p.parent.name for p in tracks_dir.glob("*/surfaces.npy")}
        uids = sorted(clip_uids & track_uids)
        if not uids:
            raise FileNotFoundError(
                f"no shared uids between {clips_dir} (*.npz: {len(clip_uids)}) "
                f"and {tracks_dir} (*/surfaces.npy: {len(track_uids)})"
            )
        self._windows: list[tuple[Path, Path, int]] = []
        self.skipped_clips = 0
        for uid in uids:
            clip_path = clips_dir / f"{uid}.npz"
            track_path = tracks_dir / uid / "surfaces.npy"
            with np.load(clip_path) as z:
                frames = z["latents"].shape[0]
            surf_frames = np.load(track_path, mmap_mode="r").shape[0]
            if surf_frames != frames:
                raise ValueError(
                    f"{uid}: clip has {frames} frames but surfaces.npy has {surf_frames}"
                )
            if frames < window:
                self.skipped_clips += 1
                continue
            for start in range(0, frames - window + 1, stride):
                self._windows.append((clip_path, track_path, start))
        if not self._windows:
            raise ValueError(f"no paired clip has >= {window} frames")
        # the last clip read (windows of one clip are contiguous)
        self._cache: "OrderedDict[Path, tuple]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._windows)

    def _load(self, clip_path: Path, track_path: Path) -> tuple:
        hit = self._cache.get(clip_path)
        if hit is None:
            with np.load(clip_path) as z:
                clip = {k: z[k] for k in ("latents", "framestep")}
            hit = (clip, np.load(track_path))
            self._cache.clear()
            self._cache[clip_path] = hit
        return hit

    def __getitem__(self, idx: int) -> dict:
        clip_path, track_path, start = self._windows[idx]
        clip, surfaces = self._load(clip_path, track_path)
        sl = slice(start, start + self.window)
        return {
            "latents": clip["latents"][sl],
            "framestep": clip["framestep"][sl],
            "surfaces": surfaces[sl],  # (window, V, 6)
        }


def decoder_batches(
    dataset: DecoderTrackDataset,
    batch_size: int,
    *,
    vertex_bucket: int = 4096,
    seed: int = 0,
    epochs: Optional[int] = None,
) -> Iterator[dict]:
    """Shuffled numpy batches in the ``training/decoder_train.decoder_loss``
    layout, forever (or for ``epochs`` passes).

    Each window trains "deform the first frame's surface to the later
    frames": ``query`` is frame 0's (V, 6) points + normals, ``positions``
    frames 1..T-1's tracked positions; alphas normalise the window's
    framesteps to [0, 1] as Stage-II inference does. V pads to
    ``vertex_bucket`` with mask-0 rows. A sample with more vertices than
    the bucket, or positions outside [-1, 1], raises.
    """
    if len(dataset) < batch_size:
        raise ValueError(f"dataset has {len(dataset)} windows < batch_size {batch_size}")
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(dataset))
        for lo in range(0, len(order) - batch_size + 1, batch_size):
            items = [dataset[int(i)] for i in order[lo : lo + batch_size]]
            queries, positions, masks = [], [], []
            for it in items:
                surf = np.asarray(it["surfaces"], np.float32)
                V = surf.shape[1]
                if V > vertex_bucket:
                    raise ValueError(f"sample has {V} vertices > vertex_bucket {vertex_bucket}")
                pos = surf[1:, :, :3]
                if np.abs(pos).max() > 1.0:
                    raise ValueError(
                        "tracked positions exceed the decoder's (-1, 1) output range "
                        f"(max |x| = {np.abs(pos).max():.3f}): normalize the tracks first"
                    )
                pad = vertex_bucket - V
                queries.append(np.concatenate([surf[0], np.zeros((pad, 6), np.float32)]))
                positions.append(
                    np.concatenate([pos, np.zeros((pos.shape[0], pad, 3), np.float32)], axis=1)
                )
                mask = np.zeros((vertex_bucket,), np.float32)
                mask[:V] = 1.0
                masks.append(mask)
            framestep = np.stack([it["framestep"] for it in items]).astype(np.float32)
            t_min = framestep.min(axis=1, keepdims=True)
            t_range = framestep.max(axis=1, keepdims=True) - t_min
            alphas = (framestep - t_min) / np.maximum(t_range, 1e-6)
            yield {
                "latents": np.stack([it["latents"] for it in items]),
                "framestep": framestep,
                "source_alpha": alphas[:, 0],
                "target_alphas": alphas[:, 1:],
                "query": np.stack(queries),
                "positions": np.stack(positions),
                "vertex_mask": np.stack(masks),
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
