"""The host-side pieces of the plain reference: frame preparation, the
sampler's schedule and guidance, and vertex features.

Frames: each RGBA frame is composited on white, all frames are cropped to
the union of their alpha boxes and padded to a square with a 10% margin
(truncated to uint8), then resized so that the short side is 256 with an
antialiased Keys-cubic kernel in two passes (width, then height), rounded
to uint8 after each as PIL does, centre-cropped to 224 and normalised with
ImageNet's mean and deviation. The flow schedule is the shifted one of
rectified flow (shift 3, 1000 training steps).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def crop_frames(frames: list[np.ndarray], padding_ratio: float = 0.1) -> list[np.ndarray]:
    """RGBA uint8 frames -> square RGB uint8 frames on white, cropped to the
    union of the frames' alpha boxes."""
    boxes, comps = [], []
    for f in frames:
        a = f[..., 3].astype(np.float32) / 255.0
        comps.append(f[..., :3].astype(np.float32) / 255.0 * a[..., None] + (1.0 - a[..., None]))
        rows = np.nonzero((f[..., 3] > 0).any(1))[0]
        cols = np.nonzero((f[..., 3] > 0).any(0))[0]
        boxes.append((cols[0], rows[0], cols[-1] + 1, rows[-1] + 1))
    x0, y0 = min(b[0] for b in boxes), min(b[1] for b in boxes)
    x1, y1 = max(b[2] for b in boxes), max(b[3] for b in boxes)
    w, h = x1 - x0, y1 - y0
    side = max(w, h)
    base = int(side * padding_ratio)
    px, py = base + (side - w) // 2, base + (side - h) // 2
    out = []
    for c in comps:
        crop = np.pad(c[y0:y1, x0:x1], ((py, py), (px, px), (0, 0)), constant_values=1.0)
        out.append((crop * 255).astype(np.uint8))
    return out


def resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    if img.shape[:2] == (h, w):
        return img.copy()
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None].float()
    for size in ((img.shape[0], w), (h, w)):
        x = F.interpolate(x, size=size, mode="bicubic", antialias=True, align_corners=False)
        x = (x + 0.5).floor().clamp(0, 255)
    return x[0].permute(1, 2, 0).to(torch.uint8).numpy()


def dino_pixels(frames: list[np.ndarray], short: int = 256, crop: int = 224) -> torch.Tensor:
    """RGB uint8 frames -> (T, 3, crop, crop) float32 normalised pixels."""
    out = []
    for f in frames:
        h, w = f.shape[:2]
        s = short / min(h, w)
        nh, nw = round(h * s), round(w * s)
        img = resize(f[..., :3], nh, nw)
        top, left = (nh - crop) // 2, (nw - crop) // 2
        arr = img[top:top + crop, left:left + crop].astype(np.float32) / 255.0
        out.append((arr - MEAN) / STD)
    return torch.from_numpy(np.stack(out)).permute(0, 3, 1, 2).contiguous()


def flow_schedule(steps: int, train_steps: int = 1000, shift: float = 3.0):
    """(timesteps (steps+1,), distances (steps,)) float32 of the shifted
    rectified-flow schedule the Euler sampler walks."""
    n = steps + 1
    sig = (np.linspace(1, train_steps, train_steps) / train_steps)[::-1]
    sig = shift * sig / (1 + (shift - 1) * sig)
    ts = np.linspace(sig[0] * train_steps, sig[-1] * train_steps, n) / train_steps
    ts = (shift * ts / (1 + (shift - 1) * ts) * train_steps).astype(np.float32)
    return ts, (ts[:-1] - ts[1:]) / train_steps


def guide(branches: torch.Tensor, scales) -> torch.Tensor:
    """v_0 + sum_i s_i (v_{i+1} - v_i) over the leading branch axis."""
    out = branches[0]
    for i, s in enumerate(scales):
        out = out + s * (branches[i + 1] - branches[i])
    return out


def vertex_features(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """(V, 6) float32: positions and unit area-weighted vertex normals."""
    v = vertices.astype(np.float64)
    tri = v[faces]
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    normals = np.zeros_like(v)
    for i in range(3):
        np.add.at(normals, faces[:, i], cross)
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-20)
    normals = normals.astype(np.float32)
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-12)
    return np.concatenate([vertices.astype(np.float32), normals], axis=1)
