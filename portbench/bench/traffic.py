"""The one generator of every traffic mix: frames, and a mesh where the mix
has one, from a mix file's parameters and the run's seed.

A mix file (``traffic/<name>.json``) holds ``mode`` ("video": video -> 4D
through ``ActionMeshPipeline``; "video_mesh": {video + 3D} -> 4D through
``ActionMeshPipelineWithMeshInput``), ``frames``, ``frame_size`` (square
RGBA frames), ``subject`` (the silhouette: ``radius`` and ``travel`` as
shares of the frame, ``lobes``, ``stripes``), ``mesh`` (null, or the
closed lat-long surface: ``lat``, ``lon``, ``harmonics``, ``amplitude``)
and ``why``.

Every seed gives the same sizes: the same frame count and size, a
silhouette of the same area range and a mesh of the same vertex and face
counts; the seed moves the path, the shape's lobes, the colours and the
surface's bumps.
"""

from __future__ import annotations

import hashlib

import numpy as np


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose (``tag``) from the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def frames(mix: dict, seed: int) -> list[np.ndarray]:
    """(size, size, 4) uint8 frames of a moving, turning, striped blob whose
    alpha is its silhouette (antialiased over one pixel)."""
    rng = np.random.default_rng(derive(seed, "frames"))
    n, size = mix["frames"], mix["frame_size"]
    sub = mix["subject"]
    radius = sub["radius"] * size
    lobes = int(sub.get("lobes", 5))
    amps = rng.uniform(0.03, 0.08, size=lobes)
    phases = rng.uniform(0, 2 * np.pi, size=lobes)
    start = rng.uniform(-1, 1, size=2) * sub["travel"] * size / 2
    heading = rng.uniform(0, 2 * np.pi)
    step = np.array([np.cos(heading), np.sin(heading)]) * sub["travel"] * size / max(n - 1, 1)
    spin = rng.uniform(-0.15, 0.15)
    colours = rng.integers(30, 226, size=(2, 3))
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) + 0.5
    out = []
    for t in range(n):
        cx, cy = size / 2 + start + step * (t - (n - 1) / 2)
        dx, dy = xx - cx, yy - cy
        r = np.hypot(dx, dy)
        ang = np.arctan2(dy, dx) - spin * t
        edge = radius * (1 + sum(a * np.cos((k + 2) * ang + p)
                                 for k, (a, p) in enumerate(zip(amps, phases))))
        alpha = np.clip(edge - r + 0.5, 0.0, 1.0)
        stripe = (np.sin(sub.get("stripes", 6) * (ang + r / radius)) > 0)[..., None]
        rgb = np.where(stripe, colours[0], colours[1]) * (0.6 + 0.4 * (1 - r / (2 * radius)))[..., None]
        img = np.concatenate([np.clip(rgb, 0, 255), 255 * alpha[..., None]], -1)
        out.append(np.round(img).astype(np.uint8))
    return out


def mesh(mix: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """A closed genus-0 triangle mesh (vertices (V, 3) float32, faces (F, 3)
    int64): a lat-long sphere of ``lat`` rings by ``lon`` columns with two
    poles, radius bumped by a few seeded low-order harmonics.
    V = (lat - 1) * lon + 2, F = 2 * lon * (lat - 1)."""
    spec = mix["mesh"]
    rng = np.random.default_rng(derive(seed, "mesh"))
    n_lat, n_lon = spec["lat"], spec["lon"]
    theta = np.linspace(0, np.pi, n_lat + 1)[1:-1]
    phi = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    t, p = np.meshgrid(theta, phi, indexing="ij")
    t = np.concatenate([[0.0], t.ravel(), [np.pi]])
    p = np.concatenate([[0.0], p.ravel(), [0.0]])
    r = np.ones_like(t)
    for _ in range(spec["harmonics"]):
        m, k = rng.integers(1, 5, size=2)
        r += spec["amplitude"] * rng.uniform(-1, 1) * np.cos(m * p + rng.uniform(0, 6.3)) * np.sin(k * t)
    verts = np.stack([r * np.sin(t) * np.cos(p), r * np.sin(t) * np.sin(p), r * np.cos(t)], -1)
    verts = verts * np.array([1.0, 0.8, 1.2])
    j = np.arange(n_lon)
    jn = (j + 1) % n_lon
    faces = [np.stack([np.zeros(n_lon, np.int64), 1 + j, 1 + jn], 1)]
    for i in range(n_lat - 2):
        a, b = 1 + i * n_lon + j, 1 + i * n_lon + jn
        c, d = a + n_lon, b + n_lon
        faces.append(np.stack([np.stack([a, c, b], 1), np.stack([b, c, d], 1)], 1).reshape(-1, 3))
    last = len(verts) - 1
    ring = 1 + (n_lat - 2) * n_lon
    faces.append(np.stack([np.full(n_lon, last), ring + jn, ring + j], 1))
    return verts.astype(np.float32), np.concatenate(faces).astype(np.int64)
