"""Animated GLB writer: one glTF morph target per frame, no Blender.

Counterpart of ``actionmesh_tpu/io/animated_glb.py:create_animated_glb_native``
(the same bytes for the same arrays): morph targets hold each frame's
positions as deltas from frame 0, and the weights animation has one
keyframe per frame with that frame's target at weight 1 (an identity weight
matrix, linear interpolation). The Blender path is ``io/glb_export.py``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from actionmesh_tpu_torch.io.mesh import _pad4, write_glb


def create_animated_glb_native(
    vertices: np.ndarray,
    faces: np.ndarray,
    output_glb: str | Path,
    fps: int = 24,
) -> None:
    """Write an animated GLB with one morph target per frame.

    Args:
        vertices (T, V, 3): per-frame vertex positions (frame 0 = base).
        faces (F, 3): shared triangle indices.
        output_glb: destination path.
        fps: playback rate; frame i shows at time i/fps.
    """
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.uint32)
    T, V, _ = vertices.shape

    base = vertices[0]
    deltas = vertices - base[None]  # morph targets are deltas from base

    blobs: list[bytes] = []
    views: list[dict] = []
    accessors: list[dict] = []
    offset = 0

    def add_blob(data: np.ndarray, target=None) -> int:
        nonlocal offset
        raw = _pad4(np.ascontiguousarray(data).tobytes())
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(raw)}
        if target is not None:
            view["target"] = target
        views.append(view)
        blobs.append(raw)
        offset += len(raw)
        return len(views) - 1

    def add_accessor(view_idx, component, count, type_, mn=None, mx=None) -> int:
        acc = {
            "bufferView": view_idx,
            "componentType": component,
            "count": count,
            "type": type_,
        }
        if mn is not None:
            acc["min"] = mn
        if mx is not None:
            acc["max"] = mx
        accessors.append(acc)
        return len(accessors) - 1

    # base positions + indices
    pos_acc = add_accessor(
        add_blob(base, 34962), 5126, V, "VEC3",
        base.min(0).tolist(), base.max(0).tolist(),
    )
    idx_acc = add_accessor(add_blob(faces.reshape(-1), 34963), 5125, faces.size,
                           "SCALAR")

    # morph targets (positions deltas), one per frame
    target_accs = []
    for t in range(T):
        d = deltas[t]
        target_accs.append(
            add_accessor(
                add_blob(d, 34962), 5126, V, "VEC3",
                d.min(0).tolist(), d.max(0).tolist(),
            )
        )

    # animation: times + weight matrix (T keyframes x T targets): frame t
    # has weight 1 at time t and 0 at t ± 1, linear in between
    times = (np.arange(T, dtype=np.float32) / fps)
    weights = np.eye(T, dtype=np.float32).reshape(-1)
    time_acc = add_accessor(
        add_blob(times), 5126, T, "SCALAR",
        [float(times.min())], [float(times.max())],
    )
    weight_acc = add_accessor(add_blob(weights), 5126, T * T, "SCALAR")

    binary = _pad4(b"".join(blobs))
    gltf = {
        # the JAX package's generator name, so both packages write the same bytes
        "asset": {"version": "2.0", "generator": "actionmesh_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [
            {
                "primitives": [
                    {
                        "attributes": {"POSITION": pos_acc},
                        "indices": idx_acc,
                        "mode": 4,
                        "targets": [{"POSITION": a} for a in target_accs],
                    }
                ],
                "weights": [1.0] + [0.0] * (T - 1),
            }
        ],
        "animations": [
            {
                "samplers": [
                    {
                        "input": time_acc,
                        "interpolation": "LINEAR",
                        "output": weight_acc,
                    }
                ],
                "channels": [
                    {
                        "sampler": 0,
                        "target": {"node": 0, "path": "weights"},
                    }
                ],
            }
        ],
        "buffers": [{"byteLength": len(binary)}],
        "bufferViews": views,
        "accessors": accessors,
    }

    write_glb(output_glb, gltf, binary)
