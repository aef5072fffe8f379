"""Mesh sequence I/O: per-frame GLBs and the deformation arrays.

Counterpart of ``actionmesh_tpu/io/mesh_io.py``. ``save_deformation`` applies
the same Blender-convention axis remap ([z, x, y] with x negated) and the
same topology checks.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np

from actionmesh_tpu_torch.io.mesh import Mesh, load_glb

__all__ = ["load_glb", "save_meshes", "save_deformation"]

logger = logging.getLogger(__name__)


def save_deformation(meshes: list[Mesh], path: str | Path) -> tuple[Path, Path]:
    """Save (T, V, 3) vertices + (F, 3) faces as npy (Blender axis order)."""
    if len(meshes) == 0:
        raise ValueError("Cannot save deformation from empty mesh list")

    n_verts = meshes[0].n_vertices
    reference_faces = meshes[0].faces
    for i, mesh in enumerate(meshes):
        if mesh.n_vertices != n_verts:
            raise ValueError(
                f"Mesh {i} has {mesh.n_vertices} vertices, expected {n_verts} "
                "(same as first mesh)"
            )
        if mesh.faces.shape != reference_faces.shape or not np.array_equal(
            mesh.faces, reference_faces
        ):
            raise ValueError(
                f"Mesh {i} has different face topology than the first mesh. "
                "All meshes must share the same faces for deformation export."
            )

    vertices = np.stack([mesh.vertices.astype(np.float32) for mesh in meshes], axis=0)
    vertices = vertices[:, :, [2, 0, 1]]
    vertices[:, :, 0] = -vertices[:, :, 0]

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    vertices_path = path.parent / f"{path.stem}_vertices.npy"
    faces_path = path.parent / f"{path.stem}_faces.npy"
    np.save(vertices_path, vertices)
    np.save(faces_path, reference_faces.astype(np.int32))
    return vertices_path, faces_path


def save_meshes(meshes: list[Mesh], output_dir: str | Path) -> None:
    """Save per-frame mesh_{i:02d}.glb files."""
    os.makedirs(output_dir, exist_ok=True)
    for i, mesh in enumerate(meshes):
        mesh.export(f"{output_dir}/mesh_{i:02d}.glb")
    logger.info("Saved %d meshes to %s", len(meshes), output_dir)
