"""Triangle mesh container (host numpy).

The ``Mesh`` dataclass of ``actionmesh_tpu/io/mesh.py`` with the geometry
the pipeline needs; GLB input and output are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Mesh:
    """Triangle mesh: vertices (V, 3) float64, faces (F, 3) int64."""

    vertices: np.ndarray
    faces: np.ndarray

    def __post_init__(self):
        self.vertices = np.asarray(self.vertices, dtype=np.float64)
        self.faces = np.asarray(self.faces, dtype=np.int64)

    @property
    def n_vertices(self) -> int:
        return len(self.vertices)

    @property
    def n_faces(self) -> int:
        return len(self.faces)

    def face_normals_and_areas(self) -> tuple[np.ndarray, np.ndarray]:
        v, f = self.vertices, self.faces
        cross = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        double_area = np.linalg.norm(cross, axis=1)
        safe = np.maximum(double_area, 1e-20)[:, None]
        return cross / safe, 0.5 * double_area

    @property
    def vertex_normals(self) -> np.ndarray:
        """Area-weighted vertex normals (trimesh convention)."""
        face_normals, areas = self.face_normals_and_areas()
        weighted = face_normals * areas[:, None]
        normals = np.zeros_like(self.vertices)
        for i in range(3):
            np.add.at(normals, self.faces[:, i], weighted)
        norm = np.linalg.norm(normals, axis=1, keepdims=True)
        return normals / np.maximum(norm, 1e-20)

    @property
    def bounds(self) -> np.ndarray:
        """(2, 3): [min, max] corner."""
        return np.stack([self.vertices.min(axis=0), self.vertices.max(axis=0)])
