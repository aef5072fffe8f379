"""Z-buffer mesh renderer for the preview (host numpy + the native rasterizer).

Counterpart of ``actionmesh_tpu/render/renderer.py``: the visibility pass is
``native/actionmesh_native.cpp:rasterize_zbuffer`` (pixel centres at +0.5,
perspective-correct barycentrics, faces behind the near plane culled);
shading is numpy on the winning samples:

- ``mode="normal"``: smooth vertex-normal shading mapped to RGB as the
  reference's ``soft_normal_shading`` (the normal transformed as a point with
  half the camera translation, normalised, (n + 1) / 2) on white; this is
  what ``grid_normal.mp4`` shows;
- ``mode="shaded"``: two-sided Phong (ambient + diffuse + specular) with
  interpolated normals;
- 2x supersampling with a 2x2 box downsample; ``return_alpha`` adds the
  coverage fraction as a fourth channel.

The JAX package falls back to a numpy bucket rasterizer when the native
library is missing; the port does not: a failed build raises.
"""

from __future__ import annotations

import numpy as np

from actionmesh_tpu_torch.io.mesh import Mesh
from actionmesh_tpu_torch.utils.native import rasterize_zbuffer

_NEAR = 1e-4  # camera-space near plane; mesh is unit-box, cameras at d=3


def vertex_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals, (V, 3) unit vectors."""
    v0, v1, v2 = (vertices[faces[:, i]] for i in range(3))
    fn = np.cross(v1 - v0, v2 - v0)  # length = 2*area -> area weighting
    vn = np.zeros_like(vertices)
    for i in range(3):
        np.add.at(vn, faces[:, i], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(norm, 1e-12)


class Renderer:
    def __init__(
        self,
        image_size: int = 256,
        supersample: int = 2,
        background: tuple[float, float, float] = (1.0, 1.0, 1.0),
        base_color: tuple[float, float, float] = (0.55, 0.65, 0.9),
        mode: str = "normal",
    ):
        if mode not in ("normal", "shaded"):
            raise ValueError(f"Renderer mode {mode!r}: 'normal' or 'shaded'")
        self.image_size = image_size
        self.supersample = max(1, int(supersample))
        self.background = np.asarray(background, np.float32)
        self.base_color = np.asarray(base_color, np.float32)
        self.mode = mode

    def render(self, mesh: Mesh, camera: dict, return_alpha: bool = False) -> np.ndarray:
        """Render one mesh with one camera -> (H, W, 3) uint8.

        With ``return_alpha=True`` returns (H, W, 4) uint8 whose alpha is the
        supersampled pixel-coverage fraction.
        """
        size = self.image_size * self.supersample
        R = np.asarray(camera["R"], np.float64)
        t = np.asarray(camera["t"], np.float64)
        focal = float(camera["focal"])

        cam_pts = mesh.vertices @ R.T + t  # (V, 3), z = view depth
        z = np.maximum(cam_pts[:, 2], _NEAR)
        px = (focal * cam_pts[:, 0] / z * 0.5 + 0.5) * size
        py = (0.5 - focal * cam_pts[:, 1] / z * 0.5) * size

        vn = vertex_normals(mesh.vertices, mesh.faces)

        img = np.tile(self.background, (size * size, 1)).astype(np.float32)
        alpha = np.zeros((size * size,), np.float32)
        win_fid, win_bary = rasterize_zbuffer(
            px.astype(np.float32), py.astype(np.float32), z, mesh.faces, size, near=_NEAR
        )
        covered = win_fid >= 0
        if covered.any():
            flat_idx = np.nonzero(covered)[0]
            bary, fid = win_bary[covered], win_fid[covered].astype(np.int64)

            # interpolate vertex normals at the winning samples
            n_tri = vn[mesh.faces[fid]]  # (M, 3, 3)
            n = np.einsum("mi,mij->mj", bary, n_tri)

            if self.mode == "normal":
                # the reference's soft_normal_shading: world->view transform of
                # the normal as a *point* with half the camera translation, then
                # normalise and map to [0, 1]
                n_view = n @ R.T + 0.5 * t
                n_view /= np.maximum(np.linalg.norm(n_view, axis=1, keepdims=True), 1e-12)
                color = (n_view + 1.0) * 0.5
            else:
                pos_tri = cam_pts[mesh.faces[fid]]
                pos = np.einsum("mi,mij->mj", bary, pos_tri)  # view space
                n_view = n @ R.T
                n_view /= np.maximum(np.linalg.norm(n_view, axis=1, keepdims=True), 1e-12)
                view_dir = -pos / np.maximum(np.linalg.norm(pos, axis=1, keepdims=True), 1e-12)
                # two-sided lighting: flip normals away from the camera
                facing = np.sign(np.sum(n_view * view_dir, axis=1, keepdims=True))
                n_view = n_view * np.where(facing == 0, 1.0, facing)
                light = np.array([0.3, 0.4, -0.85], np.float32)
                light /= np.linalg.norm(light)
                diffuse = np.clip(-(n_view @ light), 0.0, 1.0)[:, None]
                half = view_dir - light
                half /= np.maximum(np.linalg.norm(half, axis=1, keepdims=True), 1e-12)
                spec = np.clip(np.sum(n_view * half, axis=1), 0.0, 1.0) ** 32
                color = np.clip(
                    (0.30 + 0.65 * diffuse) * self.base_color + 0.25 * spec[:, None], 0.0, 1.0
                )
            img[flat_idx] = color
            alpha[flat_idx] = 1.0

        img = img.reshape(size, size, 3)
        alpha = alpha.reshape(size, size, 1)
        if self.supersample > 1:
            s, n_px = self.supersample, self.image_size
            img = img.reshape(n_px, s, n_px, s, 3).mean(axis=(1, 3))
            alpha = alpha.reshape(n_px, s, n_px, s, 1).mean(axis=(1, 3))
        if return_alpha:
            img = np.concatenate([img, alpha], axis=-1)
        return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
