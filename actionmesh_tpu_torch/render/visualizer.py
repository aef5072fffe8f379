"""Mesh-sequence visualizer: three orbit views beside the input frame.

Counterpart of ``actionmesh_tpu/render/visualizer.py``: each frame of the
preview is the input frame (composited on white, resized as PIL's bicubic
does) followed by the mesh from three orbit cameras, written to
``grid_normal.mp4`` (or ``grid_normal.gif``, ``render/utils.py:write_mp4``).
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from actionmesh_tpu_torch.io.mesh import Mesh
from actionmesh_tpu_torch.models.image_encoder import resize_bicubic
from actionmesh_tpu_torch.render.cameras import get_uniform_cameras
from actionmesh_tpu_torch.render.renderer import Renderer
from actionmesh_tpu_torch.render.utils import (
    composite_rgba_on_white,
    make_grid,
    resample_list,
    write_mp4,
)

logger = logging.getLogger(__name__)


class ActionMeshVisualizer:
    def __init__(self, image_size: int = 256, n_views: int = 3, fps: int = 8):
        self.image_size = image_size
        self.n_views = n_views
        self.fps = fps
        self.renderer = Renderer(image_size=image_size)

    def render(
        self,
        meshes: list[Mesh],
        output_dir: str | Path,
        input_frames: list[np.ndarray] | None = None,
    ) -> Path:
        """Render the sequence to {output_dir}/grid_normal.mp4 (or .gif);
        returns the path written."""
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        cameras = get_uniform_cameras(self.n_views)

        frame_imgs = None
        if input_frames is not None:
            frames = resample_list(input_frames, len(meshes))
            frame_imgs = [
                resize_bicubic(composite_rgba_on_white(f), self.image_size, self.image_size)
                for f in frames
            ]

        grid_frames = []
        for t, mesh in enumerate(meshes):
            views = [self.renderer.render(mesh, cam) for cam in cameras]
            if frame_imgs is not None:
                views = [frame_imgs[t]] + views
            grid_frames.append(make_grid(views, n_cols=len(views)))

        return write_mp4(grid_frames, output_dir / "grid_normal.mp4", fps=self.fps)
