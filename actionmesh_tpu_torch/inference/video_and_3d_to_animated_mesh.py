"""CLI: {video + 3D mesh} -> animated 3D mesh (4D), keeping the mesh's topology.

    python -m actionmesh_tpu_torch.inference.video_and_3d_to_animated_mesh \
        --input DIR --mesh_input MESH.glb [--output_dir OUT] [--fast] [--low_ram] \
        [--dtype bfloat16|float16|float32] [--weights_dir DIR] [--device cuda|cpu]

Counterpart of ``inference/video_and_3d_to_animated_mesh.py`` with the same
flags and presets (``--fast``, ``--low_ram``, both), plus ``--device``,
which defaults to cuda and raises without a card. It animates the .glb over
the frames (``pipeline_with_3d.py``) and writes ``mesh_XX.glb`` per frame
on the input's own faces, ``deformations_{vertices,faces}.npy``,
``animated_mesh.glb`` (Blender with ``--blender_path``, the anchor re-exported
for it; else the built-in morph-target writer) and, unless ``--no_render``,
the preview. Preview rendering is best-effort, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from actionmesh_tpu_torch.inference.video_to_animated_mesh import DTYPES, check_blender_available
from actionmesh_tpu_torch.io.animated_glb import create_animated_glb_native
from actionmesh_tpu_torch.io.glb_export import create_animated_glb
from actionmesh_tpu_torch.io.mesh import Mesh, load_glb, save_glb
from actionmesh_tpu_torch.io.mesh_io import save_deformation, save_meshes
from actionmesh_tpu_torch.io.video_input import load_frames
from actionmesh_tpu_torch.pipeline_with_3d import ActionMeshPipelineWithMeshInput

logger = logging.getLogger(__name__)


def run_actionmesh(
    pipeline: ActionMeshPipelineWithMeshInput,
    input: str,
    mesh_input: str,
    output_dir: str,
    seed: int,
    blender_path: Optional[str] = None,
    render: bool = True,
    fps: int = 8,
    stage_0_steps: Optional[int] = None,
    face_decimation: Optional[int] = None,
    floaters_threshold: Optional[float] = None,
    stage_1_steps: Optional[int] = None,
    guidance_scales: Optional[list[float]] = None,
    anchor_idx: Optional[int] = None,
) -> dict:
    """Load the frames and the mesh, run the pipeline, export, render.
    Returns the meshes, the input mesh, the preview's path (None if not
    rendered) and the seconds of each step (``load``, ``pipeline``,
    ``export``, ``render``)."""
    seconds = {}
    t0 = time.perf_counter()
    frames_input = load_frames(path=input, max_frames=31)
    anchor_mesh = load_glb(mesh_input)
    original_faces = anchor_mesh.faces.copy()
    seconds["load"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    meshes = pipeline(
        input=frames_input,
        anchor_mesh=anchor_mesh,
        seed=seed,
        stage_0_steps=stage_0_steps,
        face_decimation=face_decimation,
        floaters_threshold=floaters_threshold,
        stage_1_steps=stage_1_steps,
        guidance_scales=guidance_scales,
        anchor_idx=anchor_idx,
    )
    seconds["pipeline"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    save_meshes(meshes, output_dir=output_dir)
    vertices_path, faces_path = save_deformation(meshes, path=f"{output_dir}/deformations")
    animated_glb_path = f"{output_dir}/animated_mesh.glb"
    if check_blender_available(blender_path):
        # the textured anchor, re-exported for Blender to import
        anchor_for_export = Mesh(
            vertices=meshes[0].vertices, faces=original_faces, uv=anchor_mesh.uv,
            visual=anchor_mesh.visual,
        )
        with tempfile.NamedTemporaryFile(suffix=".glb", delete=False) as tmp:
            tmp_glb_path = tmp.name
        try:
            save_glb(anchor_for_export, tmp_glb_path)
            create_animated_glb(
                vertices_npy=str(vertices_path),
                faces_npy=str(faces_path),
                output_glb=animated_glb_path,
                blender_path=blender_path,
                fps=fps,
                input_glb=tmp_glb_path,
            )
        finally:
            os.remove(tmp_glb_path)
    else:
        create_animated_glb_native(
            vertices=np.load(vertices_path), faces=np.load(faces_path),
            output_glb=animated_glb_path, fps=fps,
        )
        logger.info("Animated GLB saved to %s", animated_glb_path)
    seconds["export"] = time.perf_counter() - t0

    preview = None
    if render:
        t0 = time.perf_counter()
        try:
            from actionmesh_tpu_torch.render.visualizer import ActionMeshVisualizer

            preview = ActionMeshVisualizer(image_size=256).render(
                meshes, input_frames=frames_input.frames, output_dir=output_dir
            )
        except Exception:  # rendering is best-effort, never fatal
            logger.exception("Preview rendering skipped")
        seconds["render"] = time.perf_counter() - t0
    return {"meshes": meshes, "anchor_mesh": anchor_mesh, "preview": preview, "seconds": seconds}


def preset_name(args: argparse.Namespace) -> str:
    """The preset the flags select, as the JAX CLI selects it."""
    if args.fast and args.low_ram:
        return "actionmesh_fast_lowram"
    if args.fast:
        return "actionmesh_fast"
    if args.low_ram:
        return "actionmesh_lowram"
    return "actionmesh"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input", type=str, required=True,
                        help="Folder of PNG frames (or *_image.png + *_mask.png pairs), or a glob pattern.")
    parser.add_argument("--mesh_input", type=str, required=True,
                        help="Path to the anchor .glb mesh to animate.")
    parser.add_argument("--output_dir", type=str, default=None,
                        help="Output directory. Default: outputs/<input_name>")
    parser.add_argument("--seed", type=int, default=44)
    parser.add_argument("--blender_path", type=str, default=None)
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--low_ram", action="store_true")
    parser.add_argument("--dtype", type=str, choices=list(DTYPES), default="bfloat16")
    parser.add_argument("--no_render", action="store_true")
    parser.add_argument("--stage_0_steps", type=int, default=None)
    parser.add_argument("--face_decimation", type=int, default=None)
    parser.add_argument("--floaters_threshold", type=float, default=None)
    parser.add_argument("--stage_1_steps", type=int, default=None)
    parser.add_argument("--guidance_scales", type=float, nargs="+", default=None)
    parser.add_argument("--anchor_idx", type=int, default=None)
    parser.add_argument("--weights_dir", type=str, default="pretrained_weights",
                        help="Directory of the checkpoint families (random weights where one is missing).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the default; raises without a card) or cpu.")
    return parser


def main(argv: Optional[list[str]] = None) -> dict:
    """Parse ``argv`` (the command line if None), build the pipeline and run
    it; returns ``run_actionmesh``'s result plus the preset's name and the
    pipeline."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s - %(name)s - %(levelname)s - %(message)s"
    )
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available (use --device cpu)")
    config_name = preset_name(args)
    if args.output_dir is None:
        args.output_dir = f"outputs/{Path(args.input).stem}"
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)

    pipeline = ActionMeshPipelineWithMeshInput(
        config_name=config_name,
        weights_dir=args.weights_dir,
        device=device,
        dtype=DTYPES[args.dtype],
        lazy_loading=args.low_ram,
    )
    result = run_actionmesh(
        pipeline,
        input=args.input,
        mesh_input=args.mesh_input,
        output_dir=args.output_dir,
        seed=args.seed,
        blender_path=args.blender_path,
        render=not args.no_render,
        stage_0_steps=args.stage_0_steps,
        face_decimation=args.face_decimation,
        floaters_threshold=args.floaters_threshold,
        stage_1_steps=args.stage_1_steps,
        guidance_scales=args.guidance_scales,
        anchor_idx=args.anchor_idx,
    )
    result.update(preset=config_name, pipeline=pipeline)
    return result


if __name__ == "__main__":
    main()
