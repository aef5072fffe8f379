"""CLI: video (a folder of PNG frames) -> animated 3D mesh (4D).

    python -m actionmesh_tpu_torch.inference.video_to_animated_mesh --input DIR \
        [--output_dir OUT] [--fast | --low_ram | --distilled | --distilled4 | --turbo] \
        [--dtype bfloat16|float16|float32] [--device cuda|cpu] \
        [--stage_0_model triposg|hunyuan3d-2.1]

Counterpart of ``inference/video_to_animated_mesh.py`` with the same flags
and preset precedence (``--turbo``, then ``--distilled4 --fast``,
``--distilled4``, ``--distilled``, ``--fast --low_ram``, ``--fast``,
``--low_ram``), plus ``--device``, which defaults to cuda and raises
without a card, and ``--stage_0_model``, Stage 0's image-to-3D model
(TripoSG, the default, or Hunyuan3D-2.1's shape model). It writes ``mesh_XX.glb`` per frame,
``deformations_{vertices,faces}.npy``, ``animated_mesh.glb`` (Blender with
``--blender_path``, else the built-in morph-target writer) and, unless
``--no_render``, the preview ``grid_normal.mp4`` (or ``.gif``). Preview
rendering is best-effort, as in the JAX CLI: a failure is logged, not
raised. Input frames must be PNG (``io/video_input.py``); frames without a
valid alpha are matted by RMBG-1.4 from ``--weights_dir`` (they raise
without it). ``--weights_dir`` holds the checkpoint families
(``pipeline.py``); a missing one runs on random weights.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from actionmesh_tpu_torch.io.animated_glb import create_animated_glb_native
from actionmesh_tpu_torch.io.glb_export import create_animated_glb
from actionmesh_tpu_torch.io.mesh_io import save_deformation, save_meshes
from actionmesh_tpu_torch.io.video_input import load_frames
from actionmesh_tpu_torch.models.stage0 import STAGE0_MODELS
from actionmesh_tpu_torch.pipeline import ActionMeshPipeline

logger = logging.getLogger(__name__)

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def check_blender_available(blender_path: Optional[str] = None) -> bool:
    if blender_path is None:
        logger.info(
            "No Blender path provided — using the built-in morph-target GLB "
            "exporter (pass --blender_path for Draco-compressed export)."
        )
        return False
    if os.path.isfile(blender_path) and os.access(blender_path, os.X_OK):
        return True
    logger.warning(
        "Provided Blender path '%s' is not a valid executable; falling back "
        "to the built-in exporter.",
        blender_path,
    )
    return False


def run_actionmesh(
    pipeline: ActionMeshPipeline,
    input: str,
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
    """Load, run the pipeline, export, render. Returns the meshes, the
    preview's path (None if not rendered) and the seconds of each step
    (``load``, ``pipeline``, ``export``, ``render``)."""
    seconds = {}
    t0 = time.perf_counter()
    frames_input = load_frames(path=input, max_frames=31)
    seconds["load"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    meshes = pipeline(
        input=frames_input,
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
        create_animated_glb(
            blender_path=blender_path,
            vertices_npy=vertices_path,
            faces_npy=faces_path,
            output_glb=animated_glb_path,
            fps=fps,
        )
    else:
        create_animated_glb_native(
            vertices=np.load(vertices_path),
            faces=np.load(faces_path),
            output_glb=animated_glb_path,
            fps=fps,
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
    return {"meshes": meshes, "preview": preview, "seconds": seconds}


def preset_name(args: argparse.Namespace) -> str:
    """The preset the flags select, in the JAX CLI's order of precedence."""
    if args.turbo:
        if args.fast or args.low_ram or args.distilled or args.distilled4:
            logger.warning("--turbo overrides the other preset flags.")
        return "actionmesh_turbo"
    if args.distilled4 and args.fast:
        if args.low_ram or args.distilled:
            logger.warning("--distilled4 --fast overrides --low_ram/--distilled.")
        return "actionmesh_distilled4_fast"
    if args.distilled4:
        if args.low_ram or args.distilled:
            logger.warning("--distilled4 overrides --low_ram/--distilled.")
        return "actionmesh_distilled4"
    if args.distilled:
        if args.fast or args.low_ram:
            logger.warning("--distilled overrides --fast/--low_ram.")
        return "actionmesh_distilled"
    if args.fast and args.low_ram:
        return "actionmesh_fast_lowram"
    if args.fast:
        return "actionmesh_fast"
    if args.low_ram:
        return "actionmesh_lowram"
    return "actionmesh"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--input", type=str, required=True,
        help="Folder of PNG frames (or *_image.png + *_mask.png pairs), or a glob pattern.",
    )
    parser.add_argument(
        "--output_dir", type=str, default=None,
        help="Output directory. Default: outputs/<input_name>",
    )
    parser.add_argument("--seed", type=int, default=44)
    parser.add_argument("--blender_path", type=str, default=None)
    parser.add_argument("--fast", action="store_true", help="Fast preset (stage_0=50, stage_1=15).")
    parser.add_argument(
        "--low_ram", action="store_true",
        help="Low-RAM preset: runs the CFG guidance branches one after the other "
        "(split_cfg_batch). Weights stay on the device.",
    )
    parser.add_argument(
        "--distilled", action="store_true",
        help="Distilled preset (8 guidance-free Stage-I steps; for a distilled checkpoint).",
    )
    parser.add_argument(
        "--distilled4", action="store_true",
        help="Distilled-4 preset (4 guidance-free Stage-I steps; for a three-round "
        "distilled checkpoint).",
    )
    parser.add_argument(
        "--turbo", action="store_true",
        help="Turbo preset: 4-step guidance-free Stage I + 25-step guidance-free "
        "Stage 0 (for checkpoints distilled for both stages).",
    )
    parser.add_argument("--dtype", type=str, choices=list(DTYPES), default="bfloat16")
    parser.add_argument("--no_render", action="store_true")
    parser.add_argument("--stage_0_steps", type=int, default=None)
    parser.add_argument(
        "--stage_0_model", type=str, choices=list(STAGE0_MODELS), default="triposg",
        help="Stage 0's image-to-3D model (hunyuan3d-2.1: Hunyuan3D-2.1's shape model, "
        "its checkpoint under WEIGHTS_DIR/Hunyuan3D-2.1).",
    )
    parser.add_argument("--face_decimation", type=int, default=None)
    parser.add_argument("--floaters_threshold", type=float, default=None)
    parser.add_argument("--stage_1_steps", type=int, default=None)
    parser.add_argument("--guidance_scales", type=float, nargs="+", default=None)
    parser.add_argument("--anchor_idx", type=int, default=None)
    parser.add_argument(
        "--weights_dir", type=str, default="pretrained_weights",
        help="Directory with converted checkpoints (random weights if missing).",
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="cuda (the default; raises without a card) or cpu.",
    )
    return parser


def main(argv: Optional[list[str]] = None) -> dict:
    """Parse ``argv`` (the command line if None), build the pipeline and run
    it; returns ``run_actionmesh``'s result plus the preset's name and the
    pipeline (its ``phase_seconds``, its config)."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s - %(name)s - %(levelname)s - %(message)s"
    )
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available (use --device cpu)")
    config_name = preset_name(args)
    logger.info("Preset: %s", config_name)

    if args.output_dir is None:
        args.output_dir = f"outputs/{Path(args.input).stem}"
        logger.info("Output directory not specified, using: %s", args.output_dir)
    Path(args.output_dir).mkdir(parents=True, exist_ok=True)

    pipeline = ActionMeshPipeline(
        config_name=config_name,
        weights_dir=args.weights_dir,
        device=device,
        dtype=DTYPES[args.dtype],
        lazy_loading=args.low_ram,
        stage_0_model=args.stage_0_model,
    )
    result = run_actionmesh(
        pipeline,
        input=args.input,
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
