"""Animated GLB export through a Blender subprocess (a dual-role file).

Counterpart of ``actionmesh_tpu/io/glb_export.py``, used only when the CLI
is given ``--blender_path``. On the host, ``create_animated_glb`` runs
``blender -b -P <this file> -- ...``; inside Blender, ``main()`` builds (or
imports) the mesh, adds one shape key per frame with triangular keyframe
weights and exports a Draco-compressed GLB. Without Blender the CLI writes
the animated GLB with ``io/animated_glb.py`` instead (no Draco).
"""

from __future__ import annotations

import argparse
import logging
import os
import subprocess
import sys

import numpy as np

logger = logging.getLogger(__name__)


def create_animated_glb(
    vertices_npy: str,
    faces_npy: str,
    output_glb: str,
    blender_path: str,
    fps: int = 24,
    export_normals: bool = False,
    input_glb: str | None = None,
) -> int:
    """Launch Blender to build the animated, Draco-compressed GLB.

    With ``input_glb`` set, the GLB is imported first (textures/materials
    preserved) and deformations apply as shape keys on top.
    Returns the Blender process exit code.
    """
    script_path = os.path.abspath(__file__)
    cmd = [
        blender_path, "-b", "-P", script_path, "--",
        "--vertices_npy", os.path.abspath(vertices_npy),
        "--faces_npy", os.path.abspath(faces_npy),
        "--output_glb", os.path.abspath(output_glb),
        "--fps", str(fps),
    ]
    if export_normals:
        cmd.append("--export_normals")
    if input_glb is not None:
        cmd.extend(["--input_glb", os.path.abspath(input_glb)])

    result = subprocess.run(
        cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL
    )
    if result.returncode == 0:
        logger.info("Animated GLB saved to %s", output_glb)
    else:
        logger.warning(
            "Failed to save animated GLB (Blender exit code: %d)",
            result.returncode,
        )
    return result.returncode


# ---------------------------------------------------------------------------
# Blender-side entry (runs inside `blender -b -P thisfile -- ...`)
# ---------------------------------------------------------------------------

def _parse_blender_args():
    parser = argparse.ArgumentParser(
        description="Blender shape-key animation builder"
    )
    parser.add_argument("--vertices_npy", type=str, required=True)
    parser.add_argument("--faces_npy", type=str, required=True)
    parser.add_argument("--output_glb", type=str, required=True)
    parser.add_argument("--fps", type=int, default=24)
    parser.add_argument("--export_normals", action="store_true")
    parser.add_argument("--input_glb", type=str, default=None)
    if "--" in sys.argv:
        return parser.parse_args(sys.argv[sys.argv.index("--") + 1 :])
    parser.print_help()
    sys.exit(1)


def _wipe_scene(bpy):
    """Remove every object from the default scene."""
    for o in list(bpy.data.objects):
        bpy.data.objects.remove(o, do_unlink=True)


def _mesh_from_arrays(bpy, verts: np.ndarray, faces: np.ndarray):
    """Build a mesh object from numpy arrays via from_pydata (vectorized).

    ``validate()`` drops degenerate/duplicate faces, replacing the
    try/except-per-face bmesh construction pattern.
    """
    mesh = bpy.data.meshes.new("actionmesh")
    mesh.from_pydata(
        verts.astype(np.float64).tolist(),
        [],
        faces.astype(np.int64).tolist(),
    )
    mesh.validate(verbose=False)
    mesh.update()
    obj = bpy.data.objects.new("actionmesh", mesh)
    bpy.context.collection.objects.link(obj)
    _attach_preview_material(bpy, obj)
    return obj


def _attach_preview_material(bpy, obj):
    """Simple principled material so untextured previews aren't flat grey."""
    mat = bpy.data.materials.new(name="actionmesh_preview")
    mat.use_nodes = True
    bsdf = mat.node_tree.nodes.get("Principled BSDF")
    if bsdf is not None:
        bsdf.inputs["Base Color"].default_value = (0.55, 0.65, 0.9, 1.0)
        bsdf.inputs["Roughness"].default_value = 0.5
    obj.data.materials.append(mat)


def _first_mesh_object(bpy):
    for o in bpy.context.scene.objects:
        if o.type == "MESH":
            return o
    return None


def _add_morph_animation(bpy, obj, vertices: np.ndarray, fps: int):
    """One shape key per frame, cross-faded with triangular weight ramps.

    Coordinates are written with ``foreach_set`` (flat float buffer) and the
    weight curves are authored directly as LINEAR fcurves: key i is 1.0 at
    frame i and 0.0 at frames i-1 / i+1, so consecutive frames blend
    linearly — matching the pure-Python writer in io/animated_glb.py.
    """
    n_frames, n_verts = vertices.shape[:2]
    obj.shape_key_add(name="rest")

    keys = []
    for i in range(n_frames):
        sk = obj.shape_key_add(name=f"frame_{i:03d}", from_mix=False)
        sk.data.foreach_set(
            "co", np.ascontiguousarray(vertices[i], np.float32).ravel()
        )
        keys.append(sk)

    shape_keys = obj.data.shape_keys
    shape_keys.animation_data_create()
    action = bpy.data.actions.new("morph_weights")
    shape_keys.animation_data.action = action

    for i, sk in enumerate(keys):
        ramp = [(i, 1.0)]
        if i > 0:
            ramp.insert(0, (i - 1, 0.0))
        if i < n_frames - 1:
            ramp.append((i + 1, 0.0))
        fc = action.fcurves.new(f'key_blocks["{sk.name}"].value')
        fc.keyframe_points.add(len(ramp))
        for kp, (frame, value) in zip(fc.keyframe_points, ramp):
            kp.co = (float(frame), value)
            kp.interpolation = "LINEAR"
        fc.update()

    scene = bpy.context.scene
    scene.frame_start = 0
    scene.frame_end = n_frames - 1
    scene.render.fps = fps


def main():
    """Blender-side entry: assemble the animated mesh and export GLB."""
    import bpy

    args = _parse_blender_args()
    vertices = np.load(args.vertices_npy)  # (T, V, 3)
    has_textures = args.input_glb is not None

    _wipe_scene(bpy)
    if has_textures:
        # Import the user's GLB so UVs/materials survive; deformations
        # apply as shape keys on top of its (merged-order) vertices.
        bpy.ops.import_scene.gltf(filepath=args.input_glb)
        obj = _first_mesh_object(bpy)
        if obj is None:
            sys.exit("input GLB contains no mesh")
        if len(obj.data.vertices) != vertices.shape[1]:
            sys.exit(
                f"vertex count mismatch: GLB has {len(obj.data.vertices)}, "
                f"deformation arrays have {vertices.shape[1]}"
            )
    else:
        obj = _mesh_from_arrays(bpy, vertices[0], np.load(args.faces_npy))

    bpy.context.view_layer.objects.active = obj
    obj.select_set(True)
    _add_morph_animation(bpy, obj, vertices, args.fps)

    # Export settings are the output contract (Draco level 6, 14-bit
    # positions — the reference repo's published GLB format).
    bpy.ops.export_scene.gltf(
        filepath=args.output_glb,
        export_format="GLB",
        export_texcoords=has_textures,
        export_materials="EXPORT",
        export_optimize_animation_size=True,
        export_normals=args.export_normals,
        export_tangents=False,
        export_morph_normal=False,
        export_morph_tangent=False,
        export_draco_mesh_compression_enable=True,
        export_draco_mesh_compression_level=6,
        export_draco_position_quantization=14,
        export_draco_normal_quantization=10,
    )


if __name__ == "__main__":
    main()
