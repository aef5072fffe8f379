"""The port's video-to-4D command line against the JAX package's.

Both ``run_actionmesh`` functions (the JAX one loaded from
``inference/video_to_animated_mesh.py`` by its path) run on the same
directory of image + mask PNG pairs, with ``tests/test_torch_pipeline.py``'s
tiny widths, the same (bridged) weights, the same Stage-0 latent and sphere
and the same Stage-I noise. Their per-frame GLBs, deformation arrays and
animated GLB must agree within 1e-5 (fp32; the slice alone agrees within
1e-5), and the preview frames, captured from each package's ``write_mp4``,
within 2 levels. The same tiny pipelines at float16 agree within
``FP16_TOL``.
"""

import importlib.util
import json
import re
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import actionmesh_tpu.pipeline as jpipeline_mod
import actionmesh_tpu.render.visualizer as jvis
import actionmesh_tpu_torch.pipeline as tpipeline_mod
import actionmesh_tpu_torch.render.visualizer as tvis
from actionmesh_tpu.io.mesh import Mesh as JMesh
from actionmesh_tpu.io.video_input import ActionMeshInput as JInput
from actionmesh_tpu.io.video_input import load_frames as jload_frames
from actionmesh_tpu.models.dinov2 import DinoV2Config as JDinoCfg
from actionmesh_tpu.models.image_encoder import ImageEncoder as JImageEncoder
from actionmesh_tpu.models.stage0 import make_uv_sphere as jsphere
from actionmesh_tpu_torch.inference import video_to_animated_mesh as cli
from actionmesh_tpu_torch.io.mesh import _read_accessor, load_glb
from actionmesh_tpu_torch.io.video_input import ActionMeshInput as TInput
from actionmesh_tpu_torch.models.dinov2 import DinoV2Config as TDinoCfg
from actionmesh_tpu_torch.models.image_encoder import ImageEncoder as TImageEncoder
from actionmesh_tpu_torch.models.stage0 import make_uv_sphere as tsphere
from actionmesh_tpu_torch.ops import flash_attention as tflash
from actionmesh_tpu_torch.utils.weights import params_from_jax
from tests.test_torch_pipeline import TINY_DINO, TINY_UPDATES, make_frames

REPO = Path(__file__).resolve().parent.parent
N = 16
# float16 on both sides (fp16 weights and activations, fp32 islands), sums
# in another order: the two tiny runs' vertices, in [-1, 1], measured
# 1.5e-4 apart on a CPU; 2e-3 is two fp16 ulps at 1.
FP16_TOL = 2e-3


def load_jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_video_to_animated_mesh", REPO / "inference" / "video_to_animated_mesh.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def noise(shape, batch_size, n_timesteps):
    return np.random.default_rng(2).standard_normal(
        (batch_size, n_timesteps) + tuple(shape)
    ).astype(np.float32)


def tiny_pipelines(mp, jdtype, tdtype):
    """Both tiny pipelines on the same weights, latent, sphere and noise."""
    compute = {jnp.float32: "float32", jnp.float16: "float16"}[jdtype]
    jpipe = jpipeline_mod.ActionMeshPipeline(
        config_name="actionmesh", weights_dir=None, dtype=jdtype,
        config_updates=dict(TINY_UPDATES, attn_impl="chunked", compute_dtype=compute),
    )
    jpipe.image_encoder = JImageEncoder(weights_dir=None, dtype=jdtype, config=JDinoCfg(**TINY_DINO))
    tpipe = tpipeline_mod.ActionMeshPipeline(
        config_name="actionmesh", weights_dir=None, device=torch.device("cpu"),
        dtype=tdtype, config_updates=dict(TINY_UPDATES),
    )
    tpipe.image_encoder = TImageEncoder(
        torch.device("cpu"), tdtype, TDinoCfg(**TINY_DINO),
        params=params_from_jax(jax.tree.map(np.asarray, jpipe.image_encoder.params)),
    )
    tpipe.denoiser_params = params_from_jax(jax.tree.map(np.asarray, jpipe.denoiser_params))
    tpipe.autoencoder_params = params_from_jax(jax.tree.map(np.asarray, jpipe.autoencoder_params))
    latent = np.random.default_rng(1).standard_normal((1, 16, 8)).astype(np.float32)
    jpipe.image_to_3d = lambda image, **_: (jnp.asarray(latent), jsphere(n_lat=8, n_lon=16))
    tpipe.image_to_3d = lambda image, **_: (torch.from_numpy(latent), tsphere(n_lat=8, n_lon=16))
    mp.setattr(jpipeline_mod, "get_noise", lambda key, shape, batch_size, n_timesteps, **_:
               jnp.asarray(noise(shape, batch_size, n_timesteps)))
    mp.setattr(tpipeline_mod, "get_noise", lambda gen, shape, batch_size, n_timesteps, **_:
               torch.from_numpy(noise(shape, batch_size, n_timesteps)))
    return jpipe, tpipe


def write_pairs(directory: Path) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    for i, frame in enumerate(make_frames(N)):
        Image.fromarray(frame[..., :3]).save(directory / f"{i:02d}_image.png")
        Image.fromarray(frame[..., 3]).save(directory / f"{i:02d}_mask.png")
    return directory


@pytest.fixture(scope="module")
def cli_outputs(tmp_path_factory):
    """Both CLIs' run_actionmesh on one directory; previews captured."""
    root = tmp_path_factory.mktemp("cli")
    frames_dir = write_pairs(root / "frames")
    previews = {}

    def capture(key):
        def write_mp4(frames, path, fps=8):
            previews[key] = [np.array(f) for f in frames]
            return Path(path)
        return write_mp4

    mp = pytest.MonkeyPatch()
    try:
        jpipe, tpipe = tiny_pipelines(mp, jnp.float32, torch.float32)
        mp.setattr(jvis, "write_mp4", capture("jax"))
        mp.setattr(tvis, "write_mp4", capture("port"))
        load_jax_cli().run_actionmesh(jpipe, input=str(frames_dir), output_dir=str(root / "jax"), seed=44)
        result = cli.run_actionmesh(tpipe, input=str(frames_dir), output_dir=str(root / "port"), seed=44)
        # the JAX visualizer on the port's meshes and the JAX loader's frames
        mp.setattr(jvis, "write_mp4", capture("jax_on_port_meshes"))
        jvis.ActionMeshVisualizer(image_size=256).render(
            [JMesh(m.vertices, m.faces) for m in result["meshes"]], output_dir=root / "jax_vis",
            input_frames=jload_frames(frames_dir, max_frames=31).frames,
        )
    finally:
        mp.undo()
    return root, previews, result


def test_per_frame_glbs_and_deformations_match_jax(cli_outputs):
    root, _, result = cli_outputs
    assert len(result["meshes"]) == N
    for i in range(N):
        t, j = load_glb(root / "port" / f"mesh_{i:02d}.glb"), load_glb(root / "jax" / f"mesh_{i:02d}.glb")
        np.testing.assert_array_equal(t.faces, j.faces)
        np.testing.assert_allclose(t.vertices, j.vertices, atol=1e-5)
    for part in ("vertices", "faces"):
        t = np.load(root / "port" / f"deformations_{part}.npy")
        j = np.load(root / "jax" / f"deformations_{part}.npy")
        assert t.shape == j.shape and t.dtype == j.dtype
        np.testing.assert_allclose(t, j, atol=1e-5)
    assert np.load(root / "port" / "deformations_vertices.npy").shape[0] == N


def read_glb(path: Path):
    raw = path.read_bytes()
    json_len, _ = struct.unpack_from("<II", raw, 12)
    gltf = json.loads(raw[20 : 20 + json_len])
    bin_len, _ = struct.unpack_from("<II", raw, 20 + json_len)
    return gltf, raw[28 + json_len : 28 + json_len + bin_len]


def test_animated_glb_matches_jax(cli_outputs):
    root = cli_outputs[0]
    (tg, tb), (jg, jb) = read_glb(root / "port" / "animated_mesh.glb"), read_glb(root / "jax" / "animated_mesh.glb")
    for key in ("scenes", "nodes", "meshes", "animations", "bufferViews"):
        assert tg[key] == jg[key]
    assert len(tg["meshes"][0]["primitives"][0]["targets"]) == N
    assert len(tg["accessors"]) == len(jg["accessors"])
    for i, (ta, ja) in enumerate(zip(tg["accessors"], jg["accessors"])):
        assert {k: v for k, v in ta.items() if k not in ("min", "max")} == \
               {k: v for k, v in ja.items() if k not in ("min", "max")}
        for k in ("min", "max"):
            if k in ja:
                np.testing.assert_allclose(ta[k], ja[k], atol=1e-5)
        np.testing.assert_allclose(_read_accessor(tg, tb, i).astype(np.float64),
                                   _read_accessor(jg, jb, i).astype(np.float64), atol=1e-5)


def test_preview_frames_match_jax(cli_outputs):
    """Rendered from the same meshes, the port's preview frames are within 2
    levels of the JAX visualizer's. Each CLI renders its own meshes, whose
    vertices are ~1e-7 apart: where an edge then crosses one of a pixel's 2x2
    sample centres, that pixel moves by a quarter of the color step (one
    pixel in 16 frames here), so end to end at most 1 pixel in 10^4 may be
    above 2 levels."""
    _, previews, result = cli_outputs
    assert result["preview"] is not None
    assert len(previews["port"]) == len(previews["jax"]) == len(previews["jax_on_port_meshes"]) == N
    above = 0
    for t, j, same in zip(previews["port"], previews["jax"], previews["jax_on_port_meshes"]):
        assert t.shape == j.shape == same.shape == (256, 4 * 256, 3)
        assert np.abs(t.astype(int) - same.astype(int)).max() <= 2
        above += int((np.abs(t.astype(int) - j.astype(int)).max(-1) > 2).sum())
    assert above <= N * 256 * 1024 // 10**4
    assert any((t[:, 256:] != 255).any() for t in previews["port"])


def test_float16_pipelines_agree():
    mp = pytest.MonkeyPatch()
    try:
        jpipe, tpipe = tiny_pipelines(mp, jnp.float16, torch.float16)
        frames, ts = make_frames(N), np.arange(N, dtype=np.float32)
        jm = jpipe(JInput(frames=[Image.fromarray(f) for f in frames], timesteps=ts), seed=44)
        tm = tpipe(TInput(frames=frames, timesteps=ts), seed=44)
    finally:
        mp.undo()
    assert len(tm) == len(jm) == N
    tv, jv = np.stack([m.vertices for m in tm]), np.stack([m.vertices for m in jm])
    assert np.isfinite(tv).all()
    np.testing.assert_allclose(tv, jv, atol=FP16_TOL)


def tiny_factory(monkeypatch):
    """The CLI's pipeline at tiny widths (its preset's values otherwise)."""
    real = cli.ActionMeshPipeline

    def make(config_name, weights_dir, device, dtype, lazy_loading, stage_0_model):
        pipe = real(config_name=config_name, weights_dir=None, device=device, dtype=dtype,
                    config_updates=dict(TINY_UPDATES), lazy_loading=lazy_loading,
                    stage_0_model=stage_0_model)
        pipe.image_encoder = TImageEncoder(device, dtype, TDinoCfg(**TINY_DINO))
        pipe.image_to_3d = lambda image, **_: (
            torch.from_numpy(np.random.default_rng(1).standard_normal((1, 16, 8)).astype(np.float32)),
            tsphere(n_lat=8, n_lon=16),
        )
        return pipe

    monkeypatch.setattr(cli, "ActionMeshPipeline", make)


def test_main_runs_on_the_cpu(monkeypatch, tmp_path):
    tiny_factory(monkeypatch)
    frames_dir = write_pairs(tmp_path / "frames")
    out = tmp_path / "out"
    result = cli.main(["--input", str(frames_dir), "--output_dir", str(out), "--device", "cpu",
                       "--turbo", "--dtype", "float32"])
    assert result["preset"] == "actionmesh_turbo"
    assert result["pipeline"].stage_0_model == "triposg"
    assert result["pipeline"].cfg.stage_0.guidance_scale == 0.0
    assert sorted(p.name for p in out.glob("mesh_*.glb")) == [f"mesh_{i:02d}.glb" for i in range(N)]
    for name in ("deformations_vertices.npy", "deformations_faces.npy", "animated_mesh.glb"):
        assert (out / name).is_file()
    assert result["preview"].is_file() and result["preview"].name.startswith("grid_normal")
    assert set(result["seconds"]) == {"load", "pipeline", "export", "render"}


def test_main_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=re.escape("CUDA is not available (use --device cpu)")):
        cli.main(["--input", str(tmp_path), "--output_dir", str(tmp_path / "out")])


@pytest.mark.parametrize("flags,preset", [
    ([], "actionmesh"),
    (["--fast"], "actionmesh_fast"),
    (["--low_ram"], "actionmesh_lowram"),
    (["--fast", "--low_ram"], "actionmesh_fast_lowram"),
    (["--distilled"], "actionmesh_distilled"),
    (["--distilled", "--fast", "--low_ram"], "actionmesh_distilled"),
    (["--distilled4"], "actionmesh_distilled4"),
    (["--distilled4", "--distilled"], "actionmesh_distilled4"),
    (["--distilled4", "--fast"], "actionmesh_distilled4_fast"),
    (["--turbo", "--distilled4", "--fast"], "actionmesh_turbo"),
])
def test_preset_precedence_as_the_jax_cli(flags, preset):
    """The JAX CLI's order: --turbo, --distilled4 --fast, --distilled4,
    --distilled, --fast --low_ram, --fast, --low_ram."""
    args = cli.build_parser().parse_args(["--input", "x", *flags])
    assert cli.preset_name(args) == preset


def test_kernel_a_dispatches_every_dtype_the_wrapper_takes():
    """Every dtype code of the wrapper (bf16 0, fp32 1, fp16 2) has a launch
    at both head dims in ``csrc/flash_fwd.cu``'s dispatch, so --dtype
    float16 reaches a kernel on the card instead of a refused launch."""
    assert tflash._DTYPE_CODES == {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
    source = (REPO / "actionmesh_tpu_torch" / "csrc" / "flash_fwd.cu").read_text()
    body = source[source.index("int launch(const Params& p"):]
    body = body[: body.index("\n}\n")]
    for code in tflash._DTYPE_CODES.values():
        for d in tflash._HEAD_DIMS:
            assert f"dtype == {code} && D == {d}) return launch" in body

