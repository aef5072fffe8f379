"""The port's whole slice vs the JAX pipeline, plus bookkeeping checks.

The slice test runs both ``ActionMeshPipeline``s at tiny widths on CPU with
the same weights (JAX-initialised, bridged into the port), the same Stage-0
latent and sphere, and the same Stage-I noise (each module's ``get_noise``
is replaced in this test only: jax.random and torch.Generator cannot draw
the same bits).
"""

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import actionmesh_tpu.pipeline as jpipeline_mod
import actionmesh_tpu_torch.pipeline as tpipeline_mod
from actionmesh_tpu.config import load_config as jload_config
from actionmesh_tpu.io.video_input import ActionMeshInput as JInput
from actionmesh_tpu.models.dinov2 import DinoV2Config as JDinoCfg
from actionmesh_tpu.models.image_encoder import ImageEncoder as JImageEncoder
from actionmesh_tpu.models.stage0 import make_uv_sphere as jsphere
from actionmesh_tpu_torch.config import load_config as tload_config
from actionmesh_tpu_torch.io.video_input import ActionMeshInput as TInput
from actionmesh_tpu_torch.models.dinov2 import DinoV2Config as TDinoCfg
from actionmesh_tpu_torch.models.image_encoder import ImageEncoder as TImageEncoder
from actionmesh_tpu_torch.models.stage0 import make_uv_sphere as tsphere
from actionmesh_tpu_torch.ops.flash_attention import flash_attention
from actionmesh_tpu_torch.ops.rope_norm import fused_rms_rope
from actionmesh_tpu_torch.utils.weights import load_npz, params_from_jax

REPO = Path(__file__).resolve().parent.parent

# tests/test_pipeline.py's TINY_UPDATES, less the two JAX runtime keys
# (attn_impl, compute_dtype) the port has no use for.
TINY_UPDATES = {
    "temporal_3D_denoiser.num_tokens_nominal": 16,
    "temporal_3D_denoiser.width": 64,
    "temporal_3D_denoiser.num_layers": 3,
    "temporal_3D_denoiser.num_attention_heads": 2,
    "temporal_3D_denoiser.in_channels": 8,
    "temporal_3D_denoiser.cross_attention_dim": 32,
    "temporal_3D_denoiser.inflated_layers": [0, 1, 2],
    "temporal_3D_denoiser.temporal_context_size": 16,
    "temporal_3D_vae.latent_channels": 8,
    "temporal_3D_vae.width": 64,
    "temporal_3D_vae.num_layers": 2,
    "temporal_3D_vae.num_attention_heads": 2,
    "scheduler.num_inference_steps": 2,
}
TINY_DINO = dict(hidden_size=32, num_layers=2, num_heads=2, patch_size=14, image_size=70)


def make_frames(n=16, size=64, seed=0):
    """tests/test_pipeline.py's frames: a moving square on transparency."""
    rng = np.random.default_rng(seed)
    frames = []
    for i in range(n):
        rgba = np.zeros((size, size, 4), dtype=np.uint8)
        x = 8 + i
        rgba[16:48, x : x + 24, :3] = rng.integers(64, 255, size=3, dtype=np.uint8)
        rgba[16:48, x : x + 24, 3] = 255
        frames.append(rgba)
    return frames


@pytest.fixture(scope="module")
def slice_outputs():
    """Run both pipelines on the same inputs; return (jax meshes, port meshes)."""
    mp = pytest.MonkeyPatch()
    try:
        jpipe = jpipeline_mod.ActionMeshPipeline(
            config_name="actionmesh", weights_dir=None,
            config_updates=dict(TINY_UPDATES, attn_impl="chunked", compute_dtype="float32"),
            dtype=jnp.float32,
        )
        jpipe.image_encoder = JImageEncoder(
            weights_dir=None, dtype=jnp.float32, config=JDinoCfg(**TINY_DINO)
        )
        tpipe = tpipeline_mod.ActionMeshPipeline(
            config_name="actionmesh", weights_dir=None, device=torch.device("cpu"),
            dtype=torch.float32, config_updates=dict(TINY_UPDATES),
        )
        tpipe.image_encoder = TImageEncoder(
            torch.device("cpu"), torch.float32, TDinoCfg(**TINY_DINO),
            params=params_from_jax(jax.tree.map(np.asarray, jpipe.image_encoder.params)),
        )
        tpipe.denoiser_params = params_from_jax(jax.tree.map(np.asarray, jpipe.denoiser_params))
        tpipe.autoencoder_params = params_from_jax(jax.tree.map(np.asarray, jpipe.autoencoder_params))

        latent = np.random.default_rng(1).standard_normal((1, 16, 8)).astype(np.float32)
        jpipe.image_to_3d = lambda image, **_: (jnp.asarray(latent), jsphere(n_lat=8, n_lon=16))
        tpipe.image_to_3d = lambda image, **_: (torch.from_numpy(latent), tsphere(n_lat=8, n_lon=16))

        def noise(shape, batch_size, n_timesteps):
            return np.random.default_rng(2).standard_normal(
                (batch_size, n_timesteps) + tuple(shape)
            ).astype(np.float32)

        mp.setattr(jpipeline_mod, "get_noise", lambda key, shape, batch_size, n_timesteps, **_: jnp.asarray(noise(shape, batch_size, n_timesteps)))
        mp.setattr(tpipeline_mod, "get_noise", lambda gen, shape, batch_size, n_timesteps, **_: torch.from_numpy(noise(shape, batch_size, n_timesteps)))

        frames = make_frames()
        ts = np.arange(16, dtype=np.float32)
        flash_attention.launches = fused_rms_rope.launches = 0
        jmeshes = jpipe(JInput(frames=[Image.fromarray(f) for f in frames], timesteps=ts), seed=44)
        tmeshes = tpipe(TInput(frames=frames, timesteps=ts), seed=44)
        return jmeshes, tmeshes
    finally:
        mp.undo()


def test_slice_matches_jax_pipeline(slice_outputs):
    """16 frames, one AR window, 2 Stage-I steps, Stage II in 3 target chunks.

    Tolerance 1e-5 on vertex positions in [-1, 1] (measured 3.6e-7 on a
    CPU): fp32 throughout, sums in another order; the DINOv2 input resize
    agrees with PIL's to within one uint8 level (test_torch_ops.py).
    """
    jmeshes, tmeshes = slice_outputs
    assert len(tmeshes) == len(jmeshes) == 16
    for jm, tm in zip(jmeshes, tmeshes):
        np.testing.assert_array_equal(tm.faces, jm.faces)
        np.testing.assert_allclose(tm.vertices, jm.vertices, atol=1e-5)
    verts = np.stack([m.vertices for m in tmeshes])
    assert np.isfinite(verts).all() and verts.min() >= -1 and verts.max() <= 1
    assert np.abs(verts[1:] - verts[0]).max() > 0


def test_two_ar_windows_freeze_banked_frames(monkeypatch):
    """18 frames -> Stage-I windows [0..15] and [2..17]: the second window
    is conditioned on the 14 frames the first one banked, and keeps them
    bitwise frozen; Stage II then decodes all 18 frames."""
    from actionmesh_tpu_torch.utils import banks

    records = []
    orig_update = banks.LatentBank.update

    def spy(self, timesteps, latents):
        records.append((np.asarray(timesteps).reshape(-1).copy(), latents.clone()))
        return orig_update(self, timesteps, latents)

    monkeypatch.setattr(banks.LatentBank, "update", spy)
    pipe = tpipeline_mod.ActionMeshPipeline(
        device=torch.device("cpu"), dtype=torch.float32, config_updates=dict(TINY_UPDATES)
    )
    pipe.image_encoder = TImageEncoder(torch.device("cpu"), torch.float32, TDinoCfg(**TINY_DINO))
    meshes = pipe(TInput(frames=make_frames(18), timesteps=np.arange(18)), seed=5)
    assert len(meshes) == 18
    (ts1, lat1), (ts2, lat2) = [r for r in records if len(r[0]) == 16]
    assert list(ts1) == list(range(16)) and list(ts2) == list(range(2, 18))
    torch.testing.assert_close(lat2[0, :14], lat1[0, 2:], rtol=0, atol=0)


def test_profile_to_records_the_window_spans(tmp_path):
    """``profile_to`` around a tiny pipeline call on the CPU records JAX's
    spans, one per Stage-I and Stage-II window, in its events and in the
    Chrome trace it writes."""
    from actionmesh_tpu_torch.utils.profiling import profile_to

    pipe = tpipeline_mod.ActionMeshPipeline(
        device=torch.device("cpu"), dtype=torch.float32, config_updates=dict(TINY_UPDATES)
    )
    pipe.image_encoder = TImageEncoder(torch.device("cpu"), torch.float32, TDinoCfg(**TINY_DINO))
    with profile_to(tmp_path / "trace") as prof:
        pipe(TInput(frames=make_frames(), timesteps=np.arange(16)), seed=5)
    spans = {e.name for e in prof.events() if e.name.startswith(("stage1_window", "stage2_window"))}
    assert spans == {"stage1_window_0", "stage2_window_0"}
    (trace,) = (tmp_path / "trace").glob("trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert spans <= names


def test_launch_counters_stay_zero_on_cpu(slice_outputs):
    """On CPU tensors the wrappers run their plain versions, never a kernel."""
    assert flash_attention.launches == 0
    assert fused_rms_rope.launches == 0


def test_config_matches_jax_preset():
    """The port's preset equals the JAX ``load_config("actionmesh")`` on
    every field it keeps, the TripoSG decode knobs included; the fields it
    leaves out are exactly the TPU runtime knobs."""
    omitted = {
        "temporal_3D_denoiser.clear_autocast",
        "scheduler.steps_per_launch", "compute_dtype", "attn_impl",
    }

    def flat(d, prefix=""):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}."))
            else:
                out[f"{prefix}{k}"] = v
        return out

    port = flat(dataclasses.asdict(tload_config("actionmesh")))
    ref = flat(dataclasses.asdict(jload_config("actionmesh")))
    assert set(ref) - set(port) == omitted
    assert set(port) <= set(ref)
    assert port == {k: v for k, v in ref.items() if k in port}
    assert tload_config("actionmesh").temporal_3D_denoiser.gelu_approx is True
    assert tload_config("actionmesh").stage_0.prefilter_octree_depth == 6
    with pytest.raises(KeyError):
        tload_config("actionmesh", updates={"attn_impl": "flash"})


def test_npz_bridge_roundtrip(tmp_path):
    """An npz written by the JAX package (bf16 leaves as ::bf16 uint16)
    loads into the port bit for bit, kernels transposed; non-finite leaves,
    bf16 included, are refused."""
    from actionmesh_tpu.models.denoiser import DenoiserConfig, init_denoiser
    from actionmesh_tpu.utils.weights import save_params

    cfg = DenoiserConfig(num_tokens_nominal=8, in_channels=8, num_layers=3,
                         num_attention_heads=2, width=32, cross_attention_dim=16)
    params = init_denoiser(jax.random.PRNGKey(0), cfg, dtype=jnp.bfloat16)
    save_params(params, tmp_path / "denoiser.npz")
    loaded = load_npz(tmp_path / "denoiser.npz")
    direct = params_from_jax(jax.tree.map(np.asarray, params))

    w = loaded["blocks"][1]["s_attn"]["to_q"]["weight"]
    assert w.dtype == torch.bfloat16
    kernel = np.asarray(params["blocks"][1]["s_attn"]["to_q"]["kernel"].astype(jnp.float32))
    np.testing.assert_array_equal(w.float().numpy(), kernel.T)
    assert loaded["blocks"][0]["norm_s_attn"]["scale"].dtype == torch.float32
    flat_a = jax.tree.leaves(jax.tree.map(lambda t: t.float().numpy(), loaded))
    flat_b = jax.tree.leaves(jax.tree.map(lambda t: t.float().numpy(), direct))
    assert len(flat_a) == len(flat_b) == len(jax.tree.leaves(params))
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)

    params["proj_in"]["kernel"] = params["proj_in"]["kernel"].at[0, 0].set(jnp.inf)
    save_params(params, tmp_path / "bad.npz")
    with pytest.raises(ValueError, match="proj_in.kernel"):
        load_npz(tmp_path / "bad.npz")


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py and the checkpoint writer it
    imports, imports jax or the JAX package."""
    files = sorted((REPO / "actionmesh_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "synthetic_checkpoints.py"]
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "actionmesh_tpu", "flax"), f"{path}: {name}"


def test_port_runtime_dependencies():
    """The card's host is promised only torch, numpy, scipy and the standard
    library: no module of the port imports pandas, skimage, safetensors,
    transformers or huggingface_hub, at top level or inside a function (nor
    by name through importlib), and PIL, yaml, cv2 and imageio only lazily,
    each inside the one function that decodes or writes such a file: PIL in
    io/video_input.py's _read_rgba (JPEG, WebP), cv2 in its load_from_video,
    yaml in config.py's _load_yaml_preset (config_dir), imageio in
    render/utils.py's write_mp4. Nor do chip_smoke.py and the checkpoint
    writer it imports, which run on that host too, but for cv2 in the smoke
    run's write_video (the video its CLI phase decodes). The device mesh
    (parallel/) runs on torch.distributed alone: no module imports
    deepspeed, apex, megatron or fairscale, the parallel package's modules
    import only torch and the standard library, and importing it loads
    neither jax nor the JAX package."""
    banned = {"pandas", "skimage", "safetensors", "transformers", "huggingface_hub",
              "deepspeed", "apex", "megatron", "fairscale"}
    lazy = {
        "PIL": {("actionmesh_tpu_torch/io/video_input.py", "_read_rgba")},
        "cv2": {("actionmesh_tpu_torch/io/video_input.py", "load_from_video"),
                ("chip_smoke.py", "write_video")},
        "yaml": {("actionmesh_tpu_torch/config.py", "_load_yaml_preset")},
        "imageio": {("actionmesh_tpu_torch/render/utils.py", "write_mp4")},
    }
    port = REPO / "actionmesh_tpu_torch"
    files = sorted(port.rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "synthetic_checkpoints.py"]
    assert len(files) > 20
    for path in files:
        tree = ast.parse(path.read_text())
        writer = {}
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef):
                for node in ast.walk(fn):
                    writer.setdefault(id(node), fn.name)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            elif (isinstance(node, ast.Call) and node.args
                  and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
                  and getattr(node.func, "attr", getattr(node.func, "id", None))
                  in ("import_module", "__import__")):
                names = [node.args[0].value]
            for name in names:
                root = name.split(".")[0]
                assert root not in banned, f"{path}: imports {name}"
                if root in lazy:
                    where = (path.relative_to(REPO).as_posix(), writer.get(id(node)))
                    assert where in lazy[root], f"{path}: imports {name}"
                if path.parent == port / "parallel":
                    assert root in {"__future__", "math", "os", "typing", "torch"}, f"{path}: {name}"
    assert sorted(p.name for p in (port / "parallel").glob("*.py")) == ["__init__.py", "mesh.py"]
    loaded = subprocess.run(
        [sys.executable, "-c", "import sys, actionmesh_tpu_torch.parallel.mesh; "
         "print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'actionmesh_tpu'}))"],
        cwd=REPO, capture_output=True, text=True, check=True,
    )
    assert loaded.stdout.strip() == "[]", loaded.stdout + loaded.stderr
