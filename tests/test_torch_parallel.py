"""The port's device mesh (actionmesh_tpu_torch/parallel/) against JAX's.

One gloo world of four CPU ranks runs every case of the port
(``tests/torch_parallel_ranks.py``, spawned once for the file); the JAX
package runs the same cases sharded on the first four devices of its
8-device virtual CPU mesh (``tests/conftest.py``), on the same numpy inputs
and weights, for the layouts (dp 2, tp 2), (dp 2, sp 2), (dp 1, tp 2, sp 2)
and (dp 1, tp 1, sp 4). The cases: attention with a kv mask (its sp = 4 ring
sees a key shard that the mask empties for one row), the attention layer
with qk-norm and RoPE (kernel B on each rank's shard), a Stage-I denoise
window, the Stage-II decode (T_out and V that dp and sp do not divide),
Stage 0's sampler with and without guidance, and the tiny pipeline end to
end, with the {video + 3D} pipeline at (dp 2, tp 2). A second world of
two ranks drives the server's ``build_server`` under ``torchrun``'s
environment.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import actionmesh_tpu.pipeline as jpipeline_mod
import actionmesh_tpu.pipeline_with_3d as jp3d
from actionmesh_tpu.io.mesh import Mesh as JMesh
from actionmesh_tpu.io.video_input import ActionMeshInput as JInput
from actionmesh_tpu.models.autoencoder import AutoencoderConfig as JAECfg
from actionmesh_tpu.models.autoencoder import autoencoder_forward as jae_forward
from actionmesh_tpu.models.denoiser import DenoiserConfig as JDenCfg
from actionmesh_tpu.models.dinov2 import DinoV2Config as JDinoCfg
from actionmesh_tpu.models.image_encoder import ImageEncoder as JImageEncoder
from actionmesh_tpu.models.layers import attention as jattention_layer
from actionmesh_tpu.models.stage0 import make_uv_sphere as jsphere
from actionmesh_tpu.models.triposg.pipeline import TripoSGPipeline as JTripoSG
from actionmesh_tpu.models.triposg.pipeline import _flow_sample as jflow_sample
from actionmesh_tpu.models.triposg.vae import TripoSGVAEConfig as JVAECfg
from actionmesh_tpu.ops.attention import dot_product_attention as jattention
from actionmesh_tpu.parallel import mesh as jmesh
from actionmesh_tpu.sampling.denoise_loop import denoise_window as jdenoise_window
from actionmesh_tpu.sampling.flow_schedule import get_schedule as jget_schedule
from actionmesh_tpu.sampling.guidance import make_guidance as jmake_guidance
from actionmesh_tpu.utils.weights import load_params as jload_params
from actionmesh_tpu_torch import pipeline as tpipeline_mod
from actionmesh_tpu_torch.models.dinov2 import DinoV2Config as TDinoCfg
from actionmesh_tpu_torch.models.image_encoder import ImageEncoder as TImageEncoder
from actionmesh_tpu_torch.models.layers import init_attention
from actionmesh_tpu_torch.models.triposg import vae as tvae
from actionmesh_tpu_torch.ops.attention import chunked_attention, merge_partials
from actionmesh_tpu_torch.parallel.mesh import mesh_shape
from actionmesh_tpu_torch.utils.weights import params_to_jax
from tests.test_torch_pipeline import TINY_DINO, TINY_UPDATES, make_frames
from tests.test_torch_video_3d import TINY_VAE, jax_encode_draws
from tests.torch_parallel_ranks import LAYOUTS, World, cases_rank, server_rank

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

GUIDANCE = ([[0, 1], [1, 1]], [7.5])
PIPELINE_LAYOUTS = ("dp2_tp2",)  # where the JAX pipeline runs too (each layout ~8 s of compiles)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_pipeline(pl: dict, device_mesh):
    pipe = jpipeline_mod.ActionMeshPipeline(
        config_name="actionmesh", weights_dir=None, dtype=jnp.float32,
        config_updates=dict(pl["updates"], attn_impl="chunked", compute_dtype="float32"),
        device_mesh=device_mesh,
    )
    pipe.image_encoder = JImageEncoder(weights_dir=None, dtype=jnp.float32, config=JDinoCfg(**pl["dino_cfg"]))
    pipe.image_to_3d = lambda image, **_: (jnp.asarray(pl["latent"]), jsphere(n_lat=8, n_lon=16))
    return pipe


def _inputs(tmp_path):
    """Every case's numpy inputs. The weights are a tiny port pipeline's
    (its denoiser serves the denoise window and, at T = 1, Stage 0's
    sampler, as in JAX's test_parallel; its autoencoder Stage II), written
    as npz that both packages read; the DINOv2 weights are the JAX
    encoder's."""
    rng = np.random.default_rng(0)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    frames = make_frames(seed=5)
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    for i, f in enumerate(frames):
        Image.fromarray(f).save(frames_dir / f"{i:02d}.png")
    dino = _np_tree(JImageEncoder(weights_dir=None, dtype=jnp.float32, config=JDinoCfg(**TINY_DINO)).params)
    pl = {
        "updates": TINY_UPDATES, "dino_cfg": TINY_DINO, "dino": dino, "frames": frames,
        "timesteps": np.arange(16, dtype=np.float32), "weights_dir": str(tmp_path / "weights"),
        "latent": normal(1, 16, 8),
    }
    tpipe = tpipeline_mod.ActionMeshPipeline(
        config_name="actionmesh", weights_dir=None, device=torch.device("cpu"), dtype=torch.float32,
        config_updates=dict(TINY_UPDATES), image_to_3d=lambda image, **_: None,
        image_encoder=TImageEncoder(torch.device("cpu"), torch.float32, TDinoCfg(**TINY_DINO)),
    )
    tpipe.save_pretrained(pl["weights_dir"])
    dcfg, acfg = tpipe.denoiser_config, tpipe.autoencoder_config

    B, H, S, D = 2, 4, 64, 16
    # keys valid below 40 (row 0) and 10 (row 1): every sp = 4 shard of
    # row 1 past the first is empty, and sp = 2 splits at 32
    attn = {"q": normal(B, H, S, D), "k": normal(B, H, S, D), "v": normal(B, H, S, D),
            "mask": np.arange(S)[None] < np.array([[40], [10]])}
    # the attention layer with qk-norm (random scales) and RoPE: kernel B's path
    layer = params_to_jax(init_attention(torch.Generator().manual_seed(3), H * D, H, qk_norm=True, bias=True))
    layer["norm_q"]["scale"], layer["norm_k"]["scale"] = normal(D), normal(D)
    rope = {"params": layer, "heads": H, "x": normal(B, S, H * D), "cos": normal(B, S, D), "sin": normal(B, S, D)}
    anchor = jsphere(n_lat=6, n_lon=8)
    vae_cfg = tvae.TripoSGVAEConfig(**TINY_VAE)
    p3d = {"vae_cfg": TINY_VAE, "surface_samples": 512,
           "vae_params": params_to_jax(tvae.init_triposg_vae(torch.Generator().manual_seed(5), vae_cfg)),
           "anchor": (np.asarray(anchor.vertices) * 2.0 + 5.0, np.asarray(anchor.faces)),
           "draws": jax_encode_draws(3, 1, 512, tvae.presample_size(vae_cfg, 512),
                                     (1, vae_cfg.num_tokens, vae_cfg.latent_channels))}
    ts, dist = (np.asarray(x, np.float32) for x in jget_schedule(2, shift=3.0))
    denoise = {
        "cfg": dataclasses.asdict(dcfg), "guidance": GUIDANCE,
        "params": jload_params(Path(pl["weights_dir"]) / "denoiser.npz"),
        "init_latent": normal(1, 4, 16, dcfg.in_channels),
        "context": normal(1, 4, 5, dcfg.cross_attention_dim),
        "mask": np.array([[1, 0, 0, 0]], np.int32), "framestep": np.arange(4, dtype=np.float32)[None],
        "ts": ts, "dist": dist,
    }
    ae = {
        "cfg": dataclasses.asdict(acfg), "params": jload_params(Path(pl["weights_dir"]) / "autoencoder.npz"),
        "latent": normal(1, 4, 16, acfg.latent_channels), "framestep": np.arange(4, dtype=np.float32)[None],
        "sa": np.zeros(1, np.float32), "ta": np.linspace(0.2, 1.0, 3, dtype=np.float32)[None],
        "query": rng.uniform(-1, 1, (1, 37, 6)).astype(np.float32),
    }
    flow = {"noise": normal(1, 16, dcfg.in_channels), "context": normal(1, 5, dcfg.cross_attention_dim),
            "ts": ts, "dist": dist}
    return {"attn": attn, "rope": rope, "denoise": denoise, "ae": ae, "flow": flow, "p3d": p3d,
            "pipeline": pl, "frames_dir": str(frames_dir), "out_dir": str(tmp_path / "served")}


def _jax_cases(inputs: dict, monkeypatch) -> dict:
    """The JAX package's sharded functions on each layout's mesh, the
    layouts in threads (their compiles overlap)."""
    monkeypatch.setattr(jpipeline_mod, "get_noise", lambda key, shape, batch_size, n_timesteps, **_:
                        jnp.asarray(np.random.default_rng(2).standard_normal(
                            (batch_size, n_timesteps) + tuple(shape)).astype(np.float32)))
    with ThreadPoolExecutor(len(LAYOUTS) + 2 * len(PIPELINE_LAYOUTS)) as ex:
        pipelines = {name: ex.submit(_jax_pipeline_run, inputs["pipeline"], name)
                     for name in PIPELINE_LAYOUTS}
        pipelines_3d = {name: ex.submit(_jax_pipeline_3d_run, inputs["pipeline"], inputs["p3d"], name)
                        for name in PIPELINE_LAYOUTS}
        out = dict(zip(LAYOUTS, ex.map(lambda name: _jax_layout(inputs, name), LAYOUTS)))
        for name, future in pipelines.items():
            out[name]["pipeline"] = future.result()
            out[name]["pipeline_3d"] = pipelines_3d[name].result()
    return out


def _jax_pipeline_run(pl: dict, name: str):
    """The tiny JAX pipeline on layout ``name``'s mesh: (vertices, faces)."""
    pipe = _jax_pipeline(pl, jmesh.make_mesh(4, **LAYOUTS[name])).load_native(pl["weights_dir"])
    pipe.image_encoder.params = jax.tree.map(jnp.asarray, pl["dino"])
    frames = [Image.fromarray(f) for f in pl["frames"]]
    meshes = pipe(JInput(frames=frames, timesteps=pl["timesteps"].copy()), seed=44)
    return np.stack([m.vertices for m in meshes]), meshes[0].faces


def _jax_pipeline_3d_run(pl: dict, p3d: dict, name: str):
    """The tiny JAX {video + 3D} pipeline on layout ``name``'s mesh (JAX's
    tests/test_parallel.py case): its VAE a tiny TripoSG of ``p3d``'s
    weights; (vertices, faces)."""
    pipe = jp3d.ActionMeshPipelineWithMeshInput(
        config_name="actionmesh", weights_dir=None, dtype=jnp.float32,
        config_updates=dict(pl["updates"], attn_impl="chunked", compute_dtype="float32"),
        device_mesh=jmesh.make_mesh(4, **LAYOUTS[name]), surface_samples=p3d["surface_samples"],
    ).load_native(pl["weights_dir"])
    pipe.image_encoder = JImageEncoder(weights_dir=None, dtype=jnp.float32, config=JDinoCfg(**pl["dino_cfg"]))
    pipe.image_encoder.params = jax.tree.map(jnp.asarray, pl["dino"])
    pipe.vae = JTripoSG(None, jax.tree.map(jnp.asarray, p3d["vae_params"]), pipe.image_encoder,
                        vae_cfg=JVAECfg(**p3d["vae_cfg"]), dtype=jnp.float32, attn_impl="naive")
    frames = [Image.fromarray(f) for f in pl["frames"]]
    anchor = JMesh(vertices=p3d["anchor"][0].copy(), faces=p3d["anchor"][1].copy())
    meshes = pipe(JInput(frames=frames, timesteps=pl["timesteps"].copy()), anchor_mesh=anchor, seed=3)
    return np.stack([m.vertices for m in meshes]), meshes[0].faces


def _jax_layout(inputs: dict, name: str) -> dict:
    a, r, d, ae, fs = (inputs[k] for k in ("attn", "rope", "denoise", "ae", "flow"))
    dcfg, acfg = JDenCfg(**d["cfg"]), JAECfg(**ae["cfg"])
    mesh = jmesh.make_mesh(4, **LAYOUTS[name])
    res = {"mesh": mesh.devices.shape}
    res["attn"] = np.asarray(jattention(
        *(jnp.asarray(a[k]) for k in "qkv"), kv_mask=jnp.asarray(a["mask"]), impl="chunked", mesh=mesh))
    res["rope"] = np.asarray(jattention_layer(
        jax.tree.map(jnp.asarray, r["params"]), jnp.asarray(r["x"]), r["heads"],
        freqs_rot=(jnp.asarray(r["cos"]), jnp.asarray(r["sin"])), attn_impl="chunked", rope_layout="half",
        mesh=mesh))
    res["denoiser_spec"] = jmesh.denoiser_param_shardings(d["params"], mesh)
    sharded = jmesh.shard_params(d["params"], res["denoiser_spec"])
    res["denoise"] = np.asarray(jdenoise_window(
        sharded, dcfg, jmake_guidance(*GUIDANCE),
        *(jnp.asarray(d[k]) for k in ("init_latent", "context", "mask", "framestep", "ts", "dist")),
        attn_impl="chunked", mesh=mesh,
    ))
    res["autoencoder_spec"] = jmesh.autoencoder_param_shardings(ae["params"], mesh)
    res["ae"] = np.asarray(jae_forward(
        ae["params"], acfg, *(jnp.asarray(ae[k]) for k in ("latent", "framestep", "sa", "ta", "query")),
        attn_impl="chunked", mesh=mesh,
    ))
    for scale in (7.5, None):
        res[f"flow_{scale}"] = np.asarray(jflow_sample(
            sharded, dcfg, jnp.asarray(fs["noise"]), jnp.asarray(fs["context"]),
            jnp.asarray(fs["ts"]), jnp.asarray(fs["dist"]), guidance_scale=scale,
            attn_impl="chunked", mesh=mesh,
        ))
    return res


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(JAX results, the port's world-4 results, the world-2 server's); the
    port's worlds run while the JAX side compiles."""
    mp = pytest.MonkeyPatch()
    try:
        tmp = tmp_path_factory.mktemp("parallel")
        inputs = _inputs(tmp)
        port, served = World(cases_rank, 4, inputs, tmp), World(server_rank, 2, inputs, tmp)
        try:
            jax_out = _jax_cases(inputs, mp)
        except BaseException:
            port.kill()
            served.kill()
            raise
    finally:
        mp.undo()
    return jax_out, port.result(), served.result()


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_layout(worlds, layout):
    jax_out, port, _ = worlds
    names, shape = port[layout]["mesh"]
    assert shape == jax_out[layout]["mesh"]
    assert names == (("dp", "tp") if len(shape) == 2 else ("dp", "tp", "sp"))
    assert port["default_mesh"] == (("dp", "tp"), (2, 2))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_attention_and_ring_match_jax(worlds, layout):
    """The layers' call on each rank's shard (the ring where the sequence
    splits), gathered: fp32 within 1e-5 of max|ref| of JAX's whole-tensor
    ``dot_product_attention(mesh=)``; the sp = 4 ring merges a masked-out
    shard."""
    jax_out, port, _ = worlds
    assert _rel(port[layout]["attn"], jax_out[layout]["attn"]) < 1e-5


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_rms_rope_per_shard_matches_jax(worlds, layout):
    """Kernel B on each rank's shard, on the layers' path: the attention
    layer with qk rms-norm and half-layout RoPE run by the port on the
    rank's (batch, sequence) rows and heads, gathered, within 1e-5 of
    max|ref| of JAX's layer on whole tensors, which runs
    ``fused_rms_rope(mesh=)``."""
    jax_out, port, _ = worlds
    assert _rel(port[layout]["rope"], jax_out[layout]["rope"]) < 1e-5


def test_pipeline_with_3d_sharded_matches_jax(worlds):
    """The {video + 3D} pipeline at (dp 2, tp 2), its anchor encoded by a
    tiny TripoSG VAE with JAX's encode draws, against JAX's sharded run
    (JAX's tests/test_parallel.py case): the input's faces, vertices
    within 1e-5."""
    jax_out, port, _ = worlds
    (tv, tf), (jv, jf) = port["dp2_tp2"]["pipeline_3d"], jax_out["dp2_tp2"]["pipeline_3d"]
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
    assert np.abs(tv[1:] - tv[0]).max() > 0


@pytest.mark.parametrize("case", ["denoise", "ae", "flow_7.5", "flow_None"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_model_level_matches_jax(worlds, layout, case):
    """One denoise window, the Stage-II decode and Stage 0's sampler (CFG
    pair and guidance-free), fp32, within 2e-5 of max|ref| (ROADMAP's
    model-level bar is 5e-4)."""
    jax_out, port, _ = worlds
    assert _rel(port[layout][case], jax_out[layout][case]) < 2e-5


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_pipeline_sharded_matches_jax_and_unsharded(worlds, layout):
    """The tiny pipeline on the mesh: equal faces, vertices within 1e-5 of
    the port's unsharded run and, on the default (dp 2, tp 2) mesh, of the
    JAX package's sharded run."""
    jax_out, port, _ = worlds
    (tv, tf), (uv, uf) = port[layout]["pipeline"], port["pipeline_unsharded"]
    np.testing.assert_array_equal(tf, uf)
    np.testing.assert_allclose(tv, uv, rtol=0, atol=1e-5)
    if layout in PIPELINE_LAYOUTS:
        jv, jf = jax_out[layout]["pipeline"]
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-5)
    assert np.abs(tv[1:] - tv[0]).max() > 0


def _jax_spec_to_port(tree):
    """JAX's NamedSharding tree in the port's terms: kernel -> weight, the
    tp-split dim of each torch leaf (weight (out, in) is kernel (in, out))."""
    if isinstance(tree, dict):
        return {("weight" if k == "kernel" else k): (_leaf(v, k) if not isinstance(v, (dict, list))
                                                     else _jax_spec_to_port(v)) for k, v in tree.items()}
    return [_jax_spec_to_port(v) for v in tree]


def _leaf(sharding, key):
    spec = tuple(sharding.spec)
    if "tp" not in spec:
        return None
    if key == "kernel":
        return 0 if spec.index("tp") == 1 else 1
    return 0


@pytest.mark.parametrize("tree", ["denoiser_spec", "autoencoder_spec"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_param_shardings_cover_tree_as_jax(worlds, layout, tree):
    """Every leaf has a spec, the one JAX's tree gives (heads divide tp
    here, so no attention replicates)."""
    jax_out, port, _ = worlds
    assert port[layout][tree] == _jax_spec_to_port(jax_out[layout][tree])


@pytest.mark.parametrize("args", [
    (8,), (8, None, None, 2), (4,), (2,), (1,), (8, 1), (8, None, 2), (4, 2, 1, 2),
    (8, None, None, 3), (8, 3), (6, 4),
])
def test_mesh_shape_defaults_and_asserts_match_jax(args):
    try:
        want = jmesh.make_mesh(*args).devices.shape
    except AssertionError:
        with pytest.raises(AssertionError):
            mesh_shape(*args)
        return
    assert mesh_shape(*args) == want


def test_merge_partials_empty_and_inf_shards():
    """KV split in 4: the merge equals one call; a shard the mask empties
    weighs 0, a partial with l = 0 and m = -inf adds no NaN, and rows with
    every key masked give the unsharded mean of v."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, 24, 16, generator=g) for _ in range(3))
    mask = torch.arange(32)[None] < torch.tensor([[20], [0]])
    k, v = (torch.cat([x, torch.randn(2, 2, 8, 16, generator=g)], dim=2) for x in (k, v))
    ref = chunked_attention(q, k, v, kv_mask=mask)
    parts = [chunked_attention(q, k[:, :, s:s + 8], v[:, :, s:s + 8], kv_mask=mask[:, s:s + 8],
                               return_stats=True) for s in range(0, 32, 8)]
    torch.testing.assert_close(merge_partials(parts), ref, rtol=0, atol=1e-6)
    empty = (torch.zeros_like(q), (torch.full(q.shape[:3], float("-inf")), torch.zeros(q.shape[:3])))
    merged = merge_partials(parts + [empty])
    assert torch.isfinite(merged).all()
    torch.testing.assert_close(merged, ref, rtol=0, atol=1e-6)


def test_server_at_world_two(worlds):
    """``build_server`` under torchrun's environment, world 2 on gloo: rank
    0 serves, rank 1 runs the worker loop; /healthz says two devices,
    sharded; a request that raises on both ranks is a 500 and both go on;
    the next request's vertices are the unsharded pipeline's."""
    _, port, served = worlds
    assert served["health"] == {"status": "ok", "backend": "cpu", "n_devices": 2, "sharded": True,
                                "requests": 0}
    assert served["failed_status"] == 500
    assert served["health_after"]["requests"] == 1
    assert served["status"] == 200 and served["reply"]["n_frames"] == 16
    vertices = np.load(served["reply"]["artifacts"]["deformation_vertices"])
    unsharded = port["pipeline_unsharded"][0][:, :, [2, 0, 1]]  # save_deformation's axis order
    unsharded[:, :, 0] *= -1
    np.testing.assert_allclose(vertices, unsharded, rtol=0, atol=1e-5)


def test_concurrent_builds_compile_once(tmp_path, monkeypatch):
    """Ranks that reach a library first at once build it once: the build
    holds a file lock on its .so, and whoever waited loads what the first
    built (here two threads building the PNG reader's routine with g++)."""
    import subprocess
    import threading

    from actionmesh_tpu_torch.utils import cuda_build, native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    compiles = []
    real_run = subprocess.run

    def counting_run(cmd, *args, **kwargs):
        if "-o" in cmd:
            compiles.append(cmd)
        return real_run(cmd, *args, **kwargs)

    monkeypatch.setattr(native.subprocess, "run", counting_run)
    paths = []
    threads = [threading.Thread(target=lambda: paths.append(native.build(native.PNG_SOURCE, ())))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(compiles) == 1 and len(paths) == 2 and paths[0] == paths[1] and paths[0].exists()
