"""The port's {video + 3D mesh} -> 4D mode against the JAX package's.

FPS, the TripoSG VAE encoder (deterministic route: FPS from index 0, no
presample, the posterior mean; seeded route: JAX's drawn presample, start
and noise handed to the port), the mesh helpers, the tiny
``ActionMeshPipelineWithMeshInput`` on the shared tiny
``pretrained_weights/`` tree, run once in each package through its command
line (the pipeline's own output and the files written from it are both
compared), each on the same inputs in both packages (fp32, CPU). jax.random
and torch.Generator cannot draw the same bits, so the port's three encode
draws are JAX's in the pipeline and CLI tests.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import actionmesh_tpu.pipeline_with_3d as jp3d
import actionmesh_tpu.preprocessing.mesh as jmesh_ops
import actionmesh_tpu_torch.inference.video_and_3d_to_animated_mesh as cli3d
import actionmesh_tpu_torch.models.triposg.pipeline as ttripo_mod
import actionmesh_tpu_torch.pipeline as tpipeline_mod
import actionmesh_tpu_torch.pipeline_with_3d as tp3d
import actionmesh_tpu_torch.preprocessing.mesh as tmesh_ops
from actionmesh_tpu.io.mesh import Mesh as JMesh
from actionmesh_tpu.io.mesh import load_glb as jload_glb
from actionmesh_tpu.models.triposg import vae as jvae
from actionmesh_tpu.ops.fps import farthest_point_sampling as jfps
from actionmesh_tpu_torch.io.mesh import Mesh as TMesh
from actionmesh_tpu_torch.io.mesh import _read_accessor, load_glb, save_textured_glb
from actionmesh_tpu_torch.models.stage0 import make_uv_sphere as tsphere
from actionmesh_tpu_torch.models.triposg import vae as tvae
from actionmesh_tpu_torch.ops.fps import farthest_point_sampling as tfps
from actionmesh_tpu_torch.ops.fps import sample_pc, sample_pc_grouped
from actionmesh_tpu_torch.utils.weights import params_to_jax
from tests.test_torch_checkpoints import build_pipelines, no_download, same_noise, tiny_dino
from tests.test_torch_cli import read_glb, write_pairs
from tests.torch_tiny_tree import tiny_tree  # noqa: F401  (a fixture)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
N = 16
TINY_VAE = dict(latent_channels=8, num_tokens=16, encoder_width=32, encoder_layers=2, encoder_heads=2,
                decoder_width=32, decoder_layers=2, decoder_heads=2)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# FPS and the VAE encoder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seeded", [False, True])
def test_fps_indices_equal_jax(seeded):
    """Same points, same start (index 0, or JAX's random start handed over):
    the same 64 picks of 500, in order."""
    pts = np.random.default_rng(1).uniform(-1, 1, (2, 500, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3) if seeded else None
    jsampled, jidx = jfps(jnp.asarray(pts), 64, key=key)
    start = torch.from_numpy(np.asarray(jax.random.randint(key, (2,), 0, 500))) if seeded else None
    tsampled, tidx = tfps(torch.from_numpy(pts), 64, start=start)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tsampled.numpy(), np.asarray(jsampled))
    assert len(set(tidx[0].tolist())) == 64


def test_sample_pc_dispatch():
    pts = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (6, 40, 3)).astype(np.float32))
    same, idx = sample_pc(pts, 64)  # more samples than points: identity
    assert same is pts and idx.shape == (6, 40)
    drawn = torch.randint(0, 40, (6, 5), generator=torch.Generator().manual_seed(0))
    out, idx = sample_pc(pts, 5, "random", indices=drawn)
    assert torch.equal(out, torch.take_along_dim(pts, drawn[..., None], dim=1))
    with pytest.raises(ValueError, match="drawn indices"):
        sample_pc(pts, 5, "random")
    grouped, gidx = sample_pc_grouped(pts, 8, n_grouped_frames=3)
    assert gidx.shape == (6, 8) and torch.equal(gidx[0], gidx[2]) and torch.equal(gidx[3], gidx[5])
    assert torch.equal(grouped[1], pts[1][gidx[1]])


@pytest.fixture(scope="module")
def vae():
    """(JAX tree, port tree, configs, a surface): one seeded port init,
    bridged to the JAX layout."""
    jcfg, tcfg = jvae.TripoSGVAEConfig(**TINY_VAE), tvae.TripoSGVAEConfig(**TINY_VAE)
    tparams = tvae.init_triposg_vae(torch.Generator().manual_seed(5), tcfg)
    jparams = jax.tree.map(jnp.asarray, params_to_jax(tparams))
    surface = np.random.default_rng(4).normal(size=(2, 128, 6)).astype(np.float32)
    surface[..., :3] = np.clip(surface[..., :3] * 0.4, -1, 1)
    return jparams, tparams, jcfg, tcfg, surface


def test_encode_moments_deterministic_route(vae):
    """FPS from index 0 over all points, no presample: mean and logvar
    within 1e-5 (fp32, sums in another order)."""
    jparams, tparams, jcfg, tcfg, surface = vae
    jmean, jlogvar = jvae.encode_moments(jparams, jcfg, jnp.asarray(surface), fps_key=None, attn_impl="naive")
    tmean, tlogvar = tvae.encode_moments(tparams, tcfg, torch.from_numpy(surface))
    assert tmean.shape == (2, 16, 8)
    np.testing.assert_allclose(_np(tmean), _np(jmean), atol=1e-5)
    np.testing.assert_allclose(_np(tlogvar), _np(jlogvar), atol=1e-5)
    out = tvae.encode_surface(tparams, tcfg, torch.from_numpy(surface))
    torch.testing.assert_close(out, tmean, rtol=0, atol=0)  # no noise: the mean


def jax_encode_draws(seed, batch, n_points, n_presample, latent_shape):
    """The draws of JAX's ``encode_to_latent(seed=...)`` (its key splits),
    in the layout of the port's ``encode_draws``."""
    fps_key, noise_key = jax.random.split(jax.random.PRNGKey(seed))
    pre_idx = None
    if n_presample < n_points:
        pre_key, fps_key = jax.random.split(fps_key)
        pre_idx = torch.from_numpy(np.asarray(jax.random.choice(pre_key, n_points, (n_presample,), replace=False)))
    start = torch.from_numpy(np.asarray(jax.random.randint(fps_key, (batch,), 0, n_presample)))
    noise = torch.from_numpy(np.array(jax.random.normal(noise_key, tuple(latent_shape), jnp.float32)))
    return {"pre_idx": pre_idx, "start": start, "noise": noise}


def test_encode_surface_seeded_route(vae):
    """JAX's drawn presample (64 of 128), FPS start and posterior noise,
    handed to the port: the sampled latents within 1e-5; the port's own
    draws give a different, deterministic latent."""
    jparams, tparams, jcfg, tcfg, surface = vae
    fps_key, noise_key = jax.random.split(jax.random.PRNGKey(11))
    ref = jvae.encode_surface(jparams, jcfg, jnp.asarray(surface), fps_key=fps_key, noise_key=noise_key,
                              attn_impl="naive")
    draws = jax_encode_draws(11, 2, 128, tvae.presample_size(tcfg, 128), (2, 16, 8))
    assert draws["pre_idx"].shape == (64,)
    out = tvae.encode_surface(tparams, tcfg, torch.from_numpy(surface), **draws)
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)
    pipe = ttripo_mod.TripoSGPipeline(None, tparams, None, vae_cfg=tcfg, dtype=torch.float32, device=CPU)
    a, b = pipe.encode_to_latent(surface, seed=11), pipe.encode_to_latent(surface, seed=11)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - out).abs().max() > 1e-3
    mean = pipe.encode_to_latent(surface)
    np.testing.assert_allclose(_np(mean), _np(jvae.encode_surface(jparams, jcfg, jnp.asarray(surface),
                                                                   attn_impl="naive")), atol=1e-5)


# ---------------------------------------------------------------------------
# The mesh helpers
# ---------------------------------------------------------------------------


def unwelded_anchor(seed=0) -> TMesh:
    """A UV sphere, off centre and unnormalised, with every face on its own
    three vertices (so merging has work) and a uv per vertex."""
    s = tsphere(n_lat=6, n_lon=8)
    v = s.vertices[s.faces].reshape(-1, 3) * 2.0 + 5.0
    uv = np.random.default_rng(seed).uniform(0, 1, (len(v), 2))
    return TMesh(vertices=v, faces=np.arange(len(v)).reshape(-1, 3), uv=uv)


def test_mesh_helpers_equal_jax():
    anchor = unwelded_anchor()
    janchor = JMesh(vertices=anchor.vertices, faces=anchor.faces, uv=anchor.uv)
    tm, tmap, tfaces = tmesh_ops.merge_and_clean_mesh(anchor)
    jm, jmap, jfaces = jmesh_ops.merge_and_clean_mesh(janchor)
    np.testing.assert_array_equal(tm.vertices, jm.vertices)
    np.testing.assert_array_equal(tm.faces, jm.faces)
    np.testing.assert_array_equal(tmap, jmap)
    np.testing.assert_array_equal(tfaces, jfaces)
    assert tm.n_vertices == 8 * 5 + 2 < anchor.n_vertices
    tn, tc, tf = tmesh_ops.normalize_mesh(tm)
    jn, jc, jf = jmesh_ops.normalize_mesh(jm)
    np.testing.assert_array_equal(tn.vertices, jn.vertices)
    assert (tf, list(tc)) == (jf, list(jc))
    np.testing.assert_array_equal(tmesh_ops.denormalize_mesh(tn, tc, tf).vertices,
                                  jmesh_ops.denormalize_mesh(jn, jc, jf).vertices)
    for normals in (True, False):
        np.testing.assert_array_equal(tmesh_ops.sample_surface(tn, 1000, seed=3, with_normals=normals),
                                      jmesh_ops.sample_surface(jn, 1000, seed=3, with_normals=normals))


# ---------------------------------------------------------------------------
# The pipeline and the command line
# ---------------------------------------------------------------------------


def load_jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_video_and_3d_to_animated_mesh", REPO / "inference" / "video_and_3d_to_animated_mesh.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tiny_tree):
    """Both 3D pipelines on the tiny tree (TripoSG's VAE encodes the mesh),
    each run once, through its CLI, on the same frames and .glb; JAX's
    pipeline output is caught on its way to the export."""
    root = tmp_path_factory.mktemp("p3d")
    weights, _ = tiny_tree
    anchor = unwelded_anchor()
    texture = np.random.default_rng(9).integers(0, 255, (8, 8, 3), dtype=np.uint8)
    save_textured_glb(anchor, root / "anchor.glb", texture)
    frames_dir = write_pairs(root / "frames")
    mp = pytest.MonkeyPatch()
    try:
        no_download(mp)
        tiny_dino(mp)
        same_noise(mp)
        mp.setattr(ttripo_mod, "encode_draws", jax_encode_draws)
        jpipe, tpipe = build_pipelines(weights, jp3d.ActionMeshPipelineWithMeshInput,
                                       tp3d.ActionMeshPipelineWithMeshInput)
        assert tpipe.vae is tpipe.image_to_3d and isinstance(tpipe.vae, ttripo_mod.TripoSGPipeline)
        caught = {}

        def jax_pipeline(**kw):
            caught["meshes"] = jpipe(**kw)
            return caught["meshes"]

        load_jax_cli().run_actionmesh(jax_pipeline, input=str(frames_dir), mesh_input=str(root / "anchor.glb"),
                                      output_dir=str(root / "jax"), seed=44, render=False)
        result = cli3d.run_actionmesh(tpipe, input=str(frames_dir), mesh_input=str(root / "anchor.glb"),
                                      output_dir=str(root / "port"), seed=44, render=False)
    finally:
        mp.undo()
    return root, anchor, caught["meshes"], result, dict(tpipe.stage0_seconds)


def test_pipeline_with_mesh_input_matches_jax(runs):
    """Vertices within 1e-5 (fp32); the faces are the input's pre-merge
    faces and the uv is kept, in both."""
    _, anchor, jm, result, stage0_seconds = runs
    tm = result["meshes"]
    assert len(tm) == len(jm) == N
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(b.faces, anchor.faces)
        np.testing.assert_array_equal(a.faces, anchor.faces)
        assert b.uv is result["anchor_mesh"].uv
        np.testing.assert_allclose(b.vertices, a.vertices, atol=1e-5)
    verts = np.stack([m.vertices for m in tm])
    assert np.isfinite(verts).all() and np.abs(verts[1:] - verts[0]).max() > 0
    # duplicated corners move together: the merge map re-expands one vertex
    np.testing.assert_array_equal(verts[:, 0], verts[:, np.flatnonzero(
        (anchor.vertices == anchor.vertices[0]).all(1))[-1]])
    assert set(stage0_seconds) == {"sample", "vae_encode"}


def test_cli_outputs_match_jax(runs):
    """Per-frame GLBs, deformation arrays and the animated GLB of both CLIs
    within 1e-5; the input .glb's uv and glTF payload reach the meshes."""
    root, anchor, _, result, _ = runs
    assert len(result["meshes"]) == N and result["preview"] is None
    assert set(result["seconds"]) == {"load", "pipeline", "export"}
    loaded = result["anchor_mesh"]
    np.testing.assert_allclose(loaded.uv, anchor.uv.astype(np.float32))
    assert loaded.visual["gltf"]["images"][0]["mimeType"] == "image/png"
    jl = jload_glb(root / "anchor.glb")
    np.testing.assert_array_equal(loaded.uv, jl.uv)
    assert loaded.visual["gltf"] == jl.visual["gltf"] and loaded.visual["binary"] == jl.visual["binary"]
    assert result["meshes"][0].visual is loaded.visual
    for i in range(N):
        t, j = load_glb(root / "port" / f"mesh_{i:02d}.glb"), load_glb(root / "jax" / f"mesh_{i:02d}.glb")
        np.testing.assert_array_equal(t.faces, anchor.faces)
        np.testing.assert_array_equal(t.faces, j.faces)
        np.testing.assert_allclose(t.vertices, j.vertices, atol=1e-5)
    for part in ("vertices", "faces"):
        t = np.load(root / "port" / f"deformations_{part}.npy")
        j = np.load(root / "jax" / f"deformations_{part}.npy")
        assert t.shape == j.shape and t.dtype == j.dtype
        np.testing.assert_allclose(t, j, atol=1e-5)
    (tg, tb), (jg, jb) = read_glb(root / "port" / "animated_mesh.glb"), read_glb(root / "jax" / "animated_mesh.glb")
    assert len(tg["meshes"][0]["primitives"][0]["targets"]) == N
    assert len(tg["accessors"]) == len(jg["accessors"])
    for i in range(len(jg["accessors"])):
        np.testing.assert_allclose(_read_accessor(tg, tb, i).astype(np.float64),
                                   _read_accessor(jg, jb, i).astype(np.float64), atol=1e-5)


def test_cli_main_flags_and_device(monkeypatch, tmp_path):
    parser = cli3d.build_parser()
    args = parser.parse_args(["--input", "x", "--mesh_input", "m.glb", "--fast", "--low_ram"])
    assert cli3d.preset_name(args) == "actionmesh_fast_lowram"
    assert (args.weights_dir, args.device, args.dtype, args.seed) == ("pretrained_weights", "cuda", "bfloat16", 44)
    assert cli3d.preset_name(parser.parse_args(["--input", "x", "--mesh_input", "m"])) == "actionmesh"
    jax_flags = {a.dest for a in load_jax_cli_parser()._actions}
    assert jax_flags | {"device"} == {a.dest for a in parser._actions}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=re.escape("CUDA is not available (use --device cpu)")):
        cli3d.main(["--input", str(tmp_path), "--mesh_input", "m.glb", "--output_dir", str(tmp_path / "o")])


def load_jax_cli_parser():
    """The JAX CLI's argparse parser, read from its ``main`` source (it
    builds the parser inside ``main``)."""
    import argparse
    import ast

    src = (REPO / "inference" / "video_and_3d_to_animated_mesh.py").read_text()
    parser = argparse.ArgumentParser()
    for node in ast.walk(ast.parse(src)):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument"):
            name = node.args[0].value
            kwargs = {k.arg: ast.literal_eval(k.value) for k in node.keywords
                      if k.arg in ("action", "default", "nargs")}
            parser.add_argument(name, **kwargs)
    return parser
