"""The port's checkpoint converters and loaders against the JAX package's.

At small widths the same synthetic state dict (the JAX suite's synthesizers
and torch transcriptions, or Hugging Face ``transformers`` itself for
DINOv2) goes through JAX's ``convert_*`` and the port's: every leaf must be
equal, bit for bit, in fp32 and in bf16 (the head-channel permutation of
q/k can only be wrong, never look wrong). The fail-fast cases raise as
JAX's do. A tiny ``pretrained_weights/`` tree of all four families is then
loaded by both ``ActionMeshPipeline``s: every family loads bit-equal, and
their meshes agree within 1e-5 (fp32, the same noise and Stage-0 anchor
handed to both).
"""

import dataclasses
import logging
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import actionmesh_tpu.models.image_encoder as jimage_encoder
import actionmesh_tpu.pipeline as jpipeline_mod
import actionmesh_tpu_torch.models.image_encoder as timage_encoder
import actionmesh_tpu_torch.models.triposg.pipeline as ttripo_mod
import actionmesh_tpu_torch.pipeline as tpipeline_mod
from actionmesh_tpu.io.mesh import Mesh as JMesh
from actionmesh_tpu.io.video_input import ActionMeshInput as JInput
from actionmesh_tpu.models.autoencoder import AutoencoderConfig as JAECfg
from actionmesh_tpu.models.denoiser import DenoiserConfig as JDenCfg
from actionmesh_tpu.models.dinov2 import DinoV2Config as JDinoCfg
from actionmesh_tpu.models.triposg.dit import triposg_dit_config as jdit_config
from actionmesh_tpu.models.triposg.pipeline import TripoSGPipeline as JTripo
from actionmesh_tpu.utils import weights as jw
from actionmesh_tpu_torch.io.video_input import ActionMeshInput as TInput
from actionmesh_tpu_torch.models.autoencoder import AutoencoderConfig as TAECfg
from actionmesh_tpu_torch.models.denoiser import DenoiserConfig as TDenCfg
from actionmesh_tpu_torch.models.dinov2 import DinoV2Config as TDinoCfg
from actionmesh_tpu_torch.models.triposg.dit import init_triposg_dit
from actionmesh_tpu_torch.models.triposg.dit import triposg_dit_config as tdit_config
from actionmesh_tpu_torch.models.triposg.pipeline import TripoSGPipeline as TTripo
from actionmesh_tpu_torch.models.triposg.vae import TripoSGVAEConfig as TVAECfg
from actionmesh_tpu_torch.models.triposg.vae import init_triposg_vae
from actionmesh_tpu_torch.models.dinov2 import init_dinov2
from actionmesh_tpu_torch.utils import weights as tw
from actionmesh_tpu_torch.utils.tree import named_leaves
from synthetic_checkpoints import reference_state_dict
from tests.test_checkpoint_dryrun import synth_autoencoder_state, synth_denoiser_state
from tests.test_torch_pipeline import TINY_DINO, TINY_UPDATES, make_frames
from tests.torch_tiny_tree import tiny_tree  # noqa: F401  (a fixture)

CPU = torch.device("cpu")
DENOISER = dict(num_tokens_nominal=8, temporal_context_size=4, in_channels=8, num_layers=3,
                num_attention_heads=2, width=32, mlp_ratio=2.0, cross_attention_dim=16)
AUTOENCODER = dict(temporal_context_size=4, latent_channels=8, width=32, num_layers=2,
                   num_attention_heads=2)
DIT = dict(num_tokens=16, in_channels=8, num_layers=3, width=64, num_attention_heads=2,
           cross_attention_dim=32)
TINY_DECODE = dict(dense_octree_depth=4, hierarchical_octree_depth=5)
STAGE0_UPDATES = {"stage_0.num_inference_steps": 2, "stage_0.prefilter_octree_depth": 3}
JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def leaf_bits(x):
    """(bits, dtype name) of a JAX or torch leaf; bf16 as its uint16 patterns."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), str(x.dtype).removeprefix("torch.")
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


def assert_trees_bit_equal(jtree, ttree) -> int:
    """Same keys, dtypes, shapes and bits at every leaf; returns the count."""
    jl, tl = dict(named_leaves(jtree)), dict(named_leaves(ttree))
    assert jl.keys() == tl.keys(), sorted(set(jl) ^ set(tl))
    for name in jl:
        a, da = leaf_bits(jl[name])
        b, db = leaf_bits(tl[name])
        assert (da, a.shape) == (db, b.shape), (name, da, db, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)
    return len(jl)


# ---------------------------------------------------------------------------
# The converters, leaf for leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_denoiser_converter_bit_equal(dtype):
    state = synth_denoiser_state(JDenCfg(**DENOISER))
    jtree = jw.convert_denoiser(state, JDenCfg(**DENOISER), dtype=JAX_DTYPES[dtype])
    ttree = tw.convert_denoiser(state, TDenCfg(**DENOISER), dtype=dtype)
    assert assert_trees_bit_equal(jtree, ttree) == 86
    # the permuted q columns are not the checkpoint's order
    q = state["blocks.0.s_attn.to_q.weight"].T
    assert not np.array_equal(leaf_bits(ttree["blocks"][0]["s_attn"]["to_q"]["kernel"])[0],
                              leaf_bits(torch.from_numpy(q).to(dtype))[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autoencoder_converter_bit_equal(dtype):
    state = synth_autoencoder_state(JAECfg(**AUTOENCODER))
    jtree = jw.convert_autoencoder(state, JAECfg(**AUTOENCODER), dtype=JAX_DTYPES[dtype])
    ttree = tw.convert_autoencoder(state, TAECfg(**AUTOENCODER), dtype=dtype)
    assert_trees_bit_equal(jtree, ttree)
    # the fp32 island: the final cross block and the query/output heads
    assert ttree["blocks"][-1]["x_attn"]["to_q"]["kernel"].dtype == torch.float32
    assert ttree["proj_out"]["kernel"].dtype == torch.float32
    assert ttree["blocks"][0]["s_attn"]["to_q"]["kernel"].dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_triposg_dit_converter_bit_equal(dtype):
    state = synth_denoiser_state(jdit_config(**DIT))
    jtree = jw.convert_triposg_dit(state, jdit_config(**DIT), dtype=JAX_DTYPES[dtype])
    ttree = tw.convert_triposg_dit(state, tdit_config(**DIT), dtype=dtype)
    assert_trees_bit_equal(jtree, ttree)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_triposg_vae_converter_bit_equal(dtype):
    from tests.test_triposg_parity import CFG, RefVAE

    torch.manual_seed(0)
    state = {k: v.detach().numpy() for k, v in RefVAE(CFG).state_dict().items()}
    jtree = jw.convert_triposg_vae(state, CFG, dtype=JAX_DTYPES[dtype])
    ttree = tw.convert_triposg_vae(state, TVAECfg(**dataclasses.asdict(CFG)), dtype=dtype)
    assert_trees_bit_equal(jtree, ttree)
    assert ttree["dec_cross_attn"]["to_q"]["kernel"].dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dinov2_converter_bit_equal(dtype):
    """A DINOv2 state dict under Hugging Face's names (the port's exporter
    writes them; ``test_dinov2_names_are_transformers`` holds them against
    ``transformers`` itself), converted by both."""
    gen = torch.Generator().manual_seed(1)
    state = {k: v.numpy() for k, v in
             reference_state_dict("dinov2", init_dinov2(gen, TDinoCfg(**TINY_DINO))).items()}
    jtree = jw.convert_dinov2(state, JDinoCfg(**TINY_DINO), dtype=JAX_DTYPES[dtype])
    ttree = tw.convert_dinov2(state, TDinoCfg(**TINY_DINO), dtype=dtype)
    assert_trees_bit_equal(jtree, ttree)
    assert ttree["patch_embed"]["kernel"].shape == (14, 14, 3, 32)  # HWIO


def test_dinov2_names_are_transformers():
    """Hugging Face's own Dinov2Model (a third party's names, as the JAX
    dry-run uses it): its state dict converts bit-equal in both packages,
    and the port's exporter gives exactly its names and shapes."""
    os.environ.setdefault("USE_TF", "0")  # transformers without TensorFlow: a faster import
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.Dinov2Config(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128,
        patch_size=14, image_size=70, layerscale_value=1e-5,
    )
    torch.manual_seed(1)
    state = {k: v.detach().numpy() for k, v in transformers.Dinov2Model(hf_cfg).state_dict().items()}
    jtree = jw.convert_dinov2(state, JDinoCfg(**TINY_DINO), dtype=jnp.float32)
    ttree = tw.convert_dinov2(state, TDinoCfg(**TINY_DINO), dtype=torch.float32)
    assert_trees_bit_equal(jtree, ttree)
    exported = reference_state_dict("dinov2", init_dinov2(torch.Generator(), TDinoCfg(**TINY_DINO)))
    assert {k: tuple(v.shape) for k, v in exported.items()} == {k: v.shape for k, v in state.items()}


def test_fp16_checkpoint_converts_bit_equal():
    """TripoSG ships fp16: fp16 leaves round to bf16 as JAX rounds them,
    and the fp32 islands widen exactly."""
    state = {k: v.astype(np.float16) for k, v in synth_denoiser_state(jdit_config(**DIT)).items()}
    jtree = jw.convert_triposg_dit(state, jdit_config(**DIT), dtype=jnp.bfloat16)
    ttree = tw.convert_triposg_dit(state, tdit_config(**DIT), dtype=torch.bfloat16)
    assert_trees_bit_equal(jtree, ttree)


@pytest.mark.parametrize("family,dtype", [
    ("denoiser", torch.bfloat16), ("autoencoder", torch.float32), ("triposg_dit", torch.float32),
    ("triposg_vae", torch.bfloat16), ("dinov2", torch.float32),
])
def test_exporter_round_trips_through_jax_converters(family, dtype):
    """``reference_state_dict`` of a port tree, converted by the JAX
    package's converter and bridged, gives the tree back bit for bit (the
    RoPE permutation undone and redone)."""
    gen = torch.Generator().manual_seed(4)
    if family == "denoiser":
        cfg, jcfg = TDenCfg(**DENOISER), JDenCfg(**DENOISER)
        from actionmesh_tpu_torch.models.denoiser import init_denoiser as init
        params, heads, convert = init(gen, cfg, dtype), cfg.num_attention_heads, jw.convert_denoiser
    elif family == "autoencoder":
        cfg, jcfg = TAECfg(**AUTOENCODER), JAECfg(**AUTOENCODER)
        from actionmesh_tpu_torch.models.autoencoder import init_autoencoder as init
        params, heads, convert = init(gen, cfg, dtype), cfg.num_attention_heads, jw.convert_autoencoder
    elif family == "triposg_dit":
        cfg, jcfg = tdit_config(**DIT), jdit_config(**DIT)
        params, heads, convert = init_triposg_dit(gen, cfg, dtype), 0, jw.convert_triposg_dit
    elif family == "triposg_vae":
        from tests.test_triposg_parity import CFG as jcfg

        cfg = TVAECfg(**dataclasses.asdict(jcfg))
        params, heads, convert = init_triposg_vae(gen, cfg, dtype), 0, jw.convert_triposg_vae
    else:
        cfg, jcfg = TDinoCfg(**TINY_DINO), JDinoCfg(**TINY_DINO)
        params, heads, convert = init_dinov2(gen, cfg, dtype), 0, jw.convert_dinov2
    state = {k: leaf_bits(v)[0].view(jnp.bfloat16) if v.dtype == torch.bfloat16 else v.numpy()
             for k, v in reference_state_dict(family, params, heads).items()}
    jtree = convert(state, jcfg, dtype=JAX_DTYPES[dtype])
    back = tw.params_from_jax(jax.tree.map(np.asarray, jtree))
    assert_trees_bit_equal(back, params)


# ---------------------------------------------------------------------------
# Fail fast
# ---------------------------------------------------------------------------


def test_wrong_mlp_ratio_raises_structural_report():
    state = synth_denoiser_state(JDenCfg(**DENOISER))
    wrong = dict(DENOISER, mlp_ratio=4.0)
    with pytest.raises(ValueError, match="does not match the configured"):
        jw.convert_denoiser(state, JDenCfg(**wrong), dtype=jnp.float32)
    with pytest.raises(ValueError, match="does not match the configured") as err:
        tw.convert_denoiser(state, TDenCfg(**wrong), dtype=torch.float32)
    assert "blocks[0].ff.net_0.kernel: checkpoint shape (32, 64), model expects (32, 128)" in str(err.value)


def test_fewer_layers_than_checkpoint_raises():
    state = synth_denoiser_state(JDenCfg(**dict(DENOISER, num_layers=5)))
    for convert, cfg in ((jw.convert_denoiser, JDenCfg), (tw.convert_denoiser, TDenCfg)):
        with pytest.raises((ValueError, KeyError)):
            convert(state, cfg(**dict(DENOISER, num_layers=3)))


def test_wrong_layer_count_raises():
    state = synth_autoencoder_state(JAECfg(**AUTOENCODER))
    for convert, cfg in ((jw.convert_autoencoder, JAECfg), (tw.convert_autoencoder, TAECfg)):
        with pytest.raises((ValueError, KeyError)):
            convert(state, cfg(**dict(AUTOENCODER, num_layers=1)))


def test_missing_key_reports_the_checkpoint_structure():
    state = synth_denoiser_state(JDenCfg(**DENOISER))
    del state["blocks.1.ff.net.2.weight"]
    with pytest.raises(KeyError, match="blocks.1.ff.net.2.weight") as err:
        tw.convert_denoiser(state, TDenCfg(**DENOISER))
    assert "key families" in str(err.value)
    with pytest.raises(KeyError):
        jw.convert_denoiser(state, JDenCfg(**DENOISER))


def test_fused_qkv_checkpoint_is_diagnosed():
    state = synth_denoiser_state(JDenCfg(**DENOISER))
    for n in ("q", "k", "v"):
        del state[f"blocks.0.s_attn.to_{n}.weight"]
    state["blocks.0.s_attn.qkv.weight"] = np.zeros((96, 32), np.float32)
    for convert, cfg in ((jw.convert_denoiser, JDenCfg), (tw.convert_denoiser, TDenCfg)):
        with pytest.raises(ValueError, match="FUSED qkv"):
            convert(state, cfg(**DENOISER))


def test_triposg_unknown_config_key_raises(tmp_path):
    (tmp_path / "transformer").mkdir()
    (tmp_path / "transformer" / "config.json").write_text('{"width": 64, "mystery_knob": 3}')
    with pytest.raises(ValueError, match="mystery_knob"):
        JTripo.from_pretrained(tmp_path)
    with pytest.raises(ValueError, match="mystery_knob"):
        TTripo.from_pretrained(tmp_path, device=CPU)


def test_triposg_meta_keys_are_ignored(tmp_path):
    """Metadata keys pass the check; the load then fails at the missing weights."""
    (tmp_path / "transformer").mkdir()
    (tmp_path / "transformer" / "config.json").write_text(
        '{"_class_name": "TripoSGDiTModel", "_diffusers_version": "0.30", "width": 64}'
    )
    with pytest.raises(FileNotFoundError):
        JTripo.from_pretrained(tmp_path)
    with pytest.raises(FileNotFoundError):
        TTripo.from_pretrained(tmp_path, device=CPU)


# ---------------------------------------------------------------------------
# A tiny pretrained_weights/ tree through both pipelines
# ---------------------------------------------------------------------------


def no_download(mp):
    """The JAX pipeline fetches a missing family from the Hub: here every
    family is on disk, and a fetch would fail the test instead of reaching
    for the network."""
    import actionmesh_tpu.utils

    def refuse(repo_id, local_dir):
        raise AssertionError(f"the JAX pipeline would download {repo_id} into {local_dir}")

    mp.setattr(actionmesh_tpu.utils, "download_if_missing",
               lambda repo_id, local_dir: local_dir if any(Path(local_dir).iterdir()) else refuse(repo_id, local_dir))


def tiny_dino(mp):
    """Both ImageEncoders' default DINOv2 config is the tiny one (the
    pipelines build them with the default)."""
    mp.setattr(jimage_encoder, "DinoV2Config", lambda: JDinoCfg(**TINY_DINO))
    mp.setattr(timage_encoder, "DinoV2Config", lambda: TDinoCfg(**TINY_DINO))


def stage1_noise(shape, batch_size, n_timesteps):
    return np.random.default_rng(2).standard_normal((batch_size, n_timesteps) + tuple(shape)).astype(np.float32)


def same_noise(mp):
    """The Stage-I noise of both, and JAX's Stage-0 noise handed to the port."""
    mp.setattr(jpipeline_mod, "get_noise", lambda key, shape, batch_size, n_timesteps, **_:
               jnp.asarray(stage1_noise(shape, batch_size, n_timesteps)))
    mp.setattr(tpipeline_mod, "get_noise", lambda gen, shape, batch_size, n_timesteps, **_:
               torch.from_numpy(stage1_noise(shape, batch_size, n_timesteps)))
    mp.setattr(ttripo_mod, "initial_noise", lambda seed, shape, dtype, device: torch.from_numpy(
        np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))).to(device, dtype))


def build_pipelines(root, jcls, tcls, **kw):
    """Both pipelines on the tree, fp32, Stage 0 cut to 2 steps and a
    depth-3/4/5 extraction."""
    jpipe = jcls(config_name="actionmesh", weights_dir=root, dtype=jnp.float32,
                 config_updates=dict(TINY_UPDATES, **STAGE0_UPDATES, attn_impl="chunked",
                                     compute_dtype="float32"), **kw)
    tpipe = tcls(config_name="actionmesh", weights_dir=root, device=CPU, dtype=torch.float32,
                 config_updates=dict(TINY_UPDATES, **STAGE0_UPDATES), **kw)
    return jpipe, tpipe


@pytest.fixture(scope="module")
def tree_outputs(tiny_tree):
    """Both pipelines built on the tree, then run on 16 frames.

    Stage 0 runs once, on the port's TripoSG as loaded from the tree (2 CFG
    steps, dense 4 / fine 5 / prefilter 3), and both pipelines get its
    (latent, mesh): the JAX package's CPU extraction alone takes ~45 s, and
    the two TripoSGs load bit-equal weights (``test_pretrained_tree_loads_
    the_same_weights``), their sampler and extraction being held against
    each other in ``test_torch_triposg.py``.
    """
    root, _ = tiny_tree
    mp = pytest.MonkeyPatch()
    try:
        no_download(mp)
        tiny_dino(mp)
        same_noise(mp)
        jpipe, tpipe = build_pipelines(root, jpipeline_mod.ActionMeshPipeline,
                                       tpipeline_mod.ActionMeshPipeline)
        assert isinstance(tpipe.image_to_3d, TTripo) and isinstance(jpipe.image_to_3d, JTripo)
        tripo = {"jax": jpipe.image_to_3d, "port": tpipe.image_to_3d}
        frames = make_frames()
        ts = np.arange(16, dtype=np.float32)
        anchor = {}

        def port_stage0(image, **kw):
            if not anchor:
                anchor["latent"], anchor["mesh"] = tripo["port"](image, **kw, **TINY_DECODE)
            return anchor["latent"], anchor["mesh"]

        tpipe.image_to_3d = port_stage0
        tm = tpipe(TInput(frames=frames, timesteps=ts), seed=44)
        jpipe.image_to_3d = lambda image, **_: (jnp.asarray(anchor["latent"].numpy()), JMesh(
            vertices=anchor["mesh"].vertices, faces=anchor["mesh"].faces))
        jm = jpipe(JInput(frames=[Image.fromarray(f) for f in frames], timesteps=ts), seed=44)
        return jm, tm, jpipe, tpipe, tripo, anchor
    finally:
        mp.undo()


def test_pretrained_tree_pipeline_matches_jax(tree_outputs):
    """16 frames, Stage I and II on ActionMesh's checkpoint, DINOv2's, the
    anchor from TripoSG's: vertices within 1e-5, faces equal (fp32, the same
    noise). The shaped SDF gives Stage 0 a sphere of radius ~0.55."""
    jm, tm, *_, anchor = tree_outputs
    assert len(tm) == len(jm) == 16
    assert anchor["mesh"].n_faces > 100 and anchor["latent"].shape == (1, 16, 8)
    radius = np.linalg.norm(anchor["mesh"].vertices, axis=1)
    assert 0.45 < radius.min() and radius.max() < 0.65
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(b.faces, a.faces)
        np.testing.assert_allclose(b.vertices, a.vertices, atol=1e-5)
    verts = np.stack([m.vertices for m in tm])
    assert np.isfinite(verts).all() and np.abs(verts[1:] - verts[0]).max() > 0


def test_pretrained_tree_loads_the_same_weights(tiny_tree, tree_outputs):
    """Every family loads bit-equal in both packages; the ActionMesh weights
    are the development weights the tree was written from; DINOv2 is shared
    by Stage 0."""
    _, dev = tiny_tree
    _, _, jpipe, tpipe, tripo, _ = tree_outputs

    def bridged(tree):
        return tw.params_from_jax(jax.tree.map(np.asarray, tree))

    assert_trees_bit_equal(tpipe.denoiser_params, dev.denoiser_params)
    assert_trees_bit_equal(tpipe.autoencoder_params, dev.autoencoder_params)
    assert_trees_bit_equal(bridged(jpipe.denoiser_params), tpipe.denoiser_params)
    assert_trees_bit_equal(bridged(jpipe.autoencoder_params), tpipe.autoencoder_params)
    assert_trees_bit_equal(bridged(jpipe.image_encoder.params), tpipe.image_encoder.params)
    assert_trees_bit_equal(bridged(tripo["jax"].dit_params), tripo["port"].dit_params)
    assert_trees_bit_equal(bridged(tripo["jax"].vae_params), tripo["port"].vae_params)
    assert tripo["port"].image_encoder is tpipe.image_encoder
    assert tripo["port"].dit_cfg == tdit_config(**DIT)
    assert (tripo["port"].vae_cfg.decoder_width, tripo["port"].vae_cfg.encoder_layers) == (32, 2)
    assert tpipe.image_encoder.config == TDinoCfg(**TINY_DINO)
    rmbg = {k: v for k, v in named_leaves(jpipe.background_removal._model.params)}
    for name, w in named_leaves(tpipe.background_removal._model.params):
        ref = rmbg[name[: -len("weight")] + "kernel"] if name.endswith("weight") else rmbg[name]
        ref = np.asarray(ref).transpose(3, 2, 0, 1) if name.endswith("weight") else np.asarray(ref)
        np.testing.assert_array_equal(w.numpy(), ref, err_msg=name)


def test_missing_family_is_development_mode(tiny_tree, tmp_path, caplog):
    """A family whose directory is absent runs on random weights, with the
    JAX package's warning; the missing ones are logged."""
    root, _ = tiny_tree
    partial = tmp_path / "weights"
    (partial / "ActionMesh").mkdir(parents=True)
    for sub in ("denoiser", "autoencoder"):
        (partial / "ActionMesh" / sub).symlink_to(root / "ActionMesh" / sub)
    with caplog.at_level(logging.WARNING):
        pipe = tpipeline_mod.ActionMeshPipeline(weights_dir=partial, device=CPU, dtype=torch.float32,
                                                config_updates=dict(TINY_UPDATES))
    text = caplog.text
    assert "TripoSG (VAST-AI/TripoSG)" in text and "RMBG (briaai/RMBG-1.4)" in text
    assert "dinov2 (facebook/dinov2-large)" in text and "ActionMesh (" not in text
    assert "DINOv2 weights not found" in text
    assert pipe.background_removal._model is None
    with pytest.raises(RuntimeError, match="RMBG-1.4 weights"):
        pipe.background_removal.process_images([f[..., :3] for f in make_frames()])


def test_malformed_checkpoint_raises(tiny_tree, tmp_path):
    """A family present but malformed raises with the state-dict report; it
    never falls back to random weights."""
    root, _ = tiny_tree
    from actionmesh_tpu_torch.utils.safetensors import load_file, save_file

    bad = tmp_path / "weights"
    (bad / "ActionMesh" / "autoencoder").mkdir(parents=True)
    (bad / "ActionMesh" / "autoencoder").rmdir()
    (bad / "ActionMesh" / "autoencoder").symlink_to(root / "ActionMesh" / "autoencoder")
    den = bad / "ActionMesh" / "denoiser"
    den.mkdir()
    state = load_file(root / "ActionMesh" / "denoiser" / "model.safetensors")
    del state["blocks.2.x_attn.to_k.weight"]
    save_file(state, den / "model.safetensors")
    with pytest.raises(KeyError, match="blocks.2.x_attn.to_k.weight"):
        tpipeline_mod.ActionMeshPipeline(weights_dir=bad, device=CPU, dtype=torch.float32,
                                         config_updates=dict(TINY_UPDATES))
    state = load_file(root / "ActionMesh" / "denoiser" / "model.safetensors")
    state["proj_in.weight"] = torch.zeros(64, 4)  # a wrong width
    save_file(state, den / "model.safetensors")
    with pytest.raises(ValueError, match="proj_in.kernel: checkpoint shape"):
        tpipeline_mod.ActionMeshPipeline(weights_dir=bad, device=CPU, dtype=torch.float32,
                                         config_updates=dict(TINY_UPDATES))
