"""Hunyuan3D-2.1's shape model in the port (``models/hunyuan3d/``, the
sparse-expert feed-forward of ``models/layers.py``) held against the plain
reference ``portbench/reference/hunyuan3d21.py`` at tiny widths on the CPU,
on seeded random weights in the release's names.

Tolerances: the port and the reference compute the same fp32 arithmetic in
other orders (a grouped product against a loop over experts, the port's
one-pass layer-norm variance, the flash attention's blocks), which leaves
~1e-7 relative; 1e-5 holds that with room and is ~100x below what bf16
weights and activations give (the last test shows bf16 missing it)."""

import numpy as np
import pytest
import torch

from actionmesh_tpu_torch.io.video_input import ActionMeshInput
from actionmesh_tpu_torch.models import layers, stage0
from actionmesh_tpu_torch.models.dinov2 import DinoV2Config
from actionmesh_tpu_torch.models.hunyuan3d import convert
from actionmesh_tpu_torch.models.hunyuan3d.dit import hunyuan3d_dit_config
from actionmesh_tpu_torch.models.hunyuan3d.pipeline import hunyuan3d_vae_config, recenter
from actionmesh_tpu_torch.models.image_encoder import ImageEncoder
from actionmesh_tpu_torch.models.triposg.dit import triposg_dit_forward
from actionmesh_tpu_torch.models.triposg.vae import TripoSGVAEConfig, _query_core, decode_kv
from actionmesh_tpu_torch.pipeline import ActionMeshPipeline
from portbench.bench.weights import make_state
from portbench.reference import hunyuan3d21 as H
from portbench.reference.numerics import precision
from tests.test_torch_pipeline import TINY_DINO, TINY_UPDATES, make_frames

TOL = 1e-5  # relative, fp32 port against the fp32 reference (module doc)
DIT = dict(width=64, num_layers=5, num_attention_heads=2, in_channels=8, cross_attention_dim=32,
           mlp_ratio=4.0, num_tokens=16, num_moe_layers=2, num_experts=4, moe_top_k=2)
VAE = dict(num_tokens=16, latent_channels=8, width=32, layers=2, heads=2, embed_frequency=8,
           scale_factor=1.0039506158752403)


def port_dit_config():
    return hunyuan3d_dit_config(**{k: DIT[k] for k in DIT if k not in ("moe_top_k",)})


def port_vae_config():
    return hunyuan3d_vae_config(num_tokens=VAE["num_tokens"], latent_channels=VAE["latent_channels"],
                                width=VAE["width"], layers=VAE["layers"], heads=VAE["heads"])


def rel(a, r) -> float:
    return float((a.float() - r.float()).norm() / r.float().norm())


@pytest.fixture(scope="module")
def dit_state():
    return make_state(H.dit_layout(DIT), 3, "cpu", torch.float32)


@pytest.fixture(scope="module")
def vae_state():
    return make_state(H.vae_layout(VAE), 4, "cpu", torch.float32)


# -- the expert layer ------------------------------------------------------

def _moe_state(dit_state, block=DIT["num_layers"] - 1):
    p = f"blocks.{block}.moe"
    return {k[len(p) + 1:]: v.clone() for k, v in dit_state.items() if k.startswith(p + ".")}


def _port_moe(state, dtype=torch.float32):
    return convert._moe({f"m.{k}": v for k, v in state.items()}, "m", DIT["num_experts"], dtype)


@pytest.mark.parametrize("case", ["drawn", "one_expert_idle", "all_pick_two", "shared_once"])
def test_expert_layer(dit_state, case):
    """Port against the reference's dense loop over experts; the routed
    rows each expert took (the ``moe`` span's counter) against the
    reference's own picks."""
    torch.manual_seed(1)
    state = _moe_state(dit_state)
    E, W, k = DIT["num_experts"], DIT["width"], DIT["moe_top_k"]
    h = torch.randn(37, W)
    if case in ("one_expert_idle", "all_pick_two"):
        h = h.abs() + 0.5  # every coordinate positive: a row of the gate sets an expert's odds
        state["gate.weight"][3] = -1.0  # expert 3 never wins
        if case == "all_pick_two":
            state["gate.weight"][0] = state["gate.weight"][1] = 1.0
    if case == "shared_once":
        for e in range(E):
            state[f"experts.{e}.net.2.weight"].zero_()
            state[f"experts.{e}.net.2.bias"].zero_()
    with torch.no_grad(), precision("fp32"):
        ref, scores, own = H.moe({f"m.{k}": v for k, v in state.items()}, "m", h, k)
    from actionmesh_tpu_torch.utils.profiling import span
    with torch.no_grad(), span("call") as root:
        out = layers.moe_feed_forward(_port_moe(state), h, k)
    assert rel(out, ref) < TOL
    (moe_span,) = [sp for sp in root.recorder.spans if sp.name == "moe"]
    counts = moe_span.counters["routed_rows"]
    assert counts.tolist() == torch.bincount(own.reshape(-1), minlength=E).tolist()
    assert int(counts.sum()) == k * h.shape[0]
    if case == "one_expert_idle":
        assert counts[3] == 0
    if case == "all_pick_two":
        assert counts.tolist() == [h.shape[0], h.shape[0], 0, 0]
    if case == "shared_once":
        shared = layers.feed_forward(_port_moe(state)["shared"], h)
        assert rel(out, shared) < TOL


# -- the DiT and the decoder --------------------------------------------------

def test_dit_expert_and_dense_blocks(dit_state):
    """Both CFG branches (the first without the image: its cross-attention
    skipped), 3 dense and 2 expert blocks, U-skips, the time token."""
    cfg = port_dit_config()
    assert cfg.moe_layers == (3, 4)
    params = convert.convert_dit(dit_state, cfg, torch.float32)
    torch.manual_seed(2)
    x, ctx = torch.randn(2, 16, 8), torch.randn(2, 7, 32)
    ctx[0] = 0
    t = torch.full((2,), 0.37)
    with torch.no_grad():
        v = triposg_dit_forward(params, cfg, x, ctx, t, uncond_batch=1)
        with precision("fp32"):
            ref, gates = H.dit(dit_state, DIT, x, ctx, t, uncond=1)
    assert len(gates) == 2
    assert rel(v, ref) < TOL


def test_vae_sdf_values(vae_state):
    cfg = port_vae_config()
    params = convert.convert_vae(vae_state, cfg, torch.float32)
    torch.manual_seed(3)
    lat, pts = torch.randn(1, 16, 8), torch.rand(300, 3) * 2 - 1
    with torch.no_grad():
        vals = _query_core(params, cfg, decode_kv(params, cfg, lat), pts[None])[0]
        with precision("fp32"):
            ref = H.vae_sdf(vae_state, VAE, H.vae_tokens(vae_state, VAE, lat), pts)
    assert rel(vals, ref) < TOL


def test_vae_sdf_misses_without_the_query_mlp_or_the_layer_qk_norm(vae_state):
    """The SDF comparison sees the geometry decoder's feed-forward after its
    query cross-attention and the layer norms on q and k: the port without
    the one, or with rms-norms in place of the other, misses TOL by far."""
    cfg = port_vae_config()
    params = convert.convert_vae(vae_state, cfg, torch.float32)
    no_mlp = {k: v for k, v in params.items() if k not in ("dec_norm_ff", "dec_ff")}
    rms = dict(params, dec_cross_attn={k: ({"scale": v["scale"]} if k in ("norm_q", "norm_k") else v)
                                       for k, v in params["dec_cross_attn"].items()})
    torch.manual_seed(3)
    lat, pts = torch.randn(1, 16, 8), torch.rand(300, 3) * 2 - 1
    with torch.no_grad():
        kv = decode_kv(params, cfg, lat)
        with precision("fp32"):
            ref = H.vae_sdf(vae_state, VAE, H.vae_tokens(vae_state, VAE, lat), pts)
        for changed in (no_mlp, rms):
            assert rel(_query_core(changed, cfg, kv, pts[None])[0], ref) > 100 * TOL


def test_converter_takes_every_release_tensor_once(dit_state, vae_state):
    """Release names in, the port's trees out: each drawn tensor lands,
    unchanged, where the port reads it, and every one is used once."""
    dit = convert.convert_dit(dit_state, port_dit_config(), torch.float32)
    vae = convert.convert_vae(vae_state, port_vae_config(), torch.float32)

    def numel(tree):
        if isinstance(tree, dict):
            return sum(numel(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(numel(v) for v in tree)
        return tree.numel()

    assert numel(dit) == sum(t.numel() for t in dit_state.values())
    assert numel(vae) == sum(t.numel() for t in vae_state.values())
    moe = dit["blocks"][4]["moe"]
    for e in range(DIT["num_experts"]):
        assert torch.equal(moe["experts"]["net_0"]["weight"][e],
                           dit_state[f"blocks.4.moe.experts.{e}.net.0.proj.weight"])
        assert torch.equal(moe["experts"]["net_2"]["bias"][e], dit_state[f"blocks.4.moe.experts.{e}.net.2.bias"])
    assert torch.equal(moe["gate"]["weight"], dit_state["blocks.4.moe.gate.weight"])
    assert torch.equal(dit["blocks"][2]["ff"]["net_0"]["weight"], dit_state["blocks.2.mlp.fc1.weight"])
    assert torch.equal(dit["blocks"][3]["linear_skip"]["weight"], dit_state["blocks.3.skip_linear.weight"])
    assert torch.equal(dit["time_proj"]["linear_1"]["weight"], dit_state["t_embedder.mlp.0.weight"])
    qkv = vae_state["transformer.resblocks.1.attn.c_qkv.weight"].reshape(VAE["heads"], 3, -1, VAE["width"])
    for j, name in enumerate(("to_q", "to_k", "to_v")):
        assert torch.equal(vae["dec_blocks"][1]["s_attn"][name]["weight"], qkv[:, j].reshape(-1, VAE["width"]))
    g = "geo_decoder.cross_attn_decoder"
    assert torch.equal(vae["dec_ff"]["net_0"]["weight"], vae_state[f"{g}.mlp.c_fc.weight"])
    assert torch.equal(vae["dec_norm_ff"]["bias"], vae_state[f"{g}.ln_3.bias"])
    assert torch.equal(vae["dec_cross_attn"]["norm_k"]["bias"], vae_state[f"{g}.attn.attention.k_norm.bias"])
    with pytest.raises(KeyError, match="blocks.4.moe.gate.weight"):
        convert.convert_dit({k: v for k, v in dit_state.items() if k != "blocks.4.moe.gate.weight"},
                            port_dit_config(), torch.float32)


def test_bf16_misses_the_tolerance(dit_state):
    """The same DiT call with bf16 weights and activations: far outside TOL."""
    cfg = port_dit_config()
    params = convert.convert_dit(dit_state, cfg, torch.bfloat16)
    torch.manual_seed(2)
    x, ctx = torch.randn(2, 16, 8), torch.randn(2, 7, 32)
    ctx[0] = 0
    t = torch.full((2,), 0.37)
    with torch.no_grad():
        v = triposg_dit_forward(params, cfg, x.bfloat16(), ctx.bfloat16(), t, uncond_batch=1)
        with precision("fp32"):
            ref, _ = H.dit(dit_state, DIT, x, ctx, t, uncond=1)
    assert rel(v, ref) > 10 * TOL


def test_recenter_matches_the_reference():
    frame = make_frames(n=1, size=64)[0]
    rgb = np.where(frame[..., 3:] > 0, frame[..., :3], 255).astype(np.uint8)
    assert np.array_equal(recenter(rgb), H.recenter(rgb))


# -- the pipeline ----------------------------------------------------------------

def test_pipeline_with_the_hunyuan_stage0(monkeypatch):
    """``stage_0_model="hunyuan3d-2.1"`` builds the development Hunyuan3D
    backend; a tiny call's Stage-0 seconds hold its four spans and the mesh
    processing, and every expert block's ``moe`` span routed top-k rows of
    each of its tokens (both CFG branches, the time token included)."""
    cpu = torch.device("cpu")
    dit_cfg = hunyuan3d_dit_config(num_tokens=32, in_channels=8, num_layers=3, width=32,
                                   num_attention_heads=2, cross_attention_dim=32, num_moe_layers=1,
                                   num_experts=4)
    configs = dict(dit_cfg=dit_cfg,
                   vae_cfg=hunyuan3d_vae_config(num_tokens=32, latent_channels=8, width=32, layers=1,
                                                heads=2),
                   conditioner_cfg=DinoV2Config(hidden_size=32, num_layers=1, num_heads=2,
                                                patch_size=14, image_size=56),
                   handoff_cfg=TripoSGVAEConfig(latent_channels=8, num_tokens=16, encoder_width=32,
                                                encoder_layers=1, encoder_heads=2, decoder_width=32,
                                                decoder_layers=1, decoder_heads=2))
    monkeypatch.setattr(stage0, "dev_hunyuan3d_configs", lambda shape: configs)
    pipe = ActionMeshPipeline(
        config_name="actionmesh", weights_dir=None, device=cpu, dtype=torch.float32,
        config_updates=dict(TINY_UPDATES), image_encoder=ImageEncoder(cpu, torch.float32,
                                                                      DinoV2Config(**TINY_DINO)),
        device_mesh=None, stage_0_model="hunyuan3d-2.1")
    assert isinstance(pipe.image_to_3d, stage0.DevHunyuan3D)
    backend = pipe.image_to_3d

    class Depths:  # extraction depths a CPU run affords, as a deployment passes its own
        def __call__(self, image, **kwargs):
            return backend(image, **{**kwargs, "prefilter_octree_depth": 3, "dense_octree_depth": 4,
                                     "hierarchical_octree_depth": 5})

    pipe.image_to_3d = Depths()
    steps = 2
    inp = ActionMeshInput(frames=make_frames(), timesteps=np.arange(16, dtype=np.float32))
    assert len(pipe(inp, seed=5, stage_0_steps=steps, face_decimation=300)) == 16
    s0 = pipe.stage0_seconds
    assert {k for k in s0 if "." not in k} == {"encode", "dit_sample", "decode", "handoff", "process_mesh"}
    assert {"handoff.sample", "handoff.vae_encode", "dit_sample.dit_step.moe"} <= set(s0)
    moe = [sp for sp in pipe.last_call.recorder.spans if sp.name == "moe"]
    assert len(moe) == steps * len(dit_cfg.moe_layers)
    for sp in moe:
        assert int(sp.counters["routed_rows"].sum()) == dit_cfg.moe_top_k * 2 * (dit_cfg.num_tokens_nominal + 1)
    assert set(backend.pipeline.phase_seconds) == {"encode", "dit_sample", "decode", "handoff"}
