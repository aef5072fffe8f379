"""The port's TripoSG Stage 0 and kernel F's plain version vs the JAX package.

Same inputs (numpy, seeded) and the same weights (JAX-initialised, carried
over by ``params_from_jax``) on both sides, fp32, on the CPU. JAX's Pallas
kernel F runs in interpret mode. The noise of the samplers is handed to
both sides: jax.random and torch.Generator cannot draw the same bits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from PIL import Image

import actionmesh_tpu.ops.flash_attention as jfa
import actionmesh_tpu_torch.models.triposg.pipeline as tpipe_mod
from actionmesh_tpu.models import stage0 as jstage0
from actionmesh_tpu.models.dinov2 import DinoV2Config as JDinoCfg
from actionmesh_tpu.models.image_encoder import ImageEncoder as JImageEncoder
from actionmesh_tpu.models.triposg import dit as jdit
from actionmesh_tpu.models.triposg import vae as jvae
from actionmesh_tpu.models.triposg.pipeline import TripoSGPipeline as JPipeline
from actionmesh_tpu.models.triposg.pipeline import _flow_sample as jflow_sample
from actionmesh_tpu.ops import rotary as jrot
from actionmesh_tpu.sampling.flow_schedule import get_schedule
from actionmesh_tpu_torch.models import layers as tlayers
from actionmesh_tpu_torch.models import stage0 as tstage0
from actionmesh_tpu_torch.models.dinov2 import DinoV2Config as TDinoCfg
from actionmesh_tpu_torch.models.image_encoder import ImageEncoder as TImageEncoder
from actionmesh_tpu_torch.models.triposg import dit as tdit
from actionmesh_tpu_torch.models.triposg import vae as tvae
from actionmesh_tpu_torch.models.triposg.pipeline import TripoSGPipeline as TPipeline
from actionmesh_tpu_torch.models.triposg.pipeline import flow_sample as tflow_sample
from actionmesh_tpu_torch.ops import rotary as trot
from actionmesh_tpu_torch.ops.flash_attention import flash_attention_fused, norm_rope_interleaved
from actionmesh_tpu_torch.utils.weights import params_from_jax

CPU = torch.device("cpu")
TINY_VAE = dict(
    latent_channels=8, num_tokens=16, encoder_width=32, encoder_layers=2, encoder_heads=2,
    decoder_width=32, decoder_layers=2, decoder_heads=2,
)
TINY_DIT = dict(
    num_tokens=16, in_channels=8, num_layers=3, width=64, num_attention_heads=2,
    cross_attention_dim=32,
)
TINY_DINO = dict(hidden_size=32, num_layers=2, num_heads=2, patch_size=14, image_size=70)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bridge(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), CPU)


@pytest.fixture(scope="module")
def vae():
    """(jax params, port params, jax kv, port kv) of a tiny decoder."""
    jcfg, tcfg = jvae.TripoSGVAEConfig(**TINY_VAE), tvae.TripoSGVAEConfig(**TINY_VAE)
    jparams = jvae.init_triposg_vae(jax.random.PRNGKey(0), jcfg)
    tparams = _bridge(jparams)
    latent = np.random.default_rng(1).standard_normal((1, 16, 8)).astype(np.float32)
    jkv = jvae.decode_kv(jparams, jcfg, jnp.asarray(latent), attn_impl="naive")
    tkv = tvae.decode_kv(tparams, tcfg, torch.from_numpy(latent))
    return jparams, tparams, jkv, tkv, jcfg, tcfg


@pytest.fixture(scope="module")
def dit():
    jcfg, tcfg = jdit.triposg_dit_config(**TINY_DIT), tdit.triposg_dit_config(**TINY_DIT)
    jparams = jdit.init_triposg_dit(jax.random.PRNGKey(3), jcfg)
    return jparams, _bridge(jparams), jcfg, tcfg


# ---------------------------------------------------------------------------
# Kernel F's plain version, and the interleaved rotary it needs
# ---------------------------------------------------------------------------


def test_interleaved_rotary_matches_jax():
    """Interleaved tables and the pairwise rotation on (B, S, D) tables."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(-7.5, 7.5, 40).astype(np.float32)
    jc, js = jrot.compute_rotary_embeddings(64, jnp.asarray(pos), layout="interleaved")
    tc, ts = trot.compute_rotary_embeddings(64, torch.from_numpy(pos), layout="interleaved")
    np.testing.assert_allclose(_np(tc), _np(jc), atol=1e-6)
    np.testing.assert_allclose(_np(ts), _np(js), atol=1e-6)
    x = rng.standard_normal((2, 3, 40, 64)).astype(np.float32)
    cos = np.stack([_np(jc), _np(jc)[::-1]])
    sin = np.stack([_np(js), _np(js)[::-1]])
    ref = jrot.apply_rotary_embedding(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), layout="interleaved")
    out = trot.apply_rotary_embedding(
        torch.from_numpy(x), torch.from_numpy(cos.copy()), torch.from_numpy(sin.copy()),
        layout="interleaved",
    )
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-6)
    np.testing.assert_array_equal(
        _np(trot.rotate_half_pairwise(torch.arange(6.0))), [-1.0, 0.0, -3.0, 2.0, -5.0, 4.0]
    )


def _bf16_ulp(ref):
    """One bf16 ulp at each value of ``ref`` (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_norm_rope_prepass_matches_jax(D, dtype):
    """Kernel F's pre-pass (plain version) vs the JAX package's own
    composition: fp32 rms-norm as ``_norm_rope`` computes it
    (actionmesh_tpu/ops/flash_attention.py:368-370), then
    ``apply_rotary_embedding(layout="interleaved")``, rounded to the dtype.
    Ragged S (not a multiple of any block), per-batch tables. Tolerance:
    fp32 1e-6 (values of order 1, fp32 sums in another order); bf16 one ulp
    (a last-bit difference in fp32 may round the other way)."""
    rng = np.random.default_rng(D)
    B, H, S = 2, 3, 45
    x = rng.standard_normal((B, H, S, D)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    tables = [jrot.compute_rotary_embeddings(D, jnp.asarray(rng.uniform(0, 15, S)), layout="interleaved")
              for _ in range(B)]
    cos = np.stack([_np(c) for c, _ in tables])
    sin = np.stack([_np(s) for _, s in tables])
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    xf = jnp.asarray(x).astype(jdt).astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    xf = xf * jax.lax.rsqrt(var + 1e-6) * jnp.asarray(scale)
    ref = _np(jrot.apply_rotary_embedding(xf, jnp.asarray(cos), jnp.asarray(sin),
                                          layout="interleaved").astype(jdt))
    out = norm_rope_interleaved(torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
                                torch.from_numpy(cos), torch.from_numpy(sin))
    assert out.dtype == tdt and out.shape == (B, H, S, D)
    tol = 1e-6 if dtype == "f32" else _bf16_ulp(ref)
    assert np.all(np.abs(_np(out) - ref) <= tol)


@pytest.mark.parametrize(
    "D,dtype,atol",
    [
        # the JAX test's own tolerance (tests/test_attention.py)
        (128, "f32", 3e-5),
        # q^, k^, P and the output are each rounded to bf16 on both sides,
        # with fp32 sums in another order: two bf16 ulps at the outputs'
        # largest magnitude (0.25-0.5 here; one ulp is 2^-9)
        (64, "bf16", 2 * 2.0**-9),
    ],
)
def test_fused_attention_plain_matches_jax_interpret(D, dtype, atol):
    """Kernel F's plain version vs the Pallas kernel in interpret mode,
    (1, 2, 300, D) with a ragged last block."""
    rng = np.random.default_rng(0)
    B, H, S = 1, 2, 300
    q, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(3))
    qs = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    ks = (0.9 * qs).astype(np.float32)
    cos, sin = jrot.compute_rotary_embeddings(D, jnp.linspace(0, 3, S), layout="interleaved")
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    orig = pl.pallas_call
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        ref = jfa.flash_attention_fused(
            *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), cos[None], sin[None],
            jnp.asarray(qs), jnp.asarray(ks), block_q=128, block_k=128,
        )
    finally:
        pl.pallas_call = orig
    flash_attention_fused.launches = 0
    out = flash_attention_fused(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        torch.from_numpy(_np(cos).copy())[None], torch.from_numpy(_np(sin).copy())[None],
        torch.from_numpy(qs), torch.from_numpy(ks),
    )
    assert out.shape == (B, H, S, D) and out.dtype == tdt
    np.testing.assert_allclose(_np(out), _np(ref), atol=atol)
    assert flash_attention_fused.launches == 0  # CPU tensors: the plain version


# ---------------------------------------------------------------------------
# DiT and the flow sampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("uncond_batch", [0, 1])
def test_dit_velocity_matches_jax(dit, uncond_batch):
    """One velocity prediction at tiny width, fp32, batch 2; with
    ``uncond_batch`` the first entry has a zero context and skips its
    cross-attention. Tolerance 1e-5 (sums in another order)."""
    jparams, tparams, jcfg, tcfg = dit
    rng = np.random.default_rng(4)
    lat = rng.standard_normal((2, 16, 8)).astype(np.float32)
    ctx = rng.standard_normal((2, 12, 32)).astype(np.float32)
    ctx[:uncond_batch] = 0.0
    t = np.array([900.5, 13.25], np.float32)
    ref = jdit.triposg_dit_forward(
        jparams, jcfg, jnp.asarray(lat), jnp.asarray(ctx), jnp.asarray(t),
        attn_impl="naive", uncond_batch=uncond_batch,
    )
    out = tdit.triposg_dit_forward(
        tparams, tcfg, torch.from_numpy(lat), torch.from_numpy(ctx), torch.from_numpy(t),
        uncond_batch=uncond_batch,
    )
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)


@pytest.mark.parametrize("guidance_scale", [7.5, None], ids=["cfg", "guidance_free"])
def test_flow_sample_matches_jax(dit, guidance_scale):
    """3 Euler steps from the same noise; tolerance 5e-5 (CFG 7.5 scales
    the branches' fp32 differences)."""
    jparams, tparams, jcfg, tcfg = dit
    rng = np.random.default_rng(5)
    noise = rng.standard_normal((1, 16, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 12, 32)).astype(np.float32)
    ts, dist = get_schedule(3, 1000, 3.0)
    ref = jflow_sample(
        jparams, jcfg, jnp.asarray(noise), jnp.asarray(ctx), jnp.asarray(ts),
        jnp.asarray(dist), guidance_scale=guidance_scale, attn_impl="naive",
    )
    out = tflow_sample(
        tparams, tcfg, torch.from_numpy(noise), torch.from_numpy(ctx), ts, dist, guidance_scale
    )
    np.testing.assert_allclose(_np(out), _np(ref), atol=5e-5)
    assert np.abs(_np(out) - noise).max() > 1e-3  # the sampler moved the latents


# ---------------------------------------------------------------------------
# VAE decode
# ---------------------------------------------------------------------------


def test_vae_decode_kv_and_query_sdf_match_jax(vae):
    """decode_kv and query_sdf at tiny width, fp32; tolerance 1e-5."""
    jparams, tparams, jkv, tkv, jcfg, tcfg = vae
    np.testing.assert_allclose(_np(tkv), _np(jkv), atol=1e-5)
    pts = np.random.default_rng(2).uniform(-1, 1, (1, 300, 3)).astype(np.float32)
    ref = jvae.query_sdf(jparams, jcfg, jkv, jnp.asarray(pts), attn_impl="naive")
    out = tvae.query_sdf(tparams, tcfg, tkv, torch.from_numpy(pts))
    assert out.shape == (1, 300) and out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)
    assert tparams["dec_cross_attn"]["to_q"]["weight"].dtype == torch.float32
    # the encoder side is ported too (held against JAX's in test_torch_video_3d.py)
    assert tvae.encode_surface(tparams, tcfg, torch.zeros(1, 64, 6)).shape == (1, 16, 8)


REGULARIZERS = {
    "plain": (None, None),
    "dev_regularizer": (jstage0._dev_sdf_regularizer_jax, tstage0._dev_sdf_regularizer_torch),
}


@pytest.mark.parametrize("reg", list(REGULARIZERS))
def test_query_sdf_at_ids_matches_jax(vae, reg):
    """Values at lattice ids, 3 chunks of 64; tolerance 1e-5."""
    jparams, tparams, jkv, tkv, jcfg, tcfg = vae
    jreg, treg = REGULARIZERS[reg]
    ijk = np.random.default_rng(3).integers(0, 17, (192, 3)).astype(np.int32)
    lo, step = np.full(3, -1.005), np.full(3, 2.01 / 16)
    ref = jvae.query_sdf_at_ids(
        jparams, jcfg, jkv, jnp.asarray(ijk), jnp.asarray(lo), jnp.asarray(step),
        chunk=64, attn_impl="naive", regularizer=jreg,
    )
    out = tvae.query_sdf_at_ids(tparams, tcfg, tkv, ijk, lo, step, chunk=64, regularizer=treg)
    assert out.dtype == np.float32 and out.shape == (192,)
    np.testing.assert_allclose(out, _np(ref), atol=1e-5)
    with pytest.raises(ValueError, match="multiple"):
        tvae.query_sdf_at_ids(tparams, tcfg, tkv, ijk[:100], lo, step, chunk=64)


@pytest.mark.parametrize("reg", list(REGULARIZERS))
def test_query_sdf_grid_inside_matches_jax(vae, reg):
    """Inside mask of a 9^3 lattice in 3 chunks of 256 (the last padded):
    equal to JAX's wherever the field is farther than 1e-5 from the level."""
    jparams, tparams, jkv, tkv, jcfg, tcfg = vae
    jreg, treg = REGULARIZERS[reg]
    Rc, lo = 9, np.full(3, -1.0)
    step = np.full(3, 2.0 / (Rc - 1))
    level = 0.0 if reg == "dev_regularizer" else float(_np(jvae.query_sdf(
        jparams, jcfg, jkv, jnp.zeros((1, 1, 3)), attn_impl="naive"))[0, 0])
    ref = np.asarray(jvae.query_sdf_grid_inside(
        jparams, jcfg, jkv, jnp.asarray(lo), jnp.asarray(step), jnp.float32(level), Rc=Rc,
        chunk=256, attn_impl="naive", regularizer=jreg,
    ))
    out = tvae.query_sdf_grid_inside(
        tparams, tcfg, tkv, lo, step, level, Rc, chunk=256, regularizer=treg
    )
    assert out.dtype == np.int8 and out.shape == ref.shape == (768,)
    idx = np.arange(Rc**3)
    pts = np.stack([idx // (Rc * Rc), (idx // Rc) % Rc, idx % Rc], -1) * step + lo
    vals = tvae.query_sdf(tparams, tcfg, tkv, torch.from_numpy(pts.astype(np.float32))[None])[0]
    if treg is not None:
        vals = treg(torch.from_numpy(pts.astype(np.float32)), vals)
    clear = np.abs(_np(vals) - level) > 1e-5
    assert 0 < out[: Rc**3].sum() < Rc**3  # both signs occur
    np.testing.assert_array_equal(out[: Rc**3][clear], ref[: Rc**3][clear])


# ---------------------------------------------------------------------------
# The bf16 coarse pass (stage_0.coarse_decode_dtype)
# ---------------------------------------------------------------------------

BF16_TOL = 1e-2  # of max|value|: bf16 q, k, v and projections (8 mantissa bits)


def _lattice(Rc):
    idx = np.arange(Rc**3)
    return np.stack([idx // (Rc * Rc), (idx // Rc) % Rc, idx % Rc], -1).astype(np.int32)


@pytest.mark.parametrize("reg", list(REGULARIZERS))
def test_bf16_query_matches_jax_bf16(vae, reg, monkeypatch):
    """``compute_dtype=bf16``: the port's values within 1e-2 of max|value|
    of JAX's bf16 ones, and the query cross-attention really runs on bf16
    q, k and v (a fp32 q would take kernel A's fp32 path on the card)."""
    jparams, tparams, jkv, tkv, jcfg, tcfg = vae
    jreg, treg = REGULARIZERS[reg]
    seen = []
    plain_attention = tlayers.dot_product_attention

    def recording(q, k, v, **kw):
        seen.append((q.dtype, k.dtype, v.dtype))
        return plain_attention(q, k, v, **kw)

    monkeypatch.setattr(tlayers, "dot_product_attention", recording)
    ijk = np.random.default_rng(3).integers(0, 17, (192, 3)).astype(np.int32)
    lo, step = np.full(3, -1.005), np.full(3, 2.01 / 16)
    ref = _np(jvae.query_sdf_at_ids(
        jparams, jcfg, jkv, jnp.asarray(ijk), jnp.asarray(lo), jnp.asarray(step),
        chunk=64, attn_impl="naive", regularizer=jreg, compute_dtype=jnp.bfloat16,
    ))
    out = tvae.query_sdf_at_ids(tparams, tcfg, tkv, ijk, lo, step, chunk=64, regularizer=treg,
                                compute_dtype=torch.bfloat16)
    assert out.dtype == np.float32 and seen == [(torch.bfloat16,) * 3] * 3
    np.testing.assert_allclose(out, ref, atol=BF16_TOL * np.abs(ref).max())
    f32 = tvae.query_sdf_at_ids(tparams, tcfg, tkv, ijk, lo, step, chunk=64, regularizer=treg)
    assert seen[-1] == (torch.float32,) * 3 and np.abs(out - f32).max() > 0


@pytest.mark.parametrize("reg", list(REGULARIZERS))
def test_bf16_inside_mask_matches_jax_bf16_off_the_surface(vae, reg):
    """The bf16 inside mask of a 9^3 lattice: wherever it differs from JAX's
    bf16 mask, the fp32 value lies within 1e-2 of max|value| of the level."""
    jparams, tparams, jkv, tkv, jcfg, tcfg = vae
    jreg, treg = REGULARIZERS[reg]
    Rc, lo = 9, np.full(3, -1.0)
    step = np.full(3, 2.0 / (Rc - 1))
    ijk = np.concatenate([_lattice(Rc), np.zeros((768 - Rc**3, 3), np.int32)])
    vals = tvae.query_sdf_at_ids(tparams, tcfg, tkv, ijk, lo, step, chunk=256, regularizer=treg)[: Rc**3]
    level = 0.0 if reg == "dev_regularizer" else float(np.median(vals))
    ref = np.asarray(jvae.query_sdf_grid_inside(
        jparams, jcfg, jkv, jnp.asarray(lo), jnp.asarray(step), jnp.float32(level), Rc=Rc,
        chunk=256, attn_impl="naive", regularizer=jreg, compute_dtype=jnp.bfloat16,
    ))[: Rc**3]
    out = tvae.query_sdf_grid_inside(tparams, tcfg, tkv, lo, step, level, Rc, chunk=256,
                                     regularizer=treg, compute_dtype=torch.bfloat16)[: Rc**3]
    assert 0 < out.sum() < Rc**3
    differ = out != ref
    assert np.all(np.abs(vals[differ] - level) <= BF16_TOL * np.abs(vals).max())


@pytest.fixture(scope="module")
def pipelines():
    """The tiny TripoSG on both sides (JAX-initialised weights), with the
    dev regularizer: (JAX pipeline, port pipeline, JAX DINOv2), built once
    for the module's pipeline tests."""
    jdino = JImageEncoder(weights_dir=None, dtype=jnp.float32, config=JDinoCfg(**TINY_DINO))
    jpipe = JPipeline.from_random(
        seed=0, dtype=jnp.float32, dit_cfg=jdit.triposg_dit_config(**TINY_DIT),
        vae_cfg=jvae.TripoSGVAEConfig(**TINY_VAE), image_encoder=jdino, attn_impl="naive",
    )
    jpipe.sdf_regularizer = jstage0._dev_sdf_regularizer
    jpipe.sdf_regularizer_jax = jstage0._dev_sdf_regularizer_jax
    tpipe = TPipeline(
        _bridge(jpipe.dit_params), _bridge(jpipe.vae_params),
        TImageEncoder(CPU, torch.float32, TDinoCfg(**TINY_DINO), params=_bridge(jdino.params)),
        dit_cfg=tdit.triposg_dit_config(**TINY_DIT), vae_cfg=tvae.TripoSGVAEConfig(**TINY_VAE),
        dtype=torch.float32, device=CPU,
    )
    tpipe.sdf_regularizer = tstage0._dev_sdf_regularizer
    tpipe.sdf_regularizer_torch = tstage0._dev_sdf_regularizer_torch
    return jpipe, tpipe, jdino


def test_bf16_coarse_decode_matches_jax(pipelines):
    """JAX's own check (tests/test_triposg.py, the speed knobs): prefilter 3
    + bf16 coarse passes give a finite mesh whose mean radius is within 0.01
    of the fp32 decode's; here also of JAX's bf16 decode. The bf16 passes
    take the prefilter and band chunks, the fp32 one the fine chunks."""
    jpipe, tpipe, _ = pipelines
    latents = np.random.default_rng(2).standard_normal((1, 16, 8)).astype(np.float32)
    depths = dict(dense_octree_depth=4, hierarchical_octree_depth=5)
    ref = tpipe.decode_latents(torch.from_numpy(latents), **depths)[0]
    seen = []
    plain_attention = tlayers.dot_product_attention

    def recording(q, k, v, **kw):
        seen.append(q.dtype)
        return plain_attention(q, k, v, **kw)

    tlayers.dot_product_attention = recording
    try:
        fast = tpipe.decode_latents(torch.from_numpy(latents), prefilter_octree_depth=3,
                                    coarse_decode_dtype="bfloat16", **depths)[0]
    finally:
        tlayers.dot_product_attention = plain_attention
    jfast = jpipe.decode_latents(jnp.asarray(latents), prefilter_octree_depth=3,
                                 coarse_decode_dtype="bfloat16", **depths)[0]
    stats = tpipe.extract_stats
    n_dec = TINY_VAE["decoder_layers"]
    assert seen[n_dec:].count(torch.bfloat16) == stats["prefilter"] + stats["band"] > 0
    assert seen[n_dec:].count(torch.float32) == stats["fine"] > 0
    assert len(fast.faces) > 50 and np.isfinite(fast.vertices).all()
    radius = [np.linalg.norm(m.vertices, axis=1).mean() for m in (ref, fast, jfast)]
    assert abs(radius[0] - radius[1]) < 0.01 and abs(radius[1] - radius[2]) < 0.01


def test_stage0_coarse_decode_dtype_reaches_stage0(tmp_path):
    """``stage_0.coarse_decode_dtype: bfloat16`` from a YAML preset
    (``load_config(config_dir=...)``) or ``config_updates`` reaches the
    Stage-0 backend's call, which runs it (test_bf16_coarse_decode_matches_jax)."""
    from actionmesh_tpu_torch.config import load_config
    from actionmesh_tpu_torch.io.video_input import ActionMeshInput
    from actionmesh_tpu_torch.pipeline import ActionMeshPipeline
    from tests.test_torch_pipeline import TINY_UPDATES, make_frames

    (tmp_path / "coarse.yaml").write_text("stage_0:\n  coarse_decode_dtype: bfloat16\n")
    assert load_config("coarse", config_dir=tmp_path).stage_0.coarse_decode_dtype == "bfloat16"
    pipe = ActionMeshPipeline(weights_dir=None, device=CPU, dtype=torch.float32,
                              config_updates={**TINY_UPDATES, "stage_0.coarse_decode_dtype": "bfloat16"})
    seen = {}

    def image_to_3d(image, **kwargs):
        seen.update(kwargs)
        return torch.zeros(1, 16, 8), tstage0.make_uv_sphere(n_lat=6, n_lon=8)

    pipe.image_to_3d = image_to_3d
    pipe.init_banks_from_anchor(ActionMeshInput(frames=make_frames(), timesteps=np.arange(16.0)))
    assert seen["coarse_decode_dtype"] == "bfloat16"
    assert tpipe_mod.coarse_dtype(seen["coarse_decode_dtype"]) == torch.bfloat16


@pytest.mark.parametrize("name", ["bfloat17", "Linear"])
def test_coarse_decode_dtype_that_names_no_dtype_raises(name, pipelines):
    """As JAX's ``jnp.dtype`` does; before any work."""
    tpipe = pipelines[1]
    with pytest.raises(TypeError, match="not understood"):
        tpipe.decode_latents(torch.zeros(1, 16, 8), coarse_decode_dtype=name)
    with pytest.raises(TypeError, match="not understood"):
        tpipe(np.zeros((64, 64, 3), np.uint8), coarse_decode_dtype=name)


# ---------------------------------------------------------------------------
# The pipeline end to end, and the Stage-0 selection
# ---------------------------------------------------------------------------


def test_tiny_pipeline_matches_jax(monkeypatch, pipelines):
    """Image -> DINOv2 -> 3 CFG steps -> VAE decode -> prefilter extraction
    (dense 4, fine 5, prefilter 3) with the dev regularizer, the same noise
    on both sides. Latents within 5e-5; faces equal; vertices within 1e-5."""
    jpipe, tpipe, jdino = pipelines

    rng = np.random.default_rng(6)
    image = rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)
    noise = rng.standard_normal((1, 16, 8)).astype(np.float32)
    monkeypatch.setattr(
        tpipe_mod, "initial_noise",
        lambda seed, shape, dtype, device: torch.from_numpy(noise).to(device, dtype),
    )
    decode = dict(dense_octree_depth=4, hierarchical_octree_depth=5, prefilter_octree_depth=3)
    ts, dist = get_schedule(3, 1000, 3.0)
    context = jdino.encode_images([Image.fromarray(image)])
    jlat = jflow_sample(
        jpipe.dit_params, jpipe.dit_cfg, jnp.asarray(noise), context, jnp.asarray(ts),
        jnp.asarray(dist), guidance_scale=7.5, attn_impl="naive",
    )
    jmesh = jpipe.decode_latents(jlat, **decode)[0]

    tlat, tmesh = tpipe(image, seed=1, num_inference_steps=3, guidance_scale=7.5, **decode)
    assert tlat.shape == (1, 16, 8) and tlat.dtype == torch.float32
    np.testing.assert_allclose(_np(tlat), _np(jlat), atol=5e-5)
    assert tmesh.n_faces > 100
    np.testing.assert_array_equal(tmesh.faces, jmesh.faces)
    np.testing.assert_allclose(tmesh.vertices, jmesh.vertices, atol=1e-5)
    assert set(tpipe.phase_seconds) == {"encode", "dit_sample", "decode"}
    assert tpipe.extract_stats == {"prefilter": 1, "band": 1, "dense": 0, "fine": 1}
    # the reduced-precision coarse pass (bf16 prefilter and band, fp32 fine)
    # runs as JAX's does: on the same latents, the same surface up to the
    # bf16 near-zero band (the mean radius within 0.01, JAX's own bound)
    jfast = jpipe.decode_latents(jlat, coarse_decode_dtype="bfloat16", **decode)[0]
    tfast = tpipe.decode_latents(tlat, coarse_decode_dtype="bfloat16", **decode)[0]
    assert tfast.n_faces > 100 and tpipe.extract_stats == {"prefilter": 1, "band": 1, "dense": 0, "fine": 1}
    radius = [np.linalg.norm(v, axis=1).mean() for v in (tfast.vertices, jfast.vertices, jmesh.vertices)]
    assert abs(radius[0] - radius[1]) < 0.01 and abs(radius[0] - radius[2]) < 0.01


def test_make_image_to_3d_selection(monkeypatch, tmp_path):
    """DevTripoSG at the production latent shape, built lazily; the stub at
    other shapes or with ACTIONMESH_DEV_STAGE0=stub; a weights directory is
    loaded as a checkpoint, so one without weights raises (never a fallback
    to random weights)."""
    monkeypatch.delenv("ACTIONMESH_DEV_STAGE0", raising=False)
    dev = tstage0.make_image_to_3d(None, (2048, 64), CPU)
    assert isinstance(dev, tstage0.DevTripoSG) and dev._pipe is None
    assert isinstance(tstage0.make_image_to_3d(None, (16, 8), CPU), tstage0.StubImageTo3D)
    monkeypatch.setenv("ACTIONMESH_DEV_STAGE0", "stub")
    assert isinstance(tstage0.make_image_to_3d(None, (2048, 64), CPU), tstage0.StubImageTo3D)
    with pytest.raises(FileNotFoundError, match="transformer"):
        tstage0.make_image_to_3d(tmp_path, (2048, 64), CPU)
    with pytest.raises(FileNotFoundError):
        TPipeline.from_pretrained(tmp_path, device=CPU)


def test_dev_regularizer_torch_mirrors_numpy():
    rng = np.random.default_rng(9)
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    vals = rng.standard_normal(500).astype(np.float32) * 3
    ref = jstage0._dev_sdf_regularizer(pts, vals)
    np.testing.assert_allclose(tstage0._dev_sdf_regularizer(pts, vals), ref, atol=0)
    out = tstage0._dev_sdf_regularizer_torch(torch.from_numpy(pts), torch.from_numpy(vals))
    np.testing.assert_allclose(_np(out), ref, atol=1e-6)


def test_weight_bridge_keeps_leaf_dtypes():
    """A bf16 TripoSG tree crosses with each leaf's dtype: bf16 linears,
    fp32 norms and the fp32 query side; kernels transposed."""
    jparams = jvae.init_triposg_vae(
        jax.random.PRNGKey(0), jvae.TripoSGVAEConfig(**TINY_VAE), dtype=jnp.bfloat16
    )
    tparams = _bridge(jparams)
    assert tparams["dec_blocks"][0]["s_attn"]["to_q"]["weight"].dtype == torch.bfloat16
    assert tparams["dec_blocks"][0]["norm_ff"]["scale"].dtype == torch.float32
    for key in ("proj_query", "dec_proj_out"):
        w = tparams[key]["weight"]
        assert w.dtype == torch.float32
        np.testing.assert_array_equal(w.numpy(), np.asarray(jparams[key]["kernel"]).T)
    jflat = jax.tree.leaves(jparams)
    tflat = jax.tree.leaves(tparams)
    assert len(jflat) == len(tflat)
    assert [str(a.dtype) for a in jflat] == [str(b.dtype).removeprefix("torch.") for b in tflat]
