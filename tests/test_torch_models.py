"""Port models vs the JAX package's models at tiny widths, on CPU.

Weights are initialised by the JAX package, perturbed with numpy noise (so
norm scales and biases are not the identity), and handed to both sides:
to JAX as arrays, to the port through the weight bridge. All fp32; the
tolerance is the 5e-4 the JAX suite uses for fp32 model-level parity.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actionmesh_tpu.models import autoencoder as jae
from actionmesh_tpu.models import denoiser as jden
from actionmesh_tpu.models import dinov2 as jdino
from actionmesh_tpu.models import layers as jlayers
from actionmesh_tpu.sampling import denoise_loop as jloop
from actionmesh_tpu.sampling.flow_schedule import get_schedule
from actionmesh_tpu.sampling.guidance import make_guidance as jguidance
from actionmesh_tpu_torch.models import autoencoder as tae
from actionmesh_tpu_torch.models import denoiser as tden
from actionmesh_tpu_torch.models import dinov2 as tdino
from actionmesh_tpu_torch.models import layers as tlayers
from actionmesh_tpu_torch.sampling import denoise_loop as tloop
from actionmesh_tpu_torch.sampling.guidance import make_guidance as tguidance
from actionmesh_tpu_torch.utils.weights import params_from_jax

ATOL = 5e-4


def _bridge(jax_params, seed=0):
    """(jax tree, port tree) holding the same perturbed fp32 weights."""
    rng = np.random.default_rng(seed)

    def perturb(a):
        a = np.asarray(a, dtype=np.float32)
        return (a * (1 + 0.1 * rng.standard_normal(a.shape)) + 0.02 * rng.standard_normal(a.shape)).astype(np.float32)

    tree = jax.tree.map(perturb, jax_params)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol)


def test_attention_cross_with_uncond_skip():
    """Cross-attention with qk-norm; the two leading batch entries have zero
    context, so the port and JAX both skip their attention."""
    jp, tp = _bridge(jlayers.init_attention(
        jax.random.PRNGKey(0), 64, 2, cross_attention_dim=32, qk_norm=True, bias=False
    ))
    rng = np.random.default_rng(1)
    x = _rand(rng, 4, 9, 64)
    ctx = _rand(rng, 4, 5, 32)
    ctx[:2] = 0
    ref = jlayers.attention(jp, jnp.asarray(x), 2, encoder_hidden_states=jnp.asarray(ctx), uncond_prefix=2)
    out = tlayers.attention(tp, torch.from_numpy(x), 2, encoder_hidden_states=torch.from_numpy(ctx), uncond_prefix=2)
    _close(out, ref)
    # the skipped branches equal what full attention over zero context gives
    full = tlayers.attention(tp, torch.from_numpy(x), 2, encoder_hidden_states=torch.from_numpy(ctx))
    _close(out, full.numpy(), atol=1e-6)


@pytest.mark.parametrize("table_batch", [0, 2])
def test_attention_self_rope_norm(table_batch):
    jp, tp = _bridge(jlayers.init_attention(jax.random.PRNGKey(2), 64, 2, qk_norm=True, bias=False))
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 11, 64)
    pos = rng.random((max(table_batch, 1), 11)).astype(np.float32) * 9
    from actionmesh_tpu.ops.rotary import compute_rotary_embeddings as jrot

    tabs = [jrot(32, jnp.asarray(p), layout="half") for p in pos]
    cos = np.stack([np.asarray(c) for c, _ in tabs])
    sin = np.stack([np.asarray(s) for _, s in tabs])
    if table_batch == 0:
        cos, sin = cos[0], sin[0]
    ref = jlayers.attention(jp, jnp.asarray(x), 2, freqs_rot=(jnp.asarray(cos), jnp.asarray(sin)), rope_layout="half")
    out = tlayers.attention(tp, torch.from_numpy(x), 2, freqs_rot=(torch.from_numpy(cos), torch.from_numpy(sin)))
    _close(out, ref)


@pytest.mark.parametrize("gelu_approx", [False, True])
def test_flow_matching_block_inflated_with_skip(gelu_approx):
    jp, tp = _bridge(jlayers.init_flow_matching_block(
        jax.random.PRNGKey(4), 64, 2, cross_attention_dim=32, attention_qk_norm=True,
        attention_bias=False, ff_inner_dim=128, skip=True,
    ))
    rng = np.random.default_rng(5)
    T, N = 3, 7
    x = _rand(rng, 2 * T, N, 64)
    skip = _rand(rng, 2 * T, N, 64)
    ctx = _rand(rng, 2 * T, 5, 32)
    framestep = np.tile(np.arange(T, dtype=np.float32), (2, 1))
    jcfg = jden.DenoiserConfig(width=64, num_attention_heads=2)
    jcos, jsin = jden.precompute_freqs_rot(jcfg, jnp.asarray(framestep), N - 1)
    tcos, tsin = tden.precompute_freqs_rot(
        tden.DenoiserConfig(width=64, num_attention_heads=2), torch.from_numpy(framestep), N - 1
    )
    _close(tcos, jcos, atol=1e-6)
    ref = jlayers.flow_matching_block(
        jp, jnp.asarray(x), 2, encoder_hidden_states=jnp.asarray(ctx),
        freqs_rot=(jcos, jsin), skip=jnp.asarray(skip), inflate_n_frames=T,
        rope_layout="half", gelu_approx=gelu_approx,
    )
    out = tlayers.flow_matching_block(
        tp, torch.from_numpy(x), 2, encoder_hidden_states=torch.from_numpy(ctx),
        freqs_rot=(tcos, tsin), skip=torch.from_numpy(skip), inflate_n_frames=T,
        gelu_approx=gelu_approx,
    )
    _close(out, ref)


TINY_DENOISER = dict(
    num_tokens_nominal=8, temporal_context_size=4, in_channels=8, num_layers=3,
    num_attention_heads=2, width=64, mlp_ratio=2.0, cross_attention_dim=16,
    inflated_layers=(0, 2),  # block 1 per-frame; block 2 takes the U-skip
)


@pytest.mark.parametrize("gelu_approx", [False, True])
def test_denoiser_forward(gelu_approx):
    jcfg = jden.DenoiserConfig(**TINY_DENOISER, gelu_approx=gelu_approx)
    tcfg = tden.DenoiserConfig(**TINY_DENOISER, gelu_approx=gelu_approx)
    jp, tp = _bridge(jden.init_denoiser(jax.random.PRNGKey(6), jcfg))
    rng = np.random.default_rng(7)
    B, T, N = 2, 4, 8
    x = _rand(rng, B, T, N, 8)
    ctx = _rand(rng, B, T, 5, 16)
    ctx[0] = 0  # an unconditional branch: its cross-attention is skipped
    framestep = np.tile(np.arange(3, 3 + T, dtype=np.float32), (B, 1))
    dt = np.array([700.0, 250.0], np.float32)
    mask = np.array([[1, 0, 0, 1], [0, 0, 1, 0]], np.float32)
    ref = jden.denoiser_forward(
        jp, jcfg, *(jnp.asarray(a) for a in (x, ctx, framestep, dt)),
        mask=jnp.asarray(mask), uncond_batch=1,
    )
    out = tden.denoiser_forward(
        tp, tcfg, *(torch.from_numpy(a) for a in (x, ctx, framestep, dt)),
        mask=torch.from_numpy(mask), uncond_batch=1,
    )
    assert out.shape == (B, T, N, 8)
    _close(out, ref)


def test_denoise_window_loop():
    """The Euler loop with CFG, frozen ground-truth frames and fp32 steps."""
    jcfg = jden.DenoiserConfig(**TINY_DENOISER)
    tcfg = tden.DenoiserConfig(**TINY_DENOISER)
    jp, tp = _bridge(jden.init_denoiser(jax.random.PRNGKey(8), jcfg))
    rng = np.random.default_rng(9)
    T, N = 4, 8
    init = _rand(rng, 1, T, N, 8)
    ctx = _rand(rng, 1, T, 5, 16)
    mask = np.array([[1, 0, 0, 0]], np.int32)
    framestep = np.arange(T, dtype=np.float32)[None]
    ts, dist = get_schedule(3, 1000, 3.0)
    flags, scales = [[0, 1], [1, 1]], [7.5]
    ref = jloop.denoise_window(
        jp, jcfg, jguidance(flags, scales), jnp.asarray(init), jnp.asarray(ctx),
        jnp.asarray(mask), jnp.asarray(framestep), jnp.asarray(ts), jnp.asarray(dist),
    )
    out = tloop.denoise_window(
        tp, tcfg, tguidance(flags, scales), torch.from_numpy(init), torch.from_numpy(ctx),
        torch.from_numpy(mask), torch.from_numpy(framestep), torch.from_numpy(ts),
        torch.from_numpy(dist),
    )
    np.testing.assert_array_equal(out[0, 0].numpy(), init[0, 0])  # frozen
    _close(out, ref)


@pytest.mark.parametrize("against", ["port_batched", "jax_split"])
def test_denoise_window_split_cfg_batch(against):
    """``split_cfg_batch`` runs the guidance branches one after the other:
    the same fp32 arithmetic as the batched run, branch by branch (1e-5:
    sums over other batch shapes), and JAX's split path on the same inputs
    (the model-level 5e-4)."""
    jcfg = jden.DenoiserConfig(**TINY_DENOISER)
    tcfg = tden.DenoiserConfig(**TINY_DENOISER)
    jp, tp = _bridge(jden.init_denoiser(jax.random.PRNGKey(12), jcfg))
    rng = np.random.default_rng(13)
    T, N = 4, 8
    init = _rand(rng, 1, T, N, 8)
    ctx = _rand(rng, 1, T, 5, 16)
    mask = np.array([[1, 0, 1, 0]], np.int32)
    framestep = np.arange(2, 2 + T, dtype=np.float32)[None]
    ts, dist = get_schedule(3, 1000, 3.0)
    flags, scales = [[0, 1], [1, 1]], [7.5]
    t_args = (
        tp, tcfg, tguidance(flags, scales), torch.from_numpy(init), torch.from_numpy(ctx),
        torch.from_numpy(mask), torch.from_numpy(framestep), torch.from_numpy(ts),
        torch.from_numpy(dist),
    )
    out = tloop.denoise_window(*t_args, split_cfg_batch=True)
    np.testing.assert_array_equal(out[0, 0].numpy(), init[0, 0])  # frozen
    if against == "port_batched":
        _close(out, tloop.denoise_window(*t_args).numpy(), atol=1e-5)
    else:
        ref = jloop.denoise_window(
            jp, jcfg, jguidance(flags, scales), jnp.asarray(init), jnp.asarray(ctx),
            jnp.asarray(mask), jnp.asarray(framestep), jnp.asarray(ts), jnp.asarray(dist),
            split_cfg_batch=True,
        )
        _close(out, ref)


TINY_AE = dict(temporal_context_size=4, latent_channels=8, width=64, num_layers=3, num_attention_heads=2)


@pytest.mark.parametrize("B", [1, 2])
def test_autoencoder_forward(B):
    """B=1 takes the 2-D RoPE tables; the final block is the fp32 island."""
    jcfg = jae.AutoencoderConfig(**TINY_AE, gelu_approx=False)
    tcfg = tae.AutoencoderConfig(**TINY_AE, gelu_approx=False)
    jp, tp = _bridge(jae.init_autoencoder(jax.random.PRNGKey(10), jcfg))
    assert tp["blocks"][-1]["x_attn"]["to_q"]["weight"].dtype == torch.float32
    rng = np.random.default_rng(11)
    T, N, V = 4, 6, 37
    latent = _rand(rng, B, T, N, 8)
    framestep = np.tile(np.arange(T, dtype=np.float32), (B, 1))
    src = np.zeros(B, np.float32)
    tgt = np.tile(np.array([1 / 3, 2 / 3, 1.0], np.float32), (B, 1))
    query = _rand(rng, B, V, 6, scale=0.5)
    ref = jae.autoencoder_forward(jp, jcfg, *(jnp.asarray(a) for a in (latent, framestep, src, tgt, query)))
    out = tae.autoencoder_forward(tp, tcfg, *(torch.from_numpy(a) for a in (latent, framestep, src, tgt, query)))
    assert out.shape == (B, 3, V, 3)
    _close(out, ref)


def test_dinov2_forward():
    jcfg = jdino.DinoV2Config(hidden_size=32, num_layers=2, num_heads=2, image_size=70)
    tcfg = tdino.DinoV2Config(**dataclasses.asdict(jcfg))
    jp, tp = _bridge(jdino.init_dinov2(jax.random.PRNGKey(12), jcfg))
    # LayerScale starts at 1e-5; make the blocks matter
    for jb, tb in zip(jp["blocks"], tp["blocks"]):
        for key in ("layer_scale1", "layer_scale2"):
            jb[key]["lambda1"] = jnp.full((32,), 0.5, jnp.float32)
            tb[key]["lambda1"] = torch.full((32,), 0.5)
    pixels = _rand(np.random.default_rng(13), 2, 224, 224, 3)
    ref = jdino.dinov2_forward(jp, jcfg, jnp.asarray(pixels))
    out = tdino.dinov2_forward(tp, tcfg, torch.from_numpy(pixels))
    assert out.shape == (2, 257, 32)
    _close(out, ref)
