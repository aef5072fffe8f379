"""Port ops vs the JAX package's ops, on CPU, from the same numpy inputs.

The port's kernel wrappers take their plain PyTorch versions on CPU
tensors; the JAX Pallas kernels run in interpret mode (``interpret=None``
picks it off-TPU). Tolerances are stated per test with their reason.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actionmesh_tpu.ops import chunking as jchunk
from actionmesh_tpu.ops import embeddings as jemb
from actionmesh_tpu.ops import rotary as jrot
from actionmesh_tpu.ops.flash_attention import (
    flash_attention as jflash,
    flash_attention_pipelined as jflash_pipelined,
)
from actionmesh_tpu.ops.rope_norm import fused_rms_rope as jfused_rms_rope
from actionmesh_tpu_torch.ops import chunking as tchunk
from actionmesh_tpu_torch.ops import embeddings as temb
from actionmesh_tpu_torch.ops.flash_attention import flash_attention
from actionmesh_tpu_torch.ops.rope_norm import fused_rms_rope
from actionmesh_tpu_torch.ops.rotary import compute_rotary_embeddings


def _t(a, dtype=None):
    """numpy -> torch (bf16 through fp32, since numpy has no bf16)."""
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(dtype) if dtype is not None else t


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, dtype=np.float32)).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------------
# Flash attention (kernel A's plain version) vs the two Pallas entry points
# ---------------------------------------------------------------------------

# Small blocks reach the pipelined path. Its "edge" mode masks only the
# last KV sub-block, so ragged cases keep Sk's padding (to a multiple of
# block_k * unroll) under one block_k, as at the main path's Sk = 32,784.
PIPELINED = dict(block_q=128, block_k=128, unroll=2)

FLASH_CASES = [
    # name, jax entry, D, dtype, Sq, Sk, mask, stats
    ("one-block fp32 D64 ragged", "one", 64, "f32", 200, 300, False, True),
    ("one-block fp32 D128 mask", "one", 128, "f32", 130, 260, True, True),
    ("pipelined fp32 D128 ragged", "pipe", 128, "f32", 300, 700, False, True),
    ("pipelined fp32 D64 mask", "pipe", 64, "f32", 140, 520, True, False),
    ("one-block bf16 D64", "one", 64, "bf16", 257, 257, False, False),
    ("pipelined bf16 D128 ragged", "pipe", 128, "bf16", 200, 700, False, False),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_plain_matches_pallas(case):
    _, entry, D, dt, Sq, Sk, with_mask, stats = case
    rng = np.random.default_rng(0)
    B, H = 2, 2
    q = rng.standard_normal((B, H, Sq, D))
    k = rng.standard_normal((B, H, Sk, D))
    v = rng.standard_normal((B, H, Sk, D))
    mask = None
    if with_mask:
        mask = rng.random((B, Sk)) > 0.4
        mask[:, 0] = True
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)

    fn = jflash if entry == "one" else jflash_pipelined
    kw = {} if entry == "one" else PIPELINED
    ref = fn(
        _j(q, jdt), _j(k, jdt), _j(v, jdt),
        kv_mask=None if mask is None else jnp.asarray(mask),
        return_stats=stats, **kw,
    )
    out = flash_attention(
        _t(q, tdt), _t(k, tdt), _t(v, tdt),
        kv_mask=None if mask is None else torch.from_numpy(mask),
        return_stats=stats,
    )
    if stats:
        (ref, (m_ref, l_ref)), (out, (m, l)) = ref, out
        # fp32 dot products summed in another order: ~1e-6 relative
        np.testing.assert_allclose(_np(m), _np(m_ref), atol=1e-5)
        np.testing.assert_allclose(_np(l), _np(l_ref), rtol=1e-5)
    assert out.dtype == tdt and out.shape == (B, H, Sq, D)
    if dt == "f32":
        np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)
    else:
        # bf16: the pipelined TPU kernel rounds q*scale to bf16 before QK^T,
        # the port scales fp32 scores; P's rounding to bf16 then differs at
        # a few entries. 1e-2 of the output range covers both.
        err = np.abs(_np(out) - _np(ref)).max()
        assert err <= 1e-2 * np.abs(_np(ref)).max(), err


def test_flash_fully_masked_row_is_finite_and_matches():
    """A batch entry with every key masked gives the mean of v (no NaN),
    as the TPU kernel does when Sk needs no block padding."""
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 2, 64, 64))
    k = rng.standard_normal((2, 2, 128, 64))
    v = rng.standard_normal((2, 2, 128, 64))
    mask = np.ones((2, 128), bool)
    mask[1] = False
    ref = jflash(_j(q), _j(k), _j(v), kv_mask=jnp.asarray(mask))
    out = flash_attention(_t(q), _t(k), _t(v), kv_mask=torch.from_numpy(mask))
    assert np.isfinite(_np(out)).all()
    np.testing.assert_allclose(_np(out), _np(ref), atol=1e-5)
    np.testing.assert_allclose(_np(out)[1], np.broadcast_to(v[1].mean(1, keepdims=True), (2, 64, 64)), atol=1e-5)


def test_flash_strided_views_match_contiguous():
    """Heads split off a (B, S, H*D) projection (a strided view) give the
    same result as contiguous (B, H, S, D) inputs."""
    rng = np.random.default_rng(2)
    x = _t(rng.standard_normal((2, 70, 4 * 64)))
    view = x.view(2, 70, 4, 64).transpose(1, 2)
    a = flash_attention(view, view, view)
    b = flash_attention(view.contiguous(), view.contiguous(), view.contiguous())
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# Fused rms-norm + RoPE (kernel B's plain version) vs the Pallas kernel
# ---------------------------------------------------------------------------

ROPE_CASES = [
    # name, norm, rope, table batch (0 = 2-D table), dtype
    ("norm+rope 3-D tables", True, True, 2, "f32"),
    ("norm+rope shared 3-D table", True, True, 1, "f32"),
    ("rope-only 2-D table", False, True, 0, "f32"),
    ("norm-only", True, False, None, "f32"),
    ("norm+rope bf16", True, True, 2, "bf16"),
    ("rope-only bf16 2-D table", False, True, 0, "bf16"),
]


@pytest.mark.parametrize("case", ROPE_CASES, ids=[c[0] for c in ROPE_CASES])
def test_rms_rope_plain_matches_pallas(case):
    _, with_norm, with_rope, cb, dt = case
    rng = np.random.default_rng(3)
    B, H, S, D = 2, 3, 50, 128
    x = rng.standard_normal((B, H, S, D)) * 3
    scale = rng.standard_normal(D) * 0.2 + 1 if with_norm else None
    cos = sin = None
    if with_rope:
        pos = rng.random((max(cb, 1), S)) * 15
        tabs = [compute_rotary_embeddings(D, torch.from_numpy(p).float()) for p in pos]
        cos = torch.stack([c for c, _ in tabs]).numpy()
        sin = torch.stack([s for _, s in tabs]).numpy()
        if cb == 0:
            cos, sin = cos[0], sin[0]
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    ref = jfused_rms_rope(
        _j(x, jdt), None if scale is None else _j(scale),
        None if cos is None else _j(cos), None if sin is None else _j(sin),
    )
    out = fused_rms_rope(
        _t(x, tdt), None if scale is None else _t(scale),
        None if cos is None else _t(cos), None if sin is None else _t(sin),
    )
    assert out.dtype == tdt
    if dt == "f32":
        # fp32 reductions in another order: a few ulp
        np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)
    else:
        # both round one fp32 result to bf16: at most one bf16 ulp apart
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(_np(ref)), 1e-30))) - 7)
        assert (np.abs(_np(out) - _np(ref)) <= ulp).all()


# ---------------------------------------------------------------------------
# Small ops
# ---------------------------------------------------------------------------

def test_rotary_tables_match():
    pos = np.random.default_rng(4).random(37).astype(np.float32) * 30
    jc, js = jrot.compute_rotary_embeddings(64, jnp.asarray(pos), layout="half")
    tc, ts = compute_rotary_embeddings(64, torch.from_numpy(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)


def test_embeddings_match():
    rng = np.random.default_rng(5)
    t = (rng.random((3, 5)) * 1000).astype(np.float32)
    np.testing.assert_allclose(
        temb.sinusoidal_timestep_embedding(torch.from_numpy(t), 64).numpy(),
        np.asarray(jemb.sinusoidal_timestep_embedding(jnp.asarray(t), 64)),
        atol=1e-4,  # sin/cos of arguments up to 1000 in fp32
    )
    a, b = rng.random((2, 4)).astype(np.float32), rng.random((2, 4)).astype(np.float32)
    np.testing.assert_allclose(
        temb.timestep_embedder(torch.from_numpy(a), torch.from_numpy(b), frequency_embedding_size=32).numpy(),
        np.asarray(jemb.timestep_embedder(jnp.asarray(a), jnp.asarray(b), frequency_embedding_size=32)),
        atol=1e-6,
    )
    xyz = (rng.random((2, 7, 3)) * 2 - 1).astype(np.float32)
    np.testing.assert_allclose(
        temb.frequency_positional_embedding(torch.from_numpy(xyz)).numpy(),
        np.asarray(jemb.frequency_positional_embedding(jnp.asarray(xyz))),
        atol=1e-5,
    )
    ts = np.arange(3, 19, dtype=np.float32)[None]
    np.testing.assert_array_equal(
        temb.scale_timestep(torch.from_numpy(ts)).numpy(),
        np.asarray(jemb.scale_timestep(jnp.asarray(ts))),
    )
    out_j = jemb.interpolate_timesteps(ts, 1, drop_first=True)
    np.testing.assert_array_equal(temb.interpolate_timesteps(ts, 1, drop_first=True), out_j)
    t_min, t_range = temb.get_scaling(ts)
    np.testing.assert_array_equal(
        temb.apply_scaling(out_j, t_min, t_range),
        np.asarray(jemb.apply_scaling(jnp.asarray(out_j), *jemb.get_scaling(jnp.asarray(ts)))),
    )


@pytest.mark.parametrize("total", [16, 17, 31, 40])
def test_chunk_from_matches(total):
    for start in sorted({0, 1, total // 2, total - 2, total - 1}):
        a = tchunk.chunk_from(start, total, 16, 15)
        b = jchunk.chunk_from(start, total, 16, 15)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("src,dst", [(37, 16), (5, 16), (16, 16)])
def test_dino_pos_embed_resample_matches_jax_image_resize(src, dst):
    """The port's numpy resample matrix reproduces jax.image.resize
    "bicubic" (Keys a=-0.5, antialiased when downsampling)."""
    from actionmesh_tpu.models.dinov2 import DinoV2Config as JCfg
    from actionmesh_tpu.models.dinov2 import _interpolate_pos_embed
    from actionmesh_tpu_torch.models.dinov2 import interpolate_pos_embed

    pe = np.random.default_rng(6).standard_normal((1, src * src + 1, 8)).astype(np.float32)
    ref = _interpolate_pos_embed(jnp.asarray(pe), dst, JCfg())
    out = interpolate_pos_embed(torch.from_numpy(pe), dst)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_preprocess_for_dino_matches_pil():
    """torch antialiased bicubic vs PIL bicubic (the JAX package's resize).

    Both use the a=-0.5 kernel in two passes rounded to uint8; PIL's
    coefficients are 8-bit fixed point, so a pixel may differ by one uint8
    level (1/255/0.225 normalised) and almost none do.
    """
    from PIL import Image

    from actionmesh_tpu.models.image_encoder import preprocess_for_dino as jprep
    from actionmesh_tpu_torch.models.image_encoder import preprocess_for_dino as tprep

    rng = np.random.default_rng(7)
    frames = [
        rng.integers(0, 256, (90, 120, 3), dtype=np.uint8),  # upsample
        rng.integers(0, 256, (400, 300, 3), dtype=np.uint8),  # downsample
        rng.integers(0, 256, (256, 256, 3), dtype=np.uint8),  # unchanged
    ]
    ref = jprep([Image.fromarray(f) for f in frames])
    out = tprep(frames)
    assert out.shape == ref.shape == (3, 224, 224, 3)
    diff = np.abs(out - ref)
    level = 1.0 / 255 / 0.225
    assert diff.max() <= 1.01 * level, diff.max() / level
    assert diff.mean() <= 0.01 * level, diff.mean() / level
    np.testing.assert_array_equal(out[2], ref[2])


def test_schedule_guidance_sphere_match():
    from actionmesh_tpu.models.stage0 import make_uv_sphere as jsphere
    from actionmesh_tpu.sampling.flow_schedule import get_schedule as jsched
    from actionmesh_tpu.sampling.guidance import make_guidance as jguid
    from actionmesh_tpu_torch.models.stage0 import make_uv_sphere as tsphere
    from actionmesh_tpu_torch.sampling.flow_schedule import get_schedule as tsched
    from actionmesh_tpu_torch.sampling.guidance import make_guidance as tguid

    for a, b in zip(tsched(7, 1000, 3.0), jsched(7, 1000, 3.0)):
        np.testing.assert_array_equal(a, b)
    for n_lat, n_lon in ((8, 16), (64, 128)):
        a, b = tsphere(n_lat=n_lat, n_lon=n_lon), jsphere(n_lat=n_lat, n_lon=n_lon)
        np.testing.assert_array_equal(a.faces, b.faces)
        np.testing.assert_allclose(a.vertices, b.vertices, atol=1e-12)
    stacked = np.random.default_rng(8).standard_normal((6, 3)).astype(np.float32)
    g_t = tguid([[0, 0], [0, 1], [1, 1]], [2.0, 7.5])
    g_j = jguid([[0, 0], [0, 1], [1, 1]], [2.0, 7.5])
    np.testing.assert_allclose(
        g_t.aggregate_cfg(torch.from_numpy(stacked)).numpy(),
        np.asarray(g_j.aggregate_cfg(jnp.asarray(stacked))),
        atol=1e-6,
    )
    assert g_t.leading_uncond_image_branches == g_j.leading_uncond_image_branches == 2


# ---------------------------------------------------------------------------
# Trainable attention (kernels A + C + D's plain versions) vs the Pallas
# backward and the chunked custom VJP of the JAX package
# ---------------------------------------------------------------------------

# Ragged Sq/Sk at which the JAX trainable forward is right (ROADMAP Queue 3:
# its pipelined edge mask fails when Sk's padding exceeds one sub-block);
# the same shapes tests/test_flash_bwd.py runs.
TRAIN_SHAPES = [(200, 200), (256, 512), (130, 390)]


def _jax_grads(fn, q, k, v, do):
    import jax

    def loss(q_, k_, v_):
        return jnp.vdot(fn(q_, k_, v_).astype(jnp.float32), do)

    return jax.grad(loss, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))


@pytest.mark.parametrize("sq,sk", TRAIN_SHAPES)
def test_chunked_attention_trainable_grads_match_jax(sq, sk):
    from actionmesh_tpu.ops.attention import chunked_attention_trainable as jchunked_train
    from actionmesh_tpu.ops.flash_attention_bwd import flash_attention_trainable as jflash_train
    from actionmesh_tpu_torch.ops.attention import chunked_attention_trainable
    from actionmesh_tpu_torch.ops.flash_attention import flash_attention_trainable

    rng = np.random.default_rng(10)
    B, H, D = 1, 2, 64
    q, k, v = (rng.standard_normal((B, H, s, D)) for s in (sq, sk, sk))
    do = rng.standard_normal((B, H, sq, D)).astype(np.float32)
    scale = D ** -0.5
    g_flash = _jax_grads(lambda a, b, c: jflash_train(a, b, c, scale, 128, 128), q, k, v, do)
    g_chunk = _jax_grads(lambda a, b, c: jchunked_train(a, b, c, scale, 128, 128), q, k, v, do)

    for fn in (chunked_attention_trainable, flash_attention_trainable):
        tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
        out = fn(tq, tk, tv, scale)
        grads = torch.autograd.grad((out * _t(do)).sum(), (tq, tk, tv))
        for g, gf, gc, name in zip(grads, g_flash, g_chunk, "qkv"):
            # fp32; sums in another order than either JAX path
            np.testing.assert_allclose(_np(g), _np(gf), rtol=2e-4, atol=2e-4, err_msg=f"d{name}")
            np.testing.assert_allclose(_np(g), _np(gc), rtol=2e-4, atol=2e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Sq,Sk", [(200, 400), (129, 385)])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_attention_bwd_from_stats_matches_jax(dt, Sq, Sk, D):
    """The backward from explicitly passed residuals and stats (JAX's own
    o, m, l on both sides), at the edges of the card kernels' tiles: 129
    queries leave one row in the last 64- or 128-row query tile, 385 keys
    one key in the last 128-key tile. The JAX forward pads Sk to a multiple
    of block_k * unroll = 256 by 112 or 127, under block_k (ROADMAP Queue 3)."""
    from actionmesh_tpu.ops.flash_attention_bwd import flash_attention_bwd as jbwd
    from actionmesh_tpu_torch.ops.flash_attention import flash_attention_bwd

    rng = np.random.default_rng(11)
    B, H = 2, 2
    q, do = rng.standard_normal((2, B, H, Sq, D))
    k, v = rng.standard_normal((2, B, H, Sk, D))
    jdt, tdt = (jnp.float32, torch.float32) if dt == "f32" else (jnp.bfloat16, torch.bfloat16)
    jq, jk, jv, jdo = (_j(x, jdt) for x in (q, k, v, do))
    o, (m, l) = jflash_pipelined(jq, jk, jv, return_stats=True, **PIPELINED)
    ref = jbwd(jq, jk, jv, o, m, l, jdo, block_q=128, block_k=128)
    out = flash_attention_bwd(
        *(_t(_np(x), tdt) for x in (jq, jk, jv, o)), _t(_np(m)), _t(_np(l)), _t(_np(jdo), tdt)
    )
    for a, b, name in zip(out, ref, "qkv"):
        assert a.dtype == tdt
        if dt == "f32":
            np.testing.assert_allclose(_np(a), _np(b), rtol=2e-4, atol=2e-4, err_msg=f"d{name}")
        else:
            # bf16: P and dS rounded to bf16 at a few other entries (the TPU
            # kernel scales a bf16-rounded q), plus one rounding of the result
            err = np.abs(_np(a) - _np(b)).max()
            assert err <= 2e-2 * np.abs(_np(b)).max(), (name, err)


def test_launch_errors_name_the_tensor_map_codes():
    """A nonzero return of a C entry point raises, and the message names
    the tensor-map codes of csrc/sm90.cuh apart from CUDA errors."""
    from actionmesh_tpu_torch.ops.flash_attention import _check_launch

    _check_launch("flash_bwd_dq", 0)
    for err, text in ((700, "CUDA error 700"), (10000, "no cuTensorMapEncodeTiled"),
                      (20001, "the tensor-map encode was refused \\(CUresult 1\\)")):
        with pytest.raises(RuntimeError, match=f"flash_bwd_dq launch failed: {text}"):
            _check_launch("flash_bwd_dq", err)


def test_ptxas_report_names_kernels_and_reads_spills():
    """What the build's ``-Xptxas -v`` prints, read into each kernel's
    registers and spill bytes (chip_smoke.py prints them)."""
    from actionmesh_tpu_torch.utils.cuda_build import ptxas_report

    text = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_125flash_bwd_dkv_bf16_kernel"
        "ILi128EEv14CUtensorMap_stS1_S1_S1_NS_6ParamsE' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_125flash_bwd_dkv_bf16_kernel\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, 1536 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116norm_rope_kernelILi64EfEEv"
        "NS_6ParamsEPT0_S3_PKfS5_S5_S5_' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_116norm_rope_kernel\n"
        "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 400 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z16nn_argmin_kernelILi3E13__nv_bfloat16EvPKf'"
        " for 'sm_90a'\n"
        "ptxas info    : Used 64 registers\n"
    )
    assert ptxas_report(text) == [
        {"kernel": "flash_bwd_dkv_bf16_kernel<128>", "registers": 168,
         "spill_store_bytes": 0, "spill_load_bytes": 0},
        {"kernel": "norm_rope_kernel<64, float>", "registers": 40,
         "spill_store_bytes": 12, "spill_load_bytes": 16},
        {"kernel": "nn_argmin_kernel<3, __nv_bfloat16>", "registers": 64,
         "spill_store_bytes": None, "spill_load_bytes": None},
    ]


@pytest.mark.parametrize("with_norm,table_batch", [(True, 2), (True, None), (False, 0)])
def test_rms_rope_grads_match_jax_vjp(with_norm, table_batch):
    import jax

    rng = np.random.default_rng(12)
    B, H, S, D = 2, 3, 40, 64
    x = rng.standard_normal((B, H, S, D)) * 3
    scale = rng.standard_normal(D) * 0.2 + 1 if with_norm else None
    cos = sin = None
    if table_batch is not None:
        pos = rng.random((max(table_batch, 1), S)) * 15
        tabs = [compute_rotary_embeddings(D, torch.from_numpy(p).float()) for p in pos]
        cos = torch.stack([c for c, _ in tabs]).numpy()
        sin = torch.stack([s for _, s in tabs]).numpy()
        if table_batch == 0:
            cos, sin = cos[0], sin[0]
    g = rng.standard_normal((B, H, S, D)).astype(np.float32)
    opt = lambda a: None if a is None else _j(a)
    if with_norm:
        _, vjp = jax.vjp(lambda x_, s_: jfused_rms_rope(x_, s_, opt(cos), opt(sin)), _j(x), _j(scale))
    else:
        _, vjp = jax.vjp(lambda x_: jfused_rms_rope(x_, None, opt(cos), opt(sin)), _j(x))
    ref = vjp(jnp.asarray(g))
    tx = _t(x).requires_grad_()
    ts = _t(scale).requires_grad_() if with_norm else None
    out = fused_rms_rope(tx, ts, None if cos is None else _t(cos), None if sin is None else _t(sin))
    got = torch.autograd.grad(out, [t for t in (tx, ts) if t is not None], _t(g))
    for a, b in zip(got, ref):
        # fp32 reductions in another order
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-4)
