"""Kernel A's and kernels C and D's fp32 paths: the split into TF32 parts, the
pre-passes' layouts and the plain models of their split-precision (3xTF32)
arithmetic, on the CPU.

``tf32_split`` defines the split to the bit (the CUDA pre-pass and the
kernel's register splits use the same bit operations);
``split_precision_attention_reference`` forms every product of QK^T and PV
from split operands as the kernel does. Both are held against JAX's Pallas
flash kernels (interpret mode) and against the exact fp32 decode of a tiny
TripoSG Stage 0. Inputs are made with numpy from fixed seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actionmesh_tpu.ops.flash_attention import (
    flash_attention as jflash,
    flash_attention_pipelined as jflash_pipelined,
)
from actionmesh_tpu_torch.models import layers as tlayers
from actionmesh_tpu_torch.models import stage0 as tstage0
from actionmesh_tpu_torch.models.dinov2 import DinoV2Config as TDinoCfg
from actionmesh_tpu_torch.models.image_encoder import ImageEncoder as TImageEncoder
from actionmesh_tpu_torch.models.triposg.dit import triposg_dit_config
from actionmesh_tpu_torch.models.triposg.pipeline import TripoSGPipeline
from actionmesh_tpu_torch.models.triposg.vae import TripoSGVAEConfig, decode_kv, query_sdf_at_ids
from actionmesh_tpu_torch.ops.flash_attention import (
    bwd_split_reference,
    bwd_split_workspace,
    split_kv_reference,
    split_precision_attention_bwd_reference,
    split_precision_attention_reference,
    split_workspace,
    tf32_split,
    vt_key_order,
)

# ---------------------------------------------------------------------------
# The split
# ---------------------------------------------------------------------------


def _inputs(kind: str) -> np.ndarray:
    rng = np.random.default_rng(0)
    if kind == "random":
        return (rng.standard_normal(4096) * np.exp2(rng.integers(-20, 20, 4096))).astype(np.float32)
    if kind == "tiny":
        return (rng.standard_normal(4096) * 1e-35).astype(np.float32)
    if kind == "huge":
        # up to the largest finite fp32, where rounding up would overflow
        big = np.array([np.finfo(np.float32).max, -np.finfo(np.float32).max], np.float32)
        return np.concatenate([(rng.uniform(-1, 1, 4094) * 3e38).astype(np.float32), big])
    if kind == "subnormal":
        bits = rng.integers(1, 0x800000, 4096, dtype=np.uint32) | (rng.integers(0, 2, 4096, dtype=np.uint32) << 31)
        return bits.view(np.float32)
    if kind == "ties":
        # exactly half a TF32 step above a TF32 value: ties go away from zero
        base = (rng.integers(0, 1 << 10, 4096, dtype=np.uint32) << 13) | 0x3F800000 | 0x1000
        return (base | (rng.integers(0, 2, 4096, dtype=np.uint32) << 31)).view(np.float32)
    if kind == "zero_inf":
        return np.array([0.0, -0.0, np.inf, -np.inf, 1.0, -2.5], np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["random", "tiny", "huge", "subnormal", "ties", "zero_inf"])
def test_tf32_split_is_exact(kind):
    """hi + lo == x exactly; hi has its low 13 mantissa bits zero; |lo| is at
    most half a TF32 step: 2^-11 |x| for normal x, 2^-137 for subnormals."""
    x = torch.from_numpy(_inputs(kind))
    hi, lo = tf32_split(x)
    assert torch.equal(hi + lo, x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    normal = x.abs() >= torch.finfo(torch.float32).tiny
    finite = torch.isfinite(x)
    assert (lo[normal & finite].abs() <= 2.0**-11 * x[normal & finite].abs()).all()
    assert (lo[~normal].abs() <= 2.0**-137).all()
    assert (lo[~finite] == 0).all()
    if kind == "ties":
        assert (hi.abs() > x.abs()).all()
    if kind == "zero_inf":
        assert torch.equal(hi.view(torch.int32), x.view(torch.int32))  # signs of zero kept


def test_split_kv_reference_layout():
    """The plain pre-pass: k split in place; v^T split with the keys of each
    group of 8 in the order 0,2,4,6,1,3,5,7 and zero keys up to Skp; the
    workspace views have those shapes."""
    rng = np.random.default_rng(1)
    B, H, Sk, D = 2, 3, 21, 64
    k = torch.from_numpy(rng.standard_normal((B, H, Sk, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, H, Sk, D)).astype(np.float32))
    kh, kl, vh, vl = split_kv_reference(k, v)
    assert torch.equal(kh + kl, k)
    skp = 24
    assert vt_key_order(16).tolist() == [0, 2, 4, 6, 1, 3, 5, 7, 8, 10, 12, 14, 9, 11, 13, 15]
    vt = (vh + vl).transpose(-1, -2)  # (B, H, Skp, D), permuted keys
    order = vt_key_order(skp)
    assert torch.equal(vt[:, :, order < Sk], v[:, :, order[order < Sk]])
    assert not vt[:, :, order >= Sk].any()
    _, views = split_workspace(B, H, Sk, D, "cpu")
    assert [tuple(t.shape) for t in views] == [(B, H, Sk, D)] * 2 + [(B, H, D, skp)] * 2


# ---------------------------------------------------------------------------
# The plain model of the arithmetic vs JAX's Pallas kernels (fp32)
# ---------------------------------------------------------------------------

PIPELINED = dict(block_q=128, block_k=128, unroll=2)
# the fp32 cases of tests/test_torch_ops.py:FLASH_CASES
FP32_CASES = [
    # name, jax entry, D, Sq, Sk, mask, stats
    ("one-block D64 ragged", "one", 64, 200, 300, False, True),
    ("one-block D128 mask", "one", 128, 130, 260, True, True),
    ("pipelined D128 ragged", "pipe", 128, 300, 700, False, True),
    ("pipelined D64 mask", "pipe", 64, 140, 520, True, False),
]


@pytest.mark.parametrize("case", FP32_CASES, ids=[c[0] for c in FP32_CASES])
def test_split_precision_reference_matches_pallas(case):
    """Within 2e-5 of the output's largest magnitude: each product of the
    split operands loses at most ~2^-21 of itself (lo*lo dropped, lo read
    as TF32), ~1e-6 of the output after the sums; 2e-5 keeps plain TF32
    (~1e-3 of a product) out."""
    _, entry, D, Sq, Sk, with_mask, stats = case
    rng = np.random.default_rng(0)
    B, H = 2, 2
    q, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32) for S in (Sq, Sk, Sk))
    mask = None
    if with_mask:
        mask = rng.random((B, Sk)) > 0.4
        mask[:, 0] = True
    fn = jflash if entry == "one" else jflash_pipelined
    kw = {} if entry == "one" else PIPELINED
    ref = fn(*(jnp.asarray(a) for a in (q, k, v)),
             kv_mask=None if mask is None else jnp.asarray(mask), return_stats=stats, **kw)
    out = split_precision_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)),
        kv_mask=None if mask is None else torch.from_numpy(mask), return_stats=stats,
    )
    if stats:
        (ref, (m_ref, l_ref)), (out, (m, l)) = ref, out
        np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), atol=1e-5)
        np.testing.assert_allclose(l.numpy(), np.asarray(l_ref), rtol=1e-5)
    ref = np.asarray(ref)
    assert out.dtype == torch.float32 and out.shape == (B, H, Sq, D)
    assert np.abs(out.numpy() - ref).max() <= 2e-5 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# Kernels C and D's fp32 path: the pre-pass and the plain model of the backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_transposed", [1, 2])
def test_bwd_split_reference_layout(n_transposed):
    """The plain pre-pass of kernel C (q and dO, both transposed) or D (k
    transposed, v): both inputs split in place; the transposed ones with the
    rows of each group of 8 in the order 0,2,4,6,1,3,5,7 (an accumulator's
    columns as A fragments) and zero rows up to Sp; strided inputs (heads
    split off a (B, S, H*D) tensor) give the same; the workspace holds
    exactly those tensors."""
    rng = np.random.default_rng(2)
    B, H, S, D = 2, 3, 21, 64
    x0, x1 = (torch.from_numpy(rng.standard_normal((B, S, H * D)).astype(np.float32))
              .view(B, S, H, D).transpose(1, 2) for _ in range(2))
    views = bwd_split_reference(x0, x1, n_transposed)
    assert len(views) == 4 + 2 * n_transposed
    assert torch.equal(views[0] + views[1], x0) and torch.equal(views[2] + views[3], x1)
    dense = bwd_split_reference(x0.contiguous(), x1.contiguous(), n_transposed)
    assert all(torch.equal(a, b) for a, b in zip(views, dense))
    sp = 24
    order = vt_key_order(sp)
    for j, x in enumerate((x0, x1)[:n_transposed]):
        hi, lo = views[4 + 2 * j], views[5 + 2 * j]
        assert not (hi.view(torch.int32) & 0x1FFF).any()
        xt = (hi + lo).transpose(-1, -2)  # (B, H, Sp, D), rows permuted
        assert torch.equal(xt[:, :, order < S], x[:, :, order[order < S]])
        assert not xt[:, :, order >= S].any()
    assert [tuple(t.shape) for t in views] == [(B, H, S, D)] * 4 + [(B, H, D, sp)] * 2 * n_transposed
    ws = bwd_split_workspace(B, H, S, D, n_transposed, "cpu")
    assert ws.dtype == torch.float32 and ws.numel() == sum(t.numel() for t in views)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Sq,Sk", [(200, 400), (129, 385)])
def test_split_precision_bwd_reference_matches_jax(Sq, Sk, D):
    """The plain model of kernels C and D's fp32 arithmetic (32-row steps,
    split products, each step's share added in fp32) against JAX's flash
    backward in fp32 from JAX's own o, m, l, within 2e-4 as the card
    kernels' CPU path is held in tests/test_torch_ops.py: each split
    product loses ~2^-21 of itself, and the sums run in another order. 129
    queries and 385 keys leave one row in the last 32-row step and in the
    last 128-row tile of either kernel."""
    from actionmesh_tpu.ops.flash_attention_bwd import flash_attention_bwd as jbwd

    rng = np.random.default_rng(11)
    B, H = 2, 2
    q, do = rng.standard_normal((2, B, H, Sq, D)).astype(np.float32)
    k, v = rng.standard_normal((2, B, H, Sk, D)).astype(np.float32)
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    o, (m, l) = jflash_pipelined(jq, jk, jv, return_stats=True, **PIPELINED)
    ref = jbwd(jq, jk, jv, o, m, l, jdo, block_q=128, block_k=128)
    out = split_precision_attention_bwd_reference(
        *(torch.from_numpy(np.array(x)) for x in (jq, jk, jv, o, m, l, jdo))
    )
    for a, b, name in zip(out, ref, "qkv"):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=2e-4, err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# The tiny TripoSG decode with the split arithmetic in every attention
# ---------------------------------------------------------------------------

TINY_VAE = dict(
    latent_channels=8, num_tokens=16, encoder_width=32, encoder_layers=2, encoder_heads=2,
    decoder_width=32, decoder_layers=2, decoder_heads=2,
)
TINY_DIT = dict(
    num_tokens=16, in_channels=8, num_layers=3, width=64, num_attention_heads=2,
    cross_attention_dim=32,
)
TINY_DINO = dict(hidden_size=32, num_layers=2, num_heads=2, patch_size=14, image_size=70)
DECODE = dict(dense_octree_depth=4, hierarchical_octree_depth=5, prefilter_octree_depth=3)


def _split_attention(q, k, v, scale=None, kv_mask=None, trainable=False, mesh=None,
                     sequence_parallel=False):
    return split_precision_attention_reference(q, k, v, scale=scale, kv_mask=kv_mask)


def _fine_lattice(pipe, latents):
    """Regularized field values on the whole fine lattice of the decode."""
    R = (1 << DECODE["hierarchical_octree_depth"]) + 1
    idx = np.arange(-(-R**3 // 4096) * 4096)
    ijk = np.stack([idx // (R * R), (idx // R) % R, idx % R], -1).astype(np.int32)
    kv = decode_kv(pipe.vae_params, pipe.vae_cfg, latents)
    return query_sdf_at_ids(
        pipe.vae_params, pipe.vae_cfg, kv, ijk, np.full(3, -1.005), np.full(3, 2.01 / (R - 1)),
        chunk=4096, regularizer=tstage0._dev_sdf_regularizer_torch,
    )[: R**3]


def test_split_precision_keeps_the_tiny_decode(monkeypatch):
    """The settings of tests/test_torch_triposg.py's tiny pipeline: latents
    sampled with exact fp32 attention, then decoded twice, exact and with
    the split arithmetic in place of every attention. No fine-lattice value
    changes sign, the faces are equal and the vertices agree within 1e-5."""
    cpu = torch.device("cpu")
    pipe = TripoSGPipeline.from_random(
        seed=0, dtype=torch.float32, dit_cfg=triposg_dit_config(**TINY_DIT),
        vae_cfg=TripoSGVAEConfig(**TINY_VAE),
        image_encoder=TImageEncoder(cpu, torch.float32, TDinoCfg(**TINY_DINO)), device=cpu,
    )
    pipe.sdf_regularizer = tstage0._dev_sdf_regularizer
    pipe.sdf_regularizer_torch = tstage0._dev_sdf_regularizer_torch
    image = np.random.default_rng(6).integers(0, 255, (64, 64, 3), dtype=np.uint8)
    latents, exact_mesh = pipe(image, seed=1, num_inference_steps=3, guidance_scale=7.5, **DECODE)
    exact = _fine_lattice(pipe, latents)

    monkeypatch.setattr(tlayers, "dot_product_attention", _split_attention)
    split_mesh = pipe.decode_latents(latents, **DECODE)[0]
    split = _fine_lattice(pipe, latents)

    assert (exact < 0).any() and (exact > 0).any()
    assert not ((exact < 0) != (split < 0)).any()
    assert exact_mesh.n_faces > 100
    np.testing.assert_array_equal(split_mesh.faces, exact_mesh.faces)
    np.testing.assert_allclose(split_mesh.vertices, exact_mesh.vertices, atol=1e-5)
