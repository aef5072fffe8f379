"""Kernel E's arithmetic on the CPU: ``nn_argmin_model`` (the split, the
packing and the tiled min-then-rescan of ``csrc/nn_argmin.cu``) against
float64 truth, against JAX's Pallas ``nn_argmin`` in interpret mode, and on
exact duplicates.

An index that differs from another's is accepted only where the float64
squared distances of the two picks agree within NN_TIE_REL * (|x|^2 + max
|y_pick|^2), the scale of the fp32 terms both sum (as ``chip_smoke.py``
judges the kernel on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actionmesh_tpu.ops.nn_argmin import nn_argmin as jnn_argmin
from actionmesh_tpu_torch.ops.flash_attention import tf32_split
from actionmesh_tpu_torch.ops.nn_argmin import (
    OFFSET_SCALE,
    TILE,
    kernel_channels,
    nn_argmin_model,
    nn_argmin_reference,
    packed_operands,
)

NN_TIE_REL = 1e-6
# The Pallas kernel's compensated bf16 split keeps a residual of ~1.5e-5 of
# |x||y| (actionmesh_tpu/ops/nn_argmin.py:59-61): its near-ties are wider.
PALLAS_TIE_REL = 3e-5


def beyond_ties(x, y, a, b, rel=NN_TIE_REL) -> int:
    """Picks a and b (R, N) that differ by more than a near-tie, in float64."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    r, i = np.nonzero(np.asarray(a) != np.asarray(b))
    ya, yb = y[r, np.asarray(a)[r, i]], y[r, np.asarray(b)[r, i]]
    da = ((x[r, i] - ya) ** 2).sum(-1)
    db = ((x[r, i] - yb) ** 2).sum(-1)
    scale = (x[r, i] ** 2).sum(-1) + np.maximum((ya**2).sum(-1), (yb**2).sum(-1))
    return int((np.abs(da - db) > rel * scale).sum())


@pytest.mark.parametrize("C", [1, 3, 5, 8])
def test_packing_splits_each_operand_exactly(C):
    """A = [a_hi | a_lo | a_hi], B = [b_lo | b_hi | b_hi] with a = [-2x, 1,
    s_x], b = [y, |y|^2, 1]: hi is tf32_split's to the bit, hi + lo is the
    operand up to lo's bits below the tensor core's 19, the depth a
    multiple of 8, and every packed distance positive."""
    rng = np.random.default_rng(C)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 5, C)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-1, 1, (2, 7, C)).astype(np.float32))
    A, B = packed_operands(x, y)
    cp = kernel_channels(C)
    c1 = cp + 2
    assert A.shape[-1] == B.shape[-1] == {3: 16, 8: 32}[cp]
    xp = torch.nn.functional.pad(x, (0, cp - C))
    yp = torch.nn.functional.pad(y, (0, cp - C))
    sq_x, sq_y = (xp.double() ** 2).sum(-1), (yp.double() ** 2).sum(-1)
    a = torch.cat([-2 * xp, torch.ones_like(xp[..., :1]), (sq_x * OFFSET_SCALE).float()[..., None]], -1)
    b = torch.cat([yp, sq_y.float()[..., None], torch.ones_like(yp[..., :1])], -1)
    assert torch.equal(A[..., 2 * c1 : 3 * c1], A[..., :c1]) and torch.equal(B[..., 2 * c1 : 3 * c1], B[..., c1 : 2 * c1])
    assert torch.equal(A[..., :cp + 1], tf32_split(a)[0][..., :cp + 1])
    assert torch.equal(B[..., c1 : c1 + cp], tf32_split(b)[0][..., :cp])
    assert not A[..., 3 * c1 :].any() and not B[..., 3 * c1 :].any()
    # lo as the tensor core reads it; the FMA chains within a few fp32 ulps
    assert ((A[..., :c1] + A[..., c1 : 2 * c1] - a).abs() <= 2.0**-20 * a.abs()).all()
    assert ((B[..., c1 : 2 * c1] + B[..., :c1] - b).abs() <= 2.0**-20 * b.abs()).all()
    d = torch.bmm(A.double(), B.double().transpose(1, 2))
    true = ((xp.double()[:, :, None] - yp.double()[:, None]) ** 2).sum(-1) + sq_x[..., None] / 256
    assert (d > 0).all() and ((d - true).abs() <= 1e-6 * (sq_x[..., None] + sq_y[:, None])).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_model_matches_float64_truth_on_near_ties(seed):
    """Points on a coarse grid plus tiny jitter: many neighbours at nearly
    equal distance. Differing picks must be near-ties."""
    rng = np.random.default_rng(seed)
    y = (np.round(rng.uniform(-1, 1, (3, 600, 3)) * 8) / 8).astype(np.float32)
    y += rng.normal(0, 1e-6, y.shape).astype(np.float32)
    # queries halfway between grid points: equidistant to several
    x = (np.round(rng.uniform(-1, 1, (3, 400, 3)) * 8) / 8 + 1 / 16).astype(np.float32)
    got = nn_argmin_model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    d = ((x.astype(np.float64)[:, :, None] - y.astype(np.float64)[:, None]) ** 2).sum(-1)
    truth = d.argmin(-1)
    assert got.dtype == np.int32 and got.shape == (3, 400)
    assert beyond_ties(x, y, got, truth) == 0


@pytest.mark.parametrize("C", [1, 3, 5, 8])
def test_model_matches_jax_pallas(C):
    """Random points, ragged N and M (no multiple of the tile), against the
    Pallas kernel (interpret mode, within its own near-ties), the port's
    plain version and float64 truth."""
    rng = np.random.default_rng(10 + C)
    x = rng.uniform(-1, 1, (2, 301, C)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 2 * TILE + 37, C)).astype(np.float32)
    got = nn_argmin_model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = np.asarray(jnn_argmin(jnp.asarray(x), jnp.asarray(y)))
    plain = nn_argmin_reference(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    truth = ((x.astype(np.float64)[:, :, None] - y.astype(np.float64)[:, None]) ** 2).sum(-1).argmin(-1)
    assert beyond_ties(x, y, got, want, PALLAS_TIE_REL) == 0
    assert beyond_ties(x, y, got, plain) == 0
    assert beyond_ties(x, y, got, truth) == 0


@pytest.mark.parametrize("period", [3, TILE - 3, TILE + 5])
def test_model_picks_the_first_of_exact_duplicates(period):
    """y repeats its first ``period`` points (copies within one tile and
    across tiles); queries sit on them or anywhere: the first copy wins."""
    rng = np.random.default_rng(period)
    base = rng.uniform(-1, 1, (2, period, 3)).astype(np.float32)
    y = base[:, np.arange(3 * period + 10) % period]
    x = np.concatenate([base, rng.uniform(-1, 1, (2, 50, 3)).astype(np.float32)], 1)
    got = nn_argmin_model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert (got < period).all()
    np.testing.assert_array_equal(got[:, :period], np.broadcast_to(np.arange(period), (2, period)))
