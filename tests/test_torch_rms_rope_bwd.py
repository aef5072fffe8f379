"""Kernel B's backward, its plain version on CPU: ``rms_rope_backward_reference``
against JAX's vjp of the Pallas ``fused_rms_rope`` (interpret mode on the
CPU, as ``tests/test_torch_ops.py`` runs it) and against autograd of the
port's plain forward ``rms_rope_reference``, from the same numpy inputs.

Tolerances: fp32 1e-5 of the largest |gradient| (the same closed form,
reductions in another order); bf16 2^-7 of it (dx is rounded once to bf16,
at most one bf16 ulp apart, the fp32 gradients of scale and tables sum
bf16 inputs in another order).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actionmesh_tpu.ops.rope_norm import fused_rms_rope as jfused_rms_rope
from actionmesh_tpu_torch.ops import rope_norm
from actionmesh_tpu_torch.ops.rope_norm import fused_rms_rope, rms_rope_reference
from actionmesh_tpu_torch.ops.rotary import compute_rotary_embeddings

# (norm, tables): tables None, 0 for one (S, D) table, 2 for (B, S, D)
STEPS = [(True, None), (True, 0), (True, 2), (False, 0), (False, 2)]
CASES = [
    (norm, tables, D, dt)
    for (norm, tables), D, dt in itertools.product(STEPS, (64, 128), ("f32", "bf16"))
]
B, H, S = 2, 3, 37  # S ragged: no multiple of any block


def _ids(case):
    norm, tables, D, dt = case
    tab = {None: "no-rope", 0: "table-SD", 2: "tables-BSD"}[tables]
    return f"{'norm' if norm else 'no-norm'}-{tab}-D{D}-{dt}"


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_backward_reference_matches_jax_vjp_and_autograd(case, monkeypatch):
    norm, tables, D, dt = case
    rng = np.random.default_rng(CASES.index(case))
    tdt, jdt = (torch.float32, jnp.float32) if dt == "f32" else (torch.bfloat16, jnp.bfloat16)
    # x as the models give it: a (B, H, S, D) view of a (B, S, H*D) projection
    proj = (rng.standard_normal((B, S, H * D)) * 3).astype(np.float32)
    x_np = np.ascontiguousarray(proj.reshape(B, S, H, D).transpose(0, 2, 1, 3))
    g_np = rng.standard_normal((B, H, S, D)).astype(np.float32)
    scale_np = (rng.standard_normal(D) * 0.2 + 1).astype(np.float32) if norm else None
    cos_np = sin_np = None
    if tables is not None:
        pos = rng.random((max(tables, 1), S)).astype(np.float32) * 15
        tabs = [compute_rotary_embeddings(D, torch.from_numpy(p)) for p in pos]
        cos_np = torch.stack([c for c, _ in tabs]).numpy()
        sin_np = torch.stack([s for _, s in tabs]).numpy()
        if tables == 0:
            cos_np, sin_np = cos_np[0], sin_np[0]

    # the port: autograd through the Function, whose CPU backward must be
    # the plain version
    calls = []
    plain = rope_norm.rms_rope_backward_reference

    def counted(*args, **kw):
        calls.append(args[0].device.type)
        return plain(*args, **kw)

    monkeypatch.setattr(rope_norm, "rms_rope_backward_reference", counted)
    x = torch.from_numpy(proj).to(tdt).view(B, S, H, D).transpose(1, 2).requires_grad_()
    opt = lambda a: None if a is None else torch.from_numpy(a).requires_grad_()
    scale, cos, sin = opt(scale_np), opt(cos_np), opt(sin_np)
    wrt = [t for t in (x, scale, cos, sin) if t is not None]
    g = torch.from_numpy(g_np).to(tdt)
    got = torch.autograd.grad(fused_rms_rope(x, scale, cos, sin), wrt, g)
    assert calls == ["cpu"]

    # autograd of the plain forward
    auto = torch.autograd.grad(rms_rope_reference(x, scale, cos, sin), wrt, g)

    # JAX's custom VJP of the Pallas kernel (interpret mode)
    jx = jnp.asarray(x_np).astype(jdt)
    jopt = lambda a: None if a is None else jnp.asarray(a)
    jargs = [a for a in (jx, jopt(scale_np), jopt(cos_np), jopt(sin_np)) if a is not None]

    def jfn(*args):
        it = iter(args)
        xx = next(it)
        sc = next(it) if norm else None
        cc = next(it) if tables is not None else None
        ss = next(it) if tables is not None else None
        return jfused_rms_rope(xx, sc, cc, ss)

    _, vjp = jax.vjp(jfn, *jargs)
    want = vjp(jnp.asarray(g_np).astype(jdt))

    assert len(got) == len(want) == len(auto)
    for a, b, c in zip(got, want, auto):
        a = a.float().numpy()
        b = np.asarray(jnp.asarray(b).astype(jnp.float32))
        c = c.float().numpy()
        assert a.shape == b.shape == c.shape
        tol = (1e-5 if dt == "f32" else 2.0**-7) * np.abs(b).max()
        assert np.abs(a - b).max() <= tol, (np.abs(a - b).max(), tol)
        assert np.abs(a - c).max() <= tol, (np.abs(a - c).max(), tol)
