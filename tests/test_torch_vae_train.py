"""Port VAE training vs the JAX package's, on CPU, at tiny size.

The TripoSG VAE at head dim 16 (JAX's own VAE test widths), JAX's weights
carried over, the same batches (exact TSDF of a sphere), and on the JAX side
``attn_impl="chunked"`` (the plain attention), on the port's its plain
version on CPU. The posterior noise is JAX's, passed to the port as an
array. Tolerances are stated per test with their reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actionmesh_tpu.models.triposg import vae as jvae
from actionmesh_tpu.training import flow_train as jflow
from actionmesh_tpu.training import vae_train as jvt
from actionmesh_tpu.utils.weights import load_params as jload_params
from actionmesh_tpu_torch.models.triposg import vae as tvae
from actionmesh_tpu_torch.models.stage0 import make_uv_sphere
from actionmesh_tpu_torch.preprocessing.sdf import mesh_tsdf, sample_sdf_queries
from actionmesh_tpu_torch.training import loop as tloop
from actionmesh_tpu_torch.training import vae_train as tvt
from actionmesh_tpu_torch.training.checkpoint import export_for_inference
from actionmesh_tpu_torch.training.flow_train import init_train_state, make_step
from actionmesh_tpu_torch.utils.tree import leaves, named_leaves
from actionmesh_tpu_torch.utils.weights import params_from_jax, params_to_jax

TINY = dict(
    latent_channels=4, num_tokens=8, encoder_width=32, encoder_layers=1, encoder_heads=2,
    decoder_width=32, decoder_layers=1, decoder_heads=2,
)
JCFG = jvae.TripoSGVAEConfig(**TINY)
TCFG = tvae.TripoSGVAEConfig(**TINY)
CPU = torch.device("cpu")


def _bridge(seed=0):
    """(jax tree, port tree) of the same fp32 weights."""
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jvae.init_triposg_vae(jax.random.key(seed), JCFG))
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree)


def _sphere_batch(B=2, N=64, Q=48, seed=0):
    """Surface samples with normals and an exact-TSDF query pool of a sphere."""
    m = make_uv_sphere(radius=0.6, n_lat=12, n_lon=16)
    rng = np.random.default_rng(seed)
    nrm, areas = m.face_normals_and_areas()
    cdf = np.cumsum(areas) / areas.sum()
    surf, pts, tsdf = [], [], []
    for b in range(B):
        fid = np.searchsorted(cdf, rng.random(N))
        u, v = rng.random(N), rng.random(N)
        flip = u + v > 1
        u[flip], v[flip] = 1 - u[flip], 1 - v[flip]
        tri = m.vertices[m.faces[fid]]
        p = u[:, None] * tri[:, 0] + v[:, None] * tri[:, 1] + (1 - u - v)[:, None] * tri[:, 2]
        surf.append(np.concatenate([p, nrm[fid]], 1).astype(np.float32))
        pool = sample_sdf_queries(m, Q // 2, Q - Q // 2, seed=seed + b)
        pts.append(pool)
        tsdf.append(mesh_tsdf(pool, m))
    return {"surface": np.stack(surf), "points": np.stack(pts), "tsdf": np.stack(tsdf)}


def _jax_noise(key):
    """The posterior noise JAX's ``vae_loss`` draws from ``key``."""
    _, nkey = jax.random.split(key)
    return jax.random.normal(nkey, (2, JCFG.num_tokens, JCFG.latent_channels), jnp.float32)


def _assert_rel(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of max|ref| > {tol}"


@pytest.mark.parametrize("sampled", [False, True], ids=["posterior_mean", "sampled"])
def test_vae_loss_and_gradients_match_jax(sampled):
    """Loss, its parts and every gradient leaf within 1e-5 of the largest
    magnitude of JAX's (fp32 sums in another order)."""
    jparams, tparams = _bridge()
    batch = _sphere_batch()
    key = jax.random.key(5)
    jbatch = jax.tree.map(jnp.asarray, batch)

    def jloss(p):
        return jvt.vae_loss(p, JCFG, jbatch, key, sample_posterior=sampled, attn_impl="chunked")

    (jl, jparts), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    noise = torch.from_numpy(np.array(_jax_noise(key))) if sampled else None
    for p in leaves(tparams):
        p.requires_grad_(True)
    tl, tparts = tvt.vae_loss(tparams, TCFG, {k: torch.from_numpy(v) for k, v in batch.items()}, noise)
    tgrads = torch.autograd.grad(tl, leaves(tparams))
    _assert_rel(float(tl.detach()), float(jl), 1e-5, "loss")
    for k in ("mse", "kl"):
        _assert_rel(float(tparts[k]), float(jparts[k]), 1e-5, k)
    want = dict(named_leaves(params_from_jax(jax.tree.map(np.asarray, jgrads))))
    for (name, _), g in zip(named_leaves(tparams), tgrads):
        _assert_rel(g.numpy(), want[name].numpy(), 1e-5, f"grad {name}")


def test_vae_optimizer_step_matches_jax():
    """One step of JAX's jitted VAE step against the port's step with JAX's
    noise, both on the loop's optimizer arithmetic (global-norm clip, then
    AdamW) at a constant rate: the loss and every param leaf within 1e-5 of
    the leaf's largest magnitude (Adam divides each gradient by its own
    magnitude, so the gradients' fp32 differences reach the update)."""
    import optax

    from actionmesh_tpu_torch.training.optim import AdamW

    jparams, tparams = _bridge(1)
    jopt = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(3e-3, weight_decay=0.01))
    jstate = jflow.init_train_state(jparams, jopt)
    jstep = jvt.make_vae_train_step(JCFG, jopt, attn_impl="chunked")
    topt = AdamW(lambda count: 3e-3, clip_norm=1.0, weight_decay=0.01)
    tstate = init_train_state(tparams, topt)
    tstep = make_step(lambda p, b, noise: tvt.vae_loss(p, TCFG, b, noise)[0], topt)
    batch = _sphere_batch(seed=2)
    key = jax.random.key(20)
    jstate, jl = jstep(jstate, jax.tree.map(jnp.asarray, batch), key)
    tstate, tl = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                       torch.from_numpy(np.array(_jax_noise(key))))
    _assert_rel(float(tl), float(jl), 1e-5, "loss")
    want = dict(named_leaves(params_from_jax(jax.tree.map(np.asarray, jstate["params"]))))
    for name, p in named_leaves(tstate["params"]):
        _assert_rel(p.detach().numpy(), want[name].numpy(), 1e-5, name)


def test_sdf_batches_bit_equal_jax():
    """Same seed, same batches, epoch after epoch."""
    rng = np.random.default_rng(3)
    scenes = [
        {"surface": rng.random((16, 6), dtype=np.float32),
         "points": rng.random((60, 3), dtype=np.float32),
         "tsdf": rng.random(60, dtype=np.float32)}
        for _ in range(5)
    ]
    tb = tvt.sdf_batches(scenes, 2, 20, seed=4, epochs=3)
    jb = jvt.sdf_batches(scenes, 2, 20, seed=4, epochs=3)
    n = 0
    for t, j in zip(tb, jb):
        for k in ("surface", "points", "tsdf"):
            np.testing.assert_array_equal(t[k], j[k])
        n += 1
    assert n == 6
    with pytest.raises(ValueError):
        next(tvt.sdf_batches(scenes, 6, 20))


def test_run_vae_training_round_trip(tmp_path):
    """A few CPU steps through the loop: losses logged, ``eval_loss``
    records, ``ckpt_latest.npz`` resumable, and a ``vae.npz`` export that
    JAX's ``load_params`` reads back bit-equal to the trained params."""
    batch = _sphere_batch(B=2, seed=6)
    scenes = [{k: v[b] for k, v in batch.items()} for b in range(2)]
    cfg = tloop.TrainLoopConfig(
        total_steps=4, warmup_steps=1, peak_lr=3e-3, ema_decay=None, log_every=2,
        eval_every=2, ckpt_every=100, out_dir=str(tmp_path / "vae"), seed=0,
    )
    eval_b = list(tvt.sdf_batches(scenes, 2, 32, seed=123, epochs=1))
    state, logs = tloop.run_vae_training(
        TCFG, tvt.sdf_batches(scenes, 2, 32, seed=0), cfg, device=CPU, eval_batches=eval_b,
    )
    losses = [r["loss"] for r in logs if "loss" in r]
    evals = [r["eval_loss"] for r in logs if "eval_loss" in r]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert len(evals) == 2 and all(np.isfinite(evals)) and evals[0] > 0
    assert state["step"] == 4 and "ema_params" not in state
    assert (tmp_path / "vae" / "ckpt_latest.npz").exists()
    out = export_for_inference(state, tmp_path / "ckpt_stage0", stage="stage0_vae", compute_dtype=None)
    assert out.name == "vae.npz"
    reread = jload_params(out)
    for name, leaf in named_leaves(params_to_jax(state["params"])):
        got = reread
        for part in name.split("."):
            got = got[int(part)] if isinstance(got, list) else got[part]
        np.testing.assert_array_equal(np.asarray(got), leaf)
    # the held-out eval of the final params is the TSDF MSE of the posterior mean
    with torch.no_grad():
        mse = np.mean([
            float(tvt.vae_loss(state["params"], TCFG, {k: torch.from_numpy(v) for k, v in b.items()},
                               None, trainable=False)[1]["mse"])
            for b in eval_b
        ])
    np.testing.assert_allclose(evals[-1], mse, rtol=1e-6)


def test_run_vae_training_defaults_to_the_card(tmp_path):
    """Without ``device`` the trainer takes the card, and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = tloop.TrainLoopConfig(total_steps=2, warmup_steps=1, out_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.run_vae_training(TCFG, iter([]), cfg)
