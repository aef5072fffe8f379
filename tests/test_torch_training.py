"""Port Stage-I training vs the JAX package's, on CPU, at tiny size.

Same weights (JAX init, perturbed with numpy noise) and the same inputs on
both sides; the random draws of the loss (sigma, noise, context dropout)
are JAX's own, passed to the port as tensors, since torch cannot draw
``jax.random``'s numbers. Attention on the JAX side is ``chunked_train``
(the plain O(S) custom VJP), on the port's its plain version on CPU.
Tolerances are stated per test with their reason.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from actionmesh_tpu.models import denoiser as jden
from actionmesh_tpu.training import flow_train as jflow
from actionmesh_tpu.training import loop as jloop
from actionmesh_tpu.utils.weights import load_params as jload_params
from actionmesh_tpu_torch import train as ttrain
from actionmesh_tpu_torch.models import denoiser as tden
from actionmesh_tpu_torch.training import data as tdata
from actionmesh_tpu_torch.training import flow_train as tflow
from actionmesh_tpu_torch.training import loop as tloop
from actionmesh_tpu_torch.training.checkpoint import (
    export_for_inference,
    restore_train_state,
    save_train_state,
)
from actionmesh_tpu_torch.training.optim import warmup_cosine_decay_schedule
from actionmesh_tpu_torch.utils.tree import leaves, named_leaves, tree_map
from actionmesh_tpu_torch.utils.weights import load_npz, params_from_jax, params_to_jax

TINY = dict(
    num_tokens_nominal=8, temporal_context_size=4, in_channels=8, num_layers=3,
    num_attention_heads=2, width=64, mlp_ratio=2.0, cross_attention_dim=16,
    inflated_layers=(0, 2), gelu_approx=False,
)
JCFG = jden.DenoiserConfig(**TINY)
TCFG = tden.DenoiserConfig(**TINY)


def _bridge(seed=0):
    """(jax tree, port tree) holding the same perturbed fp32 weights."""
    rng = np.random.default_rng(seed)

    def perturb(a):
        a = np.asarray(a, dtype=np.float32)
        return (a * (1 + 0.1 * rng.standard_normal(a.shape))
                + 0.02 * rng.standard_normal(a.shape)).astype(np.float32)

    tree = jax.tree.map(perturb, jden.init_denoiser(jax.random.PRNGKey(seed), JCFG))
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree)


def _batch(seed=1, B=3, T=4, N=8):
    rng = np.random.default_rng(seed)
    return {
        "latents": rng.standard_normal((B, T, N, 8)).astype(np.float32),
        "context": rng.standard_normal((B, T, 5, 16)).astype(np.float32),
        "framestep": np.tile(np.arange(2, 2 + T, dtype=np.float32), (B, 1)),
        "mask": (np.arange(T)[None] < np.array([[1], [2], [0]])[:B]).astype(np.float32),
    }


def _flat(tree):
    return {name: np.asarray(leaf, dtype=np.float32) for name, leaf in named_leaves(tree)}


def _np_tree(tree):
    return tree_map(lambda t: t.detach().float().numpy(), tree)


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------

def test_flow_matching_loss_and_grads_match_jax():
    jp, tp = _bridge()
    batch = _batch()
    key = jax.random.PRNGKey(3)
    p_uncond = 0.5
    # JAX's own draws, as flow_matching_loss makes them
    tkey, nkey, dkey = jax.random.split(key, 3)
    sigma = jflow.sample_flow_sigma(tkey, 3, 3.0)
    noise = jax.random.normal(nkey, batch["latents"].shape, jnp.float32)
    drop = jax.random.bernoulli(dkey, p_uncond, (3,))

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jflow.flow_matching_loss(
            p, JCFG, jbatch, key, p_uncond=p_uncond, attn_impl="chunked_train", remat=True
        )
    ))(jp)

    tparams = tree_map(lambda t: t.requires_grad_(True), tp)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss_t = tflow.flow_matching_loss_from_draws(
        tparams, TCFG, tbatch, *(torch.from_numpy(np.array(a)) for a in (sigma, noise, drop)),
        remat=True,
    )
    grads_t = torch.autograd.grad(loss_t, leaves(tparams))
    it = iter(grads_t)
    grad_tree = tree_map(lambda _: next(it), tparams)

    # fp32 model-level parity, the JAX suite's 5e-4
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=5e-4)
    got, want = _flat(params_to_jax(grad_tree)), _flat(grads_j)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=5e-4, rtol=5e-4, err_msg=name)


def test_remat_recomputes_each_block_once_and_changes_nothing(monkeypatch):
    """Under remat every block's attention and rms-rope forwards run twice
    per step (the kernel launch counts chip_smoke.py expects), the
    attention backward once; losses and gradients equal the plain ones."""
    import actionmesh_tpu_torch.ops.attention as tattn
    import actionmesh_tpu_torch.ops.rope_norm as trope

    calls = {"fwd": 0, "bwd": 0, "rope": 0}

    def spy(fn, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tattn, "chunked_attention", spy(tattn.chunked_attention, "fwd"))
    monkeypatch.setattr(tattn, "attention_bwd_reference", spy(tattn.attention_bwd_reference, "bwd"))
    monkeypatch.setattr(trope, "_rms_rope_forward", spy(trope._rms_rope_forward, "rope"))

    _, tp = _bridge()
    tbatch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    draws = tflow.draw_flow_noise(torch.Generator().manual_seed(0), tbatch["latents"].shape, 0.5)
    results = {}
    L = TCFG.num_layers
    for remat in (False, True):
        calls.update(fwd=0, bwd=0, rope=0)
        params = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
        loss = tflow.flow_matching_loss_from_draws(
            params, TCFG, tbatch, draws["sigma"], draws["noise"], draws["drop"], remat=remat
        )
        grads = torch.autograd.grad(loss, leaves(params))
        passes = 2 if remat else 1
        assert calls == {"fwd": passes * 2 * L, "bwd": 2 * L, "rope": passes * 4 * L}, calls
        results[remat] = (loss, grads)
    torch.testing.assert_close(results[True][0], results[False][0], rtol=0, atol=0)
    for a, b in zip(results[True][1], results[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_compute_dtype_cast_keeps_norms_fp32():
    _, tp = _bridge()
    cast = tflow.cast_params_for_compute(tp, torch.bfloat16)
    for name, leaf in named_leaves(cast):
        assert leaf.dtype == (torch.float32 if "norm" in name else torch.bfloat16), name
    jcast = jflow.cast_params_for_compute(jden.init_denoiser(jax.random.PRNGKey(0), JCFG))
    jdtypes = {n.replace("kernel", "weight"): str(l.dtype) for n, l in named_leaves(jcast)}
    assert jdtypes == {n: str(l.dtype).replace("torch.", "") for n, l in named_leaves(cast)}


# ---------------------------------------------------------------------------
# Optimizer and schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,decay,end", [(1, 3, 0.1), (0, 5, 0.0), (10, 20, 0.25)])
def test_lr_schedule_matches_optax(warmup, decay, end):
    ours = warmup_cosine_decay_schedule(0.0, 1e-3, warmup, decay, end * 1e-3)
    theirs = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup, decay, end * 1e-3)
    for count in range(decay + 3):
        # optax computes in fp32
        np.testing.assert_allclose(ours(count), float(theirs(count)), rtol=1e-6, atol=1e-12)
    assert ours(0) == 0.0 or warmup == 0


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_optimizer_and_ema_match_optax(grad_accum):
    """Three optimizer updates (clip, AdamW, warmup 1, MultiSteps) and the
    per-micro-step EMA against optax on the same gradients."""
    rng = np.random.default_rng(4)
    shapes = {"a": {"weight": (6, 5), "bias": (6,)}, "norm": {"scale": (5,)}}
    params = {k: {n: rng.standard_normal(s).astype(np.float32) for n, s in v.items()}
              for k, v in shapes.items()}
    n_micro = 3 * grad_accum
    cfg_kw = dict(total_steps=n_micro, peak_lr=0.05, warmup_steps=1, clip_norm=1.5,
                  weight_decay=0.01, grad_accum=grad_accum, ema_decay=0.9)
    jcfg, tcfg = jloop.TrainLoopConfig(**cfg_kw), tloop.TrainLoopConfig(**cfg_kw)
    assert tloop.loop_ema_decay(tcfg) == jloop._loop_ema_decay(jcfg)
    decay = tloop.loop_ema_decay(tcfg)

    jopt = jloop.make_optimizer(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    jstate, jema = jopt.init(jp), jp
    topt = tloop.make_optimizer(tcfg)
    tp = tree_map(lambda a: torch.from_numpy(a.copy()), params)
    tstate, tema = topt.init(tp), tree_map(lambda t: t.clone(), tp)
    for i in range(n_micro):
        # alternate gradients under and over the clip norm
        grads = tree_map(lambda a: (rng.standard_normal(a.shape) * (0.2 if i % 2 else 2.0)).astype(np.float32), params)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, grads), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        jema = jax.tree.map(lambda e, p: e * decay + p * (1 - decay), jema, jp)
        with torch.no_grad():
            topt.update([torch.from_numpy(g) for g in leaves(grads)], tstate, leaves(tp))
            for e, p in zip(leaves(tema), leaves(tp)):
                e.mul_(decay).add_(p, alpha=1 - decay)
        if i < grad_accum:  # the first update runs at lr 0
            for a, b in zip(leaves(tp), leaves(params)):
                np.testing.assert_array_equal(a.numpy(), b)
        # fp32 arithmetic in another order (fused multiply-adds)
        for ours, theirs in ((tp, jp), (tema, jema)):
            got, want = _flat(_np_tree(ours)), _flat(theirs)
            assert got.keys() == want.keys()
            for name in want:
                np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-6, err_msg=name)
    assert tstate["count"] == int(jstate.inner_opt_state[1][0].count if grad_accum > 1 else jstate[1][0].count)


# ---------------------------------------------------------------------------
# Loop, checkpoints, export, data, entry point
# ---------------------------------------------------------------------------

def _tiny_run_cfg(tmp_path, **kw):
    base = dict(total_steps=4, warmup_steps=1, peak_lr=1e-3, log_every=1, ckpt_every=0,
                out_dir=str(tmp_path), p_uncond=0.5, ema_decay=0.9)
    base.update(kw)
    return tloop.TrainLoopConfig(**base)


def _synthetic_batches(tmp_path, n):
    clips = tdata.synthesize_clip_dir(tmp_path / "clips", tokens=8, channels=8,
                                      context_tokens=5, context_dim=16)
    ds = tdata.ClipWindowDataset(clips, window=4)
    it = tdata.flow_batches(ds, 2, seed=0, n_cond_frames=(1, 3))
    return [next(it) for _ in range(n)]


def test_resume_is_bit_exact(tmp_path):
    """4 steps straight == 2 steps, checkpoint, restore, 2 more."""
    batches = _synthetic_batches(tmp_path, 4)
    _, tp = _bridge()
    cpu = torch.device("cpu")
    straight, hist = tloop.run_flow_training(
        TCFG, iter(batches), _tiny_run_cfg(tmp_path / "a"), params=tp, device=cpu)
    assert [h["step"] for h in hist] == [1, 2, 3, 4]
    assert all(np.isfinite(h["loss"]) for h in hist)
    tloop.run_flow_training(
        TCFG, iter(batches[:2]), _tiny_run_cfg(tmp_path / "b"), params=tp, device=cpu)
    resumed, hist_b = tloop.run_flow_training(
        TCFG, iter(batches[2:]), _tiny_run_cfg(tmp_path / "b"), params=tp, device=cpu)
    assert [h["step"] for h in hist_b] == [3, 4]
    assert resumed["step"] == straight["step"] == 4
    for (n, a), (_, b) in zip(named_leaves(resumed), named_leaves(straight)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), n
        else:
            assert a == b, n


def test_checkpoint_round_trip_and_mismatch(tmp_path):
    _, tp = _bridge()
    cfg = _tiny_run_cfg(tmp_path, grad_accum=2)
    opt = tloop.make_optimizer(cfg)
    state = tflow.init_train_state(tp, opt, ema_decay=0.9)
    state["step"], state["opt_state"]["mini_step"] = 7, 1
    with torch.no_grad():
        for leaf in leaves(state["opt_state"]["mu"]):
            leaf.normal_()
    path = save_train_state(state, tmp_path / "ck.npz")
    template = tflow.init_train_state(tp, opt, ema_decay=0.9)
    restored = restore_train_state(path, template)
    assert restored["step"] == 7 and restored["opt_state"]["mini_step"] == 1
    for (n, a), (_, b) in zip(named_leaves(restored), named_leaves(state)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), n
    other = tflow.init_train_state(tp, opt, ema_decay=None)  # no EMA leaves
    with pytest.raises(ValueError, match="does not match"):
        restore_train_state(path, other)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_export_loads_in_jax_and_matches_forward(tmp_path, dtype):
    """export_for_inference -> JAX load_params -> JAX denoiser_forward equals
    the port's forward on the exported weights."""
    _, tp = _bridge()
    state = tflow.init_train_state(tp, tloop.make_optimizer(_tiny_run_cfg(tmp_path)), ema_decay=0.9)
    with torch.no_grad():
        for leaf in leaves(state["ema_params"]):
            leaf.mul_(1.01)
    path = export_for_inference(state, tmp_path / "export", compute_dtype=dtype)
    jparams = jload_params(path)
    ported = load_npz(path)
    expect = tflow.cast_params_for_compute(state["ema_params"], dtype) if dtype else state["ema_params"]
    for (n, a), (_, b) in zip(named_leaves(ported), named_leaves(expect)):
        assert a.dtype == b.dtype and torch.equal(a, b.detach()), n
    batch = _batch()
    x, ctx = batch["latents"], batch["context"]
    dt = np.array([300.0, 700.0, 50.0], np.float32)
    ref = jden.denoiser_forward(
        jparams, JCFG, jnp.asarray(x, jparams["proj_in"]["kernel"].dtype),
        jnp.asarray(ctx, jparams["proj_in"]["kernel"].dtype),
        jnp.asarray(batch["framestep"]), jnp.asarray(dt), mask=jnp.asarray(batch["mask"]),
    )
    wdt = ported["proj_in"]["weight"].dtype
    out = tden.denoiser_forward(
        ported, TCFG, torch.from_numpy(x).to(wdt), torch.from_numpy(ctx).to(wdt),
        torch.from_numpy(batch["framestep"]), torch.from_numpy(dt), mask=torch.from_numpy(batch["mask"]),
    )
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype is None:
        np.testing.assert_allclose(out.detach().numpy(), ref, atol=5e-4)
    else:
        # bf16 activations rounded at other places in the two frameworks
        err = np.abs(out.detach().float().numpy() - ref).max()
        assert err <= 5e-2 * np.abs(ref).max(), err


def test_split_windows_disjoint_complete_and_loadable(tmp_path):
    clips = tdata.synthesize_clip_dir(tmp_path, n_clips=3, frames=8)
    ds = tdata.ClipWindowDataset(clips, window=4, stride=2)
    train, held = tdata.split_windows(ds, eval_fraction=0.3, seed=1)
    a = {(w.clip, w.start) for w in train._windows}
    b = {(w.clip, w.start) for w in held._windows}
    assert not a & b and a | b == {(w.clip, w.start) for w in ds._windows}
    for view in (train, held):  # each view loads through its own cache
        assert view[0]["latents"].shape == (4, 8, 4)
    batch = next(tdata.flow_batches(train, 2, n_cond_frames=(1, 3)))
    assert batch["latents"].shape == (2, 4, 8, 4) and batch["context"].shape == (2, 4, 3, 16)
    counts = batch["mask"].sum(1)
    assert ((counts >= 1) & (counts <= 3)).all()


def test_prefetcher_keeps_order_and_raises():
    batches = [{"x": np.full((2,), i, np.float32)} for i in range(5)]
    got = [int(b["x"][0]) for b in tdata.DevicePrefetcher(iter(batches), torch.device("cpu"))]
    assert got == list(range(5))

    def broken():
        yield batches[0]
        raise RuntimeError("bad clip")

    pf = tdata.DevicePrefetcher(broken(), torch.device("cpu"))
    next(pf)
    with pytest.raises(RuntimeError, match="bad clip"):
        next(pf)


def test_entry_point_tiny_on_cpu(tmp_path, capsys):
    out = tmp_path / "run"
    rc = ttrain.main(["--synthetic", "--size", "tiny", "--steps", "3", "--log-every", "1",
                      "--out", str(out), "--export-inference", str(tmp_path / "exp"),
                      "--device", "cpu"])
    assert rc == 0
    recs = [json.loads(line) for line in (out / "log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and r["stage_steps_per_s"] > 0 for r in recs)
    assert (out / "ckpt_latest.npz").exists()
    jparams = jload_params(tmp_path / "exp" / "denoiser.npz")
    assert jparams["proj_in"]["kernel"].shape == (4, 32)
    assert jparams["proj_in"]["kernel"].dtype == jnp.bfloat16
    assert "done: step 3" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="tracks-dir"):
        ttrain.main(["--stage", "decoder", "--data-dir", str(out), "--device", "cpu"])


def test_entry_point_device_defaults_to_cuda(tmp_path, monkeypatch):
    """Without --device the entry point asks for the card and raises where
    there is none, instead of carrying on on the CPU; --device cpu runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--synthetic", "--size", "tiny", "--steps", "1", "--log-every", "1",
            "--ckpt-every", "0", "--out", str(tmp_path / "run")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.run(ttrain.build_args().parse_args(args))
    assert not (tmp_path / "run").exists()
    state, history, _ = ttrain.run(ttrain.build_args().parse_args(args + ["--device", "cpu"]))
    assert state["step"] == 1 and [h["step"] for h in history if "loss" in h] == [1]


def test_run_flow_training_defaults_to_cuda(tmp_path, monkeypatch):
    """The library entry asks for the card when no device is given and
    raises where there is none, instead of training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batches = _synthetic_batches(tmp_path, 2)
    _, tp = _bridge()
    cfg = _tiny_run_cfg(tmp_path / "run", total_steps=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.run_flow_training(TCFG, iter(batches), cfg, params=tp)
    assert not (tmp_path / "run").exists()
    state, hist = tloop.run_flow_training(
        TCFG, iter(batches), cfg, params=tp, device=torch.device("cpu"))
    assert state["step"] == 2 and [h["step"] for h in hist] == [1, 2]


def test_entry_point_eval_profile_and_resume(tmp_path):
    """Held-out eval on the EMA weights, a profiler trace, and a second
    invocation that resumes from the checkpoint instead of restarting."""
    out = tmp_path / "run"
    args = ["--synthetic", "--size", "tiny", "--steps", "4", "--warmup", "1",
            "--batch", "1", "--eval-fraction", "0.5", "--eval-every", "2", "--eval-batches", "2",
            "--profile-steps", "1:2", "--out", str(out), "--device", "cpu"]
    state, history, _ = ttrain.run(ttrain.build_args().parse_args(args))
    evals = [h for h in history if "eval_loss" in h]
    assert [h["step"] for h in evals] == [2, 4] and all(np.isfinite(h["eval_loss"]) for h in evals)
    assert (out / "profile" / "trace.json").stat().st_size > 0
    state2, history2, _ = ttrain.run(ttrain.build_args().parse_args(args))
    assert state2["step"] == 4 and not [h for h in history2 if "loss" in h]
    for (n, a), (_, b) in zip(named_leaves(state2["params"]), named_leaves(state["params"])):
        assert torch.equal(a, b), n
