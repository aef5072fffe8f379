"""Port distillation (guidance and progressive) vs the JAX package's, on
CPU, at tiny size, and the Stage-0 DiT (``--model stage0``) entry points.

Same teacher and student weights (JAX init, perturbed with numpy noise) and
the same batches on both sides; the loss's random draws are JAX's own,
passed to the port's ``*_from_draws`` functions. The JAX teacher runs the
plain ``chunked`` attention and the student ``chunked_train``; the port's
wrappers run their plain versions on CPU. Tolerances are stated per test.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actionmesh_tpu.models import denoiser as jden
from actionmesh_tpu.sampling.flow_schedule import get_schedule as jget_schedule
from actionmesh_tpu.training import distill as jdist
from actionmesh_tpu.training import flow_train as jflow
from actionmesh_tpu.utils.weights import load_params as jload_params
from actionmesh_tpu_torch import train as ttrain
from actionmesh_tpu_torch.models import denoiser as tden
from actionmesh_tpu_torch.sampling.flow_schedule import get_schedule
from actionmesh_tpu_torch.training import distill as tdist
from actionmesh_tpu_torch.training import loop as tloop
from actionmesh_tpu_torch.training.checkpoint import export_for_inference
from actionmesh_tpu_torch.utils.tree import leaves, named_leaves, tree_map
from actionmesh_tpu_torch.utils.weights import load_npz, params_from_jax, params_to_jax

# one block (inflated): the recipes do not depend on the depth, and JAX's
# compile time does
TINY = dict(
    num_tokens_nominal=8, temporal_context_size=4, in_channels=8, num_layers=1,
    num_attention_heads=2, width=64, mlp_ratio=2.0, cross_attention_dim=16,
    inflated_layers=(0,), gelu_approx=False,
)
JCFG = jden.DenoiserConfig(**TINY)
TCFG = tden.DenoiserConfig(**TINY)
CPU = torch.device("cpu")


def _bridge(seed):
    """(jax tree, port tree) holding the same perturbed fp32 weights."""
    rng = np.random.default_rng(seed)

    def perturb(a):
        a = np.asarray(a, dtype=np.float32)
        return (a * (1 + 0.1 * rng.standard_normal(a.shape))
                + 0.02 * rng.standard_normal(a.shape)).astype(np.float32)

    tree = jax.tree.map(perturb, jden.init_denoiser(jax.random.PRNGKey(seed), JCFG))
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree)


TEACHER = _bridge(0)
STUDENT = _bridge(1)


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


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Teacher, losses, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("guidance_scale", [None, 7.5])
def test_teacher_velocity_matches_jax(guidance_scale):
    """Guided (the two-branch CFG batch) and unguided teacher velocities;
    fp32 model-level parity, the JAX suite's 5e-4. The port's teacher runs
    without gradient."""
    batch = _batch()
    rng = np.random.default_rng(2)
    x_t = rng.standard_normal(batch["latents"].shape).astype(np.float32)
    t = np.array([900.0, 420.0, 35.0], np.float32)
    want = jax.jit(lambda p, *a: jdist.teacher_velocity(
        p, JCFG, *a, guidance_scale=guidance_scale, attn_impl="chunked",
    ))(TEACHER[0], *(jnp.asarray(a) for a in (x_t, batch["context"], batch["framestep"], t, batch["mask"])))
    tb = _t(batch)
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True), TEACHER[1])
    got = tdist.teacher_velocity(
        params, TCFG, torch.from_numpy(x_t), tb["context"], tb["framestep"],
        torch.from_numpy(t), tb["mask"], guidance_scale=guidance_scale,
    )
    assert not got.requires_grad and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=5e-4)


LOSSES = {
    "guidance": dict(guidance_scale=4.0),
    "progressive": dict(num_teacher_steps=8),
}


@pytest.mark.parametrize("case", list(LOSSES))
def test_distill_losses_and_grads_match_jax(case):
    """Both losses and their gradients in the student, from JAX's own draws,
    within the JAX suite's 5e-4."""
    kw = LOSSES[case]
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(5)
    B = batch["latents"].shape[0]
    k1, k2 = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k2, batch["latents"].shape, jnp.float32))
    if case == "guidance":
        jloss = jdist.guidance_distill_loss
        draws = (np.asarray(jflow.sample_flow_sigma(k1, B, 3.0)), noise)
        tloss = tdist.guidance_distill_loss_from_draws
    else:
        jloss = jdist.progressive_distill_loss
        draws = (np.asarray(2 * jax.random.randint(k1, (B,), 0, kw["num_teacher_steps"] // 2)), noise)
        tloss = tdist.progressive_distill_loss_from_draws
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, TEACHER[0], JCFG, jbatch, key, attn_impl="chunked_train",
                        teacher_attn_impl="chunked", remat=True, **kw)
    ))(STUDENT[0])
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True), STUDENT[1])
    loss_t = tloss(params, TEACHER[1], TCFG, _t(batch), *(torch.from_numpy(np.array(d)) for d in draws), **kw)
    grads = iter(torch.autograd.grad(loss_t, leaves(params)))
    grad_tree = tree_map(lambda _: next(grads), params)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=5e-4)
    got, want = _flat(params_to_jax(grad_tree)), _flat(grads_j)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=5e-4, rtol=5e-4, err_msg=name)


def test_schedule_halving_aligns_and_matches_jax():
    """Every second point of the n-step schedule is the n/2-step schedule,
    the property progressive distillation relies on; the port's schedule
    is JAX's."""
    for n in (30, 8):
        ts_full, dist_full = get_schedule(n, 1000, 3.0)
        ts_half, dist_half = get_schedule(n // 2, 1000, 3.0)
        np.testing.assert_allclose(ts_full[::2], ts_half, rtol=1e-6)
        np.testing.assert_allclose(dist_full[0::2] + dist_full[1::2], dist_half, rtol=1e-5)
        for a, b in zip(get_schedule(n, 1000, 3.0), jget_schedule(n, 1000, 3.0)):
            np.testing.assert_array_equal(a, b)


def test_odd_teacher_counts_and_unknown_modes_raise():
    tb = _t(_batch())
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="must be even"):
        tdist.progressive_distill_loss(STUDENT[1], TEACHER[1], TCFG, tb, gen, num_teacher_steps=15)
    with pytest.raises(ValueError, match="must be even"):
        tdist.progressive_distill_loss_from_draws(
            STUDENT[1], TEACHER[1], TCFG, tb, torch.zeros(3, dtype=torch.long),
            torch.zeros_like(tb["latents"]), num_teacher_steps=7)
    opt = tloop.make_optimizer(tloop.TrainLoopConfig(total_steps=2, warmup_steps=1))
    with pytest.raises(ValueError, match="must be even"):
        tdist.make_distill_step(TCFG, opt, TEACHER[1], mode="progressive", num_teacher_steps=15)
    with pytest.raises(ValueError, match="unknown distillation mode"):
        tdist.make_distill_step(TCFG, opt, TEACHER[1], mode="consistency")


def test_draws_are_even_indices_in_range():
    d = tdist.draw_progressive_noise(torch.Generator().manual_seed(3), (64, 4, 8, 8), 30)
    assert d["noise"].shape == (64, 4, 8, 8)
    assert (d["j"] % 2 == 0).all() and d["j"].min() >= 0 and d["j"].max() <= 28
    assert len(set(d["j"].tolist())) > 5


@pytest.mark.parametrize("mode", ["guidance", "progressive"])
def test_mask_frames_frozen_and_excluded(mode):
    """Conditioning frames (mask 1) enter clean, the progressive target is 0
    there (both teacher steps re-freeze them), and whatever the target holds
    on them does not reach the loss."""
    tb = _t(_batch())
    mask = tb["mask"].bool()
    fn = tdist.distill_targets_fn(TCFG, TEACHER[1], mode=mode, num_teacher_steps=8)
    targets = fn(tb, torch.Generator().manual_seed(1))
    assert torch.equal(targets["x_t"][mask], tb["latents"][mask])
    if mode == "progressive":
        assert torch.equal(targets["v"][mask], torch.zeros_like(targets["v"][mask]))
    loss = tdist.student_loss(STUDENT[1], TCFG, tb, targets)
    noisy = dict(targets, v=targets["v"].clone())
    noisy["v"][mask] = 1e3
    assert torch.equal(tdist.student_loss(STUDENT[1], TCFG, tb, noisy), loss)


# ---------------------------------------------------------------------------
# Loop, exports, entry points
# ---------------------------------------------------------------------------

def _cfg(out_dir, **kw):
    base = dict(total_steps=4, warmup_steps=1, peak_lr=1e-3, log_every=1, ckpt_every=0,
                ema_decay=0.9, out_dir=str(out_dir))
    base.update(kw)
    return tloop.TrainLoopConfig(**base)


@pytest.mark.parametrize("mode", ["guidance", "progressive"])
def test_run_distillation_resume_is_bit_exact(tmp_path, mode):
    """4 steps straight == 2 steps, checkpoint, restore, 2 more; the student
    keeps an EMA and the held-out eval uses fixed draws (equal in both)."""
    batches = [_batch(seed=s) for s in range(4)]
    kw = dict(mode=mode, num_teacher_steps=8, device=CPU, eval_batches=[_batch(seed=9)])
    straight, hist = tloop.run_distillation(TCFG, TEACHER[1], iter(batches),
                                            _cfg(tmp_path / "a", eval_every=2), **kw)
    assert "ema_params" in straight
    assert [h["step"] for h in hist if "loss" in h] == [1, 2, 3, 4]
    tloop.run_distillation(TCFG, TEACHER[1], iter(batches[:2]), _cfg(tmp_path / "b", eval_every=2), **kw)
    resumed, hist_b = tloop.run_distillation(TCFG, TEACHER[1], iter(batches[2:]),
                                             _cfg(tmp_path / "b", eval_every=2), **kw)
    assert [h["step"] for h in hist_b if "loss" in h] == [3, 4]
    assert [h["eval_loss"] for h in hist if h["step"] == 4 and "eval_loss" in h] == \
        [h["eval_loss"] for h in hist_b if h["step"] == 4 and "eval_loss" in h]
    for (n, a), (_, b) in zip(named_leaves(resumed), named_leaves(straight)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), n
        else:
            assert a == b, n


def test_student_warm_starts_from_the_teacher(tmp_path):
    """The first update runs at lr 0, so after one step the student is the
    teacher, bit for bit; the teacher tree the caller holds is not moved."""
    before = [p.clone() for p in leaves(TEACHER[1])]
    state, _ = tloop.run_distillation(TCFG, TEACHER[1], iter([_batch()]), _cfg(tmp_path), device=CPU)
    assert state["step"] == 1
    for a, b, c in zip(leaves(state["params"]), leaves(TEACHER[1]), before):
        assert torch.equal(a.detach(), b) and torch.equal(b, c)


def test_run_distillation_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.run_distillation(TCFG, TEACHER[1], iter([_batch()]), _cfg(tmp_path / "run"))
    assert not (tmp_path / "run").exists()


def _jax_forward_matches(path, cfg_j, cfg_t, T):
    """JAX load_params + denoiser_forward on an exported file equals the
    port's forward on it (fp32 exports: the JAX suite's 5e-4)."""
    jparams, ported = jload_params(path), load_npz(path)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, T, cfg_t.num_tokens_nominal, cfg_t.in_channels)).astype(np.float32)
    ctx = rng.standard_normal((2, T, 3, cfg_t.cross_attention_dim)).astype(np.float32)
    fs = np.tile(np.arange(T, dtype=np.float32), (2, 1))
    dt = np.array([250.0, 800.0], np.float32)
    ref = jden.denoiser_forward(jparams, cfg_j, *(jnp.asarray(a) for a in (x, ctx, fs, dt)),
                                attn_impl="chunked")
    with torch.no_grad():
        out = tden.denoiser_forward(ported, cfg_t, *(torch.from_numpy(a) for a in (x, ctx, fs, dt)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=5e-4)


def test_distill_entry_point_and_exports(tmp_path, capsys):
    """train.py --stage distill in both modes from a --teacher directory
    (denoiser.npz written by a flow run's export), the Stage-0 DiT's flow
    and distill stages (window 1, dit.npz), and their exports read by JAX's
    load_params with the forward matching."""
    flow = ["--synthetic", "--size", "tiny", "--steps", "2", "--log-every", "1", "--device", "cpu"]
    assert ttrain.main(flow + ["--out", str(tmp_path / "flow"), "--export-inference", str(tmp_path / "t")]) == 0
    for mode in ("guidance", "progressive"):
        out = tmp_path / mode
        state, hist, _ = ttrain.run(ttrain.build_args().parse_args(
            flow + ["--stage", "distill", "--distill-mode", mode, "--teacher", str(tmp_path / "t"),
                    "--teacher-steps", "4", "--ema-decay", "0.5", "--out", str(out),
                    "--export-inference", str(out / "exp"), "--compute-dtype", "bfloat16"]))
        assert state["step"] == 2 and all(np.isfinite(h["loss"]) for h in hist)
        assert (out / "exp" / "denoiser.npz").exists()
    printed = capsys.readouterr().out
    assert "CFG scale 7.5 -> single forward" in printed and "4 -> 2 steps" in printed
    cfg_t = ttrain.flow_model_config("tiny", "stage0")
    cfg_j = jden.DenoiserConfig(**{f: getattr(cfg_t, f) for f in cfg_t.__dataclass_fields__})
    for stage in ("flow", "distill"):
        out = tmp_path / f"stage0_{stage}"
        args = ttrain.build_args().parse_args(
            flow + ["--model", "stage0", "--stage", stage, "--window", "8", "--out", str(out),
                    "--export-inference", str(out / "exp")])
        state, hist, _ = ttrain.run(args)
        assert args.window == 1 and state["step"] == 2
        assert {p.name for p in (out / "exp").iterdir()} == {"dit.npz"}
        assert jload_params(out / "exp" / "dit.npz")["proj_in"]["kernel"].shape == (4, 32)
    # an fp32 export of the DiT, held against JAX's forward at T = 1
    state = {"params": state["params"]}
    path = export_for_inference(state, tmp_path / "dit32", stage="stage0_dit", compute_dtype=None)
    _jax_forward_matches(path, cfg_j, cfg_t, T=1)
    with pytest.raises(SystemExit, match="--teacher"):
        ttrain.main(["--stage", "distill", "--data-dir", str(tmp_path), "--device", "cpu"])
    with pytest.raises(ValueError, match="stage must be one of"):
        export_for_inference(state, tmp_path / "x", stage="vae")


def test_denoiser_export_loads_in_jax(tmp_path):
    """A distilled student's EMA exported as denoiser.npz reads in JAX's
    load_params with every leaf equal to the port's export (the forward on
    such a file is held in test_torch_training.py)."""
    state, _ = tloop.run_distillation(TCFG, TEACHER[1], iter([_batch(), _batch(2)]),
                                      _cfg(tmp_path, total_steps=2), device=CPU)
    path = export_for_inference(state, tmp_path / "exp")
    assert path.name == "denoiser.npz"
    got = _flat(params_to_jax(tree_map(lambda t: t.float(), load_npz(path))))
    want = _flat(jload_params(path))
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert [json.loads(l)["step"] for l in (tmp_path / "log.jsonl").read_text().splitlines()] == [1, 2]
