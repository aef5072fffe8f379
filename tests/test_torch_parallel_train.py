"""The port's sharded training (mesh=) against the JAX package's.

One gloo world of four CPU ranks runs every case of the port
(``tests/torch_parallel_train_ranks.py``, spawned once for the file) and
one of two ranks drives ``train.py --mesh`` through its ``main``; the JAX
package runs its sharded train steps and loop on the first four devices of
its 8-device virtual CPU mesh (``tests/conftest.py``), in processes while
the ranks run, on the same numpy inputs and weights and with its own random
draws, which the ranks take as tensors. Layouts (dp 2, tp 2), (dp 2, sp 2)
and (dp 1, tp 2, sp 2), the Stage-0 DiT's step at the two with sp; the
attention's ring backward also at (dp 1, sp 4).
Tolerances: 5e-4 relative for the model-level fp32 comparisons (ROADMAP's
model-level bar), 1e-5 of max|ref| for the attention gradients in fp32.
"""

import dataclasses
import importlib.util
import json
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actionmesh_tpu.models.autoencoder import AutoencoderConfig as JAECfg
from actionmesh_tpu.models.denoiser import DenoiserConfig as JDenCfg
from actionmesh_tpu.models.triposg.dit import triposg_dit_config as jdit_config
from actionmesh_tpu.parallel import mesh as jmesh
from actionmesh_tpu.training import decoder_train as jdec
from actionmesh_tpu.training import distill as jdistill
from actionmesh_tpu.training import flow_train as jflow
from actionmesh_tpu.training import loop as jloop
from actionmesh_tpu.utils.weights import load_params as jload_params
from actionmesh_tpu_torch import train as ttrain
from actionmesh_tpu_torch.models.autoencoder import AutoencoderConfig as TAECfg
from actionmesh_tpu_torch.models.autoencoder import init_autoencoder as tinit_ae
from actionmesh_tpu_torch.models.denoiser import DenoiserConfig as TDenCfg
from actionmesh_tpu_torch.models.denoiser import init_denoiser as tinit_den
from actionmesh_tpu_torch.models.triposg.dit import triposg_dit_config
from actionmesh_tpu_torch.ops.attention import chunked_attention_trainable
from actionmesh_tpu_torch.utils.tree import named_leaves
from actionmesh_tpu_torch.utils.weights import params_from_jax, params_to_jax
from tests.torch_parallel_ranks import LAYOUTS, World
from tests.torch_parallel_train_ranks import (
    ATTN_LAYOUTS,
    DIT_DRAWS,
    DIT_LAYOUTS,
    TRAIN_LAYOUTS,
    cli_rank,
    train_rank,
)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

DEN = dict(num_tokens_nominal=8, temporal_context_size=4, in_channels=4, num_layers=3,
           num_attention_heads=4, width=32, mlp_ratio=2.0, cross_attention_dim=16,
           inflated_layers=(0, 1, 2), gelu_approx=False)
DIT = dict(num_tokens=8, in_channels=4, num_layers=3, num_attention_heads=4, width=32,
           cross_attention_dim=16)
AE = dict(temporal_context_size=4, latent_channels=4, width=32, num_layers=3, num_attention_heads=4,
          gelu_approx=False)
# warmup 0: the first update moves the params; a clip norm the gradients
# exceed, so the whole model's norm (summed over tp) sets every update
OPT = dict(total_steps=3, peak_lr=1e-3, warmup_steps=0, clip_norm=0.05)
EMA = 0.9
LOOP = dict(OPT, ema_decay=EMA, p_uncond=0.5, seed=0, log_every=1, ckpt_every=0)
ACCUM = dict(total_steps=4, grad_accum=2)
P_UNCOND = 0.5
CLI_ARGS = ["--synthetic", "--size", "tiny", "--window", "4", "--batch", "2", "--steps", "2",
            "--warmup", "0", "--log-every", "1", "--ckpt-every", "0", "--device", "cpu"]
MODEL_RTOL = 5e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(torch_layout_tree) -> dict:
    """{dotted name: array} of a port-layout tree."""
    return {n: np.asarray(a, np.float32) for n, a in named_leaves(torch_layout_tree)}


def _port_named(jax_tree) -> dict:
    """A JAX-layout tree under the port's names and layout."""
    return _flat(params_from_jax(_np_tree(jax_tree)))


def _weights(init, cfg, seed):
    """A JAX-layout numpy tree of the port's random init (drawn in torch,
    quicker than JAX's eager init)."""
    return params_to_jax(init(torch.Generator().manual_seed(seed), cfg))


def _flow_draws(key, B, shape):
    tkey, nkey, dkey = jax.random.split(key, 3)
    return {"sigma": np.asarray(jflow.sample_flow_sigma(tkey, B, 3.0)),
            "noise": np.asarray(jax.random.normal(nkey, shape, jnp.float32)),
            "drop": np.asarray(jax.random.bernoulli(dkey, P_UNCOND, (B,)))}


def _inputs(tmp: Path) -> dict:
    rng = np.random.default_rng(0)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    B, T, N = 2, 4, 8
    flow_batch = {"latents": normal(B, T, N, 4), "context": normal(B, T, 3, 16),
                  "framestep": np.tile(np.arange(T, dtype=np.float32)[None], (B, 1)),
                  "mask": np.array([[1, 0, 0, 0], [1, 1, 0, 0]], np.float32)}
    # the single steps are the loop's first
    loop_batches = [flow_batch] + [{k: (normal(*v.shape) if k in ("latents", "context") else v)
                                    for k, v in flow_batch.items()} for _ in range(2)]
    V, T_out = 12, 3
    decoder_batch = {
        "latents": normal(1, T, N, 4), "framestep": np.arange(T, dtype=np.float32)[None],
        "source_alpha": np.zeros(1, np.float32),
        "target_alphas": np.linspace(0.25, 1.0, T_out, dtype=np.float32)[None],
        "query": rng.uniform(-1, 1, (1, V, 6)).astype(np.float32),
        "positions": np.tanh(normal(1, T_out, V, 3)),
        "vertex_mask": np.concatenate([np.ones((1, V - 2)), np.zeros((1, 2))], 1).astype(np.float32),
    }
    # attention: row 5 of (batch 0, head 0) points along u, the keys of the
    # last sp = 4 shard against it, so exp(s - L) underflows to 0 there:
    # that shard gets exact-zero terms from the row
    Ba, H, S, D = 2, 4, 64, 16
    q, k, v, do = normal(Ba, H, S, D), normal(Ba, H, S, D), normal(Ba, H, S, D), normal(Ba, H, S, D)
    u = normal(D)
    u /= np.linalg.norm(u)
    q[0, 0, 5] = 100.0 * u
    k[0, 0, 48:] = -5.0 * u + 0.01 * normal(16, D)
    # JAX's draws, the loop's (fold_in(key(seed), step)); the single steps
    # take step 0's key
    root = jax.random.key(LOOP["seed"])
    step_key = jax.random.fold_in(root, 0)
    ik, nk = jax.random.split(step_key)
    draws = {
        "flow": [_flow_draws(jax.random.fold_in(root, s), B, (B, T, N, 4)) for s in range(DIT_DRAWS)]
        + [_flow_draws(jax.random.fold_in(root, DIT_DRAWS), B, (B, 1, N, 4))],
        "guidance": [{"sigma": np.asarray(jflow.sample_flow_sigma(ik, B, 3.0)),
                      "noise": np.asarray(jax.random.normal(nk, (B, T, N, 4), jnp.float32))}],
        "progressive": [{"j": np.asarray(2 * jax.random.randint(ik, (B,), 0, 2)),
                         "noise": np.asarray(jax.random.normal(nk, (B, T, N, 4), jnp.float32))}],
    }
    return {
        "den_cfg": DEN, "ae_cfg": AE, "opt": OPT, "loop_cfg": LOOP, "accum_cfg": ACCUM,
        "p_uncond": P_UNCOND, "tmp": str(tmp),
        "den_params": _weights(tinit_den, TDenCfg(**DEN), 1),
        "teacher_params": _weights(tinit_den, TDenCfg(**DEN), 2),
        "ae_params": _weights(tinit_ae, TAECfg(**AE), 3), "ema": EMA,
        "flow_batch": flow_batch, "loop_batches": loop_batches, "decoder_batch": decoder_batch,
        "attn": {"q": q, "k": k, "v": v, "do": do},
        "dit_cfg": dataclasses.asdict(triposg_dit_config(**DIT)),
        "dit_params": _weights(tinit_den, triposg_dit_config(**DIT), 4),
        "dit_batch": {"latents": normal(2, 1, 8, 4), "context": normal(2, 1, 3, 16),
                      "framestep": np.zeros((2, 1), np.float32)},
        "draws": draws,
    }


# ---------------------------------------------------------------------------
# The JAX side
# ---------------------------------------------------------------------------

def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _jstate_out(state, loss) -> dict:
    adam = state["opt_state"][1][0]
    return {"loss": float(loss), "params": _port_named(state["params"]),
            "mu": _port_named(adam.mu), "nu": _port_named(adam.nu),
            "mu_shard": {n: tuple(np.asarray(a.addressable_shards[0].data.shape))
                         for n, a in zip(_port_named(adam.mu), jax.tree.leaves(adam.mu))}}


def _jax_flow_steps(inputs, name, n_steps=1, **kw):
    """JAX's sharded Stage-I steps on layout ``name``, the loop's keys
    (``fold_in(key(seed), step)``) and batches: the first step's state,
    and with ``n_steps`` the loss curve and final params, as JAX's
    ``run_flow_training`` steps them."""
    cfg, mesh = JDenCfg(**DEN), jmesh.make_mesh(4, **LAYOUTS[name])
    sh = jmesh.denoiser_param_shardings(inputs["den_params"], mesh)
    opt = jloop.make_optimizer(jloop.TrainLoopConfig(**{**OPT, **kw}))
    state = jflow.init_train_state(jmesh.shard_params(_jtree(inputs["den_params"]), sh), opt,
                                   param_shardings=sh, ema_decay=EMA)
    step = jflow.make_train_step(cfg, opt, p_uncond=P_UNCOND, mesh=mesh, attn_impl="chunked_train",
                                 remat=False, ema_decay=jloop._loop_ema_decay(jloop.TrainLoopConfig(**{**OPT, **kw})))
    batches = inputs["loop_batches"] + inputs["loop_batches"][:1]
    root, out, losses = jax.random.key(LOOP["seed"]), {}, []
    for i in range(n_steps):
        state, loss = step(state, _jtree(batches[i]), jax.random.fold_in(root, i))
        losses.append(float(loss))
        if i == 0 and not kw:
            out = _jstate_out(state, loss)
    return {**out, "losses": losses, "final": _port_named(state["params"])}


def _jax_dit_step(inputs, name):
    """JAX's sharded step of the Stage-0 DiT (``scripts/train.py --model
    stage0 --mesh``: T = 1) on layout ``name``, with the key of the DiT's
    draws."""
    mesh = jmesh.make_mesh(4, **LAYOUTS[name])
    sh = jmesh.denoiser_param_shardings(inputs["dit_params"], mesh)
    opt = jloop.make_optimizer(jloop.TrainLoopConfig(**OPT))
    state = jflow.init_train_state(jmesh.shard_params(_jtree(inputs["dit_params"]), sh), opt,
                                   param_shardings=sh, ema_decay=EMA)
    step = jflow.make_train_step(jdit_config(**DIT), opt, p_uncond=P_UNCOND, mesh=mesh,
                                 attn_impl="chunked_train", remat=False, ema_decay=EMA)
    state, loss = step(state, _jtree(inputs["dit_batch"]),
                       jax.random.fold_in(jax.random.key(LOOP["seed"]), DIT_DRAWS))
    return _jstate_out(state, loss)


def _jax_decoder_step(inputs):
    mesh = jmesh.make_mesh(4, **LAYOUTS["dp2_tp2"])
    sh = jmesh.autoencoder_param_shardings(inputs["ae_params"], mesh)
    opt = jloop.make_optimizer(jloop.TrainLoopConfig(**OPT))
    state = jflow.init_train_state(jmesh.shard_params(_jtree(inputs["ae_params"]), sh), opt,
                                   param_shardings=sh)
    step = jdec.make_decoder_train_step(JAECfg(**AE), opt, mesh=mesh, attn_impl="chunked_train",
                                        remat=False)
    state, loss = step(state, _jtree(inputs["decoder_batch"]))
    return _jstate_out(state, loss)


def _jax_distill_step(inputs, mode):
    mesh = jmesh.make_mesh(4, **LAYOUTS["dp2_tp2"])
    sh = jmesh.denoiser_param_shardings(inputs["den_params"], mesh)
    opt = jloop.make_optimizer(jloop.TrainLoopConfig(**OPT))
    teacher = jmesh.shard_params(_jtree(inputs["teacher_params"]), sh)
    state = jflow.init_train_state(jmesh.shard_params(_jtree(inputs["den_params"]), sh), opt,
                                   param_shardings=sh)
    step = jdistill.make_distill_step(JDenCfg(**DEN), opt, teacher, mode=mode, num_teacher_steps=4,
                                      mesh=mesh, attn_impl="chunked_train", teacher_attn_impl="chunked",
                                      remat=False)
    state, loss = step(state, _jtree(inputs["flow_batch"]), jax.random.fold_in(jax.random.key(LOOP["seed"]), 0))
    return _jstate_out(state, loss)


def _jax_cases(inputs) -> dict:
    """Every JAX case, in three spawned processes (tracing holds the GIL,
    so threads would run them one after another), the longest first. JAX's
    Stage-I step runs on its (dp 2, tp 2) mesh for three steps: the first
    is every layout's step case (JAX's own tests hold its layouts to one
    another), the three the plain loop's."""
    with ProcessPoolExecutor(3, mp_context=multiprocessing.get_context("spawn")) as ex:
        futures = {"flow": ex.submit(_jax_flow_steps, inputs, "dp2_tp2", 3)}
        futures["loop_accum"] = ex.submit(_jax_flow_steps, inputs, "dp2_tp2", 4, **ACCUM)
        for mode in ("progressive", "guidance"):
            futures[f"distill_{mode}"] = ex.submit(_jax_distill_step, inputs, mode)
        for name in DIT_LAYOUTS:
            futures[f"dit_{name}"] = ex.submit(_jax_dit_step, inputs, name)
        futures["decoder"] = ex.submit(_jax_decoder_step, inputs)
        out = {name: f.result() for name, f in futures.items()}
    out["loop_plain"] = out["flow"]
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """(JAX results, the port's world-4 results, the CLI run's dirs); the
    port's worlds run while the JAX side compiles."""
    tmp = tmp_path_factory.mktemp("parallel_train")
    inputs = _inputs(tmp)
    cli_out = tmp / "cli_mesh"
    cli_argv = CLI_ARGS + ["--mesh", "tp=2", "--out", str(cli_out), "--export-inference", str(cli_out / "exp")]
    port = World(train_rank, 4, inputs, tmp)
    cli = World(cli_rank, 2, {"argv": cli_argv}, tmp)
    try:
        jax_out = _jax_cases(inputs)
    except BaseException:
        port.kill()
        cli.kill()
        raise
    return inputs, jax_out, port.result(), {"rc": cli.result(), "dir": cli_out, "tmp": tmp}


def _close(got: dict, want: dict, rtol=MODEL_RTOL, what=""):
    """Each leaf within ``rtol`` of the largest |value| of its JAX leaf."""
    assert got.keys() == want.keys()
    for name in want:
        scale = max(float(np.abs(want[name]).max()), 1e-12)
        err = float(np.abs(got[name] - want[name]).max())
        assert err <= rtol * scale, f"{what}{name}: {err} > {rtol} * {scale}"


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ATTN_LAYOUTS)
def test_trainable_attention_grads_match_plain(worlds, layout):
    """dq, dk, dv of ``dot_product_attention(trainable=True, mesh=)`` on
    the shards, gathered, within 1e-5 of max|ref| of the plain unsharded
    backward; under sp the ring backward (sp 2, and sp 4 with a KV shard
    that one row's probabilities do not reach)."""
    inputs, _, port, _ = worlds
    a = inputs["attn"]
    q, k, v = (torch.from_numpy(a[n]).requires_grad_(True) for n in "qkv")
    out = chunked_attention_trainable(q, k, v)
    grads = torch.autograd.grad((out * torch.from_numpy(a["do"])).sum(), (q, k, v))
    want = {"out": out.detach().numpy(), **{n: g.numpy() for n, g in zip(("dq", "dk", "dv"), grads)}}
    _close(port[f"attn_{layout}"], want, rtol=1e-5)


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------

def _step_matches(got, want, what):
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=MODEL_RTOL)
    for part in ("params", "mu", "nu"):
        _close(got[part], want[part], what=f"{what} {part} ")
    # the step moved the params
    assert any(np.abs(got["params"][n] - want["params"][n]).max() < np.abs(want["mu"][n]).max()
               for n in want["params"])


@pytest.mark.parametrize("layout", TRAIN_LAYOUTS)
def test_sharded_train_step_matches_jax(worlds, layout):
    """One Stage-I step (clip by the whole model's norm, AdamW, EMA) on
    the mesh: the loss, the gathered params and Adam's moments against
    JAX's sharded step on the same draws."""
    _, jax_out, port, _ = worlds
    _step_matches(port[f"flow_{layout}"], jax_out["flow"], layout)


@pytest.mark.parametrize("layout", DIT_LAYOUTS)
def test_dit_step_on_mesh_matches_one_rank(worlds, layout):
    """The Stage-0 DiT's step (``--model stage0``: T = 1) on a mesh with
    sp, which splits no frame, so every sp rank runs the whole window: the
    shares of its gradient (``share_grad``) make the sums over dp and sp
    the step of one process (the port's, unsharded, in this process)."""
    inputs, _, port, _ = worlds
    from actionmesh_tpu_torch.models.denoiser import DenoiserConfig
    from actionmesh_tpu_torch.training.flow_train import init_train_state, make_train_step
    from actionmesh_tpu_torch.training.loop import TrainLoopConfig, make_optimizer

    cfg = DenoiserConfig(**{**inputs["dit_cfg"], "inflated_layers": tuple(inputs["dit_cfg"]["inflated_layers"])})
    opt = make_optimizer(TrainLoopConfig(**OPT))
    state = init_train_state(params_from_jax(inputs["dit_params"]), opt, ema_decay=EMA)
    step = make_train_step(cfg, opt, p_uncond=P_UNCOND, ema_decay=EMA)
    gen = torch.Generator().manual_seed(0)  # unused: the draws are given
    from actionmesh_tpu_torch.training import flow_train

    draws = inputs["draws"]["flow"][DIT_DRAWS]
    real = flow_train.draw_flow_noise
    flow_train.draw_flow_noise = lambda *a, **k: {n: torch.from_numpy(np.array(v)) for n, v in draws.items()}
    try:
        state, loss = step(state, {k: torch.from_numpy(v) for k, v in inputs["dit_batch"].items()}, gen)
    finally:
        flow_train.draw_flow_noise = real
    got = port[f"dit_{layout}"]
    np.testing.assert_allclose(got["loss"], float(loss), rtol=MODEL_RTOL)
    _close(got["params"], {n: t.detach().numpy() for n, t in named_leaves(state["params"])}, what=f"dit {layout} ")


@pytest.mark.parametrize("layout", DIT_LAYOUTS)
def test_dit_step_on_mesh_matches_jax(worlds, layout):
    """The Stage-0 DiT's step on a mesh with sp against JAX's sharded DiT
    step at the same layout (``scripts/train.py --model stage0 --mesh``):
    the loss, the gathered params and Adam's moments, on the same draws."""
    _, jax_out, port, _ = worlds
    _step_matches(port[f"dit_{layout}"], jax_out[f"dit_{layout}"], f"dit {layout}")


def test_optimizer_state_layout_matches_jax(worlds):
    """Each rank's moments are its tp slices of the params, as JAX's
    ``optimizer_state_shardings`` lays them out: the local shape of every
    moment leaf at (dp 2, tp 2) is the per-device shard shape of JAX's."""
    _, jax_out, port, _ = worlds
    want = {n: s[::-1] if n.endswith(".weight") else s for n, s in jax_out["flow"]["mu_shard"].items()}
    assert port["flow_dp2_tp2"]["mu_local_shapes"] == want


def test_decoder_step_matches_jax(worlds):
    """The Stage-II decoder's step at (dp 2, tp 2): T_out = 3 padded to
    the dp split, V = 12 with two padded vertices."""
    _, jax_out, port, _ = worlds
    _step_matches(port["decoder"], jax_out["decoder"], "decoder")


@pytest.mark.parametrize("mode", ["guidance", "progressive"])
def test_distill_step_matches_jax(worlds, mode):
    """A distillation step at (dp 2, tp 2), the teacher run on the mesh
    without gradients."""
    _, jax_out, port, _ = worlds
    _step_matches(port[f"distill_{mode}"], jax_out[f"distill_{mode}"], mode)


# ---------------------------------------------------------------------------
# The loop, checkpoints, resume, the CLI
# ---------------------------------------------------------------------------

def _ckpt_params(path: Path) -> dict:
    """The params of a port checkpoint as JAX's ``load_params`` reads the
    file (port names and layout)."""
    return _flat(jax.tree.map(np.asarray, jload_params(path)["params"]))


@pytest.mark.parametrize("run", ["plain", "accum"])
def test_sharded_loop_matches_jax(worlds, run):
    """``run_flow_training(mesh=)`` at (dp 2, tp 2): three steps (four
    micro-steps with grad_accum 2), EMA on, match JAX's sharded train step
    run as JAX's loop runs it (its keys, its batches) in the loss curve and
    the final params, read from the full-tree checkpoint rank 0 wrote."""
    inputs, jax_out, port, _ = worlds
    np.testing.assert_allclose(port[f"loop_{run}"], jax_out[f"loop_{run}"]["losses"], rtol=MODEL_RTOL)
    got = _ckpt_params(Path(inputs["tmp"]) / f"loop_{run}" / "ckpt_latest.npz")
    _close(got, jax_out[f"loop_{run}"]["final"], what=f"loop {run} ")


def test_checkpoint_is_full_tree_jax_reads(worlds):
    """The sharded run's checkpoint is the full tree: JAX's ``load_params``
    reads params, moments and EMA at the unsharded shapes, and the step
    count."""
    inputs, _, _, _ = worlds
    tree = jload_params(Path(inputs["tmp"]) / "loop_plain" / "ckpt_latest.npz")
    full = _flat(params_from_jax(inputs["den_params"]))
    for part in (tree["params"], tree["ema_params"], tree["opt_state"]["mu"], tree["opt_state"]["nu"]):
        assert {n: a.shape for n, a in _flat(jax.tree.map(np.asarray, part)).items()} == \
            {n: a.shape for n, a in full.items()}
    assert int(tree["step"]) == 3


def test_resume_at_other_layout_continues(worlds):
    """Two steps at (dp 2, tp 2), then the checkpoint resumed at (dp 1,
    tp 2, sp 2) for the third: the loss curve and final params of the
    uninterrupted run."""
    inputs, _, port, _ = worlds
    np.testing.assert_allclose(port["loop_first"] + port["loop_resumed"], port["loop_plain"], rtol=MODEL_RTOL)
    tmp = Path(inputs["tmp"])
    _close(_ckpt_params(tmp / "loop_resume" / "ckpt_latest.npz"),
           _ckpt_params(tmp / "loop_plain" / "ckpt_latest.npz"), what="resumed ")


def test_train_cli_mesh_matches_unsharded(worlds):
    """``train.py --mesh tp=2`` under a two-rank world (gloo, torchrun's
    environment) against the same command without ``--mesh``: rank 0's
    log, checkpoint and exported ``denoiser.npz`` (read by JAX's
    ``load_params``; both gathered over tp) match the unsharded run's."""
    _, _, _, cli = worlds
    assert cli["rc"] == 0
    plain = cli["tmp"] / "cli_plain"
    assert ttrain.main(CLI_ARGS + ["--out", str(plain), "--export-inference", str(plain / "exp")]) == 0

    def losses(d):
        return [json.loads(l)["loss"] for l in (d / "log.jsonl").read_text().splitlines()]

    np.testing.assert_allclose(losses(cli["dir"]), losses(plain), rtol=MODEL_RTOL)
    _close(_ckpt_params(cli["dir"] / "ckpt_latest.npz"), _ckpt_params(plain / "ckpt_latest.npz"))
    exported = [_flat(jax.tree.map(lambda a: np.asarray(a, np.float32), jload_params(d / "exp" / "denoiser.npz")))
                for d in (cli["dir"], plain)]
    _close(*exported, rtol=1e-2)  # bf16 exports: one rounding apart at most


def _scripts_parse_mesh():
    spec = importlib.util.spec_from_file_location(
        "_jax_train_script", Path(__file__).resolve().parents[1] / "scripts" / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.parse_mesh


@pytest.mark.parametrize("spec", ["dp=2,tp=2", "dp=2,tp=4,sp=2", "tp=8", "dp=2,pp=2", "dp=x", "dp2"])
def test_parse_mesh_matches_scripts(spec):
    """``--mesh`` takes what ``scripts/train.py`` takes, with its error text."""
    import argparse

    want = _scripts_parse_mesh()
    try:
        expected = want(spec)
    except argparse.ArgumentTypeError as e:
        with pytest.raises(argparse.ArgumentTypeError, match=str(e).replace("(", r"\(").replace(")", r"\)")):
            ttrain.parse_mesh(spec)
        return
    assert ttrain.parse_mesh(spec) == expected


def test_mesh_without_process_group_raises(tmp_path, monkeypatch):
    """``--mesh`` outside torchrun raises; it never trains unsharded."""
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="process group"):
        ttrain.main(CLI_ARGS + ["--mesh", "dp=2", "--out", str(tmp_path)])
    assert not (tmp_path / "log.jsonl").exists()
