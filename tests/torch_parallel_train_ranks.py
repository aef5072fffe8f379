"""The ranks of the port's gloo worlds in tests/test_torch_parallel_train.py.

Each function runs in a spawned process (one per rank, CPU, gloo; see
``tests/torch_parallel_ranks.py:World``) and imports only torch and the
port. The random draws of the losses are JAX's own, made in the test
process and handed to the port's draw functions by step (patched in the
rank's process only), so the sharded port and the sharded JAX package see
the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from tests.torch_parallel_ranks import CPU, LAYOUTS, attention_split

TRAIN_LAYOUTS = ("dp2_tp2", "dp2_sp2", "tp2_sp2")
ATTN_LAYOUTS = ("dp2_tp2", "dp2_sp2", "tp2_sp2", "sp4")
DIT_LAYOUTS = ("dp2_sp2", "tp2_sp2")
DIT_DRAWS = 4  # the DiT step's draws: the flow draws' fifth (the loops use the first four)


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(b: dict) -> dict:
    return {k: _t(v) for k, v in b.items()}


def _patch_draws(draws: dict) -> None:
    """The port's draw functions return ``draws[kind][step]``, the step
    read off the generator's seed (``step_generator`` patched to seed it
    with the step)."""
    from actionmesh_tpu_torch.training import distill, flow_train, loop

    loop.step_generator = lambda seed, step: torch.Generator().manual_seed(step)

    def by_step(kind):
        return lambda gen, *a, **k: {n: _t(v) for n, v in draws[kind][gen.initial_seed()].items()}

    flow_train.draw_flow_noise = by_step("flow")
    distill.draw_guidance_noise = by_step("guidance")
    distill.draw_progressive_noise = by_step("progressive")


def _gathered(tree, shardings, mesh) -> dict:
    from actionmesh_tpu_torch.parallel.mesh import gather_params
    from actionmesh_tpu_torch.utils.tree import named_leaves

    return {n: t.detach().float().numpy() for n, t in named_leaves(gather_params(tree, shardings, mesh))}


def _state_out(state, loss, shardings, mesh) -> dict:
    opt = state["opt_state"]
    from actionmesh_tpu_torch.utils.tree import named_leaves

    return {"loss": float(loss), "params": _gathered(state["params"], shardings, mesh),
            "mu": _gathered(opt["mu"], shardings, mesh), "nu": _gathered(opt["nu"], shardings, mesh),
            "mu_local_shapes": {n: tuple(t.shape) for n, t in named_leaves(opt["mu"])}}


def train_rank(rank, world, inputs):
    """Trainable attention per layout, one Stage-I step per layout (and the
    Stage-0 DiT's on the sp layouts), the three-step loop (plain and grad_accum 2) with its checkpoint and a
    resume at another layout, the decoder step and both distillation
    steps."""
    from actionmesh_tpu_torch.parallel.mesh import init_distributed, make_mesh

    init_distributed(device_type="cpu")
    _patch_draws(inputs["draws"])
    out = {}
    for name in ATTN_LAYOUTS:
        out[f"attn_{name}"] = _attention_grads(inputs["attn"], make_mesh(**LAYOUTS[name]))
    for name in TRAIN_LAYOUTS:
        out[f"flow_{name}"] = _flow_step(inputs, make_mesh(**LAYOUTS[name]))
    for name in DIT_LAYOUTS:  # T = 1: sp splits no frame, every sp rank runs them all
        out[f"dit_{name}"] = _flow_step(inputs, make_mesh(**LAYOUTS[name]), "dit_cfg", "dit_params", "dit_batch",
                                        step_index=DIT_DRAWS)
    dp2_tp2 = make_mesh(**LAYOUTS["dp2_tp2"])
    out["decoder"] = _decoder_step(inputs, dp2_tp2)
    for mode in ("guidance", "progressive"):
        out[f"distill_{mode}"] = _distill_step(inputs, dp2_tp2, mode)
    out.update(_loops(inputs, dp2_tp2, make_mesh(**LAYOUTS["tp2_sp2"])))
    return out


def _attention_grads(a: dict, mesh) -> dict:
    """``dot_product_attention(trainable=True, mesh=)`` on each rank's
    shard (cut by ``attention_split``, the ring backward where the sequence
    splits), the loss sum(out * dout); the gathered (out, dq, dk, dv)."""
    from actionmesh_tpu_torch.ops.attention import dot_product_attention
    from actionmesh_tpu_torch.parallel.mesh import gather_shards, local_shard

    q, k, v, do = (_t(a[key]) for key in ("q", "k", "v", "do"))
    b_axes, heads, seq = attention_split(mesh, q.shape[0], q.shape[1], q.shape[2], k.shape[2])
    h_axes, s_axes = ("tp",) if heads else (), ("sp",) if seq else ()

    def shard(x):
        return local_shard(local_shard(local_shard(x, 0, mesh, b_axes), 1, mesh, h_axes), 2, mesh, s_axes)

    def gather(x):
        return gather_shards(gather_shards(gather_shards(x, 2, mesh, s_axes), 1, mesh, h_axes), 0, mesh, b_axes)

    leaves = [shard(x).clone().requires_grad_(True) for x in (q, k, v)]
    o = dot_product_attention(*leaves, trainable=True, mesh=mesh, sequence_parallel=seq)
    grads = torch.autograd.grad((o * shard(do)).sum(), leaves)
    return {n: gather(x.detach()).numpy() for n, x in zip(("out", "dq", "dk", "dv"), (o, *grads))}


def _optimizer(kw: dict):
    from actionmesh_tpu_torch.training.loop import TrainLoopConfig, make_optimizer

    return make_optimizer(TrainLoopConfig(**kw))


def _cut(params, mesh, shardings_fn, cfg):
    """(this rank's slices of ``params``, their spec tree)."""
    from actionmesh_tpu_torch.parallel.mesh import shard_params

    shardings = shardings_fn(params, mesh, cfg.num_attention_heads)
    return shard_params(params, shardings, mesh), shardings


def _flow_step(inputs: dict, mesh, cfg_key="den_cfg", params_key="den_params", batch_key="flow_batch",
               step_index=0) -> dict:
    from actionmesh_tpu_torch.models.denoiser import DenoiserConfig
    from actionmesh_tpu_torch.parallel.mesh import denoiser_param_shardings
    from actionmesh_tpu_torch.training.flow_train import init_train_state, make_train_step
    from actionmesh_tpu_torch.training.loop import step_generator
    from actionmesh_tpu_torch.utils.weights import params_from_jax

    cfg = DenoiserConfig(**inputs[cfg_key])
    params, shardings = _cut(params_from_jax(inputs[params_key]), mesh, denoiser_param_shardings, cfg)
    opt = _optimizer(inputs["opt"])
    state = init_train_state(params, opt, ema_decay=inputs["ema"])
    step = make_train_step(cfg, opt, p_uncond=inputs["p_uncond"], ema_decay=inputs["ema"], mesh=mesh,
                           shardings=shardings)
    state, loss = step(state, _batch(inputs[batch_key]), step_generator(0, step_index))
    return _state_out(state, loss, shardings, mesh)


def _decoder_step(inputs: dict, mesh) -> dict:
    from actionmesh_tpu_torch.models.autoencoder import AutoencoderConfig
    from actionmesh_tpu_torch.parallel.mesh import autoencoder_param_shardings
    from actionmesh_tpu_torch.training.decoder_train import make_decoder_train_step
    from actionmesh_tpu_torch.training.flow_train import init_train_state
    from actionmesh_tpu_torch.utils.weights import params_from_jax

    cfg = AutoencoderConfig(**inputs["ae_cfg"])
    params, shardings = _cut(params_from_jax(inputs["ae_params"]), mesh, autoencoder_param_shardings, cfg)
    opt = _optimizer(inputs["opt"])
    state = init_train_state(params, opt)
    step = make_decoder_train_step(cfg, opt, mesh=mesh, shardings=shardings)
    state, loss = step(state, _batch(inputs["decoder_batch"]), None)
    return _state_out(state, loss, shardings, mesh)


def _distill_step(inputs: dict, mesh, mode: str) -> dict:
    from actionmesh_tpu_torch.models.denoiser import DenoiserConfig
    from actionmesh_tpu_torch.parallel.mesh import denoiser_param_shardings
    from actionmesh_tpu_torch.training.distill import make_distill_step
    from actionmesh_tpu_torch.training.flow_train import init_train_state
    from actionmesh_tpu_torch.training.loop import step_generator
    from actionmesh_tpu_torch.utils.weights import params_from_jax

    cfg = DenoiserConfig(**inputs["den_cfg"])
    teacher, shardings = _cut(params_from_jax(inputs["teacher_params"]), mesh, denoiser_param_shardings, cfg)
    student = _cut(params_from_jax(inputs["den_params"]), mesh, denoiser_param_shardings, cfg)[0]
    opt = _optimizer(inputs["opt"])
    state = init_train_state(student, opt)
    step = make_distill_step(cfg, opt, teacher, mode=mode, num_teacher_steps=4, mesh=mesh,
                             shardings=shardings)
    state, loss = step(state, _batch(inputs["flow_batch"]), step_generator(0, 0))
    return _state_out(state, loss, shardings, mesh)


def _loops(inputs: dict, mesh, other_mesh) -> dict:
    """``run_flow_training(mesh=)`` for three steps, plain and with
    grad_accum 2, and a run of two steps at ``mesh`` resumed for the third
    at ``other_mesh``; each run's history (the checkpoints stay on disk for
    the test process)."""
    from actionmesh_tpu_torch.models.denoiser import DenoiserConfig
    from actionmesh_tpu_torch.training.loop import TrainLoopConfig, run_flow_training
    from actionmesh_tpu_torch.utils.weights import params_from_jax

    cfg = DenoiserConfig(**inputs["den_cfg"])
    batches = [_batch_np(b) for b in inputs["loop_batches"]]
    out = {}

    def run(name, layout_mesh, items, **kw):
        loop_cfg = TrainLoopConfig(**{**inputs["loop_cfg"], **kw, "out_dir": f"{inputs['tmp']}/{name}"})
        _, hist = run_flow_training(cfg, iter(items), loop_cfg, device=CPU,
                                    params=params_from_jax(inputs["den_params"]), mesh=layout_mesh)
        return [h["loss"] for h in hist if "loss" in h]

    out["loop_plain"] = run("loop_plain", mesh, batches)
    out["loop_accum"] = run("loop_accum", mesh, batches + batches[:1], **inputs["accum_cfg"])
    out["loop_first"] = run("loop_resume", mesh, batches[:2])
    out["loop_resumed"] = run("loop_resume", other_mesh, batches[2:])
    return out


def _batch_np(b: dict) -> dict:
    return {k: np.array(v) for k, v in b.items()}


def cli_rank(rank, world, inputs):
    """``train.py --mesh`` through its ``main``, as torchrun would start it
    (the environment set by ``World``); rank 0 returns the exit code."""
    from actionmesh_tpu_torch import train

    return train.main(inputs["argv"])
