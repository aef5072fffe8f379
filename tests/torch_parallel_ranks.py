"""The ranks of the port's gloo worlds in tests/test_torch_parallel.py.

Each function here runs in a spawned process (one per rank, CPU, gloo) and
imports only torch and the port, so a rank pays no JAX import. The test
process builds every input with numpy (and the JAX package's weights), runs
the JAX side, spawns one world per file and compares; rank 0 puts its
results on a queue.
"""

from __future__ import annotations

import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

LAYOUTS = {
    "dp2_tp2": dict(dp=2, tp=2),
    "dp2_sp2": dict(dp=2, tp=1, sp=2),
    "tp2_sp2": dict(dp=1, tp=2, sp=2),
    "sp4": dict(dp=1, tp=1, sp=4),
}
CPU = torch.device("cpu")


class World:
    """``world`` spawned gloo ranks running ``target(rank, world, inputs)``;
    ``result()`` is rank 0's return value, after every rank exited with
    code 0."""

    def __init__(self, target, world: int, inputs: dict, tmp_dir):
        import pickle
        import socket
        from pathlib import Path

        import torch.multiprocessing as mp

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        # the inputs go by file: a spawn argument of megabytes fills the
        # pipe, and each start would wait for its child's imports
        path = Path(tmp_dir) / f"inputs_{target.__name__}.pkl"
        path.write_bytes(pickle.dumps(inputs))
        ctx = mp.get_context("spawn")
        self.queue = ctx.Queue()
        self.procs = [ctx.Process(target=_rank_entry, args=(target, r, world, port, str(path), self.queue))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def kill(self) -> None:
        for p in self.procs:
            p.kill()
            p.join()

    def result(self, timeout: float = 240.0):
        try:
            status, payload = self.queue.get(timeout=timeout)
        finally:
            for p in self.procs:
                p.join(timeout=60)
                if p.is_alive():
                    p.kill()
        codes = [p.exitcode for p in self.procs]
        if status != "ok":
            raise RuntimeError(f"rank 0 failed:\n{payload}")
        if any(codes):
            raise RuntimeError(f"rank exit codes {codes}")
        return payload


def _rank_entry(target, rank, world, port, inputs_path, queue):
    import pickle

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    try:
        with open(inputs_path, "rb") as f:
            inputs = pickle.load(f)
        out = target(rank, world, inputs)
        if rank == 0:
            queue.put(("ok", out))
    except BaseException:
        if rank == 0:
            queue.put(("error", traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _n(x):
    return x.detach().float().numpy()


def _spec_tree(tree):
    return {k: _spec_tree(v) for k, v in tree.items()} if isinstance(tree, dict) else (
        [_spec_tree(v) for v in tree] if isinstance(tree, list) else tree)


def cases_rank(rank, world, inputs):
    """Every layout's cases: attention, the attention layer with kernel B
    (qk-norm and RoPE), a denoise window, Stage II, Stage 0's sampler, the
    tiny pipeline, the spec trees and the mesh; at (dp 2, tp 2) also the
    {video + 3D} pipeline."""
    from actionmesh_tpu_torch.models.autoencoder import AutoencoderConfig, autoencoder_forward
    from actionmesh_tpu_torch.models.denoiser import DenoiserConfig
    from actionmesh_tpu_torch.models.triposg.pipeline import flow_sample
    from actionmesh_tpu_torch.parallel.mesh import (
        autoencoder_param_shardings,
        denoiser_param_shardings,
        init_distributed,
        make_mesh,
        shard_params,
    )
    from actionmesh_tpu_torch.sampling.denoise_loop import denoise_window
    from actionmesh_tpu_torch.sampling.guidance import make_guidance
    from actionmesh_tpu_torch.utils.weights import params_from_jax

    init_distributed(device_type="cpu")
    default = make_mesh()
    out = {"default_mesh": (default.mesh_dim_names, tuple(default.shape))}
    a, r, d, ae, fs, pl = (inputs[k] for k in ("attn", "rope", "denoise", "ae", "flow", "pipeline"))
    if rank == 0:
        out["pipeline_unsharded"] = _run_tiny_pipeline(pl, None)
    den_params = params_from_jax(d["params"])
    ae_params = params_from_jax(ae["params"])
    dcfg = DenoiserConfig(**d["cfg"])
    acfg = AutoencoderConfig(**ae["cfg"])
    guidance = make_guidance(*d["guidance"])
    for name, lay in LAYOUTS.items():
        mesh = make_mesh(**lay)
        res = out[name] = {"mesh": (mesh.mesh_dim_names, tuple(mesh.shape))}
        res["attn"] = _n(_attention_on_shards(a, mesh))
        res["rope"] = _n(_attention_layer_on_shards(r, mesh))
        dspec = denoiser_param_shardings(den_params, mesh, dcfg.num_attention_heads)
        res["denoiser_spec"] = _spec_tree(dspec)
        den_local = shard_params(den_params, dspec, mesh)
        res["denoise"] = _n(denoise_window(
            den_local, dcfg, guidance, _t(d["init_latent"]),
            _t(d["context"]), _t(d["mask"]), _t(d["framestep"]), _t(d["ts"]), _t(d["dist"]),
            mesh=mesh,
        ))
        aspec = autoencoder_param_shardings(ae_params, mesh, acfg.num_attention_heads)
        res["autoencoder_spec"] = _spec_tree(aspec)
        res["ae"] = _n(autoencoder_forward(
            shard_params(ae_params, aspec, mesh), acfg, *(_t(ae[k]) for k in
                                                          ("latent", "framestep", "sa", "ta", "query")),
            mesh=mesh,
        ))
        for scale in (7.5, None):  # the denoiser as a DiT (T = 1), as JAX's test_parallel
            res[f"flow_{scale}"] = _n(flow_sample(
                den_local, dcfg, _t(fs["noise"]), _t(fs["context"]), fs["ts"], fs["dist"],
                guidance_scale=scale, mesh=mesh,
            ))
        res["pipeline"] = _run_tiny_pipeline(pl, mesh)
        if name == "dp2_tp2":
            res["pipeline_3d"] = _run_tiny_pipeline_3d(pl, inputs["p3d"], mesh)
    return out


def _attention_layer_on_shards(r: dict, mesh) -> torch.Tensor:
    """``models/layers.attention`` (qk rms-norm and half-layout RoPE, kernel
    B's path) as the denoiser runs it under ``mesh``: the rank's batch rows
    (dp) and sequence rows (sp, the ring) with their RoPE table rows, the
    heads over tp (``shard_params``); the output gathered."""
    from actionmesh_tpu_torch.models.layers import attention
    from actionmesh_tpu_torch.parallel.mesh import COL, ROW, gather_shards, local_shard, shard_params, split_axes
    from actionmesh_tpu_torch.utils.weights import params_from_jax

    params = params_from_jax(r["params"])
    spec = {k: {n: None if k.startswith("norm") else (ROW if k == "to_out" else COL)[n] for n in v}
            for k, v in params.items()}
    x, cos, sin = _t(r["x"]), _t(r["cos"]), _t(r["sin"])
    b_axes, s_axes = split_axes(x.shape[0], mesh, ("dp",)), split_axes(x.shape[1], mesh, ("sp",))

    def shard(t):
        return local_shard(local_shard(t, 0, mesh, b_axes), 1, mesh, s_axes).contiguous()

    out = attention(shard_params(params, spec, mesh), shard(x), r["heads"], freqs_rot=(shard(cos), shard(sin)),
                    mesh=mesh, sequence_parallel=bool(s_axes))
    return gather_shards(gather_shards(out, 1, mesh, s_axes), 0, mesh, b_axes)


def attention_split(mesh, B: int, H: int, Sq: int, Sk: int):
    """How a whole (B, H, Sq|Sk, D) attention operand splits over the mesh:
    (batch axes, heads over tp, sequence over sp). JAX
    ``_sharded_attention``'s rule: batch over dp, heads over tp, the
    sequence over sp (the ring) when Sq == Sk and sp divides it; without
    the sequence split, the batch over (dp, sp) or sp when they divide it
    (per-frame attention). An axis that does not divide leaves its
    dimension whole."""
    from actionmesh_tpu_torch.parallel.mesh import axis_size, split_axes

    dp, sp = axis_size(mesh, "dp"), axis_size(mesh, "sp")
    b_axes = split_axes(B, mesh, ("dp",))
    heads = bool(split_axes(H, mesh, ("tp",)))
    seq = sp > 1 and Sq == Sk and Sq % sp == 0
    if not seq and sp > 1:
        if b_axes and B % (dp * sp) == 0:
            b_axes = ("dp", "sp")
        elif not b_axes and B % sp == 0:
            b_axes = ("sp",)
    return b_axes, heads, seq


def _attention_on_shards(a: dict, mesh) -> torch.Tensor:
    """Attention as the layers run it under ``mesh``: each rank cuts its
    shard of the whole q, k, v and mask by JAX ``_sharded_attention``'s rule
    (``attention_split``), runs ``dot_product_attention(mesh=,
    sequence_parallel=)`` on it (the ring when the sequence splits), and
    the shards are gathered back."""
    from actionmesh_tpu_torch.ops.attention import dot_product_attention
    from actionmesh_tpu_torch.parallel.mesh import gather_shards, local_shard

    q, k, v, mask = (_t(a[key]) for key in ("q", "k", "v", "mask"))
    b_axes, heads, seq = attention_split(mesh, q.shape[0], q.shape[1], q.shape[2], k.shape[2])
    h_axes, s_axes = ("tp",) if heads else (), ("sp",) if seq else ()

    def shard(x):
        return local_shard(local_shard(local_shard(x, 0, mesh, b_axes), 1, mesh, h_axes), 2, mesh, s_axes)

    out = dot_product_attention(shard(q), shard(k), shard(v), mesh=mesh, sequence_parallel=seq,
                                kv_mask=local_shard(local_shard(mask, 0, mesh, b_axes), 1, mesh, s_axes))
    return gather_shards(gather_shards(gather_shards(out, 2, mesh, s_axes), 1, mesh, h_axes), 0, mesh, b_axes)


def _tiny_pipeline(pl: dict, device_mesh, cls=None, **kw):
    """The tiny port pipeline of ``pl`` (its config, DINOv2 and Stage I/II
    weights, a fixed Stage-0 latent and sphere, numpy Stage-I noise);
    ``kw`` to ``cls``."""
    import actionmesh_tpu_torch.pipeline as tpipeline_mod
    from actionmesh_tpu_torch.models.dinov2 import DinoV2Config
    from actionmesh_tpu_torch.models.image_encoder import ImageEncoder
    from actionmesh_tpu_torch.models.stage0 import make_uv_sphere
    from actionmesh_tpu_torch.utils.weights import params_from_jax

    def noise(gen, shape, batch_size, n_timesteps, **_):
        return torch.from_numpy(np.random.default_rng(2).standard_normal(
            (batch_size, n_timesteps) + tuple(shape)).astype(np.float32))

    tpipeline_mod.get_noise = noise  # this rank's process only
    latent = torch.from_numpy(pl["latent"])
    pipe = (cls or tpipeline_mod.ActionMeshPipeline)(
        config_name="actionmesh", weights_dir=None, device=CPU, dtype=torch.float32,
        config_updates=dict(pl["updates"]),
        image_encoder=ImageEncoder(CPU, torch.float32, DinoV2Config(**pl["dino_cfg"]),
                                   params=params_from_jax(pl["dino"])),
        image_to_3d=lambda image, **_: (latent, make_uv_sphere(n_lat=8, n_lon=16)),
        device_mesh=device_mesh, **kw,
    )
    return pipe.load_native(pl["weights_dir"])


def _run_tiny_pipeline(pl: dict, mesh):
    from actionmesh_tpu_torch.io.video_input import ActionMeshInput

    pipe = _tiny_pipeline(pl, mesh)
    meshes = pipe(ActionMeshInput(frames=list(pl["frames"]), timesteps=pl["timesteps"].copy()), seed=44)
    return np.stack([m.vertices for m in meshes]), meshes[0].faces


def _run_tiny_pipeline_3d(pl: dict, p3d: dict, mesh):
    """The tiny {video + 3D} pipeline on ``mesh``: its VAE a tiny TripoSG
    of ``p3d``'s weights, whose seeded encode takes JAX's draws."""
    import actionmesh_tpu_torch.models.triposg.pipeline as tripo_mod
    from actionmesh_tpu_torch.io.mesh import Mesh
    from actionmesh_tpu_torch.io.video_input import ActionMeshInput
    from actionmesh_tpu_torch.models.triposg.vae import TripoSGVAEConfig
    from actionmesh_tpu_torch.pipeline_with_3d import ActionMeshPipelineWithMeshInput
    from actionmesh_tpu_torch.utils.weights import params_from_jax

    tripo_mod.encode_draws = lambda *a, **k: p3d["draws"]  # this rank's process only
    vae = tripo_mod.TripoSGPipeline(None, params_from_jax(p3d["vae_params"]), None,
                                    vae_cfg=TripoSGVAEConfig(**p3d["vae_cfg"]), dtype=torch.float32, device=CPU)
    pipe = _tiny_pipeline(pl, mesh, cls=ActionMeshPipelineWithMeshInput, vae=vae,
                          surface_samples=p3d["surface_samples"])
    anchor = Mesh(vertices=p3d["anchor"][0].copy(), faces=p3d["anchor"][1].copy())
    meshes = pipe(ActionMeshInput(frames=list(pl["frames"]), timesteps=pl["timesteps"].copy()),
                  anchor_mesh=anchor, seed=3)
    return np.stack([m.vertices for m in meshes]), meshes[0].faces


def server_rank(rank, world, inputs):
    """``build_server`` at this world on gloo (``--device cpu``), the tiny
    pipeline standing in for the preset's: rank 0 answers /healthz, a
    request that fails on every rank and then a good one over HTTP, then
    stops the workers."""
    import json
    import threading
    import urllib.error
    import urllib.request

    import actionmesh_tpu_torch.pipeline as tpipeline_mod
    from actionmesh_tpu_torch.inference import serve

    pl = inputs["pipeline"]
    real = tpipeline_mod.ActionMeshPipeline
    tpipeline_mod.ActionMeshPipeline = lambda **kwargs: _tiny_pipeline(pl, "auto", cls=real)
    try:
        httpd, server = serve.build_server(["--device", "cpu", "--port", "0", "--dtype", "float32"])
    finally:
        tpipeline_mod.ActionMeshPipeline = real
    if httpd is None:
        return None
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    def post(**fields):
        body = json.dumps({"input": inputs["frames_dir"], "output_dir": inputs["out_dir"],
                           "seed": 44, **fields}).encode()
        req = urllib.request.Request(f"{url}/v1/video_to_4d", data=body, method="POST",
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        # raises on both ranks (no frame 99), after the same collectives
        failed_status, _ = post(anchor_idx=99)
        status, reply = post()
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as resp:
            health_after = json.loads(resp.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        server.stop_workers()
    return {"health": health, "health_after": health_after, "failed_status": failed_status,
            "status": status, "reply": reply}
