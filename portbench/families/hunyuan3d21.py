"""Hunyuan3D-2.1's shape model as ActionMesh's Stage 0.

The interface is the one ``families/actionmesh.py`` documents. Stage 0 is
tencent/Hunyuan3D-2.1's (``models/hunyuan3d/`` in the port): its own
DINOv2-L at 518^2 on the recentred anchor frame, 50 CFG steps of the
sparse-expert DiT over 4,096 latents, the ShapeVAE's SDF decode and
extraction, and the handoff: the mesh's surface encoded by TripoSG's VAE
into the latent Stage I starts from. The plain reference is
``reference/hunyuan3d21.py``. The video mode only: {video + 3D} bypasses
Stage 0, so it would run the release's family.

Stage 0's compared numbers:
  s0_gate   the router's scores of every expert block at the DiT's last
            step and at one drawn from the seed (both CFG branches, every
            token): the program's against the reference's, worst block;
  s0_route  at those steps, the tokens whose top-k the program picked
            otherwise than the reference: the largest of their gaps
            between the reference's k-th and (k+1)-th scores (0 when every
            pick agrees). A random router sits near uniform, so rounding
            flips picks whose scores nearly tie; its limit is the tie band;
  s0_v      the DiT's prediction at those steps (both branches), the
            reference's experts run on the program's picks (``route``),
            so that a flip inside the band is not read as an error of the
            products;
  s0_step   the Euler update at those steps;
  sdf       the decoder's field values at a sample of the fine pass's
            queries;
  s0_vae    the handoff's encode: TripoSG's posterior sample of the
            generated mesh's surface samples.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.bench import check, port
from portbench.families import actionmesh as tripo
from portbench.reference import hunyuan3d21 as H
from portbench.reference import layout


def networks(mode: str) -> list[str]:
    if mode != "video":
        raise ValueError(f"the hunyuan3d21 family has no {mode!r} mode: {{video + 3D}} bypasses Stage 0")
    return ["dinov2", "triposg_vae", "denoiser", "autoencoder", "hunyuan3d_dinov2", "hunyuan3d_dit",
            "hunyuan3d_vae"]


def layouts(model: dict, nets) -> dict[str, layout.Layout]:
    makers = {
        "dinov2": lambda: layout.dinov2(model["dinov2"]),
        "triposg_vae": lambda: layout.triposg_vae(model["triposg_vae"]),
        "denoiser": lambda: layout.flow_transformer(model["denoiser"]),
        "autoencoder": lambda: layout.autoencoder(model["autoencoder"]),
        "hunyuan3d_dinov2": lambda: layout.dinov2(model["hunyuan3d_dinov2"]),
        "hunyuan3d_dit": lambda: H.dit_layout(model["hunyuan3d_dit"]),
        "hunyuan3d_vae": lambda: H.vae_layout(model["hunyuan3d_vae"]),
    }
    return {n: makers[n]() for n in nets}


def build(cfg: dict, states: dict, mode: str, device):
    """DINOv2, Hunyuan3D-2.1 (its conditioner, DiT and decoder, with the
    port's development SDF regulariser on the random-weight field) handing
    over through TripoSG's VAE, the Stage-I denoiser and the Stage-II
    autoencoder."""
    from actionmesh_tpu_torch.models import stage0
    from actionmesh_tpu_torch.models.dinov2 import DinoV2Config
    from actionmesh_tpu_torch.models.hunyuan3d import convert as C
    from actionmesh_tpu_torch.models.hunyuan3d.dit import hunyuan3d_dit_config
    from actionmesh_tpu_torch.models.hunyuan3d.pipeline import (
        Conditioner,
        Hunyuan3DPipeline,
        hunyuan3d_vae_config,
    )
    from actionmesh_tpu_torch.models.triposg.pipeline import TripoSGPipeline
    from actionmesh_tpu_torch.models.triposg.vae import TripoSGVAEConfig
    from actionmesh_tpu_torch.utils import weights as W

    dtype = port.DTYPES[cfg["dtype"]]
    m = cfg["model"]
    encoder = port.image_encoder(cfg, states, device)
    d, v, c, t = m["hunyuan3d_dit"], m["hunyuan3d_vae"], m["hunyuan3d_dinov2"], m["triposg_vae"]
    dit_cfg = hunyuan3d_dit_config(
        num_tokens=d["num_tokens"], in_channels=d["in_channels"], num_layers=d["num_layers"],
        width=d["width"], num_attention_heads=d["num_attention_heads"],
        cross_attention_dim=d["cross_attention_dim"], mlp_ratio=d["mlp_ratio"],
        num_moe_layers=d["num_moe_layers"], num_experts=d["num_experts"], moe_top_k=d["moe_top_k"])
    vae_cfg = dataclasses.replace(
        hunyuan3d_vae_config(num_tokens=v["num_tokens"], latent_channels=v["latent_channels"],
                             width=v["width"], layers=v["layers"], heads=v["heads"]),
        embed_frequency=v["embed_frequency"], scale_factor=v["scale_factor"])
    cond_cfg = DinoV2Config(hidden_size=c["hidden_size"], num_layers=c["num_layers"],
                            num_heads=c["num_heads"], mlp_ratio=c["mlp_ratio"],
                            patch_size=c["patch_size"], image_size=c["image_size"],
                            eps=c["layer_norm_eps"])
    tcfg = TripoSGVAEConfig(
        latent_channels=t["latent_channels"], num_tokens=t["num_tokens"],
        embed_frequency=t["embed_frequency"], encoder_width=t["encoder_width"],
        encoder_layers=t["encoder_layers"], encoder_heads=t["encoder_heads"],
        decoder_width=t["decoder_width"], decoder_layers=t["decoder_layers"],
        decoder_heads=t["decoder_heads"])
    handoff = TripoSGPipeline(
        None, W.params_from_jax(W.convert_triposg_vae(states["triposg_vae"], tcfg, dtype), device),
        None, vae_cfg=tcfg, dtype=dtype, device=device)
    conditioner = Conditioner(
        W.params_from_jax(C.convert_conditioner(states["hunyuan3d_dinov2"], cond_cfg, dtype), device),
        cond_cfg, dtype, device)
    hy = Hunyuan3DPipeline(
        W.params_from_jax(C.convert_dit(states["hunyuan3d_dit"], dit_cfg, dtype), device),
        W.params_from_jax(C.convert_vae(states["hunyuan3d_vae"], vae_cfg, dtype), device),
        conditioner, handoff, dit_cfg=dit_cfg, vae_cfg=vae_cfg, dtype=dtype, device=device,
        shift=cfg["stage0_sampler"]["shift"], surface_samples=cfg["surface_samples"])
    hy.sdf_regularizer = stage0._dev_sdf_regularizer
    hy.sdf_regularizer_torch = stage0._dev_sdf_regularizer_torch
    return port.pipeline(cfg, states, mode, device, encoder, tripo.Stage0(hy, cfg["stage0_decode"]))


# -- the capture ------------------------------------------------------------

# TripoSG's draws (the DiT's checked steps, the SDF rows), profiled spans and SDF line
plan, spans, report = tripo.plan, tripo.spans, tripo.report


def new_capture() -> dict:
    return {"dit": {}, "gate": {}, "sdf": [], "vae": None, "image": None, "hy_latent": None}


def capture(hooks) -> None:
    """The conditioner's image, the DiT's inputs and outputs and every
    expert block's router at the checked steps, the latent the decoder
    reads, a sample of SDF queries, and the handoff's encode (the latent
    Stage I starts from)."""
    import actionmesh_tpu_torch.models.layers as layers_mod
    import actionmesh_tpu_torch.models.triposg.pipeline as tsg_mod
    import actionmesh_tpu_torch.models.triposg.vae as vae_mod

    hy = hooks.pipe.image_to_3d.tsg
    dit = None
    step = None  # the checked step the DiT call in progress belongs to

    def dit_forward(orig):
        def f(params, cfg, latents, *a, **k):
            nonlocal step
            if hooks.recording and dit is not None:
                s = dit.rows // dit.per_step
                step = s if s in dit.steps else None
            try:
                out = orig(params, cfg, latents, *a, **k)
            finally:
                step = None
            if hooks.recording and dit is not None:
                dit.call(latents, out)
            return out
        return f

    hooks.patch(tsg_mod, "triposg_dit_forward", dit_forward)

    def moe_route(orig):
        def f(gate, h, top_k):
            scores, weights, experts = orig(gate, h, top_k)
            if step is not None:
                hooks.cap["gate"].setdefault(step, []).append(
                    {"scores": port.detach(scores), "top": port.detach(experts)})
            return scores, weights, experts
        return f

    hooks.patch(layers_mod, "moe_route", moe_route)

    def flow_sample(orig):
        def f(*a, **k):
            nonlocal dit
            if not hooks.recording:
                return orig(*a, **k)
            args = port.bind(orig, a, k)
            B = args["init_noise"].shape[0]
            dit = port.Steps(B, B if args["guidance_scale"] is None else 2 * B,
                             hooks.plan["dit_steps"])
            out = orig(*a, **k)
            hooks.cap["dit"] = dit.close(out)
            dit = None
            return out
        return f

    hooks.patch(tsg_mod, "flow_sample", flow_sample)

    def decode_kv(orig):
        def f(params, cfg, latents, *a, **k):
            if hooks.recording:
                hooks.cap["hy_latent"] = port.detach(latents)
            return orig(params, cfg, latents, *a, **k)
        return f

    hooks.patch(tsg_mod, "decode_kv", decode_kv)

    def query_chunk(orig):
        def f(params, cfg, kv, pts, mesh=None, compute_dtype=None):
            vals = orig(params, cfg, kv, pts, mesh, compute_dtype)
            if hooks.recording and compute_dtype is None:
                n = hooks.plan["sdf_rows"]
                stride = max(1, pts.shape[0] // n)
                rows = torch.arange(len(hooks.cap["sdf"]) % stride, pts.shape[0], stride,
                                    device=pts.device)[:n]
                hooks.cap["sdf"].append({"pts": pts[rows], "vals": vals[rows]})
            return vals
        return f

    hooks.patch(vae_mod, "_query_chunk", query_chunk)
    hooks.patch(tsg_mod, "_query_chunk", query_chunk)

    def encode_images(orig):
        def f(images):
            if hooks.recording:
                hooks.cap["image"] = images[0].copy()
            return orig(images)
        return f

    hooks.patch(hy.image_encoder, "encode_images", encode_images)

    def encode_to_latent(orig):
        def f(surface, seed=None):
            out = orig(surface, seed=seed)
            if hooks.recording:
                hooks.cap["vae"] = {"surface": surface[0].copy(), "seed": seed,
                                    "latent": port.detach(out)}
                hooks.cap["anchor_latent"] = port.detach(out)
            return out
        return f

    hooks.patch(hy.handoff, "encode_to_latent", encode_to_latent)


# -- the check --------------------------------------------------------------

def reference(mode: str, cfg: dict, states: dict, cap: dict, feats: torch.Tensor, device) -> dict:
    m, p = cfg["model"], cfg["pipeline"]
    out: dict = {}
    if cap["dit"] and cap["image"] is not None:
        g = p["stage_0.guidance_scale"]
        ctx = H.conditioner(states["hunyuan3d_dinov2"], m["hunyuan3d_dinov2"], cap["image"], device)
        sig, dist = H.schedule(p["stage_0.num_inference_steps"], cfg["stage0_sampler"]["shift"])
        out["dit"] = {}
        for i, c in cap["dit"].items():
            x = c["x"].float()
            B = x.shape[0]
            cfg_on = g > 0
            lat = torch.cat([x, x]) if cfg_on else x
            cx = (torch.cat([torch.zeros_like(ctx), ctx]) if cfg_on else ctx).expand(lat.shape[0], -1, -1)
            route = [r["top"] for r in cap["gate"].get(i, [])]
            if len(route) != m["hunyuan3d_dit"]["num_moe_layers"]:
                continue
            t = torch.full((lat.shape[0],), float(sig[i]), device=device)
            v, gates = H.dit(states["hunyuan3d_dit"], m["hunyuan3d_dit"], lat, cx, t,
                             uncond=B if cfg_on else 0, route=route)
            guided = v[:B] + g * (v[B:] - v[:B]) if cfg_on else v
            out["dit"][i] = {"v": v, "next": check.store(mode, x + float(dist[i]) * guided),
                             "gate": [s for s, _ in gates], "top": [o for _, o in gates]}
    if cap["hy_latent"] is not None and cap["sdf"]:
        tok = H.vae_tokens(states["hunyuan3d_vae"], m["hunyuan3d_vae"], cap["hy_latent"].float())
        pts = torch.cat([c["pts"] for c in cap["sdf"]])
        out["sdf"] = torch.cat([H.vae_sdf(states["hunyuan3d_vae"], m["hunyuan3d_vae"], tok,
                                          pts[i:i + 16384]) for i in range(0, len(pts), 16384)])
    if cap["vae"] is not None:
        out["vae"] = tripo._vae_encode(states["triposg_vae"], m["triposg_vae"], cap["vae"], device)
    return out


def program(cap: dict) -> dict:
    out = tripo.program(cap)
    for i, rec in out["dit"].items():
        gates = cap["gate"].get(i, [])
        rec.update(gate=[r["scores"] for r in gates], top=[r["top"] for r in gates])
    return out


def route_gap(top: torch.Tensor, scores: torch.Tensor) -> float:
    """The largest gap between the k-th and (k+1)-th of ``scores`` (n, E)
    over the rows whose top-k set differs from ``top`` (n, k); 0 when none
    differs."""
    k = top.shape[-1]
    srt = scores.sort(-1, descending=True)
    own = srt.indices[:, :k].sort(-1).values
    differ = (top.to(own.device).long().sort(-1).values != own).any(-1)
    if not bool(differ.any()):
        return 0.0
    return float((srt.values[:, k - 1] - srt.values[:, k])[differ].max())


def numbers(answer: dict, ref: dict, cap: dict, plan_: dict) -> dict:
    out = tripo.numbers(answer, ref, cap, plan_)
    if plan_["dit_steps"]:
        dit = ref.get("dit", {})
        if len(dit) == len(plan_["dit_steps"]) and all(
                len(answer["dit"][i]["gate"]) == len(dit[i]["gate"]) for i in dit):
            out["s0_gate"] = check.worst(check.rel(a, r) for i in dit
                                         for a, r in zip(answer["dit"][i]["gate"], dit[i]["gate"]))
            out["s0_route"] = max(route_gap(a, r) for i in dit
                                  for a, r in zip(answer["dit"][i]["top"], dit[i]["gate"]))
        else:
            out["s0_gate"] = out["s0_route"] = check.MISSING
    return out
