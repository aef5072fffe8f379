"""The release's model family: ActionMesh with TripoSG as Stage 0.

A model family is the file ``families/<family>.py`` that a configuration
names under ``family``; the harness finds it by that name
(``bench/manifest.py``) and asks it for what differs between
architectures. Every family runs ActionMesh's own DINOv2, Stage I and
Stage II, which the harness builds, captures and checks itself
(``bench/port.py``, ``bench/check.py``) from the configuration's
``dinov2``, ``denoiser`` and ``autoencoder`` blocks. A family provides:

  networks(mode)       the networks whose weights a mix mode draws, in order
  layouts(model, nets) their release layouts from the ``model`` block
  build(cfg, states, mode, device)
                       the port's pipeline entry of ``mode``: the Stage-0
                       backend, handed to ``port.pipeline``
  plan(cfg, mix, limits, rng)
                       Stage 0's part of the check's plan, drawn first
  new_capture()        Stage 0's keys of the capture, fresh for one clip
  capture(hooks)       wraps the port's Stage-0 calls (``hooks.patch``);
                       while ``hooks.recording``, fills its keys and the
                       shared ``anchor_latent`` (what Stage 0 hands Stage I)
                       and ``decode_latent`` (what it decodes, if it does)
  spans(hooks)         Stage 0's ``record_function`` ranges (profiled clip)
  reference(mode, cfg, states, cap, feats, device)
                       the plain reference's Stage-0 answers, in products
                       of ``mode``, from the captured inputs
  program(cap)         the program's Stage-0 answers, in the same shapes
  numbers(answer, ref, cap, plan)
                       the compared Stage-0 numbers, each with a limit in
                       ``checks/<cell>.json``
  report(answer, ref)  a line on standard error about them, or nothing

This family's Stage 0 is TripoSG: its DiT's prediction at the last step
and at one drawn from the seed (``s0_v``, both CFG branches), the Euler
update at those steps (``s0_step``), the SDF decode's values at a sample of
the fine pass's queries (``sdf``), and in {video + 3D} the VAE's posterior
sample of the user's mesh (``s0_vae``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from portbench.bench import check, port
from portbench.reference import layout
from portbench.reference import models as R
from portbench.reference import pipeline as RP


def networks(mode: str) -> list[str]:
    base = ["dinov2", "triposg_vae", "denoiser", "autoencoder"]
    return base + ["triposg_dit"] if mode == "video" else base


def layouts(model: dict, nets) -> dict[str, layout.Layout]:
    makers = {
        "dinov2": lambda: layout.dinov2(model["dinov2"]),
        "triposg_dit": lambda: layout.flow_transformer(model["triposg_dit"]),
        "triposg_vae": lambda: layout.triposg_vae(model["triposg_vae"]),
        "denoiser": lambda: layout.flow_transformer(model["denoiser"]),
        "autoencoder": lambda: layout.autoencoder(model["autoencoder"]),
    }
    return {n: makers[n]() for n in nets}


class Stage0:
    """The pipeline's image-to-3D backend: the port's TripoSG pipeline with
    the configuration's extraction depths."""

    def __init__(self, tsg, decode: dict):
        self.tsg = tsg
        self.decode = decode

    def __call__(self, image, **kwargs):
        return self.tsg(image, **self.decode, **kwargs)

    def encode_to_latent(self, surface, seed=None):
        return self.tsg.encode_to_latent(surface, seed=seed)


def build(cfg: dict, states: dict, mode: str, device):
    """DINOv2, TripoSG (its DiT, its VAE, and the development SDF
    regulariser the port applies to random-weight fields,
    ``models/stage0.py``), the Stage-I denoiser and the Stage-II
    autoencoder."""
    from actionmesh_tpu_torch.models import stage0
    from actionmesh_tpu_torch.models.triposg.dit import triposg_dit_config
    from actionmesh_tpu_torch.models.triposg.pipeline import TripoSGPipeline
    from actionmesh_tpu_torch.models.triposg.vae import TripoSGVAEConfig
    from actionmesh_tpu_torch.utils import weights as W

    dtype = port.DTYPES[cfg["dtype"]]
    m = cfg["model"]
    encoder = port.image_encoder(cfg, states, device)
    v = m["triposg_vae"]
    vae_cfg = TripoSGVAEConfig(
        latent_channels=v["latent_channels"], num_tokens=v["num_tokens"],
        embed_frequency=v["embed_frequency"], encoder_width=v["encoder_width"],
        encoder_layers=v["encoder_layers"], encoder_heads=v["encoder_heads"],
        decoder_width=v["decoder_width"], decoder_layers=v["decoder_layers"],
        decoder_heads=v["decoder_heads"])
    dit_cfg = dit_params = None
    if "triposg_dit" in states:
        t = m["triposg_dit"]
        dit_cfg = triposg_dit_config(
            num_tokens=t["num_tokens"], in_channels=t["in_channels"], num_layers=t["num_layers"],
            width=t["width"], num_attention_heads=t["num_attention_heads"],
            cross_attention_dim=t["cross_attention_dim"], mlp_ratio=t["mlp_ratio"])
        dit_params = W.params_from_jax(W.convert_triposg_dit(states["triposg_dit"], dit_cfg, dtype), device)
    sched = cfg["pipeline"]
    tsg = TripoSGPipeline(
        dit_params, W.params_from_jax(W.convert_triposg_vae(states["triposg_vae"], vae_cfg, dtype), device),
        encoder, dit_cfg=dit_cfg, vae_cfg=vae_cfg, dtype=dtype, device=device,
        num_train_timesteps=sched["scheduler.num_train_timesteps"], shift=sched["scheduler.shift"])
    tsg.sdf_regularizer = stage0._dev_sdf_regularizer
    tsg.sdf_regularizer_torch = stage0._dev_sdf_regularizer_torch
    backend = Stage0(tsg, cfg["stage0_decode"])
    extra = dict(surface_samples=cfg["surface_samples"], vae=backend) if mode == "video_mesh" else {}
    return port.pipeline(cfg, states, mode, device, encoder, backend, **extra)


# -- the capture ------------------------------------------------------------

def plan(cfg: dict, mix: dict, limits: dict, rng) -> dict:
    """The DiT's checked steps (video mode: the last and one drawn) and the
    SDF rows kept a field query."""
    s0 = cfg["pipeline"]["stage_0.num_inference_steps"]
    dit = sorted({s0 - 1, int(rng.integers(0, max(s0 - 1, 1)))}) if mix["mode"] == "video" else []
    return {"dit_steps": dit, "sdf_rows": int(limits["sample"]["sdf_rows"])}


def new_capture() -> dict:
    return {"dit": {}, "sdf": [], "vae": None}


def capture(hooks) -> None:
    """The DiT's inputs and outputs at the checked steps, the latent the
    decode reads, a sample of SDF queries and, {video + 3D}, the VAE's
    encode."""
    import actionmesh_tpu_torch.models.triposg.pipeline as tsg_mod
    import actionmesh_tpu_torch.models.triposg.vae as vae_mod

    dit = None

    def dit_forward(orig):
        def f(params, cfg, latents, *a, **k):
            out = orig(params, cfg, latents, *a, **k)
            if hooks.recording and dit is not None:
                dit.call(latents, out)
            return out
        return f

    hooks.patch(tsg_mod, "triposg_dit_forward", dit_forward)

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
            hooks.cap["anchor_latent"] = port.detach(out)
            return out
        return f

    hooks.patch(tsg_mod, "flow_sample", flow_sample)

    def decode_kv(orig):
        def f(params, cfg, latents, *a, **k):
            if hooks.recording:
                hooks.cap["decode_latent"] = port.detach(latents)
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

    def encode_to_latent(orig):
        def f(surface, seed=None):
            out = orig(surface, seed=seed)
            if hooks.recording:
                hooks.cap["vae"] = {"surface": np.asarray(surface)[0].copy(), "seed": seed,
                                "latent": port.detach(out)}
                hooks.cap["anchor_latent"] = port.detach(out)
            return out
        return f

    hooks.patch(hooks.pipe.image_to_3d, "encode_to_latent", encode_to_latent)


def spans(hooks) -> None:
    import actionmesh_tpu_torch.models.triposg.pipeline as tsg_mod

    hooks.patch(hooks.pipe.image_to_3d.tsg, "decode_latents", hooks.spanned("portbench.stage0.decode"))
    hooks.patch(tsg_mod, "flow_sample", hooks.spanned("portbench.stage0.dit_sample"))


# -- the check --------------------------------------------------------------

def reference(mode: str, cfg: dict, states: dict, cap: dict, feats: torch.Tensor, device) -> dict:
    m, p = cfg["model"], cfg["pipeline"]
    out: dict = {}
    if cap["dit"]:
        g = p["stage_0.guidance_scale"]
        ctx = feats[p["anchor_idx"]][None, None]
        ts, dist = RP.flow_schedule(p["stage_0.num_inference_steps"],
                                    p["scheduler.num_train_timesteps"], p["scheduler.shift"])
        out["dit"] = {}
        for i, c in cap["dit"].items():
            x = c["x"].float()
            B = x.shape[0]
            cfg_on = g > 0
            lat = torch.cat([x, x]) if cfg_on else x
            cx = torch.cat([torch.zeros_like(ctx), ctx]) if cfg_on else ctx
            t = torch.full((lat.shape[0],), float(ts[i]), device=device)
            v = R.flow_transformer(states["triposg_dit"], m["triposg_dit"], lat[:, None],
                                   cx.expand(lat.shape[0], -1, -1, -1),
                                   torch.zeros(lat.shape[0], 1, device=device), t,
                                   inflated=False, uncond=B if cfg_on else 0)[:, 0]
            guided = v[:B] + g * (v[B:] - v[:B]) if cfg_on else v
            out["dit"][i] = {"v": v, "next": check.store(mode, x + float(dist[i]) * guided)}
    if cap["decode_latent"] is not None and cap["sdf"]:
        lat = cap["decode_latent"].float()
        tok = R.vae_decode_tokens(states["triposg_vae"], m["triposg_vae"], lat)
        pts = torch.cat([c["pts"] for c in cap["sdf"]])
        out["sdf"] = torch.cat([R.vae_sdf(states["triposg_vae"], m["triposg_vae"], tok, pts[i:i + 16384])
                                for i in range(0, len(pts), 16384)])
    if cap["vae"] is not None:
        out["vae"] = _vae_encode(states["triposg_vae"], m["triposg_vae"], cap["vae"], device)
    return out


def _vae_encode(state, vcfg, vae: dict, device) -> torch.Tensor:
    """The seeded encode's draws, as the pipeline makes them from its seed
    (one CPU generator: the presample, FPS's start, the posterior noise)."""
    surface = torch.as_tensor(vae["surface"], device=device)
    n, k = surface.shape[0], vcfg["num_tokens"]
    n_pre = min(4 * k, n)
    gen = torch.Generator().manual_seed(int(vae["seed"]))
    pre = torch.randperm(n, generator=gen)[:n_pre] if n_pre < n else None
    start = torch.randint(0, n_pre, (1,), generator=gen)
    noise = torch.randn((1, k, vcfg["latent_channels"]), generator=gen)
    return R.vae_encode(state, vcfg, surface, None if pre is None else pre.to(device),
                        int(start[0]), noise.to(device))


def program(cap: dict) -> dict:
    out = {"dit": {i: {"v": c["v"], "next": c["x_next"]} for i, c in cap["dit"].items()}}
    if cap["sdf"]:
        out["sdf"] = torch.cat([c["vals"] for c in cap["sdf"]])
    if cap["vae"] is not None:
        out["vae"] = cap["vae"]["latent"]
    return out


def numbers(answer: dict, ref: dict, cap: dict, plan_: dict) -> dict:
    out = {}
    if plan_["dit_steps"]:
        dit = ref.get("dit", {})
        if len(dit) == len(plan_["dit_steps"]):
            out["s0_v"] = check.worst(g for i in dit for g in check.rows(answer["dit"][i]["v"], dit[i]["v"]))
            out["s0_step"] = check.worst(
                check.rel(answer["dit"][i]["next"].float() - c["x"].float(), dit[i]["next"] - c["x"].float())
                for i, c in cap["dit"].items())
        else:
            out["s0_v"] = out["s0_step"] = check.MISSING
        out["sdf"] = check.rel(answer["sdf"], ref["sdf"]) if "sdf" in ref else check.MISSING
    if "vae" in ref:
        out["s0_vae"] = check.rel(answer["vae"], ref["vae"])
    return out


def report(answer: dict, ref: dict) -> None:
    if "sdf" in ref:
        r, d = ref["sdf"].float(), answer["sdf"].float().to(ref["sdf"].device) - ref["sdf"].float()
        print(f"portbench sdf: reference mean {float(r.mean()):.4g} rms {float(r.square().mean().sqrt()):.4g}"
              f" std {float(r.std()):.4g}; gap rms {float(d.square().mean().sqrt()):.4g}",
              file=sys.stderr)
