"""The comparison that decides ``correct``.

Once the window has closed, the plain reference (``reference/``), in fp32
with TF32 off, recomputes from the run's own frames, mesh and weights what
the timed path produced in the first clip of the window, stage by stage
from the state the program handed on (see ``PERF.md``):

  enc      DINOv2 features of every frame;
  (s0_*)   Stage 0's numbers, which the cell's model family
           (``families/<family>.py``) captures, recomputes and compares;
  s1_v     the Stage-I denoiser's prediction (every branch and frame) at
           one step per window drawn from the seed;
  s1_step  the Euler update at that step: the program's next latent
           against its latent plus the step times the guided reference
           prediction, relative to that update;
  s2       Stage II's deformed vertex positions for one target drawn from
           the seed in every Stage-II call (so every window and every
           chunk of targets) at vertices drawn from the seed, from the
           program's latents;
  handoff  exact equality of what one stage hands the next: the anchor
           latent into the decode and into Stage I, each frame's Stage-I
           latent into every Stage-II call that reads it (a count of
           differing elements; a call whose latents match no Stage-I
           frame counts all of them, and a clip whose Stage-II calls
           leave a frame without a target counts one).

Each relative number is the largest over its items (frames, branches,
targets) of ||answer - reference|| / ||reference||; where the capture
lacks an answer the check needs (a step the forward calls never reached,
a prediction of the wrong shape) the number is infinite. The step's
diffusion time comes from the reference's own schedule. The control
(``control``) puts the reference in fp8 in the program's place, on the
same captured inputs, and reads the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.bench.traffic import derive
from portbench.reference import models as R
from portbench.reference import pipeline as RP
from portbench.reference.numerics import fp8_round, precision

MISSING = float("inf")


def rel(a: torch.Tensor, r: torch.Tensor) -> float:
    a, r = a.float(), r.float().to(a.device)
    return float((a - r).norm() / r.norm().clamp_min(1e-30))


def plan(cfg: dict, mix: dict, limits: dict, seed: int, family) -> dict:
    """Which steps, targets and rows the check reads, drawn from the seed:
    the family's Stage-0 draws first, then Stage I's and Stage II's."""
    rng = np.random.default_rng(derive(seed, "check"))
    p = cfg["pipeline"]
    n_windows = len(windows(mix["frames"], cfg["model"]["denoiser"]["temporal_context_size"],
                            p["sliding_window_denoiser"]))
    out = family.plan(cfg, mix, limits, rng)
    out.update(s1_steps={w: int(rng.integers(0, p["scheduler.num_inference_steps"]))
                         for w in range(n_windows)},
               s2_per_call=int(limits["sample"]["s2_targets_per_call"]),
               s2_vertices=int(limits["sample"]["s2_vertices"]),
               rng=derive(seed, "check-draws"))
    return out


def windows(total: int, size: int, slide: int) -> list[list[int]]:
    """The sliding windows from anchor 0: [0, size), then each `slide`
    frames on, the last ending at `total`."""
    if total <= size:
        return [list(range(total))]
    out, end = [], 0
    while end < total:
        end = size if not out else min(end + slide, total)
        out.append(list(range(max(0, end - size), end)))
    return out


def _frames_features(state, cfg, frames, device) -> torch.Tensor:
    pix = RP.dino_pixels(RP.crop_frames(frames)).to(device)
    return torch.cat([R.dinov2(state, cfg, pix[i:i + 4]) for i in range(0, len(pix), 4)])


def store(mode: str, latents: torch.Tensor) -> torch.Tensor:
    """The sampler's state as the reference keeps it between steps: fp32,
    or in fp8 for the control (the program keeps it in its dtype)."""
    return fp8_round(latents) if mode == "fp8" else latents


def reference(mode: str, cfg: dict, states: dict, cap: dict, frames, plan_: dict, family,
              device) -> dict:
    """The reference's answers, in products of ``mode``, on the captured
    inputs."""
    m, p = cfg["model"], cfg["pipeline"]
    with precision(mode), torch.no_grad():
        feats = _frames_features(states["dinov2"], m["dinov2"], frames, device)
        out = {"enc": feats, **family.reference(mode, cfg, states, cap, feats, device)}
        out["s1"] = []
        ts1, dist1 = RP.flow_schedule(p["scheduler.num_inference_steps"],
                                      p["scheduler.num_train_timesteps"], p["scheduler.shift"])
        flags = p["cf_guidance.guidance_at_inference"]
        uncond = next((i for i, f in enumerate(flags) if f[0]), len(flags))
        for w in cap["s1"]:
            if "x" not in w:
                out["s1"].append(None)
                continue
            x = w["x"].float()
            T = x.shape[1]
            idx = w["framestep"][0].long()
            ctx = feats[idx][None]
            mask = w["mask"].float()
            lat = torch.cat([x] * len(flags))
            cx = torch.cat([ctx if f[0] else torch.zeros_like(ctx) for f in flags])
            mk = torch.cat([mask if f[1] else torch.zeros_like(mask) for f in flags])
            t = torch.full((len(flags),), float(ts1[w["step"]]), device=device)
            v = R.flow_transformer(states["denoiser"], m["denoiser"], lat, cx,
                                   w["framestep"].float().expand(len(flags), T), t, mask=mk,
                                   inflated=True, uncond=uncond)
            guided = RP.guide(v, p["cf_guidance.guidance_scales"])
            free = (w["mask"] == 0)[0][:, None, None]
            nxt = torch.where(free, x[0] + float(dist1[w["step"]]) * guided, x[0])[None]
            out["s1"].append({"v": v, "next": store(mode, nxt)})
        out["s2"] = _stage2(states["autoencoder"], m["autoencoder"], cap, plan_, device)
    return out


def s2_sample(cap: dict, plan_: dict) -> list[tuple[int, int, np.ndarray]]:
    """(call, target, vertex ids) of the Stage-II answers the check reads:
    ``s2_per_call`` targets of every call."""
    rng = np.random.default_rng(plan_["rng"])
    out = []
    for c, call in enumerate(cap["s2"]):
        n = call["targets"].shape[1]
        for j in sorted(rng.choice(n, size=min(plan_["s2_per_call"], n), replace=False)):
            V = call["query"].shape[1]
            ids = np.sort(rng.choice(V, size=min(plan_["s2_vertices"], V), replace=False))
            out.append((c, int(j), ids))
    return out


def _stage2(state, acfg, cap, plan_, device) -> list:
    out = []
    for c, j, ids in s2_sample(cap, plan_):
        call = cap["s2"][c]
        feats = torch.as_tensor(RP.vertex_features(call["mesh"]["vertices"], call["mesh"]["faces"]),
                                device=device)
        tok = R.autoencoder_tokens(state, acfg, call["latents"].float(), call["framestep"].float(),
                                   call["source_alpha"][0], call["targets"][0, j])
        out.append(R.autoencoder_vertices(state, acfg, tok, feats[torch.as_tensor(ids, device=device)]))
    return out


def program(cap: dict, plan_: dict, acfg: dict, family) -> dict:
    """The program's answers, from the capture, in the reference's shapes."""
    out = {"enc": cap["features"], **family.program(cap)}
    out["s1"] = [{"v": w["v"], "next": w["x_next"]} if "x" in w else None for w in cap["s1"]]
    s2 = []
    for c, j, ids in s2_sample(cap, plan_):
        disp = cap["s2"][c]["out"][0, j][torch.as_tensor(ids, device=cap["s2"][c]["out"].device)]
        if acfg.get("prediction_mode", "direct") == "residual":
            disp = cap["s2"][c]["query"][0, ids, :3] + disp
        s2.append(disp.clamp(-1.0, 1.0))
    out["s2"] = s2
    return out


def worst(gaps) -> float:
    gaps = list(gaps)
    return max(gaps) if gaps else MISSING


def rows(a: torch.Tensor, r: torch.Tensor):
    """Row by row gaps of ``a`` to ``r``, or one missing gap when the
    program's answer is not of the reference's shape."""
    if a.shape != r.shape:
        return [MISSING]
    return [rel(a[b], r[b]) for b in range(r.shape[0])]


def numbers(answer: dict, ref: dict, cap: dict, plan_: dict, family) -> dict:
    """The compared numbers: the relative gaps of ``answer`` to ``ref``."""
    enc = answer["enc"]
    out = {"enc": worst(rows(enc, ref["enc"])) if enc is not None else MISSING,
           **family.numbers(answer, ref, cap, plan_)}
    s1v, s1s = [], []
    for win in plan_["s1_steps"]:
        r = ref["s1"][win] if win < len(ref["s1"]) else None
        if r is None:
            s1v.append(MISSING)
            s1s.append(MISSING)
            continue
        a, x = answer["s1"][win], cap["s1"][win]["x"].float()
        v = a["v"]
        s1v += [rel(v[b, f], r["v"][b, f]) for b in range(v.shape[0]) for f in range(v.shape[1])] \
            if v.shape == r["v"].shape else [MISSING]
        s1s.append(rel(a["next"].float() - x, r["next"] - x))
    out["s1_v"], out["s1_step"] = worst(s1v), worst(s1s)
    out["s2"] = worst(rel(a, r) for a, r in zip(answer["s2"], ref["s2"]))
    return out


def _frame_key(t) -> float:
    return round(float(t), 4)


def handoff(cap: dict, s2_windows: list[list[int]]) -> int:
    """Elements that differ where one stage hands its result to the next.
    ``s2_windows``: the frames of each Stage-II window as the configuration
    lays them out; a window that no call covers, or a call over other
    frames, counts one more."""
    bad = 0
    anchor = cap["anchor_latent"]
    if cap["decode_latent"] is not None:
        bad += int((cap["decode_latent"].float() != anchor.float()).sum())
    w0 = cap["s1"][0]
    first = w0["init"][0, 0]
    bad += int((first.float() != anchor.float().to(first.dtype).float()[0]).sum())
    # each frame's latent as Stage I left it (a later window's frozen
    # frames carry the banked value on)
    latent = {}
    for w in cap["s1"]:
        for f, t in enumerate(w["framestep"][0].tolist()):
            latent[_frame_key(t)] = w["out"][0, f]
    seen, targets = [], {}
    for c in cap["s2"]:
        keys = tuple(_frame_key(t) for t in c["framestep"].reshape(-1).tolist())
        if not seen or seen[-1] != keys:
            seen.append(keys)
        targets[keys] = targets.get(keys, 0) + c["targets"].shape[1]
        got = c["latents"][0]
        if len(keys) != got.shape[0] or any(k not in latent for k in keys):
            bad += got.numel()
            continue
        want = torch.stack([latent[k] for k in keys])
        bad += int((got.float() != want.float()).sum()) if want.shape == got.shape else got.numel()
    expected = [tuple(_frame_key(f) for f in w) for w in s2_windows]
    bad += sum(1 for w in expected if w not in seen) + sum(1 for w in seen if w not in expected)
    bad += sum(1 for w in expected if targets.get(w, 0) < len(w) - 1)
    return bad


def run(cfg: dict, states: dict, cap: dict, frames, plan_: dict, device, family,
        with_control: bool = False) -> tuple[dict, dict | None]:
    """The program's numbers and, ``with_control``, the control's: the
    reference in fp8 put in the program's place on the same inputs."""
    ref = reference("fp32", cfg, states, cap, frames, plan_, family, device)
    prog = program(cap, plan_, cfg["model"]["autoencoder"], family)
    vals = numbers(prog, ref, cap, plan_, family)
    family.report(prog, ref)
    s2_windows = windows(len(frames), cfg["model"]["autoencoder"]["temporal_context_size"],
                         cfg["pipeline"]["sliding_window_autoencoder"])
    vals["handoff"] = handoff(cap, s2_windows)
    if not with_control:
        return vals, None
    return vals, numbers(reference("fp8", cfg, states, cap, frames, plan_, family, device), ref,
                         cap, plan_, family)
