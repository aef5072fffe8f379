"""A run of a tiny cell with the timed path broken underneath: ``correct``
comes out false, once for each fault the cells can have. (They run on one
chip, so no exchange between chips can be left out.)"""

import time

import pytest
import torch

from portbench.bench import check, driver


def _run(root, cell="tiny.video"):
    return driver.run(root, cell, 2**31 + 99, 0.01, False, time.perf_counter(), device="cpu")


def _frozen_schedule(orig):
    def f(*a, **k):
        ts, dist = orig(*a, **k)
        return ts, dist * 0.0
    return f


FAULTS = {
    # every Stage-I step hands back the latents it was given
    "stage1_step_returns_its_state": ("actionmesh_tpu_torch.pipeline", "get_schedule", _frozen_schedule),
    # every DiT step hands back the latents it was given
    "dit_step_returns_its_state": ("actionmesh_tpu_torch.models.triposg.pipeline", "get_schedule",
                                   _frozen_schedule),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_frozen_steps(tiny_root, monkeypatch, fault):
    import importlib

    mod_name, attr, make = FAULTS[fault]
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, attr, make(getattr(mod, attr)))
    out = _run(tiny_root)
    assert not out["correct"], out["compared"]


def test_half_the_batch_left_out(tiny_root, monkeypatch):
    """The denoiser runs only the first half of the CFG branch batch and
    hands its prediction to the other half too."""
    import actionmesh_tpu_torch.sampling.denoise_loop as loop

    orig = loop.denoiser_forward

    def half(params, cfg, hidden, context, framestep, dt, *a, **k):
        h = hidden.shape[0] // 2
        k = dict(k, uncond_batch=min(k.get("uncond_batch", 0), h))
        if k.get("freqs_rot") is not None:
            k["freqs_rot"] = tuple(f[:h] for f in k["freqs_rot"])
        if k.get("mask") is not None:
            k["mask"] = k["mask"][:h]
        out = orig(params, cfg, hidden[:h], context[:h], framestep[:h], dt[:h], *a, **k)
        return torch.cat([out, out])

    monkeypatch.setattr(loop, "denoiser_forward", half)
    out = _run(tiny_root)
    assert not out["correct"]
    assert out["compared"]["s1_v"]["value"] > out["compared"]["s1_v"]["limit"]


def test_answer_altered_where_produced(tiny_root, monkeypatch):
    """Stage II's displacements nudged by 1e-2 where they are produced."""
    import actionmesh_tpu_torch.pipeline as pipe_mod

    orig = pipe_mod.autoencoder_forward
    monkeypatch.setattr(pipe_mod, "autoencoder_forward", lambda *a, **k: orig(*a, **k) + 1e-2)
    out = _run(tiny_root, "tiny.mesh")
    assert not out["correct"]
    assert out["compared"]["s2"]["value"] > out["compared"]["s2"]["limit"]


def test_features_altered_where_produced(tiny_root, monkeypatch):
    import actionmesh_tpu_torch.models.image_encoder as enc

    orig = enc.dinov2_forward
    monkeypatch.setattr(enc, "dinov2_forward", lambda *a, **k: orig(*a, **k) * 1.001)
    out = _run(tiny_root)
    assert out["compared"]["enc"]["value"] > out["compared"]["enc"]["limit"]


def test_handoff_altered(tiny_root, monkeypatch):
    """Stage I's latents altered on their way into Stage II."""
    import actionmesh_tpu_torch.pipeline as pipe_mod

    orig = pipe_mod.ActionMeshPipeline.generate_mesh_animation

    def bump(self, latent_bank, mesh_bank):
        latent_bank.items = [x + 1e-2 for x in latent_bank.items]
        return orig(self, latent_bank, mesh_bank)

    monkeypatch.setattr(pipe_mod.ActionMeshPipeline, "generate_mesh_animation", bump)
    out = _run(tiny_root)
    assert out["compared"]["handoff"]["value"] > 0


def _clip(windows=((0, 1, 2, 3), (2, 3, 4, 5)), n=2, c=3):
    """A synthetic capture of one clip: Stage I's windows over ``windows``
    (frame indices) and one Stage-II call per window reading them."""
    gen = torch.Generator().manual_seed(0)
    anchor = torch.randn(1, n, c, generator=gen)
    latent = {f: torch.randn(n, c, generator=gen) for w in windows for f in w}
    latent[0] = anchor[0]
    s1, s2 = [], []
    for w in windows:
        out = torch.stack([latent[f] for f in w])[None]
        fs = torch.tensor([list(w)], dtype=torch.float32)
        s1.append({"init": out.clone(), "framestep": fs, "out": out})
        s2.append({"latents": out.clone(), "framestep": fs.clone(),
                   "targets": torch.zeros(1, len(w) - 1)})
    return {"anchor_latent": anchor, "decode_latent": anchor.clone(), "s1": s1, "s2": s2}, \
        [list(w) for w in windows]


def _drop_a_frame(cap):
    c = cap["s2"][1]
    c["latents"], c["framestep"] = c["latents"][:, :-1], c["framestep"][:, :-1]


def _drop_a_call(cap):
    cap["s2"].pop()


def _alter_one_element(cap):
    cap["s2"][0]["latents"][0, 1, 0, 0] += 1.0


def _other_window(cap):
    c = cap["s2"][1]
    c["framestep"] = c["framestep"] - 1.0
    c["latents"] = torch.cat([cap["s1"][0]["out"][:, 1:2], c["latents"][:, :-1]], 1)


HANDOFF_FAULTS = {"a Stage-II call over fewer frames": _drop_a_frame,
                  "a Stage-II window left out": _drop_a_call,
                  "a handed-on element altered": _alter_one_element,
                  "a Stage-II window over other frames": _other_window}


def test_handoff_of_a_sound_clip_is_zero():
    cap, windows = _clip()
    assert check.handoff(cap, windows) == 0


@pytest.mark.parametrize("fault", sorted(HANDOFF_FAULTS))
def test_handoff_counts_a_fault(fault):
    cap, windows = _clip()
    HANDOFF_FAULTS[fault](cap)
    assert check.handoff(cap, windows) > 0


def test_a_step_the_capture_never_saw_fails(tiny_root, monkeypatch):
    """A Stage-I loop whose forward calls bypass the module the benchmark
    wraps leaves no checked step: the numbers read infinite."""
    import functools

    import actionmesh_tpu_torch.models.denoiser as den
    import actionmesh_tpu_torch.pipeline as pipe_mod
    import actionmesh_tpu_torch.sampling.denoise_loop as loop

    orig = loop.denoise_window

    @functools.wraps(orig)
    def hidden_steps(*a, **k):
        wrapped = loop.denoiser_forward
        loop.denoiser_forward = den.denoiser_forward
        try:
            return orig(*a, **k)
        finally:
            loop.denoiser_forward = wrapped

    monkeypatch.setattr(pipe_mod, "denoise_window", hidden_steps)
    out = _run(tiny_root)
    assert not out["correct"]
    assert out["compared"]["s1_v"]["value"] == float("inf")
