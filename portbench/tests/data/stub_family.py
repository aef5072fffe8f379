"""A test model family: the port's Stage-0 stub (a seeded latent and a UV
sphere, ``models/stage0.py:StubImageTo3D``) in TripoSG's place. Its video
mode draws no Stage-0 network and reports no Stage-0 number; Stage I and
Stage II run and are checked as in every family. The interface is the one
``families/actionmesh.py`` documents."""

from __future__ import annotations

from portbench.bench import port
from portbench.reference import layout


def networks(mode: str) -> list[str]:
    if mode != "video":
        raise ValueError(f"the stub family has no {mode!r} mode: the stub encodes no mesh")
    return ["dinov2", "denoiser", "autoencoder"]


def layouts(model: dict, nets) -> dict[str, layout.Layout]:
    makers = {"dinov2": layout.dinov2, "denoiser": layout.flow_transformer,
              "autoencoder": layout.autoencoder}
    return {n: makers[n](model[n]) for n in nets}


def build(cfg: dict, states: dict, mode: str, device):
    from actionmesh_tpu_torch.models.stage0 import StubImageTo3D

    den = cfg["model"]["denoiser"]
    backend = StubImageTo3D((den["num_tokens_nominal"], den["in_channels"]), device)
    return port.pipeline(cfg, states, mode, device, port.image_encoder(cfg, states, device), backend)


def plan(cfg: dict, mix: dict, limits: dict, rng) -> dict:
    return {}


def new_capture() -> dict:
    return {}


def capture(hooks) -> None:
    """The stub's latent, which Stage I starts from."""
    def call(orig):
        def f(self, *a, **k):
            latent, mesh = orig(self, *a, **k)
            if hooks.recording:
                hooks.cap["anchor_latent"] = port.detach(latent)
            return latent, mesh
        return f

    hooks.patch(type(hooks.pipe.image_to_3d), "__call__", call)


def spans(hooks) -> None:
    pass


def reference(mode, cfg, states, cap, feats, device) -> dict:
    return {}


def program(cap: dict) -> dict:
    return {}


def numbers(answer: dict, ref: dict, cap: dict, plan_: dict) -> dict:
    return {}


def report(answer: dict, ref: dict) -> None:
    pass
