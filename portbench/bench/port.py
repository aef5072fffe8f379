"""The system under test: ``actionmesh_tpu_torch``, built from the
benchmark's weights, and the hooks the benchmark sets on it.

A model family's ``build`` (``families/<family>.py``) makes the cell's
Stage-0 backend and hands it to ``pipeline``, which builds the pipeline
entry of the cell's mode around it with DINOv2 (``image_encoder``), the
Stage-I denoiser and the Stage-II autoencoder. The release-named tensors
go through the port's own checkpoint converters (``utils/weights.py``), as
loading a real checkpoint does.

``Hooks`` wraps the functions the pipeline calls between its layers, at
the module names it looks them up under, and, while recording, keeps what
the correctness check needs from one clip: the encoder's features, each
Stage-I window's inputs and output and its checked step, and every
Stage-II call; the family's ``capture`` keeps Stage 0's (the anchor
latent, and what its own check reads). ``install_spans`` also opens a
``record_function`` range around each call into a layer and each
attention call (with the call's shape), for the profiled clip.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

ATTN_SPAN = "portbench.attn"
DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _pipeline_updates(cfg: dict) -> dict:
    up = dict(cfg["pipeline"])
    den = cfg["model"]["denoiser"]
    for k, v in den.items():
        up[f"temporal_3D_denoiser.{k}"] = v
    up["temporal_3D_denoiser.inflated_layers"] = list(range(den["num_layers"]))
    for k, v in cfg["model"]["autoencoder"].items():
        up[f"temporal_3D_vae.{k}"] = v
    return up


def image_encoder(cfg: dict, states: dict, device):
    """DINOv2 from ``states["dinov2"]`` at the configuration's widths."""
    from actionmesh_tpu_torch.models.dinov2 import DinoV2Config
    from actionmesh_tpu_torch.models.image_encoder import ImageEncoder
    from actionmesh_tpu_torch.utils import weights as W

    dtype = DTYPES[cfg["dtype"]]
    d = cfg["model"]["dinov2"]
    dino_cfg = DinoV2Config(hidden_size=d["hidden_size"], num_layers=d["num_layers"],
                            num_heads=d["num_heads"], mlp_ratio=d["mlp_ratio"],
                            patch_size=d["patch_size"], image_size=d["image_size"],
                            eps=d["layer_norm_eps"])
    return ImageEncoder(device=device, dtype=dtype, config=dino_cfg, params=W.params_from_jax(
        W.convert_dinov2(states["dinov2"], dino_cfg, dtype), device))


def pipeline(cfg: dict, states: dict, mode: str, device, encoder, backend, **kwargs):
    """The pipeline entry of ``mode`` ("video" | "video_mesh") on ``device``:
    ``encoder`` and the Stage-0 ``backend`` given, the Stage-I denoiser and
    the Stage-II autoencoder from ``states``; ``kwargs`` go to the entry
    ({video + 3D}: ``surface_samples``, ``vae``)."""
    from actionmesh_tpu_torch.pipeline import ActionMeshPipeline
    from actionmesh_tpu_torch.pipeline_with_3d import ActionMeshPipelineWithMeshInput
    from actionmesh_tpu_torch.utils import weights as W

    dtype = DTYPES[cfg["dtype"]]
    base = ActionMeshPipelineWithMeshInput if mode == "video_mesh" else ActionMeshPipeline

    class Pipeline(base):
        def _load_actionmesh_weights(self):
            self.denoiser_params = W.params_from_jax(
                W.convert_denoiser(states["denoiser"], self.denoiser_config, dtype), device)
            self.autoencoder_params = W.params_from_jax(
                W.convert_autoencoder(states["autoencoder"], self.autoencoder_config, dtype), device)

    return Pipeline(config_name=cfg["preset"], weights_dir=None, device=device, dtype=dtype,
                    config_updates=_pipeline_updates(cfg), image_encoder=encoder,
                    image_to_3d=backend, device_mesh=None, **kwargs)


def make_input(frames):
    from actionmesh_tpu_torch.io.video_input import ActionMeshInput

    return ActionMeshInput(frames=list(frames), timesteps=np.arange(len(frames), dtype=np.float32))


def make_mesh(vertices, faces):
    from actionmesh_tpu_torch.io.mesh import Mesh

    return Mesh(vertices=vertices, faces=faces)


def run_clip(pipe, mode: str, inp, mesh, seed: int, **overrides):
    if mode == "video_mesh":
        return pipe(inp, mesh, seed=seed, **overrides)
    return pipe(inp, seed=seed, **overrides)


def detach(x):
    return x.detach().clone() if isinstance(x, torch.Tensor) else x


def bind(orig, args, kwargs) -> dict:
    """The call's arguments by parameter name."""
    import inspect

    b = inspect.signature(orig).bind(*args, **kwargs)
    b.apply_defaults()
    return b.arguments


class Steps:
    """Groups a sampler's forward calls into its steps by the rows they
    carry: a step is ``per_step`` rows (every guidance branch of the B
    latents), in one call or in one call per branch. Keeps, at the planned
    steps, the latents the step starts from (the first B rows of its first
    call), every branch's prediction (its calls' outputs in order) and the
    latents the next step starts from."""

    def __init__(self, B: int, per_step: int, steps):
        self.B, self.per_step, self.steps = B, per_step, set(steps)
        self.rows = 0
        self.at: dict[int, dict] = {}

    def call(self, hidden: torch.Tensor, out: torch.Tensor) -> None:
        step, offset = divmod(self.rows, self.per_step)
        self.rows += hidden.shape[0]
        if offset == 0 and step - 1 in self.at:
            self.at[step - 1]["x_next"] = detach(hidden[:self.B])
        if step in self.steps:
            rec = self.at.setdefault(step, {"x": detach(hidden[:self.B]), "v": []})
            rec["v"].append(detach(out))

    def close(self, result: torch.Tensor) -> dict[int, dict]:
        """The planned steps seen, the prediction concatenated; the last
        step's next latents are the sampler's result."""
        for rec in self.at.values():
            rec.setdefault("x_next", detach(result))
            if isinstance(rec["v"], list):
                rec["v"] = torch.cat(rec["v"])
        return self.at


class Hooks:
    """Wrappers around the port's inter-layer calls (see the module doc).

    ``plan``: {"s1_steps": {window: step}, ...} and the family's own keys
    (``check.plan``). ``family``: the cell's model family, whose
    ``capture(hooks)`` wraps the Stage-0 calls and whose ``new_capture()``
    gives its keys of ``cap`` at the start of a recorded clip. ``record``
    arms the capture for one clip; disarmed, the wrappers only pass the
    call on. A step is found by the rows of the forward calls, so a loop
    that runs its guidance branches one call each is read as one that
    batches them. Nothing synchronises the device: every kept tensor is an
    asynchronous copy.
    """

    def __init__(self, pipe, plan: dict, family):
        self.pipe, self.plan, self.family = pipe, plan, family
        self.recording = False
        self.cap: dict = {}
        self._undo: list = []
        self._install()
        family.capture(self)

    # -- capture state -------------------------------------------------
    @contextlib.contextmanager
    def record(self):
        self.cap = {"s1": [], "s2": [], "features": None, "decode_latent": None,
                    "anchor_latent": None, **self.family.new_capture()}
        self._mesh = None
        self._s1 = None
        self.recording = True
        try:
            yield self.cap
        finally:
            self.recording = False

    def patch(self, obj, name, make):
        """Replace ``obj.name`` by ``make(original)`` until ``remove``."""
        orig = getattr(obj, name)
        setattr(obj, name, make(orig))
        self._undo.append((obj, name, orig))

    def remove(self):
        for obj, name, orig in reversed(self._undo):
            setattr(obj, name, orig)
        self._undo.clear()

    # -- the wrappers --------------------------------------------------
    def _install(self):
        import actionmesh_tpu_torch.pipeline as pipe_mod
        import actionmesh_tpu_torch.sampling.denoise_loop as loop_mod

        pipe = self.pipe

        def encode_images(orig):
            def f(images):
                out = orig(images)
                if self.recording and len(images) > 1:
                    self.cap["features"] = detach(out)
                return out
            return f

        self.patch(pipe.image_encoder, "encode_images", encode_images)

        def denoise_window(orig):
            def f(*a, **k):
                if not self.recording:
                    return orig(*a, **k)
                args = bind(orig, a, k)
                init = args["init_latent"]
                B = init.shape[0]
                win = len(self.cap["s1"])
                w = {"init": detach(init), "mask": detach(args["mask"]),
                     "framestep": detach(args["framestep"])}
                self.cap["s1"].append(w)
                step = self.plan["s1_steps"].get(win)
                self._s1 = Steps(B, args["guidance"].n_branches * B,
                                 [] if step is None else [step])
                out = orig(*a, **k)
                seen = self._s1.close(out)
                self._s1 = None
                if step in seen:
                    w.update(step=step, **seen[step])
                w["out"] = detach(out)
                return out
            return f

        self.patch(pipe_mod, "denoise_window", denoise_window)

        def denoiser_forward(orig):
            def f(params, dcfg, hidden, *a, **k):
                out = orig(params, dcfg, hidden, *a, **k)
                if self.recording and self._s1 is not None:
                    self._s1.call(hidden, out)
                return out
            return f

        self.patch(loop_mod, "denoiser_forward", denoiser_forward)

        def autoencoder_forward(orig):
            def f(params, cfg, latents, framestep, source_alpha, target_alphas, query, **k):
                out = orig(params, cfg, latents, framestep, source_alpha, target_alphas, query, **k)
                if self.recording:
                    self.cap["s2"].append({
                        "latents": detach(latents), "framestep": detach(framestep),
                        "source_alpha": detach(source_alpha), "targets": detach(target_alphas),
                        "query": detach(query), "out": detach(out), "mesh": self._mesh})
                return out
            return f

        self.patch(pipe_mod, "autoencoder_forward", autoencoder_forward)

        def mesh_features(orig):
            def f(mesh, *a, **k):
                if self.recording:
                    self._mesh = {"vertices": np.array(mesh.vertices),
                                  "faces": np.array(mesh.faces)}
                return orig(mesh, *a, **k)
            return f

        self.patch(pipe_mod, "get_mesh_features", mesh_features)

    @staticmethod
    def spanned(name: str):
        """A ``patch`` maker that opens a ``record_function`` range ``name``
        around each call."""
        def make(orig):
            def f(*a, **k):
                with torch.profiler.record_function(name):
                    return orig(*a, **k)
            return f
        return make

    def install_spans(self):
        """Open a ``record_function`` range around each call into a layer
        and each attention call (named with the call's shape), for the
        profiled clip that follows the window; the family's ``spans(hooks)``
        adds Stage 0's."""
        import actionmesh_tpu_torch.models.dinov2 as dinov2_mod
        import actionmesh_tpu_torch.models.layers as layers_mod

        pipe = self.pipe
        self.attn_masks: dict[int, torch.Tensor] = {}

        def attn(orig):
            def f(q, k, v, *a, **kw):
                mask = kw.get("kv_mask")
                tag = ""
                if mask is not None:
                    tag = f":m{len(self.attn_masks)}"
                    self.attn_masks[len(self.attn_masks)] = (mask != 0).sum(-1)
                B, H, Sq, D = q.shape
                name = f"{ATTN_SPAN}:{B}x{H}x{Sq}x{k.shape[2]}x{D}:{str(q.dtype)[6:]}{tag}"
                with torch.profiler.record_function(name):
                    return orig(q, k, v, *a, **kw)
            return f

        self.patch(layers_mod, "dot_product_attention", attn)
        self.patch(dinov2_mod, "dot_product_attention", attn)

        for attr, name in (("preprocess", "portbench.preprocess"),
                           ("init_banks_from_anchor", "portbench.stage0"),
                           ("encode_all_frames", "portbench.encode"),
                           ("generate_3d_latents", "portbench.stage1"),
                           ("generate_mesh_animation", "portbench.stage2")):
            self.patch(pipe, attr, self.spanned(name))
        self.patch(pipe.mesh_process, "process_mesh", self.spanned("portbench.stage0.process_mesh"))
        self.family.spans(self)
