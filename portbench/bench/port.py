"""The system under test: ``actionmesh_tpu_torch``, built from the
benchmark's weights, and the hooks the benchmark sets on it.

``build`` hands the release-named tensors to the port's own checkpoint
converters (``utils/weights.py``), as loading a real checkpoint does, and
builds the pipeline entry of the cell's mode with them: DINOv2, TripoSG
(its DiT, its VAE, and the development SDF regulariser the port applies
to random-weight fields, ``models/stage0.py``), the Stage-I denoiser and
the Stage-II autoencoder.

``Hooks`` wraps the functions the pipeline calls between its layers, at
the module names it looks them up under, and, while recording, keeps what
the correctness check needs from one clip: the encoder's features, the
DiT's inputs and outputs at the checked steps, a sample of SDF queries,
each Stage-I window's inputs and output and its checked step, and every
Stage-II call. ``install_spans`` also opens a ``record_function`` range
around each call into a layer and each attention call (with the call's
shape), for the profiled clip.
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


class Stage0:
    """The pipeline's image-to-3D backend: the port's TripoSG pipeline with
    the configuration's extraction depths."""

    def __init__(self, tsg, decode: dict):
        self.tsg = tsg
        self.decode = decode

    @property
    def phase_seconds(self):
        return self.tsg.phase_seconds

    def __call__(self, image, **kwargs):
        return self.tsg(image, **self.decode, **kwargs)

    def encode_to_latent(self, surface, seed=None):
        return self.tsg.encode_to_latent(surface, seed=seed)


def build(cfg: dict, states: dict, mode: str, device):
    """The pipeline entry of ``mode`` ("video" | "video_mesh") on ``device``."""
    from actionmesh_tpu_torch.models import stage0
    from actionmesh_tpu_torch.models.dinov2 import DinoV2Config
    from actionmesh_tpu_torch.models.image_encoder import ImageEncoder
    from actionmesh_tpu_torch.models.triposg.dit import triposg_dit_config
    from actionmesh_tpu_torch.models.triposg.pipeline import TripoSGPipeline
    from actionmesh_tpu_torch.models.triposg.vae import TripoSGVAEConfig
    from actionmesh_tpu_torch.pipeline import ActionMeshPipeline
    from actionmesh_tpu_torch.pipeline_with_3d import ActionMeshPipelineWithMeshInput
    from actionmesh_tpu_torch.utils import weights as W

    dtype = DTYPES[cfg["dtype"]]
    m = cfg["model"]
    d = m["dinov2"]
    dino_cfg = DinoV2Config(hidden_size=d["hidden_size"], num_layers=d["num_layers"],
                            num_heads=d["num_heads"], mlp_ratio=d["mlp_ratio"],
                            patch_size=d["patch_size"], image_size=d["image_size"],
                            eps=d["layer_norm_eps"])
    encoder = ImageEncoder(device=device, dtype=dtype, config=dino_cfg, params=W.params_from_jax(
        W.convert_dinov2(states["dinov2"], dino_cfg, dtype), device))
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

    base = ActionMeshPipelineWithMeshInput if mode == "video_mesh" else ActionMeshPipeline

    class Pipeline(base):
        def _load_actionmesh_weights(self):
            self.denoiser_params = W.params_from_jax(
                W.convert_denoiser(states["denoiser"], self.denoiser_config, dtype), device)
            self.autoencoder_params = W.params_from_jax(
                W.convert_autoencoder(states["autoencoder"], self.autoencoder_config, dtype), device)

    kwargs = dict(config_name=cfg["preset"], weights_dir=None, device=device, dtype=dtype,
                  config_updates=_pipeline_updates(cfg), image_encoder=encoder,
                  image_to_3d=backend, device_mesh=None)
    if mode == "video_mesh":
        kwargs.update(surface_samples=cfg["surface_samples"], vae=backend)
    return Pipeline(**kwargs)


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


def _detach(x):
    return x.detach().clone() if isinstance(x, torch.Tensor) else x


def _bind(orig, args, kwargs) -> dict:
    """The call's arguments by parameter name."""
    import inspect

    b = inspect.signature(orig).bind(*args, **kwargs)
    b.apply_defaults()
    return b.arguments


class _Steps:
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
            self.at[step - 1]["x_next"] = _detach(hidden[:self.B])
        if step in self.steps:
            rec = self.at.setdefault(step, {"x": _detach(hidden[:self.B]), "v": []})
            rec["v"].append(_detach(out))

    def close(self, result: torch.Tensor) -> dict[int, dict]:
        """The planned steps seen, the prediction concatenated; the last
        step's next latents are the sampler's result."""
        for rec in self.at.values():
            rec.setdefault("x_next", _detach(result))
            if isinstance(rec["v"], list):
                rec["v"] = torch.cat(rec["v"])
        return self.at


class Hooks:
    """Wrappers around the port's inter-layer calls (see the module doc).

    ``plan``: {"dit_steps": [...], "s1_steps": {window: step}, "sdf_rows":
    rows kept per field query}. ``record`` arms the capture for one clip;
    disarmed, the wrappers only pass the call on. A step is found by the
    rows of the forward calls, so a loop that runs its guidance branches
    one call each is read as one that batches them. Nothing synchronises
    the device: every kept tensor is an asynchronous copy.
    """

    def __init__(self, pipe, plan: dict):
        self.pipe, self.plan = pipe, plan
        self.recording = False
        self.cap: dict = {}
        self._undo: list = []
        self._install()

    # -- capture state -------------------------------------------------
    @contextlib.contextmanager
    def record(self):
        self.cap = {"dit": {}, "sdf": [], "s1": [], "s2": [], "features": None,
                    "decode_latent": None, "anchor_latent": None, "vae": None}
        self._mesh = None
        self._dit = None
        self._s1 = None
        self.recording = True
        try:
            yield self.cap
        finally:
            self.recording = False

    def _patch(self, obj, name, make):
        orig = getattr(obj, name)
        setattr(obj, name, make(orig))
        self._undo.append((obj, name, orig))

    def remove(self):
        for obj, name, orig in reversed(self._undo):
            setattr(obj, name, orig)
        self._undo.clear()

    # -- the wrappers --------------------------------------------------
    def _install(self):
        import actionmesh_tpu_torch.models.triposg.pipeline as tsg_mod
        import actionmesh_tpu_torch.models.triposg.vae as vae_mod
        import actionmesh_tpu_torch.pipeline as pipe_mod
        import actionmesh_tpu_torch.sampling.denoise_loop as loop_mod

        pipe = self.pipe
        backend = pipe.image_to_3d

        def encode_images(orig):
            def f(images):
                out = orig(images)
                if self.recording and len(images) > 1:
                    self.cap["features"] = _detach(out)
                return out
            return f

        self._patch(pipe.image_encoder, "encode_images", encode_images)

        def dit_forward(orig):
            def f(params, cfg, latents, *a, **k):
                out = orig(params, cfg, latents, *a, **k)
                if self.recording and self._dit is not None:
                    self._dit.call(latents, out)
                return out
            return f

        self._patch(tsg_mod, "triposg_dit_forward", dit_forward)

        def flow_sample(orig):
            def f(*a, **k):
                if not self.recording:
                    return orig(*a, **k)
                args = _bind(orig, a, k)
                B = args["init_noise"].shape[0]
                self._dit = _Steps(B, B if args["guidance_scale"] is None else 2 * B,
                                   self.plan["dit_steps"])
                out = orig(*a, **k)
                self.cap["dit"] = self._dit.close(out)
                self._dit = None
                self.cap["anchor_latent"] = _detach(out)
                return out
            return f

        self._patch(tsg_mod, "flow_sample", flow_sample)

        def decode_kv(orig):
            def f(params, cfg, latents, *a, **k):
                if self.recording:
                    self.cap["decode_latent"] = _detach(latents)
                return orig(params, cfg, latents, *a, **k)
            return f

        self._patch(tsg_mod, "decode_kv", decode_kv)

        def query_chunk(orig):
            def f(params, cfg, kv, pts, mesh=None, compute_dtype=None):
                vals = orig(params, cfg, kv, pts, mesh, compute_dtype)
                if self.recording and compute_dtype is None:
                    n = self.plan["sdf_rows"]
                    stride = max(1, pts.shape[0] // n)
                    rows = torch.arange(len(self.cap["sdf"]) % stride, pts.shape[0], stride,
                                        device=pts.device)[:n]
                    self.cap["sdf"].append({"pts": pts[rows], "vals": vals[rows]})
                return vals
            return f

        self._patch(vae_mod, "_query_chunk", query_chunk)
        self._patch(tsg_mod, "_query_chunk", query_chunk)

        def encode_to_latent(orig):
            def f(surface, seed=None):
                out = orig(surface, seed=seed)
                if self.recording:
                    self.cap["vae"] = {"surface": np.asarray(surface)[0].copy(), "seed": seed,
                                       "latent": _detach(out)}
                    self.cap["anchor_latent"] = _detach(out)
                return out
            return f

        self._patch(backend, "encode_to_latent", encode_to_latent)

        def denoise_window(orig):
            def f(*a, **k):
                if not self.recording:
                    return orig(*a, **k)
                args = _bind(orig, a, k)
                init = args["init_latent"]
                B = init.shape[0]
                win = len(self.cap["s1"])
                w = {"init": _detach(init), "mask": _detach(args["mask"]),
                     "framestep": _detach(args["framestep"])}
                self.cap["s1"].append(w)
                step = self.plan["s1_steps"].get(win)
                self._s1 = _Steps(B, args["guidance"].n_branches * B,
                                  [] if step is None else [step])
                out = orig(*a, **k)
                seen = self._s1.close(out)
                self._s1 = None
                if step in seen:
                    w.update(step=step, **seen[step])
                w["out"] = _detach(out)
                return out
            return f

        self._patch(pipe_mod, "denoise_window", denoise_window)

        def denoiser_forward(orig):
            def f(params, dcfg, hidden, *a, **k):
                out = orig(params, dcfg, hidden, *a, **k)
                if self.recording and self._s1 is not None:
                    self._s1.call(hidden, out)
                return out
            return f

        self._patch(loop_mod, "denoiser_forward", denoiser_forward)

        def autoencoder_forward(orig):
            def f(params, cfg, latents, framestep, source_alpha, target_alphas, query, **k):
                out = orig(params, cfg, latents, framestep, source_alpha, target_alphas, query, **k)
                if self.recording:
                    self.cap["s2"].append({
                        "latents": _detach(latents), "framestep": _detach(framestep),
                        "source_alpha": _detach(source_alpha), "targets": _detach(target_alphas),
                        "query": _detach(query), "out": _detach(out), "mesh": self._mesh})
                return out
            return f

        self._patch(pipe_mod, "autoencoder_forward", autoencoder_forward)

        def mesh_features(orig):
            def f(mesh, *a, **k):
                if self.recording:
                    self._mesh = {"vertices": np.array(mesh.vertices),
                                  "faces": np.array(mesh.faces)}
                return orig(mesh, *a, **k)
            return f

        self._patch(pipe_mod, "get_mesh_features", mesh_features)

    def install_spans(self):
        """Open a ``record_function`` range around each call into a layer
        and each attention call (named with the call's shape), for the
        profiled clip that follows the window."""
        import actionmesh_tpu_torch.models.dinov2 as dinov2_mod
        import actionmesh_tpu_torch.models.layers as layers_mod
        import actionmesh_tpu_torch.models.triposg.pipeline as tsg_mod

        pipe = self.pipe
        backend = pipe.image_to_3d
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

        self._patch(layers_mod, "dot_product_attention", attn)
        self._patch(dinov2_mod, "dot_product_attention", attn)

        def spanned(name):
            def make(orig):
                def f(*a, **k):
                    with torch.profiler.record_function(name):
                        return orig(*a, **k)
                return f
            return make

        for attr, name in (("preprocess", "portbench.preprocess"),
                           ("init_banks_from_anchor", "portbench.stage0"),
                           ("encode_all_frames", "portbench.encode"),
                           ("generate_3d_latents", "portbench.stage1"),
                           ("generate_mesh_animation", "portbench.stage2")):
            self._patch(pipe, attr, spanned(name))
        self._patch(pipe.mesh_process, "process_mesh", spanned("portbench.stage0.process_mesh"))
        self._patch(backend.tsg, "decode_latents", spanned("portbench.stage0.decode"))
        self._patch(tsg_mod, "flow_sample", spanned("portbench.stage0.dit_sample"))
