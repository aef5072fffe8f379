"""The port's span tree (actionmesh_tpu_torch/utils/profiling.py) on tiny
pipeline calls on the CPU.

A tiny video call (tests/test_torch_pipeline.py's TINY configuration with a
tiny random-weight TripoSG Stage 0 and the development SDF regulariser):
one call id for the whole call, every span within its parent,
``phase_seconds`` with its five keys, ``stage0_seconds`` with its children
and the dotted keys of the extraction and the mesh processing, the mesh
processing's steps covering its span (on the thread's CPU clock, which the
machine's load does not move). A TINY call
with the Stage-0 stub under torch.profiler: every span on the profiler's
clock (the stub keeps the profiled call small: the tiny TripoSG's padded
SDF chunks are a hundred thousand CPU ops). Then every function the benchmark's
correctness capture wraps (the shared hook points in portbench/bench/port.py,
TripoSG's Stage-0 ones in portbench/families/actionmesh.py) is wrapped here
with a counting wrapper at the same attribute and a clip of each mode must
call it, with arguments that bind to its signature.
"""

import inspect
import time

import numpy as np
import pytest
import torch

import actionmesh_tpu_torch.models.dinov2 as dinov2_mod
import actionmesh_tpu_torch.models.layers as layers_mod
import actionmesh_tpu_torch.models.triposg.pipeline as tsg_mod
import actionmesh_tpu_torch.models.triposg.vae as vae_mod
import actionmesh_tpu_torch.pipeline as pipe_mod
import actionmesh_tpu_torch.sampling.denoise_loop as loop_mod
from actionmesh_tpu_torch.io.video_input import ActionMeshInput
from actionmesh_tpu_torch.models import stage0
from actionmesh_tpu_torch.models.dinov2 import DinoV2Config
from actionmesh_tpu_torch.models.image_encoder import ImageEncoder
from actionmesh_tpu_torch.models.triposg.dit import triposg_dit_config
from actionmesh_tpu_torch.models.triposg.pipeline import TripoSGPipeline
from actionmesh_tpu_torch.models.triposg.vae import TripoSGVAEConfig
from actionmesh_tpu_torch.pipeline import ActionMeshPipeline
from actionmesh_tpu_torch.pipeline_with_3d import ActionMeshPipelineWithMeshInput
from actionmesh_tpu_torch.utils.profiling import Recorder, span, tree_seconds
from tests.test_torch_pipeline import TINY_DINO, TINY_UPDATES, make_frames

CPU = torch.device("cpu")
TINY_DIT = dict(num_tokens=16, in_channels=8, num_layers=2, width=64, num_attention_heads=2,
                cross_attention_dim=32)
TINY_VAE = dict(latent_channels=8, num_tokens=16, encoder_width=32, encoder_layers=1,
                encoder_heads=2, decoder_width=32, decoder_layers=2, decoder_heads=2)
CALL = dict(seed=5, stage_0_steps=2, face_decimation=300)
STAGE0_CHILDREN = {"encode", "dit_sample", "decode", "process_mesh"}
NEW_KEYS = {"decode.extract", "process_mesh.clean", "process_mesh.decimate", "process_mesh.floaters"}


class Backend:
    """The tiny TripoSG with extraction depths a CPU run affords, as a
    deployment's backend passes its own."""

    def __init__(self, tsg, prefilter_octree_depth, hierarchical_octree_depth):
        self.tsg = tsg
        self.depths = dict(prefilter_octree_depth=prefilter_octree_depth, dense_octree_depth=4,
                           hierarchical_octree_depth=hierarchical_octree_depth)

    def __call__(self, image, **kwargs):
        return self.tsg(image, **{**kwargs, **self.depths})

    def encode_to_latent(self, surface, seed=None):
        return self.tsg.encode_to_latent(surface, seed=seed)


def tiny_pipeline(mode: str = "video", host_queries: bool = False):
    """A tiny pipeline of ``mode`` ("video" | "video_mesh") on a tiny
    TripoSG; ``host_queries``: the regulariser without its torch mirror, so
    the extraction queries the field through host callbacks, at one level
    (one query instead of the prefilter path's three)."""
    encoder = ImageEncoder(CPU, torch.float32, DinoV2Config(**TINY_DINO))
    tsg = TripoSGPipeline.from_random(
        seed=0, dtype=torch.float32, dit_cfg=triposg_dit_config(**TINY_DIT),
        vae_cfg=TripoSGVAEConfig(**TINY_VAE), image_encoder=encoder, device=CPU,
    )
    tsg.sdf_regularizer = stage0._dev_sdf_regularizer
    if not host_queries:
        tsg.sdf_regularizer_torch = stage0._dev_sdf_regularizer_torch
    backend = Backend(tsg, None, 4) if host_queries else Backend(tsg, 3, 5)
    kwargs = dict(config_name="actionmesh", weights_dir=None, device=CPU, dtype=torch.float32,
                  config_updates=dict(TINY_UPDATES), image_encoder=encoder,
                  image_to_3d=backend, device_mesh=None)
    if mode == "video_mesh":
        return ActionMeshPipelineWithMeshInput(surface_samples=256, vae=backend, **kwargs)
    return ActionMeshPipeline(**kwargs)


def run(pipe, mode: str = "video"):
    inp = ActionMeshInput(frames=make_frames(), timesteps=np.arange(16, dtype=np.float32))
    if mode == "video_mesh":
        return pipe(inp, stage0.make_uv_sphere(n_lat=8, n_lon=16), **CALL)
    return pipe(inp, **CALL)


@pytest.fixture(scope="module")
def called():
    """The tiny video pipeline after one call, with the benchmark's hook
    points wrapped for it: (pipeline, calls by hook point). One call serves
    every test of the video mode: a tiny TripoSG decode is a hundred
    thousand small CPU ops (the SDF queries' padded chunks). The call's
    spans are stamped with the calling thread's CPU clock, which time the
    thread spends preempted does not advance, so what the tree's seconds
    show does not depend on the machine's load."""
    pipe = tiny_pipeline()
    with pytest.MonkeyPatch.context() as mp:
        calls = wrap_hook_points(mp, pipe)
        mp.setattr(Recorder, "now_ns", lambda self: time.thread_time_ns())
        run(pipe)
    return pipe, calls


def test_one_call_id_and_every_span_within_its_parent(called):
    root = called[0].last_call
    spans = root.recorder.spans
    assert root.name == "pipeline" and root.parent == -1 and spans[0] is root
    assert {sp.call for sp in spans} == {root.call}
    for sp in spans[1:]:
        parent = spans[sp.parent]
        assert parent.start_ns <= sp.start_ns <= sp.end_ns <= parent.end_ns, (sp, parent)
    names = {sp.name for sp in spans}
    assert {"stage1_window_0", "stage2_window_0", "stage1_step", "dit_step", "decode_kv",
            "extract", "grid_inside_fn:prefilter", "ids_val_fn:band", "ids_val_fn:fine",
            "matting", "crop", "vertex_features", "autoencoder_chunk", "to_host",
            "target_meshes", "clean", "decimate", "floaters"} <= names
    assert sum(sp.name == "dit_step" for sp in spans) == CALL["stage_0_steps"]
    assert sum(sp.name == "stage1_step" for sp in spans) == TINY_UPDATES["scheduler.num_inference_steps"]


def test_phase_and_stage0_seconds_are_views_of_the_tree(called):
    pipe, _ = called
    phases = pipe.phase_seconds
    assert set(phases) == {"preprocess", "stage0", "encode", "stage1", "stage2"}
    assert all(v > 0 for v in phases.values())
    s0 = pipe.stage0_seconds
    assert {k for k in s0 if "." not in k} == STAGE0_CHILDREN
    assert NEW_KEYS <= set(s0) and all(s0[k] > 0 for k in NEW_KEYS)
    assert sum(v for k, v in s0.items() if "." not in k) <= phases["stage0"]
    # the mesh processing's three steps are its only child spans, and with
    # its own time they make up its span: an identity of the tree
    tree = tree_seconds(pipe.last_call)
    steps = ("process_mesh.clean", "process_mesh.decimate", "process_mesh.floaters")
    assert {k for k in tree if k.startswith("stage0.process_mesh.")} == {f"stage0.{k}" for k in steps}
    mesh_total, mesh_own = tree["stage0.process_mesh"]
    assert s0["process_mesh"] == mesh_total
    assert sum(s0[k] for k in steps) + mesh_own == pytest.approx(mesh_total, abs=1e-6)
    # and they cover it: its own time, on the thread's CPU clock (the
    # fixture), is no work of its own
    assert mesh_own <= max(0.02 * mesh_total, 0.005)
    # decode.extract is the extraction's own time: the span less its field queries
    extract_total, extract_own = tree["stage0.image_to_3d.decode.extract"]
    queries = sum(total for path, (total, _) in tree.items()
                  if path.startswith("stage0.image_to_3d.decode.extract."))
    assert queries > 0 and s0["decode.extract"] == pytest.approx(extract_total - queries, abs=1e-6)
    assert extract_own == s0["decode.extract"] < s0["decode"]
    # the backend's own view keeps exactly its three keys, and its counters
    tsg = pipe.image_to_3d.tsg
    assert set(tsg.phase_seconds) == {"encode", "dit_sample", "decode"}
    assert tsg.extract_stats == {"prefilter": 1, "band": 1, "dense": 0, "fine": 1}


def test_spans_share_the_profilers_clock():
    """Every in-memory span of a TINY call (Stage-0 stub) under
    torch.profiler has a user annotation of its name that starts within
    5 ms of it: the recorder stamps torch.profiler's clock. A second call
    is another recorder, with another id."""
    from torch.profiler import ProfilerActivity, profile

    pipe = ActionMeshPipeline(
        config_name="actionmesh", weights_dir=None, device=CPU, dtype=torch.float32,
        config_updates=dict(TINY_UPDATES),
        image_encoder=ImageEncoder(CPU, torch.float32, DinoV2Config(**TINY_DINO)),
        image_to_3d=stage0.StubImageTo3D((16, 8), CPU), device_mesh=None,
    )
    run(pipe)  # a first call builds the native library outside the trace
    first = pipe.last_call
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(pipe)
    root = pipe.last_call
    assert root.call != first.call and root.recorder is not first.recorder
    by_name: dict[str, list[int]] = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation():
            by_name.setdefault(ev.name(), []).append(ev.start_ns())
    assert len(root.recorder.spans) > 20
    for sp in root.recorder.spans:
        assert min(abs(s - sp.start_ns) for s in by_name[sp.name]) < 5_000_000, sp


def test_span_without_a_recorder_starts_one():
    with span("outer") as outer:
        with span("inner") as inner:
            pass
    assert outer.parent == -1 and inner.parent == 0 and inner.call == outer.call
    assert outer.recorder.spans == [outer, inner]
    with span("next") as nxt:
        pass
    assert nxt.call != outer.call and nxt.parent == -1
    assert tree_seconds(outer) == {"inner": (inner.seconds, inner.seconds)}


# -- the benchmark's hook points ----------------------------------------

MODULE_HOOKS = [
    (tsg_mod, "triposg_dit_forward"), (tsg_mod, "flow_sample"), (tsg_mod, "decode_kv"),
    (tsg_mod, "_query_chunk"), (vae_mod, "_query_chunk"), (pipe_mod, "denoise_window"),
    (pipe_mod, "autoencoder_forward"), (pipe_mod, "get_mesh_features"),
    (loop_mod, "denoiser_forward"), (layers_mod, "dot_product_attention"),
    (dinov2_mod, "dot_product_attention"),
]
INSTANCE_HOOKS = ["preprocess", "init_banks_from_anchor", "encode_all_frames",
                  "generate_3d_latents", "generate_mesh_animation", "mesh_process.process_mesh",
                  "tsg.decode_latents", "image_encoder.encode_images", "encode_to_latent"]
STAGE0_VIDEO = {"tsg_mod.triposg_dit_forward", "tsg_mod.flow_sample", "tsg_mod.decode_kv",
                "mesh_process.process_mesh", "tsg.decode_latents"}
CALLED = {
    # the device fast paths query through the VAE module's _query_chunk
    "video": STAGE0_VIDEO | {"vae_mod._query_chunk"},
    # the host callbacks through the name the TripoSG pipeline imported
    "video_host_queries": STAGE0_VIDEO | {"tsg_mod._query_chunk"},
    "video_mesh": {"encode_to_latent"},
}
ALWAYS = {"pipe_mod.denoise_window", "pipe_mod.autoencoder_forward", "pipe_mod.get_mesh_features",
          "loop_mod.denoiser_forward", "layers_mod.dot_product_attention",
          "dinov2_mod.dot_product_attention", "preprocess", "init_banks_from_anchor",
          "encode_all_frames", "generate_3d_latents", "generate_mesh_animation",
          "image_encoder.encode_images"}
MODULE_NAMES = {tsg_mod: "tsg_mod", vae_mod: "vae_mod", pipe_mod: "pipe_mod",
                loop_mod: "loop_mod", layers_mod: "layers_mod", dinov2_mod: "dinov2_mod"}


def test_every_hook_point_is_called_in_some_mode():
    every = {f"{MODULE_NAMES[m]}.{n}" for m, n in MODULE_HOOKS} | set(INSTANCE_HOOKS)
    assert set().union(ALWAYS, *CALLED.values()) == every


def wrap_hook_points(mp, pipe) -> dict[str, int]:
    """Wrap each function the benchmark wraps at its attribute with a
    counting wrapper that binds the call's arguments to its signature;
    returns the counts by hook point."""
    calls: dict[str, int] = {}

    def counting(key, orig):
        sig = inspect.signature(orig)

        def wrapper(*args, **kwargs):
            sig.bind(*args, **kwargs)
            calls[key] = calls.get(key, 0) + 1
            return orig(*args, **kwargs)
        return wrapper

    for mod, name in MODULE_HOOKS:
        mp.setattr(mod, name, counting(f"{MODULE_NAMES[mod]}.{name}", getattr(mod, name)))
    owners = {"mesh_process": pipe.mesh_process, "tsg": pipe.image_to_3d.tsg,
              "image_encoder": pipe.image_encoder}
    for key in INSTANCE_HOOKS:
        owner, _, name = key.rpartition(".")
        obj = owners[owner] if owner else (pipe.image_to_3d if name == "encode_to_latent" else pipe)
        mp.setattr(obj, name, counting(key, getattr(obj, name)))
    return calls


@pytest.mark.parametrize("mode", list(CALLED))
def test_hook_points_are_looked_up_at_call_time(mode, request, monkeypatch):
    """Each function the benchmark wraps, wrapped at its attribute here,
    is called by a clip of the mode, with arguments that bind to its
    signature."""
    if mode == "video":
        _, calls = request.getfixturevalue("called")
    else:
        pipe = tiny_pipeline("video_mesh" if mode == "video_mesh" else "video",
                             host_queries=mode == "video_host_queries")
        calls = wrap_hook_points(monkeypatch, pipe)
        assert len(run(pipe, "video_mesh" if mode == "video_mesh" else "video")) == 16
    expected = ALWAYS | CALLED[mode]
    assert expected <= set(calls), sorted(expected - set(calls))
