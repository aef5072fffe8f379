"""The port's closed loop (``training/closed_loop.py``, ``closed_loop.py``)
vs the JAX package's, on CPU, at the micro spec of ``tests/test_closed_loop.py``.

Scenes, tracks and renders against JAX's; the data build with JAX's frozen
conditioning stack carried over (the port draws its own from torch
generators, so its numbers differ from JAX's); the loop end to end on the
port alone (build, train, export, ``load_native``, inference, ActionBench
scoring) and its Stage-0 phase. Also the kernels' padding of the small head
dims the loop's models use (12, 16, 32) on the plain versions, and kernel
B's dispatch of those dims. Tolerances are stated per test with their reason.
"""

import dataclasses
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from actionmesh_tpu.training import closed_loop as jcl
from actionmesh_tpu_torch import closed_loop as tcli
from actionmesh_tpu_torch.config import load_config
from actionmesh_tpu_torch.io.mesh import Mesh
from actionmesh_tpu_torch.io.png import read_png
from actionmesh_tpu_torch.ops import flash_attention as tflash
from actionmesh_tpu_torch.ops import rope_norm as trope
from actionmesh_tpu_torch.ops.attention import attention_bwd_reference, chunked_attention
from actionmesh_tpu_torch.training import closed_loop as tcl
from actionmesh_tpu_torch.utils.weights import params_from_jax

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
MICRO_FIELDS = dict(
    image_size=96, surface_samples=256, track_points=128, gt_points=2000, n_lat=12, n_lon=16,
    denoiser_width=64, denoiser_layers=2, denoiser_heads=2, decoder_width=64, decoder_layers=2,
    decoder_heads=2, num_inference_steps=2,
)
MICRO = tcl.CascadeSpec(**MICRO_FIELDS)
JMICRO = jcl.CascadeSpec(**MICRO_FIELDS)


def _jax_stack(jspec):
    """JAX's frozen conditioning stack, and the port's stack on its weights."""
    jenc, jvae = jcl.make_conditioning_stack(jspec)
    spec = tcl.CascadeSpec(**dataclasses.asdict(jspec))
    to_port = lambda tree: params_from_jax(jax.tree.map(np.asarray, tree))
    return (jenc, jvae), tcl.make_conditioning_stack(
        spec, CPU, dino_params=to_port(jenc.params), vae_params=to_port(jvae._inner.vae_params)
    )


# ---------------------------------------------------------------------------
# Scenes, tracks, renders, spec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_make_scene_and_tracked_points_bit_equal(seed):
    spec, jspec = dataclasses.replace(MICRO, n_frames=6), dataclasses.replace(JMICRO, n_frames=6)
    got, want = tcl.make_scene(seed, spec), jcl.make_scene(seed, jspec)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.vertices, w.vertices)
        np.testing.assert_array_equal(g.faces, w.faces)
    np.testing.assert_array_equal(
        tcl.tracked_points(got, 64, seed=seed + 7), jcl.tracked_points(want, 64, seed=seed + 7)
    )


def test_render_frames_within_one_level():
    """Both packages' native rasterizer in shaded mode, RGBA: within one
    8-bit level (host float rounding at edge pixels)."""
    from actionmesh_tpu.io.mesh import Mesh as JMesh

    spec = dataclasses.replace(MICRO, n_frames=3)
    normed, _, _ = tcl.normalized_scene(tcl.make_scene(1, spec))
    got = tcl.render_frames(normed, spec)
    want = jcl.render_frames([JMesh(m.vertices, m.faces) for m in normed], spec)
    for g, w in zip(got, want):
        assert g.shape == (96, 96, 4) and g.dtype == np.uint8
        assert int(np.abs(g.astype(int) - np.asarray(w).astype(int)).max()) <= 1


def test_spec_written_by_jax_loads(tmp_path):
    """A JAX ``spec.json`` loads in the port field for field, and the port's
    pipeline updates are a valid port config."""
    jspec = dataclasses.replace(JMICRO, guidance_scale=3.5, compute_dtype="float32")
    jspec.save(tmp_path / "spec.json")
    spec = tcl.CascadeSpec.load(tmp_path / "spec.json")
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    assert spec.dtype == torch.float32
    cfg = load_config("actionmesh", updates=spec.pipeline_updates())
    assert cfg.temporal_3D_denoiser.width == 64 and cfg.cf_guidance.guidance_scales == [3.5]
    jupdates = jspec.pipeline_updates()
    assert set(jupdates) - set(spec.pipeline_updates()) == {"attn_impl", "compute_dtype"}


@pytest.mark.parametrize("key", ["attn_impl", "compute_dtype", "temporal_3D_denoiser.attn_impl"])
def test_load_config_still_refuses_unknown_keys(key):
    """The JAX runtime keys are dropped by the spec, not skipped by the
    config: an unknown key still raises."""
    with pytest.raises(KeyError, match="Unknown config key"):
        load_config("actionmesh", updates={key: "x"})


# ---------------------------------------------------------------------------
# The data build, against JAX's
# ---------------------------------------------------------------------------


def _pil_preprocess_for_dino(frames):
    """JAX's DINOv2 input resize (PIL) on the port's uint8 frames."""
    from PIL import Image

    from actionmesh_tpu.models.image_encoder import preprocess_for_dino

    return preprocess_for_dino([Image.fromarray(f[..., :3]) for f in frames])


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """JAX's build and the port's on JAX's stack: 2 train + 1 eval scenes.
    The port's build resizes DINOv2's input with PIL, as JAX does: its own
    resize is held to PIL's separately (one uint8 level at a pixel,
    ``test_torch_ops.py::test_preprocess_for_dino_matches_pil``), so that
    the clips' context is held to the build's arithmetic alone."""
    import actionmesh_tpu_torch.models.image_encoder as timage_encoder

    root = tmp_path_factory.mktemp("build")
    _, stack = _jax_stack(JMICRO)
    juids = jcl.build_dataset(root / "jax", JMICRO, n_train=2, n_eval=1, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(timage_encoder, "preprocess_for_dino", _pil_preprocess_for_dino)
        tuids = tcl.build_dataset(root / "port", MICRO, n_train=2, n_eval=1, seed=0, device=CPU,
                                  stack=stack)
    assert juids == tuids == {"train": ["scene_0000", "scene_0001"], "eval": ["scene_0002"]}
    return root / "jax", root / "port", tuids, stack


def test_build_dataset_matches_jax(builds):
    """Tracks and ground truth exact, the anchor GLB byte-equal, the frames
    within one level, the clips' context and latents within 1e-5 of their
    largest magnitude (fp32 sums in another order)."""
    jroot, troot, uids, _ = builds
    assert json.loads((troot / "split.json").read_text()) == uids
    assert tcl.CascadeSpec.load(troot / "spec.json") == MICRO
    for split, uid_list in uids.items():
        for uid in uid_list:
            for sub in ("gt", "tracks"):
                np.testing.assert_array_equal(
                    np.load(troot / sub / uid / "surfaces.npy"), np.load(jroot / sub / uid / "surfaces.npy")
                )
            assert (troot / "anchor" / f"{uid}.glb").read_bytes() == (jroot / "anchor" / f"{uid}.glb").read_bytes()
            for t in range(MICRO.n_frames):
                got = read_png(troot / "frames" / uid / f"frame_{t:02d}.png").astype(int)
                want = read_png(jroot / "frames" / uid / f"frame_{t:02d}.png").astype(int)
                assert np.abs(got - want).max() <= 1
            sub = "clips_train" if split == "train" else "clips_eval"
            with np.load(troot / sub / f"{uid}.npz") as t, np.load(jroot / sub / f"{uid}.npz") as j:
                np.testing.assert_array_equal(t["framestep"], j["framestep"])
                for k in ("context", "latents"):
                    scale = float(np.abs(j[k]).max())
                    assert np.abs(t[k] - j[k]).max() <= 1e-5 * scale, k


# ---------------------------------------------------------------------------
# The loop end to end, and its Stage-0 phase (port only, on the CPU)
# ---------------------------------------------------------------------------


def test_closed_loop_end_to_end(builds, tmp_path):
    """Train (8 flow, 8 decoder steps) through the entry point, export,
    ``load_native`` the checkpoint into the {video + 3D} pipeline, infer the
    held-out scene and score it: one success, finite CDs."""
    _, built, uids, stack = builds
    root = tmp_path / "loop"
    shutil.copytree(built, root)
    common = ["--root", str(root), "--device", "cpu", "--batch", "2"]
    tcli.main(["train", *common, "--flow-steps", "8", "--decoder-steps", "8"])
    for name in ("denoiser.npz", "autoencoder.npz"):
        assert (root / "ckpt" / name).exists()
    pipe = tcl.make_pipeline(MICRO, ckpt_dir=root / "ckpt", device=CPU, stack=stack)
    from actionmesh_tpu_torch.utils.weights import load_npz

    exported = load_npz(root / "ckpt" / "denoiser.npz")
    torch.testing.assert_close(pipe.denoiser_params["proj_in"]["weight"], exported["proj_in"]["weight"],
                               rtol=0, atol=0)
    tcl.run_inference(root, pipe, uids["eval"], root / "pred", MICRO, seed=1)
    files = sorted((root / "pred" / uids["eval"][0]).glob("mesh_*.glb"))
    assert len(files) == MICRO.n_frames
    metrics = tcl.evaluate_predictions(root, root / "pred", root / "results.csv", uids["eval"],
                                       icp_iters=10, n_pts_icp=500, n_pts_chamfer=2000, device="cpu")
    assert metrics["n_samples"] == metrics["n_success"] == 1, metrics
    for k in ("cd_3d", "cd_4d", "cd_motion"):
        assert np.isfinite(metrics[k]) and metrics[k] > 0


def test_stage0_phase_to_stage0_clips(builds, tmp_path):
    """The stage0 phase through the entry point (4 VAE and 4 DiT steps):
    exact-TSDF pools, a ``vae.npz`` + ``dit.npz`` export, every clip
    re-encoded through the trained VAE, and T = 1 anchor clips."""
    _, built, uids, _ = builds
    root = tmp_path / "s0"
    shutil.copytree(built, root)
    before = {u: np.load(root / "clips_train" / f"{u}.npz")["latents"] for u in uids["train"]}
    tcli.main(["stage0", "--root", str(root), "--device", "cpu", "--batch", "2",
               "--vae-steps", "4", "--dit-steps", "4", "--vae-query-points", "256"])
    for name in ("vae.npz", "dit.npz"):
        assert (root / "ckpt_stage0" / name).exists()
    logs = json.loads((root / "train_vae_log.json").read_text())
    assert any("eval_loss" in r and np.isfinite(r["eval_loss"]) for r in logs)
    for u in uids["train"] + uids["eval"]:
        with np.load(root / "sdf" / f"{u}.npz") as z:
            assert z["points"].shape == (4096, 3) and z["tsdf"].shape == (4096,)
            assert z["surface"].shape == (MICRO.surface_samples, 6)
        with np.load(root / "clips_stage0" / f"{u}.npz") as z:
            assert z["latents"].shape == (1, MICRO.latent_tokens, MICRO.latent_channels)
            assert z["context"].shape[0] == 1
    for u in uids["train"]:
        after = np.load(root / "clips_train" / f"{u}.npz")["latents"]
        assert after.shape == before[u].shape and not np.array_equal(after, before[u])


def test_degenerate_anchor_is_the_only_skip(tmp_path):
    """``run_inference_video`` skips a scene only on a degenerate anchor;
    any other error propagates; the report counts the skip."""
    spec = MICRO

    class Pipe:
        def __init__(self, exc):
            self.exc = exc

        def __call__(self, video, seed=44):
            raise self.exc

    root = tmp_path
    frames = root / "frames" / "scene_0000"
    frames.mkdir(parents=True)
    from actionmesh_tpu_torch.io.png import write_png

    for t in range(spec.n_frames):
        write_png(frames / f"frame_{t:02d}.png", np.full((8, 8, 4), 200, np.uint8))
    skipped = tcl.run_inference_video(root, Pipe(tcl.DegenerateAnchorError("empty")), ["scene_0000"],
                                      root / "pred", spec)
    assert skipped == ["scene_0000"] and not (root / "pred").exists()
    metrics = tcl.evaluate_predictions(root, root / "pred", root / "r.csv", ["scene_0000"], device="cpu")
    assert metrics["n_samples"] == 1 and metrics["n_success"] == 0
    with pytest.raises(RuntimeError, match="launch failed"):
        tcl.run_inference_video(root, Pipe(RuntimeError("flash_fwd launch failed")), ["scene_0000"],
                                root / "pred", spec)


def test_stage0_adapter_raises_on_degenerate_anchor():
    class Empty:
        phase_seconds = {}

        def __call__(self, image, **_):
            return torch.zeros(1, 16, 8), Mesh(np.zeros((0, 3)), np.zeros((0, 3), np.int64))

    with pytest.raises(tcl.DegenerateAnchorError):
        tcl.Stage0Adapter(Empty(), 4, 5)(np.zeros((8, 8, 4), np.uint8))


def test_entry_points_default_to_the_card():
    """Both new entry points take the card unless told otherwise, and raise
    without one."""
    from actionmesh_tpu_torch import prepare_clips

    assert tcli.build_parser().parse_args(["eval"]).device == "cuda"
    assert prepare_clips.build_parser().parse_args(["--input", "x", "--out", "y"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcli.main(["build", "--root", "unused"])


def test_cli_flags_and_variants_match_jax():
    """The same phases, flags and variants as ``scripts/closed_loop.py``;
    every variant's updates are a valid port config."""
    import importlib.util

    spec_ = importlib.util.spec_from_file_location("jax_closed_loop", REPO / "scripts" / "closed_loop.py")
    jmod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(jmod)
    assert set(tcli.VARIANTS) == set(jmod.VARIANTS)
    for name, (ckpt, extra, *rest) in tcli.VARIANTS.items():
        jckpt, jextra, *jrest = jmod.VARIANTS[name]
        assert (ckpt, extra, rest) == (jckpt, jextra, jrest), name
        updates = dict(MICRO.pipeline_updates(), **{k: (4 if v is None else v) for k, v in extra.items()})
        load_config("actionmesh", updates=updates)
    flags = {a.dest for a in tcli.build_parser()._actions}
    assert flags >= {"root", "seed", "n_train", "n_eval", "batch", "lr", "flow_steps", "decoder_steps",
                     "distill_steps", "vae_steps", "dit_steps", "vae_query_points", "kl_weight", "spec",
                     "eval_batches", "icp_iters", "variants", "ckpt_name", "extra_progressive",
                     "decoder_select_chamfer", "report_name", "device"}


# ---------------------------------------------------------------------------
# The closed loop's head dims on the kernels' wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [12, 16, 32, 96])
def test_padded_head_dim_is_exact_on_the_plain_versions(D):
    """Zero-padding D to the kernels' width (64 or 128) with the scale of
    the true D gives the unpadded forward, stats and gradients (fp32 sums
    over more zero terms: 1e-6 of the largest magnitude)."""
    width = tflash.padded_head_dim(D)
    assert width == (64 if D <= 64 else 128)
    g = torch.Generator().manual_seed(D)
    q, k, v, do = (torch.randn((2, 3, s, D), generator=g) for s in (37, 53, 53, 37))
    scale = D ** -0.5
    out, (m, l) = chunked_attention(q, k, v, scale=scale, return_stats=True)
    pq, pk, pv, pdo = (tflash.pad_head_dim(x, width) for x in (q, k, v, do))
    pout, (pm, pl) = chunked_attention(pq, pk, pv, scale=scale, return_stats=True)
    torch.testing.assert_close(pout[..., :D], out, rtol=0, atol=1e-6)
    assert float(pout[..., D:].abs().max()) == 0.0
    torch.testing.assert_close(pm, m, rtol=0, atol=1e-6)
    torch.testing.assert_close(pl, l, rtol=1e-6, atol=0)
    grads = attention_bwd_reference(q, k, v, out, m, l, do, scale)
    pgrads = attention_bwd_reference(pq, pk, pv, pout, pm, pl, pdo, scale)
    for got, want in zip(pgrads, grads):
        torch.testing.assert_close(got[..., :D], want, rtol=0, atol=1e-6 * float(want.abs().max()))
        assert float(got[..., D:].abs().max()) == 0.0
    assert tflash.padded_head_dim(129) is None


def test_kernel_dispatch_covers_the_closed_loop_head_dims():
    """Kernel B is instantiated at every head dim its wrapper takes (the
    loop's 32, and 12 and 16), forward and backward; A, C and D pad."""
    source = (REPO / "actionmesh_tpu_torch" / "csrc" / "rms_rope.cu").read_text()
    for d in trope.HEAD_DIMS:
        assert f"if (D == {d}) return dispatch_fwd<T, {d}>" in source
        assert f"if (D == {d}) return dispatch_bwd<T, {d}>" in source
    for d in (12, 16, 32):
        assert tflash.padded_head_dim(d) in tflash._HEAD_DIMS
        x = torch.randn(2, 4, 5, d)
        scale = torch.rand(d) + 0.5
        cos, sin = torch.rand(5, d), torch.rand(5, d)
        for s, c, sn in ((scale, cos, sin), (None, cos, sin), (scale, None, None)):
            out = trope.fused_rms_rope(x, s, c, sn)  # the plain version on CPU
            assert out.shape == x.shape and torch.isfinite(out).all()


def test_pipeline_save_pretrained_and_load_native(tmp_path):
    """``save_pretrained`` writes the Stage I/II params in the layout JAX's
    ``load_params`` reads (bit-equal); ``load_native`` reads them back."""
    from actionmesh_tpu.utils.weights import load_params as jload_params
    from actionmesh_tpu_torch.utils.tree import named_leaves
    from actionmesh_tpu_torch.utils.weights import params_to_jax

    stack = tcl.make_conditioning_stack(MICRO, CPU)
    pipe = tcl.make_pipeline(MICRO, device=CPU, stack=stack)
    pipe.save_pretrained(tmp_path / "ckpt")
    for name, params in (("denoiser.npz", pipe.denoiser_params), ("autoencoder.npz", pipe.autoencoder_params)):
        reread = jload_params(tmp_path / "ckpt" / name)
        for key, leaf in named_leaves(params_to_jax(params)):
            got = reread
            for part in key.split("."):
                got = got[int(part)] if isinstance(got, list) else got[part]
            np.testing.assert_array_equal(np.asarray(got), leaf)
    other = tcl.make_pipeline(dataclasses.replace(MICRO), device=CPU, stack=stack)
    with torch.no_grad():
        for t in named_leaves(other.denoiser_params):
            t[1].add_(1.0)
    other.load_native(tmp_path / "ckpt")
    for (n, a), (m, b) in zip(named_leaves(other.denoiser_params), named_leaves(pipe.denoiser_params)):
        assert n == m and torch.equal(a, b)


@pytest.mark.parametrize("trainable", [True, False])
def test_vae_trainable_attention_reaches_the_flash_backward(monkeypatch, trainable):
    """``trainable`` sends every attention of the VAE's encode, decode and
    SDF query to ``flash_attention_trainable`` (kernels A, C and D on the
    card); without it none goes there."""
    from actionmesh_tpu_torch.models.triposg import vae as tvae

    calls = []
    plain = tflash.flash_attention_trainable

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return plain(*args, **kw)

    monkeypatch.setattr(tflash, "flash_attention_trainable", counting)
    cfg = MICRO.vae_config()
    params = tvae.init_triposg_vae(torch.Generator().manual_seed(0), cfg)
    surface = torch.rand(1, 64, 6)
    mean, _ = tvae.encode_moments(params, cfg, surface, trainable=trainable)
    kv = tvae.decode_kv(params, cfg, mean, trainable=trainable)
    tvae.query_sdf(params, cfg, kv, torch.rand(1, 10, 3), trainable=trainable)
    want = 2 + cfg.encoder_layers + cfg.decoder_layers if trainable else 0
    assert len(calls) == want
