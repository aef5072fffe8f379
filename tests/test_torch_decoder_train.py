"""Port Stage-II decoder training vs the JAX package's, on CPU, at tiny size.

Same weights (JAX init, perturbed with numpy noise), the same batches and
the same data directories on both sides. Attention on the JAX side is
``chunked_train`` (the plain O(S) custom VJP), on the port's its plain
version on CPU. Tolerances are stated per test with their reason.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from actionmesh_tpu.models import autoencoder as jae
from actionmesh_tpu.training import data as jdata
from actionmesh_tpu.training import decoder_train as jdec
from actionmesh_tpu.training import loop as jloop
from actionmesh_tpu.utils.weights import load_params as jload_params
from actionmesh_tpu_torch import train as ttrain
from actionmesh_tpu_torch.models import autoencoder as tae
from actionmesh_tpu_torch.training import data as tdata
from actionmesh_tpu_torch.training import decoder_train as tdec
from actionmesh_tpu_torch.training import loop as tloop
from actionmesh_tpu_torch.training.checkpoint import export_for_inference
from actionmesh_tpu_torch.training.flow_train import init_train_state
from actionmesh_tpu_torch.utils.tree import leaves, named_leaves, tree_map
from actionmesh_tpu_torch.utils.weights import load_npz, params_from_jax, params_to_jax

TINY = dict(temporal_context_size=4, latent_channels=8, width=64, num_layers=2, num_attention_heads=2)
JCFG = jae.AutoencoderConfig(**TINY)
TCFG = tae.AutoencoderConfig(**TINY)


def _bridge(seed=0):
    """(jax tree, port tree) holding the same perturbed fp32 weights."""
    rng = np.random.default_rng(seed)

    def perturb(a):
        a = np.asarray(a, dtype=np.float32)
        return (a * (1 + 0.1 * rng.standard_normal(a.shape))
                + 0.02 * rng.standard_normal(a.shape)).astype(np.float32)

    tree = jax.tree.map(perturb, jae.init_autoencoder(jax.random.PRNGKey(seed), JCFG))
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree)


def _batch(seed=1, B=2, T=4, N=8, V=12):
    """A decoder batch; the second sample's last 5 vertices are padding."""
    rng = np.random.default_rng(seed)
    alphas = np.sort(rng.uniform(0.1, 1.0, (B, T - 1)), axis=1).astype(np.float32)
    mask = np.ones((B, V), np.float32)
    mask[1, -5:] = 0.0
    return {
        "latents": rng.standard_normal((B, T, N, 8)).astype(np.float32),
        "framestep": np.tile(np.arange(1, 1 + T, dtype=np.float32), (B, 1)),
        "source_alpha": np.zeros((B,), np.float32),
        "target_alphas": alphas,
        "query": rng.uniform(-1, 1, (B, V, 6)).astype(np.float32),
        "positions": np.tanh(rng.standard_normal((B, T - 1, V, 3))).astype(np.float32),
        "vertex_mask": mask,
    }


def _flat(tree):
    return {name: np.asarray(leaf, dtype=np.float32) for name, leaf in named_leaves(tree)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Metrics, loss and gradients
# ---------------------------------------------------------------------------

MASKS = {
    "no_mask": None,
    "partial": np.array([[1] * 12, [1] * 7 + [0] * 5], np.float32),
    "all_padding": np.zeros((2, 12), np.float32),
}


@pytest.mark.parametrize("mask", list(MASKS))
def test_masked_position_mse_and_chamfer_match_jax(mask):
    """Both metrics on the same predictions; an all-padding batch gives 0,
    not NaN. fp32 sums in another order: 1e-6 relative."""
    rng = np.random.default_rng(7)
    pred = np.tanh(rng.standard_normal((2, 3, 12, 3))).astype(np.float32)
    target = np.tanh(rng.standard_normal((2, 3, 12, 3))).astype(np.float32)
    m = MASKS[mask]
    tm = None if m is None else torch.from_numpy(m)
    jm = None if m is None else jnp.asarray(m)
    got = float(tdec.masked_position_mse(torch.from_numpy(pred), torch.from_numpy(target), tm))
    want = float(jdec.masked_position_mse(jnp.asarray(pred), jnp.asarray(target), jm))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    ch_t = tdec.chamfer_eval_metrics(torch.from_numpy(pred), torch.from_numpy(target), tm)
    ch_j = jdec.chamfer_eval_metrics(jnp.asarray(pred), jnp.asarray(target), jm)
    for k in ("eval_cd", "eval_motion"):
        np.testing.assert_allclose(float(ch_t[k]), float(ch_j[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    if mask == "all_padding":
        assert got == 0.0 and float(ch_t["eval_cd"]) == 0.0 and float(ch_t["eval_motion"]) == 0.0


def test_chamfer_ignores_padded_vertices():
    """Padded rows, however far away, change neither metric."""
    rng = np.random.default_rng(8)
    pred = np.tanh(rng.standard_normal((1, 2, 9, 3))).astype(np.float32)
    target = np.tanh(rng.standard_normal((1, 2, 9, 3))).astype(np.float32)
    mask = np.array([[1] * 6 + [0] * 3], np.float32)
    far_p, far_t = pred.copy(), target.copy()
    far_p[:, :, 6:] = 50.0
    far_t[:, :, 6:] = -50.0
    a = tdec.chamfer_eval_metrics(torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(mask))
    b = tdec.chamfer_eval_metrics(torch.from_numpy(far_p), torch.from_numpy(far_t), torch.from_numpy(mask))
    c = tdec.chamfer_eval_metrics(torch.from_numpy(pred[:, :, :6]), torch.from_numpy(target[:, :, :6]))
    for k in a:
        assert float(a[k]) == float(b[k])
        np.testing.assert_allclose(float(a[k]), float(c[k]), rtol=1e-6)


def test_decoder_loss_and_grads_match_jax():
    jp, tp = _bridge()
    batch = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jdec.decoder_loss(p, JCFG, jbatch, attn_impl="chunked_train", remat=True)
    ))(jp)
    tparams = tree_map(lambda t: t.requires_grad_(True), tp)
    loss_t = tdec.decoder_loss(tparams, TCFG, _t(batch))
    grads_t = torch.autograd.grad(loss_t, leaves(tparams))
    it = iter(grads_t)
    grad_tree = tree_map(lambda _: next(it), tparams)
    # fp32 model-level parity, the JAX suite's 5e-4
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=5e-4)
    got, want = _flat(params_to_jax(grad_tree)), _flat(grads_j)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=5e-4, rtol=5e-4, err_msg=name)


def test_trainable_and_remat_change_nothing(monkeypatch):
    """With both switches on the forward is bit-equal to the inference
    forward and the gradients equal those without remat; remat recomputes
    each self-attention block once (the final cross block is not wrapped),
    which is what chip_smoke.py's decoder launch counts expect."""
    import actionmesh_tpu_torch.ops.attention as tattn

    calls = {"fwd": 0, "bwd": 0}

    def spy(fn, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tattn, "chunked_attention", spy(tattn.chunked_attention, "fwd"))
    monkeypatch.setattr(tattn, "attention_bwd_reference", spy(tattn.attention_bwd_reference, "bwd"))
    _, tp = _bridge()
    b = _t(_batch())
    args = (b["latents"], b["framestep"], b["source_alpha"], b["target_alphas"], b["query"])
    with torch.no_grad():
        plain = tae.autoencoder_forward(tp, TCFG, *args)
    L = TCFG.num_layers
    grads = {}
    for remat in (False, True):
        calls.update(fwd=0, bwd=0)
        params = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
        out = tae.autoencoder_forward(params, TCFG, *args, trainable=True, remat=remat)
        assert torch.equal(out.detach(), plain)
        grads[remat] = torch.autograd.grad((out ** 2).sum(), leaves(params))
        assert calls == {"fwd": (2 if remat else 1) * L + 1, "bwd": L + 1}, calls
    for a, c in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def track_dirs(tmp_path_factory):
    """Three uids with clips and tracks (V 13, 10, 7; 6, 6 and 3 frames),
    a clip without tracks and tracks without a clip."""
    root = tmp_path_factory.mktemp("decoder_data")
    clips, tracks = root / "clips", root / "tracks"
    clips.mkdir()
    rng = np.random.default_rng(0)
    for uid, V, frames in (("clip_a", 13, 6), ("clip_b", 10, 6), ("clip_c", 7, 3), ("lonely", 5, 6)):
        jdata.write_clip(clips / f"{uid}.npz", rng.normal(size=(frames, 8, 4)).astype(np.float32),
                         rng.normal(size=(frames, 3, 16)).astype(np.float32),
                         np.arange(frames, dtype=np.float32) * 2.0)
        base = rng.uniform(-0.8, 0.8, (1, V, 3)).astype(np.float32)
        t = np.arange(frames, dtype=np.float32)[:, None, None]
        positions = np.clip(base + 0.02 * rng.normal(size=(1, V, 3)) * t, -1, 1)
        surf = np.concatenate([positions, rng.normal(size=(frames, V, 3))], axis=-1).astype(np.float32)
        if uid != "lonely":
            (tracks / uid).mkdir(parents=True)
            np.save(tracks / uid / "surfaces.npy", surf)
    (tracks / "no_clip").mkdir()
    np.save(tracks / "no_clip" / "surfaces.npy", np.zeros((6, 4, 6), np.float32))
    return clips, tracks


@pytest.mark.parametrize("window,stride,bucket", [(4, 1, 16), (2, 2, 13), (3, 1, 32)])
def test_decoder_data_matches_jax(track_dirs, window, stride, bucket):
    """The same directories, window, bucket and seed give bit-equal batches."""
    clips, tracks = track_dirs
    tds = tdata.DecoderTrackDataset(clips, tracks, window=window, stride=stride)
    jds = jdata.DecoderTrackDataset(clips, tracks, window=window, stride=stride)
    assert len(tds) == len(jds) and tds.skipped_clips == jds.skipped_clips
    tb = tdata.decoder_batches(tds, 2, vertex_bucket=bucket, seed=3, epochs=2)
    jb = jdata.decoder_batches(jds, 2, vertex_bucket=bucket, seed=3, epochs=2)
    n = 0
    for a, b in zip(tb, jb, strict=True):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        n += 1
    assert n == 2 * (len(tds) // 2)


def test_decoder_data_errors(track_dirs, tmp_path):
    """Each check of the JAX dataset raises in the port too."""
    clips, tracks = track_dirs
    with pytest.raises(ValueError, match=">= 2"):
        tdata.DecoderTrackDataset(clips, tracks, window=1)
    with pytest.raises(FileNotFoundError, match="no shared uids"):
        tdata.DecoderTrackDataset(clips, tmp_path, window=4)
    bad = tmp_path / "bad"
    (bad / "clip_a").mkdir(parents=True)
    np.save(bad / "clip_a" / "surfaces.npy", np.zeros((4, 5, 6), np.float32))
    with pytest.raises(ValueError, match="clip has 6 frames"):
        tdata.DecoderTrackDataset(clips, bad, window=4)
    with pytest.raises(ValueError, match="no paired clip has >= 7 frames"):
        tdata.DecoderTrackDataset(clips, tracks, window=7)
    ds = tdata.DecoderTrackDataset(clips, tracks, window=4)
    with pytest.raises(ValueError, match="vertex_bucket"):
        next(tdata.decoder_batches(ds, 2, vertex_bucket=12))
    with pytest.raises(ValueError, match="< batch_size"):
        next(tdata.decoder_batches(ds, 9))
    far = tmp_path / "far"
    (far / "clip_a").mkdir(parents=True)
    surf = np.zeros((6, 4, 6), np.float32)
    surf[3, 0, 0] = 1.7  # outside (-1, 1)
    np.save(far / "clip_a" / "surfaces.npy", surf)
    with pytest.raises(ValueError, match="output range"):
        next(tdata.decoder_batches(tdata.DecoderTrackDataset(clips, far, window=4), 1, vertex_bucket=8))


def test_split_windows_on_decoder_tracks(track_dirs):
    """split_windows gives disjoint, complete views of the decoder dataset,
    each loading through its own cache."""
    clips, tracks = track_dirs
    ds = tdata.DecoderTrackDataset(clips, tracks, window=3)
    ds[0]  # fill the parent's cache
    train, held = tdata.split_windows(ds, eval_fraction=0.3, seed=2)
    assert not set(train._windows) & set(held._windows)
    assert set(train._windows) | set(held._windows) == set(ds._windows)
    assert train._cache is not held._cache and train._cache is not ds._cache
    for view in (train, held):
        for i in range(len(view)):
            clip, track, start = view._windows[i]
            want = np.load(track)[start : start + 3]
            assert np.array_equal(view[i]["surfaces"], want)


# ---------------------------------------------------------------------------
# Loop, export, entry point
# ---------------------------------------------------------------------------

def _loop_cfg(module, out_dir, **kw):
    base = dict(total_steps=3, warmup_steps=1, peak_lr=1e-4, log_every=1, ckpt_every=0,
                eval_every=1, keep_best_eval=True, best_metric="eval_score",
                track_best_metrics=("eval_loss", "eval_cd"), out_dir=str(out_dir))
    base.update(kw)
    return module.TrainLoopConfig(**base)


def test_run_decoder_training_matches_jax(tmp_path):
    """Three steps and four held-out evals (with the chamfer metrics) from
    the same weights and batches: the same losses, eval records and final
    params, and the same best-eval files."""
    jp, tp = _bridge()
    batches = [_batch(seed=s) for s in range(3)]
    held = [_batch(seed=10)]
    jstate, jhist = jloop.run_decoder_training(
        JCFG, iter(batches), _loop_cfg(jloop, tmp_path / "jax"), params=jp,
        attn_impl="chunked_train", eval_batches=held, eval_chamfer=True)
    tstate, thist = tloop.run_decoder_training(
        TCFG, iter(batches), _loop_cfg(tloop, tmp_path / "port"), params=tp,
        device=torch.device("cpu"), eval_batches=held, eval_chamfer=True)
    assert "ema_params" not in tstate and tstate["step"] == int(jstate["step"]) == 3
    assert [sorted(h) for h in thist] == [sorted(h) for h in jhist]
    for a, b in zip(thist, jhist):
        for k in a:
            if k not in ("stage_steps_per_s", "step", "best"):
                # fp32 model-level parity, the JAX suite's 5e-4
                np.testing.assert_allclose(a[k], b[k], rtol=5e-4, err_msg=k)
            elif k != "stage_steps_per_s":
                assert a[k] == b[k], k
    # two updates at lr <= 1e-4 (the first runs at lr 0): Adam moves each
    # leaf by at most ~1e-4 a step, so 5e-4 also bounds a sign flip of a
    # near-zero gradient
    got, want = _flat(params_to_jax(tree_map(lambda t: t.detach(), tstate["params"]))), _flat(jstate["params"])
    for name in want:
        np.testing.assert_allclose(got[name], want[name], atol=5e-4, err_msg=name)
    names = {"ckpt_latest.npz", "ckpt_best.npz", "ckpt_best_eval_loss.npz", "ckpt_best_eval_cd.npz",
             "best_eval.json", "log.jsonl"}
    assert {p.name for p in (tmp_path / "port").iterdir()} == names
    assert names <= {p.name for p in (tmp_path / "jax").iterdir()}
    tbest = json.loads((tmp_path / "port" / "best_eval.json").read_text())
    jbest = json.loads((tmp_path / "jax" / "best_eval.json").read_text())
    assert tbest.keys() == jbest.keys() == {"eval_score", "eval_loss", "eval_cd"}
    for k in tbest:
        np.testing.assert_allclose(tbest[k], jbest[k], rtol=5e-4, err_msg=k)


def test_best_eval_survives_resume(tmp_path):
    """A resumed run reads best_eval.json, so a worse eval after the resume
    leaves ckpt_best.npz as it was."""
    _, tp = _bridge()
    batches = [_batch(seed=s) for s in range(4)]
    cpu = torch.device("cpu")
    cfg = _loop_cfg(tloop, tmp_path, total_steps=2, best_metric="eval_loss", track_best_metrics=())
    tloop.run_decoder_training(TCFG, iter(batches[:2]), cfg, params=tp, device=cpu,
                               eval_batches=[_batch(seed=10)])
    best = json.loads((tmp_path / "best_eval.json").read_text())
    stamp = (tmp_path / "ckpt_best.npz").stat().st_mtime_ns
    # an eval batch far from the weights' range: every later eval is worse
    worse = _batch(seed=10)
    worse["positions"] = -np.sign(worse["positions"])
    cfg = _loop_cfg(tloop, tmp_path, total_steps=4, best_metric="eval_loss", track_best_metrics=())
    _, hist = tloop.run_decoder_training(TCFG, iter(batches[2:]), cfg, params=tp, device=cpu,
                                         eval_batches=[worse])
    evals = [h for h in hist if "eval_loss" in h]
    assert [h["step"] for h in evals] == [3, 4] and not any(h.get("best") for h in evals)
    assert json.loads((tmp_path / "best_eval.json").read_text()) == best
    assert (tmp_path / "ckpt_best.npz").stat().st_mtime_ns == stamp


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_autoencoder_export_loads_in_jax_and_matches_forward(tmp_path, dtype):
    """export_for_inference(stage="decoder") -> autoencoder.npz -> JAX
    load_params -> JAX autoencoder_forward equals the port's forward on the
    exported weights."""
    _, tp = _bridge()
    state = init_train_state(tp, tloop.make_optimizer(_loop_cfg(tloop, tmp_path)))
    path = export_for_inference(state, tmp_path / "export", stage="decoder", compute_dtype=dtype)
    assert path.name == "autoencoder.npz"
    jparams = jload_params(path)
    ported = load_npz(path)
    b = _batch()
    args = ("latents", "framestep", "source_alpha", "target_alphas", "query")
    cd = jnp.float32 if dtype is None else jnp.bfloat16
    ref = np.asarray(jae.autoencoder_forward(jparams, JCFG, *(jnp.asarray(b[k]) for k in args),
                                             compute_dtype=cd), np.float32)
    with torch.no_grad():
        out = tae.autoencoder_forward(ported, TCFG, *(torch.from_numpy(b[k]) for k in args),
                                      compute_dtype=dtype or torch.float32).float().numpy()
    # fp32: the JAX suite's 5e-4; bf16: activations rounded at other places
    np.testing.assert_allclose(out, ref, atol=5e-4 if dtype is None else 2e-2)


def test_entry_point_decoder_stage(tmp_path, track_dirs, monkeypatch):
    """train.py --stage decoder on the CPU: synthetic batches (JAX's numbers
    at --size tiny), and --data-dir with --tracks-dir and a held-out split;
    without a card the default device raises."""
    syn = ttrain.synthetic_decoder_batches(2, 0)
    import scripts.train as jtrain

    jax_syn = jtrain.synthetic_decoder_batches(2, 0)
    for _ in range(2):
        a, b = next(syn), next(jax_syn)
        assert all(np.array_equal(a[k], b[k]) for k in a)
    out = tmp_path / "syn"
    rc = ttrain.main(["--stage", "decoder", "--synthetic", "--steps", "2", "--log-every", "1",
                      "--out", str(out), "--export-inference", str(tmp_path / "exp"), "--device", "cpu"])
    assert rc == 0 and (tmp_path / "exp" / "autoencoder.npz").exists()
    assert jload_params(tmp_path / "exp" / "autoencoder.npz")["post_quant"]["kernel"].shape == (4, 32)
    clips, tracks = track_dirs
    args = ["--stage", "decoder", "--data-dir", str(clips), "--tracks-dir", str(tracks),
            "--window", "3", "--batch", "2", "--vertex-bucket", "16", "--steps", "3",
            "--eval-fraction", "0.3", "--eval-every", "3", "--out", str(tmp_path / "data")]
    state, history, _ = ttrain.run(ttrain.build_args().parse_args(args + ["--device", "cpu"]))
    assert state["step"] == 3 and [h["step"] for h in history if "eval_loss" in h] == [3]
    with pytest.raises(SystemExit, match="tracks-dir"):
        ttrain.main(["--stage", "decoder", "--data-dir", str(clips), "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.run(ttrain.build_args().parse_args(args))


def test_run_decoder_training_defaults_to_cuda(tmp_path, monkeypatch):
    """Without a device the library entry asks for the card and raises
    where there is none; with the CPU named it trains."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tp = _bridge()
    cfg = _loop_cfg(tloop, tmp_path / "run", total_steps=2, eval_every=0, keep_best_eval=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tloop.run_decoder_training(TCFG, iter([_batch()] * 2), cfg, params=tp)
    assert not (tmp_path / "run").exists()
    state, hist = tloop.run_decoder_training(TCFG, iter([_batch()] * 2), cfg, params=tp,
                                             device=torch.device("cpu"))
    assert state["step"] == 2 and [h["step"] for h in hist] == [1, 2]
