"""The port's resident server (actionmesh_tpu_torch/inference/serve.py).

Every case of tests/test_serve_hardening.py against the port's server on a
fake pipeline of the port's own meshes (400, 404, field types, a crash then
recovery, the lock serialising, per-request output directories, an internal
assertion as 500), the health keys of the JAX server, ``--prewarm`` and
``--device``, one request through the port's server on a tiny port
pipeline against JAX's ``ActionMeshServer.handle`` on the JAX tiny pipeline
with the same weights, and a request's overrides holding for it alone (JAX's
pipeline keeps them for the requests after; the port does not). The server
at world 2 is in tests/test_torch_parallel.py.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import actionmesh_tpu.pipeline as jpipeline_mod
import actionmesh_tpu_torch.pipeline as tpipeline_mod
from actionmesh_tpu.models.dinov2 import DinoV2Config as JDinoCfg
from actionmesh_tpu.models.image_encoder import ImageEncoder as JImageEncoder
from actionmesh_tpu.models.stage0 import make_uv_sphere as jsphere
from actionmesh_tpu_torch.inference import serve
from actionmesh_tpu_torch.models.dinov2 import DinoV2Config as TDinoCfg
from actionmesh_tpu_torch.models.image_encoder import ImageEncoder as TImageEncoder
from actionmesh_tpu_torch.models.stage0 import make_uv_sphere
from actionmesh_tpu_torch.utils.weights import params_from_jax
from inference.serve import ActionMeshServer as JServer
from tests.test_torch_pipeline import TINY_DINO, TINY_UPDATES, make_frames

CPU = torch.device("cpu")


class FakePipeline:
    """Stands in for ActionMeshPipeline: returns n_frames tiny meshes."""

    device = CPU

    def __init__(self, *args, **kwargs):
        self.in_flight = 0
        self.max_in_flight = 0
        self.calls = 0
        self.fail_next = None
        self.hold_seconds = 0.0
        self._stat_lock = threading.Lock()

    def __call__(self, inp, seed=44, **overrides):
        with self._stat_lock:
            self.in_flight += 1
            self.calls += 1
            self.max_in_flight = max(self.max_in_flight, self.in_flight)
        try:
            if self.fail_next:
                exc, self.fail_next = self.fail_next, None
                raise exc
            if self.hold_seconds:
                time.sleep(self.hold_seconds)
            base = make_uv_sphere(n_lat=6, n_lon=8)
            return [base for _ in range(inp.n_frames)]
        finally:
            with self._stat_lock:
                self.in_flight -= 1


def start(srv):
    """Serve ``srv`` on a free local port from a daemon thread; (url, httpd)."""
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(srv))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", httpd


def write_frames(directory: Path, frames) -> str:
    directory.mkdir(parents=True, exist_ok=True)
    for i, frame in enumerate(frames):
        Image.fromarray(frame).save(directory / f"{i:02d}.png")
    return str(directory)


@pytest.fixture()
def served(tmp_path):
    pipe = FakePipeline()
    url, httpd = start(serve.ActionMeshServer(pipe))
    frames = write_frames(tmp_path / "frames", [np.full((8, 8, 4), 128, np.uint8)] * 16)
    yield url, pipe, frames, str(tmp_path / "out")
    httpd.shutdown()
    httpd.server_close()


def _post_raw(url, data: bytes):
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"},
                                 method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, payload):
    return _post_raw(url, json.dumps(payload).encode())


def _health(url):
    with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
        return r.status, json.loads(r.read())


def test_malformed_json_body_is_structured_400(served):
    url, _, _, _ = served
    status, body = _post_raw(f"{url}/v1/video_to_4d", b"{not json!!")
    assert status == 400
    assert body["status"] == "error" and body["error"]


def test_unknown_paths_are_structured_404(served):
    url, _, _, _ = served
    status, body = _post(f"{url}/v1/nope", {})
    assert status == 404 and "unknown path" in body["error"]
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{url}/nope", timeout=60)
    assert e.value.code == 404 and "unknown path" in json.loads(e.value.read())["error"]


@pytest.mark.parametrize("body", [
    {"seed": "not-a-number"},
    {"max_frames": "many"},
    {"input": None},
    {"input": "/nonexistent/frames"},
], ids=["seed", "max_frames", "no_input", "missing_dir"])
def test_invalid_field_is_structured_400(served, body):
    url, pipe, frames, out = served
    status, reply = _post(f"{url}/v1/video_to_4d", {"input": frames, "output_dir": out, **body})
    assert status == 400 and reply["status"] == "error"
    assert pipe.calls == 0
    assert _health(url)[1]["requests"] == 0


def test_healthz_keys_are_the_jax_servers(served):
    url, _, _, _ = served
    status, health = _health(url)
    assert status == 200
    assert set(health) == {"status", "backend", "n_devices", "sharded", "requests"}
    assert health == {"status": "ok", "backend": "cpu", "n_devices": 1, "sharded": False,
                      "requests": 0}


def test_mid_request_crash_500_then_server_and_lock_recover(served):
    url, pipe, frames, out = served
    pipe.fail_next = RuntimeError("device program aborted mid-request")
    status, body = _post(f"{url}/v1/video_to_4d", {"input": frames, "output_dir": out})
    assert status == 500 and body["status"] == "error"
    assert "aborted mid-request" in body["error"]
    # the crash leaks neither the lock nor the process: the next request succeeds
    status, body = _post(f"{url}/v1/video_to_4d", {"input": frames, "output_dir": out})
    assert status == 200, body
    assert body["status"] == "ok" and body["n_frames"] == 16
    assert _health(url)[1]["requests"] == 1


def test_concurrent_requests_serialized_by_device_lock(served):
    url, pipe, frames, out = served
    pipe.hold_seconds = 0.2  # long enough to overlap without the lock
    results = []

    def fire(i):
        results.append(_post(f"{url}/v1/video_to_4d", {"input": frames, "output_dir": f"{out}/{i}"}))

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert len(results) == 3 and all(status == 200 for status, _ in results), results
    assert pipe.max_in_flight == 1
    assert _health(url)[1]["requests"] == 3


def test_artifacts_written_per_request_output_dir(served, tmp_path):
    url, _, frames, _ = served
    out = tmp_path / "req_out"
    status, body = _post(f"{url}/v1/video_to_4d",
                         {"input": frames, "output_dir": str(out), "save_animated_glb": True})
    assert status == 200, body
    for key in ("meshes", "deformation_vertices", "deformation_faces", "animated_glb"):
        assert key in body["artifacts"]
    assert len(body["artifacts"]["meshes"]) == 16
    assert all(Path(p).exists() for p in body["artifacts"]["meshes"])
    assert (out / "animated_mesh.glb").exists()
    v = np.load(body["artifacts"]["deformation_vertices"])
    assert v.shape[0] == 16 and np.isfinite(v).all()


def test_internal_assertion_is_500_not_400(served):
    url, pipe, frames, out = served
    pipe.fail_next = AssertionError("bank invariant violated")
    status, body = _post(f"{url}/v1/video_to_4d", {"input": frames, "output_dir": out})
    assert status == 500 and body["status"] == "error"
    assert "bank invariant violated" in body["error"]
    status, body = _post(f"{url}/v1/video_to_4d", {"input": frames, "output_dir": out})
    assert status == 200, body


def test_build_server_prewarms_before_serving(monkeypatch, tmp_path):
    """``--prewarm`` runs the pipeline once inside ``build_server``, before
    the server is returned to answer; ``--port 0`` binds a free port."""
    built = []

    class Recording(FakePipeline):
        def __init__(self, **kwargs):
            super().__init__()
            self.kwargs = kwargs
            built.append(self)

    monkeypatch.setattr(tpipeline_mod, "ActionMeshPipeline", Recording)
    frames = write_frames(tmp_path / "frames", [np.full((8, 8, 4), 128, np.uint8)] * 16)
    httpd, srv = serve.build_server(["--device", "cpu", "--config", "actionmesh_turbo", "--port", "0",
                                     "--dtype", "float32", "--prewarm", frames])
    try:
        (pipe,) = built
        assert pipe.calls == 1 and srv.prewarm_seconds is not None and srv.requests_served == 0
        assert pipe.kwargs == {"config_name": "actionmesh_turbo", "weights_dir": "pretrained_weights",
                               "device": CPU, "dtype": torch.float32}
        assert httpd.server_address[1] > 0
    finally:
        httpd.server_close()


def test_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.build_server([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--port", "0"])


def test_request_matches_the_jax_server(tmp_path, monkeypatch):
    """One request on the tiny pipelines, the same weights, Stage 0 a UV
    sphere on both sides and the same Stage-I noise: the port's server over
    HTTP and JAX's ``ActionMeshServer.handle`` give vertices within 1e-5
    (fp32, sums in another order), equal faces and the same artifacts."""
    jpipe = jpipeline_mod.ActionMeshPipeline(
        config_name="actionmesh", weights_dir=None,
        config_updates=dict(TINY_UPDATES, attn_impl="chunked", compute_dtype="float32"),
        dtype=jnp.float32,
    )
    jpipe.image_encoder = JImageEncoder(weights_dir=None, dtype=jnp.float32, config=JDinoCfg(**TINY_DINO))
    tpipe = tpipeline_mod.ActionMeshPipeline(
        config_name="actionmesh", weights_dir=None, device=CPU, dtype=torch.float32,
        config_updates=dict(TINY_UPDATES),
    )
    tpipe.image_encoder = TImageEncoder(
        CPU, torch.float32, TDinoCfg(**TINY_DINO),
        params=params_from_jax(jax.tree.map(np.asarray, jpipe.image_encoder.params)),
    )
    tpipe.denoiser_params = params_from_jax(jax.tree.map(np.asarray, jpipe.denoiser_params))
    tpipe.autoencoder_params = params_from_jax(jax.tree.map(np.asarray, jpipe.autoencoder_params))
    latent = np.random.default_rng(1).standard_normal((1, 16, 8)).astype(np.float32)
    jpipe.image_to_3d = lambda image, **_: (jnp.asarray(latent), jsphere(n_lat=8, n_lon=16))
    tpipe.image_to_3d = lambda image, **_: (torch.from_numpy(latent), make_uv_sphere(n_lat=8, n_lon=16))

    def noise(shape, batch_size, n_timesteps):
        return np.random.default_rng(2).standard_normal(
            (batch_size, n_timesteps) + tuple(shape)).astype(np.float32)

    monkeypatch.setattr(jpipeline_mod, "get_noise", lambda key, shape, batch_size, n_timesteps, **_:
                        jnp.asarray(noise(shape, batch_size, n_timesteps)))
    monkeypatch.setattr(tpipeline_mod, "get_noise", lambda gen, shape, batch_size, n_timesteps, **_:
                        torch.from_numpy(noise(shape, batch_size, n_timesteps)))

    frames = write_frames(tmp_path / "frames", make_frames())
    jbody = JServer(jpipe).handle({"input": frames, "output_dir": str(tmp_path / "jax"), "seed": 44})
    srv = serve.ActionMeshServer(tpipe)
    url, httpd = start(srv)
    try:
        status, tbody = _post(f"{url}/v1/video_to_4d",
                              {"input": frames, "output_dir": str(tmp_path / "port"), "seed": 44})
        health = _health(url)[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert status == 200, tbody
    assert health["requests"] == 1 and health["backend"] == "cpu"

    def names(body):
        return {k: sorted(Path(p).name for p in v) if isinstance(v, list) else Path(v).name
                for k, v in body["artifacts"].items()}

    assert names(tbody) == names(jbody)
    assert tbody["n_frames"] == jbody["n_frames"] == 16
    tv, jv = (np.load(b["artifacts"]["deformation_vertices"]) for b in (tbody, jbody))
    tf, jf = (np.load(b["artifacts"]["deformation_faces"]) for b in (tbody, jbody))
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, atol=1e-5)
    assert np.abs(tv[1:] - tv[0]).max() > 0


def test_request_overrides_hold_for_that_request_only(tmp_path, monkeypatch):
    """A request with ``stage_1_steps`` (and ``guidance_scales``) runs with
    them; the next request without them runs at the preset's values, as
    does one after a request that failed mid-run with overrides."""
    pipe = tpipeline_mod.ActionMeshPipeline(
        config_name="actionmesh", weights_dir=None, device=CPU, dtype=torch.float32,
        config_updates=dict(TINY_UPDATES),
        image_encoder=TImageEncoder(CPU, torch.float32, TDinoCfg(**TINY_DINO)),
        image_to_3d=lambda image, **_: (torch.zeros(1, 16, 8), make_uv_sphere(n_lat=8, n_lon=16)),
    )
    seen = []
    real = tpipeline_mod.denoise_window

    def recording(params, dcfg, guidance, *args, **kwargs):
        seen.append((len(args[5]), guidance.guidance_scales))  # distances: one per step
        return real(params, dcfg, guidance, *args, **kwargs)

    monkeypatch.setattr(tpipeline_mod, "denoise_window", recording)
    preset = (pipe.cfg.scheduler.num_inference_steps, tuple(pipe.cfg.cf_guidance.guidance_scales))
    assert preset == (2, (7.5,))
    frames = write_frames(tmp_path / "frames", make_frames())
    url, httpd = start(serve.ActionMeshServer(pipe))
    try:
        body = {"input": frames, "output_dir": str(tmp_path / "out")}
        assert _post(f"{url}/v1/video_to_4d", {**body, "stage_1_steps": 1, "guidance_scales": [3.0]})[0] == 200
        assert _post(f"{url}/v1/video_to_4d", body)[0] == 200
        monkeypatch.setattr(pipe, "generate_mesh_animation", lambda *a: (_ for _ in ()).throw(
            RuntimeError("failed after Stage I")))
        status, reply = _post(f"{url}/v1/video_to_4d", {**body, "stage_1_steps": 3})
        assert status == 500 and "failed after Stage I" in reply["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert seen == [(1, (3.0,)), (2, (7.5,)), (3, (7.5,))]
    assert (pipe.cfg.scheduler.num_inference_steps, tuple(pipe.cfg.cf_guidance.guidance_scales)) == preset


def test_reply_carries_the_calls_span_breakdown(tmp_path, served):
    """A reply gives the pipeline call's id and its phase and Stage-0
    seconds from the call's span tree; a pipeline without a span tree (the
    fake) answers with none."""
    pipe = tpipeline_mod.ActionMeshPipeline(
        config_name="actionmesh", weights_dir=None, device=CPU, dtype=torch.float32,
        config_updates=dict(TINY_UPDATES),
        image_encoder=TImageEncoder(CPU, torch.float32, TDinoCfg(**TINY_DINO)),
        image_to_3d=lambda image, **_: (torch.zeros(1, 16, 8), make_uv_sphere(n_lat=8, n_lon=16)),
    )
    frames = write_frames(tmp_path / "frames", make_frames())
    url, httpd = start(serve.ActionMeshServer(pipe))
    try:
        body = {"input": frames, "output_dir": str(tmp_path / "out")}
        replies = [_post(f"{url}/v1/video_to_4d", body) for _ in range(2)]
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert [status for status, _ in replies] == [200, 200]
    first, second = (reply for _, reply in replies)
    assert isinstance(first["call_id"], int) and second["call_id"] == pipe.last_call.call != first["call_id"]
    for reply in (first, second):
        assert set(reply["phase_seconds"]) == {"preprocess", "stage0", "encode", "stage1", "stage2"}
        assert sum(reply["phase_seconds"].values()) <= reply["generation_seconds"] + 0.01
        assert {k for k in reply["stage0_seconds"] if "." not in k} == {"image_to_3d", "process_mesh"}
        assert {"process_mesh.clean", "process_mesh.decimate", "process_mesh.floaters"} <= set(
            reply["stage0_seconds"])
    fake_url, _, fake_frames, out = served
    status, reply = _post(f"{fake_url}/v1/video_to_4d", {"input": fake_frames, "output_dir": out})
    assert status == 200 and reply["call_id"] is None
    assert reply["phase_seconds"] == reply["stage0_seconds"] == {}
