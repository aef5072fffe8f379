"""Resident inference server: video -> 4D over HTTP.

    python -m actionmesh_tpu_torch.inference.serve [--port 8080] [--host 127.0.0.1]
        [--config actionmesh] [--weights_dir pretrained_weights]
        [--dtype bfloat16|float16|float32] [--prewarm FRAMES_DIR] [--device cuda|cpu]

Counterpart of the repository's ``inference/serve.py``, with its endpoints,
bodies, status codes and flags, plus ``--device`` (cuda by default; without
a card it raises, as the port's CLIs do). One ``ActionMeshPipeline`` stays
loaded on the device, so a request pays no set-up, and one lock lets one
request at a time into it: the device runs one program at a time.

  GET  /healthz          -> {"status": "ok", "backend": "cuda" | "cpu",
                             "n_devices": N, "sharded": bool, "requests": N}
  POST /v1/video_to_4d   -> run the pipeline
       body: {"input": <path>, "output_dir": <path>, "seed": 44,
              "stage_0_steps"/"stage_1_steps"/"guidance_scales"/
              "face_decimation"/"floaters_threshold"/"anchor_idx": optional,
              "max_frames": 31, "save_animated_glb": true, "render": false}

A request writes ``mesh_XX.glb`` per frame, ``deformations_{vertices,
faces}.npy``, ``animated_mesh.glb`` and, with ``render``, the preview into
its ``output_dir``. Its reply gives ``generation_seconds`` (the pipeline
call, host clock) and the call's breakdown from its span tree
(``utils/profiling.py``): ``call_id`` (the call's id in this process),
``phase_seconds`` (preprocess, stage0, encode, stage1, stage2) and
``stage0_seconds`` (``ActionMeshPipeline.stage0_seconds``). A malformed
body or input (``ValueError``, ``FileNotFoundError``) is answered 400, an
unknown path 404, any other failure 500; the server keeps serving after
each, with the lock released.
``--prewarm`` runs the pipeline once on a frames directory before the
server answers, so the CUDA kernels and the native library are built and
the first request is warm.

On several cards, one rank per card:

    torchrun --nproc-per-node N -m actionmesh_tpu_torch.inference.serve [flags]

Every rank builds the pipeline on its card with the default device mesh
(``parallel/mesh.py:make_mesh``; dp = 2 when N is even, the rest tp). Rank 0
serves HTTP; it sends each admitted request (frames, timesteps, seed,
overrides) to the other ranks (``broadcast_object``) under the lock, and
every rank runs the same pipeline call (``worker_loop`` on the others).
``/healthz`` then says ``"n_devices": N, "sharded": true``. When the server
stops, rank 0 sends the workers a stop message. A request that fails on
one rank after the others started it leaves them waiting in a collective:
restart the job. Without ``torchrun`` it is the one-process server above.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from actionmesh_tpu_torch.io.animated_glb import create_animated_glb_native
from actionmesh_tpu_torch.io.mesh_io import save_deformation, save_meshes
from actionmesh_tpu_torch.io.video_input import ActionMeshInput, load_frames
from actionmesh_tpu_torch.parallel.mesh import broadcast_object, init_distributed

logger = logging.getLogger(__name__)

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}
OVERRIDE_KEYS = (
    "stage_0_steps",
    "stage_1_steps",
    "guidance_scales",
    "face_decimation",
    "floaters_threshold",
    "anchor_idx",
)


def distributed_world() -> int:
    """The number of ranks ``torchrun`` started (WORLD_SIZE; 1 without it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


class ActionMeshServer:
    """Holds the resident pipeline and serialises device access. On rank 0
    of a distributed job (``distributed``) each run is also sent to the
    other ranks, which run it with it (``worker_loop``)."""

    def __init__(self, pipeline, distributed: bool = False):
        self.pipeline = pipeline
        self.distributed = distributed
        self.lock = threading.Lock()
        self.requests_served = 0
        self.prewarm_seconds: Optional[float] = None

    def health(self) -> dict:
        backend = self.pipeline.device.type
        if self.distributed:
            n_devices = distributed_world()
        else:
            n_devices = torch.cuda.device_count() if backend == "cuda" else 1
        return {
            "status": "ok",
            "backend": backend,
            "n_devices": n_devices,
            "sharded": getattr(self.pipeline, "device_mesh", None) is not None,
            "requests": self.requests_served,
        }

    def run(self, inp: ActionMeshInput, seed: int, overrides: dict):
        """One pipeline call (the caller holds the lock), on every rank."""
        if self.distributed:
            broadcast_object(("run", inp.frames, inp.timesteps, seed, overrides))
        return self.pipeline(inp, seed=seed, **overrides)

    def stop_workers(self) -> None:
        """End the other ranks' ``worker_loop``."""
        if self.distributed:
            with self.lock:
                broadcast_object(("stop",))
            self.distributed = False

    def handle(self, req: dict) -> dict:
        input_path = req.get("input")
        if not input_path:
            raise ValueError("missing required field: input")
        output_dir = Path(req.get("output_dir", "outputs/serve"))
        output_dir.mkdir(parents=True, exist_ok=True)

        inp = load_frames(input_path, max_frames=int(req.get("max_frames", 31)))
        overrides = {k: req[k] for k in OVERRIDE_KEYS if req.get(k) is not None}
        seed = int(req.get("seed", 44))

        t0 = time.perf_counter()
        with self.lock:  # one device program at a time
            meshes = self.run(inp, seed, overrides)
            self.requests_served += 1
            call = getattr(self.pipeline, "last_call", None)
            breakdown = {
                "call_id": call.call if call is not None else None,
                "phase_seconds": dict(getattr(self.pipeline, "phase_seconds", {})),
                "stage0_seconds": dict(getattr(self.pipeline, "stage0_seconds", {})),
            }
        gen_s = time.perf_counter() - t0

        save_meshes(meshes, output_dir=output_dir)
        vertices_path, faces_path = save_deformation(meshes, path=output_dir / "deformations")
        artifacts = {
            "meshes": [str(output_dir / f"mesh_{i:02d}.glb") for i in range(len(meshes))],
            "deformation_vertices": str(vertices_path),
            "deformation_faces": str(faces_path),
        }
        if req.get("save_animated_glb", True):
            glb_path = output_dir / "animated_mesh.glb"
            create_animated_glb_native(
                vertices=np.load(vertices_path), faces=np.load(faces_path), output_glb=glb_path
            )
            artifacts["animated_glb"] = str(glb_path)
        if req.get("render", False):
            from actionmesh_tpu_torch.render.visualizer import ActionMeshVisualizer

            out = ActionMeshVisualizer().render(meshes, output_dir=output_dir, input_frames=inp.frames)
            artifacts["preview"] = str(out)

        return {
            "status": "ok",
            "n_frames": len(meshes),
            "generation_seconds": round(gen_s, 2),
            **breakdown,
            "artifacts": artifacts,
        }


def worker_loop(pipeline) -> int:
    """A rank other than 0: run each call rank 0 sends, until it sends
    stop. A call that raises is logged and the loop goes on, as rank 0's
    handler answers 500 and goes on: a request that fails (bad overrides, a
    broken invariant) fails at the same point on every rank, so the ranks
    stay in step. Returns the number of calls that raised."""
    failed = 0
    while True:
        msg = broadcast_object(None)
        if msg[0] == "stop":
            return failed
        _, frames, timesteps, seed, overrides = msg
        try:
            pipeline(ActionMeshInput(frames=frames, timesteps=timesteps), seed=seed, **overrides)
        except Exception:
            logger.exception("worker call failed")
            failed += 1


def make_handler(server: ActionMeshServer):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path == "/healthz":
                self._send(200, server.health())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/v1/video_to_4d":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                self._send(200, server.handle(req))
            except (ValueError, FileNotFoundError) as e:
                # malformed input is the client's error; an AssertionError
                # (a broken invariant) goes to the 500 path below, logged
                self._send(400, {"status": "error", "error": str(e)})
            except Exception as e:  # keep the server alive on request failure
                logger.exception("request failed")
                self._send(500, {"status": "error", "error": str(e)})

        def log_message(self, fmt, *args):
            logger.info("%s - %s", self.address_string(), fmt % args)

    return Handler


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", type=str, default="127.0.0.1")
    ap.add_argument("--config", type=str, default="actionmesh")
    ap.add_argument("--weights_dir", type=str, default="pretrained_weights")
    ap.add_argument("--dtype", type=str, default="bfloat16", choices=list(DTYPES))
    ap.add_argument(
        "--prewarm", type=str, default=None,
        help="frames dir to run once at startup so the first request is warm",
    )
    ap.add_argument(
        "--device", type=str, default="cuda",
        help="cuda (the default; raises without a card) or cpu.",
    )
    return ap


def build_server(
    argv: Optional[list[str]] = None,
) -> tuple[Optional[ThreadingHTTPServer], ActionMeshServer]:
    """Parse ``argv`` (the command line if None), build the pipeline, run
    ``--prewarm`` and bind the HTTP server (``--port 0``: any free port,
    ``httpd.server_address`` says which); the caller runs ``serve_forever``.

    Under ``torchrun`` (WORLD_SIZE > 1) this rank joins the process group
    on its card (``init_distributed``; gloo with ``--device cpu``) and
    builds the pipeline on the default mesh. Rank 0 returns as above (its
    server sends every run to the others); any other rank runs
    ``worker_loop`` (the prewarm included) and returns (None, server) once
    rank 0 stops it.
    """
    from actionmesh_tpu_torch.pipeline import ActionMeshPipeline

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    distributed = distributed_world() > 1
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available (use --device cpu)")
    if distributed:
        device = init_distributed(device_type=device.type)
    pipe = ActionMeshPipeline(
        config_name=args.config, weights_dir=args.weights_dir, device=device, dtype=DTYPES[args.dtype]
    )
    server = ActionMeshServer(pipe, distributed=distributed)
    if distributed and torch.distributed.get_rank() != 0:
        worker_loop(pipe)
        return None, server
    if args.prewarm:
        logger.info("Prewarming on %s ...", args.prewarm)
        t0 = time.perf_counter()
        with server.lock:
            server.run(load_frames(args.prewarm, max_frames=16), seed=0, overrides={})
        server.prewarm_seconds = time.perf_counter() - t0
        logger.info("Prewarm done in %.1f s", server.prewarm_seconds)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server))
    return httpd, server


def main(argv: Optional[list[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    httpd, server = build_server(argv)
    if httpd is None:  # a worker rank, stopped by rank 0
        torch.distributed.destroy_process_group()
        return
    host, port = httpd.server_address[:2]
    logger.info("Serving on http://%s:%d", host, port)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        if server.distributed:
            server.stop_workers()
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
