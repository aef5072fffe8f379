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
                             "n_devices": N, "sharded": false, "requests": N}
  POST /v1/video_to_4d   -> run the pipeline
       body: {"input": <path>, "output_dir": <path>, "seed": 44,
              "stage_0_steps"/"stage_1_steps"/"guidance_scales"/
              "face_decimation"/"floaters_threshold"/"anchor_idx": optional,
              "max_frames": 31, "save_animated_glb": true, "render": false}

A request writes ``mesh_XX.glb`` per frame, ``deformations_{vertices,
faces}.npy``, ``animated_mesh.glb`` and, with ``render``, the preview into
its ``output_dir``. A malformed body or input (``ValueError``,
``FileNotFoundError``) is answered 400, an unknown path 404, any other
failure 500; the server keeps serving after each, with the lock released.
``--prewarm`` runs the pipeline once on a frames directory before the
server answers, so the CUDA kernels and the native library are built and
the first request is warm.
"""

from __future__ import annotations

import argparse
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from actionmesh_tpu_torch.io.animated_glb import create_animated_glb_native
from actionmesh_tpu_torch.io.mesh_io import save_deformation, save_meshes
from actionmesh_tpu_torch.io.video_input import load_frames

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


class ActionMeshServer:
    """Holds the resident pipeline and serialises device access."""

    def __init__(self, pipeline):
        self.pipeline = pipeline
        self.lock = threading.Lock()
        self.requests_served = 0
        self.prewarm_seconds: Optional[float] = None

    def health(self) -> dict:
        backend = self.pipeline.device.type
        return {
            "status": "ok",
            "backend": backend,
            "n_devices": torch.cuda.device_count() if backend == "cuda" else 1,
            "sharded": False,
            "requests": self.requests_served,
        }

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
            meshes = self.pipeline(inp, seed=seed, **overrides)
            self.requests_served += 1
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
            "artifacts": artifacts,
        }


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


def build_server(argv: Optional[list[str]] = None) -> tuple[ThreadingHTTPServer, ActionMeshServer]:
    """Parse ``argv`` (the command line if None), build the pipeline, run
    ``--prewarm`` and bind the HTTP server (``--port 0``: any free port,
    ``httpd.server_address`` says which); the caller runs ``serve_forever``."""
    from actionmesh_tpu_torch.pipeline import ActionMeshPipeline

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available (use --device cpu)")
    pipe = ActionMeshPipeline(
        config_name=args.config, weights_dir=args.weights_dir, device=device, dtype=DTYPES[args.dtype]
    )
    server = ActionMeshServer(pipe)
    if args.prewarm:
        logger.info("Prewarming on %s ...", args.prewarm)
        t0 = time.perf_counter()
        pipe(load_frames(args.prewarm, max_frames=16), seed=0)
        server.prewarm_seconds = time.perf_counter() - t0
        logger.info("Prewarm done in %.1f s", server.prewarm_seconds)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server))
    return httpd, server


def main(argv: Optional[list[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO)
    httpd, _ = build_server(argv)
    host, port = httpd.server_address[:2]
    logger.info("Serving on http://%s:%d", host, port)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
