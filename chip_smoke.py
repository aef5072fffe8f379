"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: requires CUDA; prints the card (nvidia-smi name, power limit)
     and the toolchain versions;
  2. build: compiles kernel A (csrc/flash_fwd.cu) with nvcc from this
     checkout; Triton compiles kernel B at its first launch;
  3. kernels vs their plain PyTorch versions on the card, at the main
     path's shapes: max abs error against the stated tolerance, and
     CUDA-event times (median of warm runs) of both;
  4. small reference: the slice at a small fp32 width on the card and on
     the CPU (plain versions) with the same weights agree;
  5. the slice: ActionMeshPipeline at the full widths of the default preset
     (random weights from seed 0, 2 Stage-I steps) on 16 synthetic RGBA
     frames; checks the meshes and that the launch counters equal what the
     path implies.
The line before the last is a JSON object with the per-kernel results; the
last line is the device JSON.
"""

from __future__ import annotations

import json
import logging
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from actionmesh_tpu_torch.io.video_input import ActionMeshInput
from actionmesh_tpu_torch.models.dinov2 import DinoV2Config
from actionmesh_tpu_torch.models.image_encoder import ImageEncoder
from actionmesh_tpu_torch.models.stage0 import make_uv_sphere
from actionmesh_tpu_torch.ops.attention import chunked_attention
from actionmesh_tpu_torch.ops.chunking import chunk_from
from actionmesh_tpu_torch.ops.flash_attention import flash_attention
from actionmesh_tpu_torch.ops.rope_norm import fused_rms_rope, rms_rope_reference
from actionmesh_tpu_torch.ops.rotary import compute_rotary_embeddings
from actionmesh_tpu_torch.pipeline import ActionMeshPipeline
from actionmesh_tpu_torch.preprocessing.mesh import MeshPostprocessor
from actionmesh_tpu_torch.utils import cuda_build

STAGE1_STEPS = 2
N_FRAMES = 16


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi.splitlines()[0])
    nvcc = subprocess.run(
        [cuda_build.find_nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    import triton

    log(
        f"python {sys.version.split()[0]} | torch {torch.__version__} | "
        f"cuda {torch.version.cuda} | triton {triton.__version__} | nvcc {nvcc}"
    )
    log(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return {"nvidia_smi": smi}


def phase_build() -> float:
    t0 = time.perf_counter()
    from actionmesh_tpu_torch.ops.flash_attention import _library

    _library()
    seconds = time.perf_counter() - t0
    log(f"build: flash_fwd.cu compiled with nvcc and loaded in {seconds:.1f} s")
    return seconds


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``reps`` warm runs, in ms."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def heads_view(gen, B, S, H, D, dtype):
    """(B, H, S, D) view of a (B, S, H*D) tensor, the layout the path gives."""
    x = torch.randn((B, S, H * D), generator=gen, device="cuda", dtype=torch.float32)
    return x.to(dtype).view(B, S, H, D).transpose(1, 2)


# Main-path shapes: 16 frames x 2049 tokens = 32,784; Stage II decodes 5
# targets per chunk; DINOv2-L has 257 tokens, head dim 64; V is the anchor
# mesh's vertex count.
def flash_cases(n_vertices: int):
    bf, f32 = torch.bfloat16, torch.float32
    return [
        # name, (B, H, Sq, Sk, D), dtype, replaces
        ("stage1_self", (2, 16, 32784, 32784, 128), bf, "actionmesh_tpu/ops/flash_attention.py:302"),
        ("stage1_cross", (16, 16, 2049, 257, 128), bf, "actionmesh_tpu/ops/flash_attention.py:612"),
        ("dinov2_self", (16, 16, 257, 257, 64), bf, "actionmesh_tpu/ops/flash_attention.py:612"),
        ("stage2_self", (5, 8, 32784, 32784, 128), bf, "actionmesh_tpu/ops/flash_attention.py:302"),
        ("stage2_vertex_cross", (5, 8, n_vertices, 32784, 128), f32, "actionmesh_tpu/ops/flash_attention.py:302"),
    ]


def check_flash(gen, name, shape, dtype, reps=3) -> dict:
    B, H, Sq, Sk, D = shape
    q = heads_view(gen, B, Sq, H, D, dtype)
    k = heads_view(gen, B, Sk, H, D, dtype)
    v = heads_view(gen, B, Sk, H, D, dtype)
    out = flash_attention(q, k, v)
    ref = chunked_attention(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    # bf16: one bf16 rounding of P and of the output, in another order
    tol = (2e-2 if dtype == torch.bfloat16 else 1e-4) * scale
    ms = cuda_ms(lambda: flash_attention(q, k, v), reps)
    plain_ms = cuda_ms(lambda: chunked_attention(q, k, v), reps)
    tflops = 4 * B * H * Sq * Sk * D / (ms * 1e-3) / 1e12
    log(f"flash {name} q{(B, H, Sq, D)} k{(B, H, Sk, D)} {str(dtype)[6:]}: "
        f"max_abs_err {err:.3e} (tol {tol:.3e}) | kernel {ms:.3f} ms "
        f"({tflops:.1f} TFLOP/s) | plain {plain_ms:.3f} ms")
    if not err <= tol:
        raise AssertionError(f"flash {name}: max abs err {err} > {tol}")
    return {"name": name, "shape": [B, H, Sq, Sk, D], "dtype": str(dtype)[6:],
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "tflops": tflops}


def check_rms_rope(gen, name, shape, norm, tables, reps=5) -> dict:
    B, H, S, D = shape
    x = heads_view(gen, B, S, H, D, torch.bfloat16)
    scale = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")) if norm else None
    cos = sin = None
    if tables is not None:  # number of table batches; 0 = one (S, D) table
        pos = torch.rand((max(tables, 1), S // 2049 + 1), generator=gen, device="cuda") * 15
        pos = pos.repeat_interleave(2049, dim=1)[:, :S]
        cs = [compute_rotary_embeddings(D, p) for p in pos]
        cos = torch.stack([c for c, _ in cs]).contiguous()
        sin = torch.stack([s for _, s in cs]).contiguous()
        if tables == 0:
            cos, sin = cos[0], sin[0]
    out = fused_rms_rope(x, scale, cos, sin)
    ref = rms_rope_reference(x, scale, cos, sin)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    # One bf16 ulp of the output, plus fp32 rounding at the tensor's scale:
    # x*cos - rot*sin cancels, so a small output carries the fp32 error of
    # its large terms, which fused multiply-adds round differently.
    ulp = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(1e-30))) - 7)
    tol = ulp + 2.0**-20 * ref.float().abs().max()
    bad = int((diff > tol).sum())
    n_ulp = int((diff > ulp).sum())
    err = diff.max().item()
    ms = cuda_ms(lambda: fused_rms_rope(x, scale, cos, sin), reps)
    plain_ms = cuda_ms(lambda: rms_rope_reference(x, scale, cos, sin), reps)
    gbs = 2 * x.numel() * 2 / (ms * 1e-3) / 1e9
    log(f"rms_rope {name} {shape} bf16 norm={norm} tables={tables}: max_abs_err "
        f"{err:.3e}, {n_ulp} elements above 1 bf16 ulp, {bad} above the "
        f"tolerance | kernel {ms:.3f} ms "
        f"({gbs:.0f} GB/s of x in+out) | plain {plain_ms:.3f} ms")
    if bad:
        raise AssertionError(f"rms_rope {name}: {bad} elements above the tolerance")
    return {"name": name, "shape": list(shape), "max_abs_err": err,
            "tol": "1 bf16 ulp + 2^-20 max|ref|", "above_1_ulp": n_ulp,
            "ms": ms, "plain_ms": plain_ms}


def phase_kernels() -> tuple[list, list]:
    # Stage II's vertex cross-attention has one query per anchor-mesh vertex
    n_vertices = MeshPostprocessor().process_mesh(make_uv_sphere()).n_vertices
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flash = [check_flash(gen, n, s, d) for n, s, d, _ in flash_cases(n_vertices)]
    for row, (_, _, _, rep) in zip(flash, flash_cases(n_vertices)):
        row["replaces"] = rep
    rope = [
        check_rms_rope(gen, "stage1_self_qk", (2, 16, 32784, 128), True, 2),
        check_rms_rope(gen, "stage1_cross_q", (16, 16, 2049, 128), True, None),
        check_rms_rope(gen, "stage1_cross_k", (16, 16, 257, 128), True, None),
        check_rms_rope(gen, "stage2_self_qk", (5, 8, 32784, 128), False, 0),
    ]
    return flash, rope


# A small configuration with head dim 64, so every kernel runs on it.
SMALL_UPDATES = {
    "temporal_3D_denoiser.num_tokens_nominal": 32,
    "temporal_3D_denoiser.width": 128,
    "temporal_3D_denoiser.num_layers": 3,
    "temporal_3D_denoiser.num_attention_heads": 2,
    "temporal_3D_denoiser.in_channels": 8,
    "temporal_3D_denoiser.cross_attention_dim": 128,
    "temporal_3D_denoiser.inflated_layers": [0, 1, 2],
    "temporal_3D_vae.latent_channels": 8,
    "temporal_3D_vae.width": 128,
    "temporal_3D_vae.num_layers": 2,
    "temporal_3D_vae.num_attention_heads": 2,
    "scheduler.num_inference_steps": 2,
}
SMALL_DINO = DinoV2Config(hidden_size=128, num_layers=2, num_heads=2, image_size=70)


def tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def phase_small_reference() -> float:
    """The slice at a small width in fp32, on the card (kernels) and on the
    CPU (plain versions), same weights, seeds and frames: vertices agree."""
    pipes = {}
    for dev in ("cpu", "cuda"):
        pipe = ActionMeshPipeline(
            config_updates=dict(SMALL_UPDATES), device=torch.device(dev), dtype=torch.float32
        )
        pipe.image_encoder = ImageEncoder(torch.device(dev), torch.float32, SMALL_DINO)
        pipes[dev] = pipe
    cpu, gpu = pipes["cpu"], pipes["cuda"]
    gpu.denoiser_params = tree_to(cpu.denoiser_params, "cuda")
    gpu.autoencoder_params = tree_to(cpu.autoencoder_params, "cuda")
    gpu.image_encoder.params = tree_to(cpu.image_encoder.params, "cuda")
    launched = (flash_attention.launches, fused_rms_rope.launches)
    inp = ActionMeshInput(frames=make_frames(), timesteps=np.arange(N_FRAMES, dtype=np.float32))
    ref = np.stack([m.vertices for m in cpu(inp, seed=3)])
    out = np.stack([m.vertices for m in gpu(inp, seed=3)])
    if (flash_attention.launches, fused_rms_rope.launches) == launched:
        raise AssertionError("the small run on the card launched no kernel")
    err = float(np.abs(out - ref).max())
    # fp32 everywhere (no TF32); sums in another order on the card
    log(f"small reference: {out.shape[0]} meshes x {out.shape[1]} vertices, "
        f"card vs CPU max abs err {err:.3e} (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"card and CPU disagree at small width: {err}")
    return err


def make_frames(n: int = N_FRAMES, size: int = 256, seed: int = 0) -> list[np.ndarray]:
    """A textured square moving over a transparent background."""
    rng = np.random.default_rng(seed)
    texture = rng.integers(64, 255, size=(128, 128, 3), dtype=np.uint8)
    frames = []
    for i in range(n):
        rgba = np.zeros((size, size, 4), dtype=np.uint8)
        x = 32 + 4 * i
        rgba[64:192, x : x + 128, :3] = texture
        rgba[64:192, x : x + 128, 3] = 255
        frames.append(rgba)
    return frames


def expected_launches(pipe: ActionMeshPipeline, n_frames: int) -> tuple[int, int]:
    """Kernel launches the main path implies for ``n_frames`` frames.

    DINOv2: one flash per layer. Stage I, per window and step, per block:
    self (q, k rms+rope; flash) and cross (q, k rms; flash; the
    unconditional branch skips it). Stage II, per window and target chunk:
    one flash and two rope-only launches per self block, one flash for the
    vertex cross block.
    """
    cfg = pipe.cfg
    win1 = len(chunk_from(cfg.anchor_idx, n_frames, cfg.temporal_3D_denoiser.temporal_context_size, cfg.sliding_window_denoiser))
    win2 = chunk_from(cfg.anchor_idx, n_frames, cfg.temporal_3D_vae.temporal_context_size, cfg.sliding_window_autoencoder)
    chunks2 = sum(math.ceil((len(w) - 1) / cfg.decode_target_chunk) for w in win2)
    steps = cfg.scheduler.num_inference_steps
    L1, L2 = cfg.temporal_3D_denoiser.num_layers, cfg.temporal_3D_vae.num_layers
    dino = pipe.image_encoder.config.num_layers
    flash = dino + 2 * L1 * steps * win1 + (L2 + 1) * chunks2
    rope = 4 * L1 * steps * win1 + 2 * L2 * chunks2
    return flash, rope


def phase_slice() -> dict:
    t0 = time.perf_counter()
    pipe = ActionMeshPipeline(
        config_name="actionmesh", weights_dir=None, device=torch.device("cuda"), init_seed=0
    )
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frames = make_frames()
    inp = ActionMeshInput(frames=frames, timesteps=np.arange(N_FRAMES, dtype=np.float32))

    flash_attention.launches = 0
    fused_rms_rope.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    meshes = pipe(inp, seed=44, stage_1_steps=STAGE1_STEPS)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {"flash_fwd": flash_attention.launches, "rms_rope": fused_rms_rope.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    want_flash, want_rope = expected_launches(pipe, N_FRAMES)
    log(f"slice: init {init_s:.2f} s | __call__ {total_s:.2f} s | phases "
        + " ".join(f"{k} {v:.2f} s" for k, v in pipe.phase_seconds.items())
        + f" | peak memory {peak_gib:.2f} GiB")
    log(f"slice: launches flash_fwd {launches['flash_fwd']} (expected {want_flash}), "
        f"rms_rope {launches['rms_rope']} (expected {want_rope})")
    if (launches["flash_fwd"], launches["rms_rope"]) != (want_flash, want_rope):
        raise AssertionError(f"launch counts {launches} != ({want_flash}, {want_rope})")

    if len(meshes) != N_FRAMES:
        raise AssertionError(f"{len(meshes)} meshes for {N_FRAMES} frames")
    faces = meshes[0].faces
    verts = np.stack([m.vertices for m in meshes])
    if not all(np.array_equal(m.faces, faces) for m in meshes):
        raise AssertionError("meshes do not share the anchor's faces")
    if not np.isfinite(verts).all() or verts.min() < -1 or verts.max() > 1:
        raise AssertionError("vertices are not finite or leave [-1, 1]")
    motion = float(np.abs(verts[1:] - verts[0]).max())
    if not motion > 0:
        raise AssertionError("no displacement across time")
    log(f"slice: {len(meshes)} meshes, {verts.shape[1]} vertices, {faces.shape[0]} faces, "
        f"max displacement from frame 0 {motion:.4f}")
    return {"launches": launches, "phase_seconds": pipe.phase_seconds,
            "init_seconds": init_s, "call_seconds": total_s, "peak_gib": peak_gib}


def main() -> None:
    logging.basicConfig(level=logging.WARNING)
    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    info = phase_device()
    build_s = phase_build()
    flash, rope = phase_kernels()
    small_err = phase_small_reference()
    sl = phase_slice()

    def summary(name, source, replaces, rows, launches):
        head = rows[0]
        return {"name": name, "route": "cuda" if source.endswith(".cu") else "triton",
                "source": source, "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "shape": head["shape"], "shapes": rows}

    kernels = [
        summary("flash_fwd", "actionmesh_tpu_torch/csrc/flash_fwd.cu",
                "actionmesh_tpu/ops/flash_attention.py:302", flash,
                sl["launches"]["flash_fwd"]),
        summary("fused_rms_rope", "actionmesh_tpu_torch/ops/rope_norm.py",
                "actionmesh_tpu/ops/rope_norm.py:94", rope,
                sl["launches"]["rms_rope"]),
    ]
    kernels[0]["also_replaces"] = "actionmesh_tpu/ops/flash_attention.py:612"
    print(json.dumps({"kernels": kernels, "build_seconds": build_s,
                      "small_reference_max_abs_err": small_err,
                      "slice": sl, "card": info["nvidia_smi"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
