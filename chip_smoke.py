"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: requires CUDA; prints the card (nvidia-smi name, power limit)
     and the toolchain versions (nvcc, g++);
  2. build: compiles kernels A and F (csrc/flash_fwd.cu), C and D
     (csrc/flash_bwd.cu) and E (csrc/nn_argmin.cu) with nvcc, one process
     per source, and the native geometry library
     (native/actionmesh_native.cpp) with g++, all in parallel, from this
     checkout, and prints each CUDA kernel's registers and spills as
     ptxas reports them (kernel A's fp32 kernel and its split pre-pass
     must spill nothing); Triton compiles kernel B at its first launch;
  3. the inference slice: ActionMeshPipeline at the full widths of the
     default preset (random weights from seed 0) on 16 synthetic RGBA
     frames, Stage 0 the real TripoSG path (DevTripoSG: DINOv2, 100 DiT
     steps with CFG 7.5, SDF decode with prefilter 6 / dense 8 / fine 9,
     marching cubes, QEM decimation to 40,000 faces), Stage I cut to 2
     steps; checks the anchor mesh, the meshes, and that the launch
     counters equal what the path implies; then one 2^18-point chunk of
     its fine SDF pass (the slice's weights and decoded latent set) through
     kernel A's fp32 path and through chunked_attention: no sign flip above
     1e-5 of the largest |value|;
  4. kernels vs their plain PyTorch versions on the card, at the main
     paths' shapes (Stage 0's included): max abs error against the stated
     tolerance, and CUDA-event times (median of warm runs, each as many
     back-to-back calls as last about 1 ms) of the kernel,
     the plain version and, where one PyTorch call computes the same
     function, that call (``library_ms``; the port never calls it); kernel
     A also with a kv_mask (ragged Sk, one batch entry with every key
     masked), with its stats (m, l) held against the plain version's, and
     at D = 64 with ragged Sq and Sk. fp32 rows (3xTF32: fp32 accuracy on
     TF32 tensor cores) are held within 2e-5 of the output's largest
     magnitude with their stats, and give their distance from the plain
     model of the split arithmetic
     (``split_precision_attention_reference``), SDPA's distance from the
     plain version and the kernels SDPA launches (torch.profiler, one
     session for both fp32 shapes); the split pre-pass's workspaces must
     equal ``split_kv_reference`` bit for bit;
  5. kernel F (qk-norm + interleaved RoPE pre-pass, then kernel A's
     mainloop; on no path) against its plain version at the Stage-I self
     shape, a ragged fp32 and a D = 64 shape, timed beside
     scaled_dot_product_attention on q and k normalised and rotated
     beforehand, and at the Stage-I shape beside the unfused composition
     (kernel B twice, then kernel A);
  6. the backward kernels C and D at the Stage-I training shapes (on
     kernel A's stats), timed beside SDPA's forward + backward and SDPA's
     backward alone (over one retained forward), at a small fp32, a D = 64
     and two ragged bf16 shapes (a one-row last query tile, a one-key last
     key tile), two calls bit-equal at the Stage-I cross and a small shape;
     and kernel B's backward;
  7. kernel E at the evaluator's shape and small shapes;
  8. small references: the inference slice (Stage-0 stub) and a small
     TripoSG Stage 0 (DiT 3 x 128, VAE decoder 2 x 128, dense 5 / fine 6 /
     prefilter 4), each in fp32 on the card and on the CPU (plain
     versions) with the same weights and noise, agree (Stage 0: equal
     faces and no fine-lattice sign flip);
  9. small train reference: 3 fp32 train steps of a small denoiser on the
     card and on the CPU, same weights, batches and draws, agree;
 10. the training slice: ``python -m actionmesh_tpu_torch.train``'s code path
     at the production DenoiserConfig (window 16, batch 2, bf16 compute,
     EMA, remat, 3 steps on synthetic clips of production size); checks a
     finite loss, moved params, a checkpoint that restores, and launch
     counts equal to what the path implies;
 11. small ICP reference: gradient ICP (2 problems x 24 inits, 512 points,
     50 steps) on the card (kernel E) and on the CPU (plain version) agree;
 12. the ActionBench slice: the synthetic suite (16 frames, 50,000 tracked
     GT points, one sample per class) through
     ``python -m actionmesh_tpu_torch.actionbench.evaluate_dataset``'s code
     path at the evaluator's defaults (10,000 ICP points, 100,000 chamfer
     points, 200 Adam steps with per-step correspondences, 24 inits per
     frame); checks 4 successes, the metric-stack sanity checks, 400
     kernel-E launches per sample, and a resumed call that launches none.
Each kernel's ``bound_ms`` is the least time the card could take for the
work of its main-path call: the larger of its bytes (inputs read once,
outputs written once) at 3.35 TB/s and its operations at the peak rate of
their type, counted from this run's shapes: 989 TFLOP/s for bf16 products;
495 / 3 TFLOP/s for fp32 products (kernel A's and F's fp32 rows, C and D's
fp32 row), since an fp32-accurate product on the tensor cores is three
TF32 products at the data sheet's 495 TFLOP/s; 67 TFLOP/s, the non-tensor
fp32 rate, for kernels B and E, which are no matrix products. Rows of
kernels A and F also give ``tflops`` (the products' 4*B*H*Sq*Sk*D
operations per second), ``bound_share`` (bound_ms / ms) and
``vs_library`` (ms / library_ms).
The line before the last is a JSON object with the per-kernel results; the
last line is the device JSON.
"""

from __future__ import annotations

import json
import logging
import math
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from actionmesh_tpu_torch.actionbench import evaluate_dataset as ab_eval
from actionmesh_tpu_torch.actionbench import synthetic as ab_synth
from actionmesh_tpu_torch.actionbench.icp import gradient_icp_multi
from actionmesh_tpu_torch.io.video_input import ActionMeshInput
from actionmesh_tpu_torch.models.dinov2 import DinoV2Config
from actionmesh_tpu_torch import train as train_entry
from actionmesh_tpu_torch.models.denoiser import DenoiserConfig, init_denoiser
from actionmesh_tpu_torch.models.image_encoder import ImageEncoder
from actionmesh_tpu_torch.models.stage0 import DevTripoSG
from actionmesh_tpu_torch.ops.attention import (
    attention_bwd_reference,
    bwd_row_stats,
    chunked_attention,
    dot_product_attention,
)
from actionmesh_tpu_torch.ops.chunking import chunk_from
from actionmesh_tpu_torch.models import layers as model_layers
from actionmesh_tpu_torch.models.triposg import pipeline as triposg_pipeline
from actionmesh_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_fused,
    flash_attention_fused_reference,
    launch_bwd_kernels,
    norm_rope_interleaved,
    split_kv_reference,
    split_precision_attention_reference,
    tf32_split_kv,
)
from actionmesh_tpu_torch.ops.nn_argmin import nn_argmin, nn_argmin_reference
from actionmesh_tpu_torch.ops.rope_norm import fused_rms_rope, rms_rope_reference
from actionmesh_tpu_torch.models.stage0 import _dev_sdf_regularizer, _dev_sdf_regularizer_torch
from actionmesh_tpu_torch.models.triposg.dit import triposg_dit_config
from actionmesh_tpu_torch.models.triposg.pipeline import TripoSGPipeline
from actionmesh_tpu_torch.models.triposg.vae import (
    QUERY_CHUNK,
    TripoSGVAEConfig,
    decode_kv,
    query_sdf_at_ids,
)
from actionmesh_tpu_torch.ops.rotary import compute_rotary_embeddings
from actionmesh_tpu_torch.pipeline import ActionMeshPipeline
from actionmesh_tpu_torch.training.checkpoint import restore_train_state
from actionmesh_tpu_torch.training.flow_train import init_train_state, make_train_step
from actionmesh_tpu_torch.training.loop import TrainLoopConfig, make_optimizer, step_generator
from actionmesh_tpu_torch.utils import cuda_build, native
from actionmesh_tpu_torch.utils.tree import leaves, named_leaves, tree_map

STAGE1_STEPS = 2
N_FRAMES = 16
TRAIN_STEPS = 3
OUT_DIR = Path(__file__).resolve().parent / "outputs" / "chip_smoke"  # git-ignored; removed at the end


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
    gxx = subprocess.run(
        [native.find_cxx(), "--version"], capture_output=True, text=True, check=True
    ).stdout.splitlines()[0]
    log(f"g++: {gxx}")
    log(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return {"nvidia_smi": smi, "gxx": gxx}


def phase_build() -> dict:
    """nvcc for every CUDA source and g++ for the native library, all at once."""
    from actionmesh_tpu_torch.ops.flash_attention import _bwd_library, _library
    from actionmesh_tpu_torch.ops.nn_argmin import _library as _nn_library

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        native_job = pool.submit(timed, native.build)
        nvcc_s = timed(cuda_build.build)  # one nvcc per source, in parallel
        gxx_s = native_job.result()
    _library()
    _bwd_library()
    _nn_library()
    native._load()
    seconds = time.perf_counter() - t0
    log(f"build: {', '.join(f'{n}.cu' for n in cuda_build.SOURCES)} compiled with nvcc in "
        f"{nvcc_s:.1f} s, native/actionmesh_native.cpp with g++ in {gxx_s:.1f} s, in parallel; "
        f"all loaded in {seconds:.1f} s")
    ptxas = {name: cuda_build.ptxas_report(cuda_build.ptxas_output.get(name, ""))
             for name in cuda_build.SOURCES}
    for name, rows in ptxas.items():
        log(f"ptxas {name}.cu: " + "; ".join(
            f"{r['kernel']} {r['registers']} registers, spills {r['spill_store_bytes']} B stored / "
            f"{r['spill_load_bytes']} B loaded" for r in rows))
    # kernel A's fp32 path and its pre-pass must not spill (a library built
    # by an earlier run in this checkout leaves no report to read)
    fp32_path = [r for r in ptxas["flash_fwd"]
                 if r["kernel"].startswith(("flash_fwd_tf32x3_kernel", "split_kv_kernel"))]
    if "flash_fwd" not in cuda_build.ptxas_output:
        log("ptxas: flash_fwd.cu was built before this run; no report to check")
    elif len(fp32_path) != 4 or any(r["spill_store_bytes"] or r["spill_load_bytes"] for r in fp32_path):
        raise AssertionError(f"kernel A's fp32 path: ptxas reports {fp32_path}")
    return {"seconds": seconds, "nvcc_seconds": nvcc_s, "gxx_seconds": gxx_s, "ptxas": ptxas}


# Peak rates of one H100 SXM (NVIDIA's data sheet, dense), for the bounds.
# An fp32-accurate product on the tensor cores takes three TF32 products
# (3xTF32), so fp32 attention and its backward are priced at TF32 / 3; fp32
# work that is no matrix product (kernels B, E) at the non-tensor rate.
BF16_FLOPS, TF32_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S = 989e12, 495e12, 67e12, 3.35e12
FP32_PRODUCT_FLOPS = TF32_FLOPS / 3


def product_rate(dtype) -> float:
    """The peak rate of matrix products of ``dtype`` (fp32: 3xTF32)."""
    return BF16_FLOPS if dtype == torch.bfloat16 else FP32_PRODUCT_FLOPS


def bound(flop: float, flop_rate: float, nbytes: float) -> dict:
    """The least time for the work: the larger of its operations at the
    peak rate of their type and its bytes at the memory rate, in ms."""
    t_ops, t_bytes = flop / flop_rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def library_time(fn, reps: int, what: str):
    """CUDA-event time of one PyTorch library call computing the same
    function (a yardstick only), or None where PyTorch has no backend for
    these inputs."""
    try:
        return cuda_ms(fn, reps)
    except RuntimeError as e:  # e.g. no SDPA backend for these shapes
        log(f"library call for {what} not timed: {str(e).splitlines()[0]}")
        return None


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time per call of ``reps`` warm runs, in ms. A run
    is as many back-to-back calls as last about 1 ms (one for a call of 1 ms
    or more), so that a short kernel's time is not the host time of one
    call's wrapper."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    calls = max(1, min(1000, int(1.0 / max(start.elapsed_time(end), 1e-3))))
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def heads_view(gen, B, S, H, D, dtype):
    """(B, H, S, D) view of a (B, S, H*D) tensor, the layout the path gives."""
    x = torch.randn((B, S, H * D), generator=gen, device="cuda", dtype=torch.float32)
    return x.to(dtype).view(B, S, H, D).transpose(1, 2)


# Main-path shapes: 16 frames x 2049 tokens = 32,784; Stage II decodes 5
# targets per chunk; DINOv2-L has 257 tokens, head dim 64; V is the anchor
# mesh's vertex count. Stage 0: the DiT over 2049 tokens (2 CFG branches
# self, the conditional one cross), the VAE decoder over 2048 latent tokens,
# and the SDF query of one 2^18-point chunk onto the decoded set, in fp32.
def flash_cases(n_vertices: int):
    bf, f32 = torch.bfloat16, torch.float32
    pipelined, one_block = "actionmesh_tpu/ops/flash_attention.py:302", "actionmesh_tpu/ops/flash_attention.py:612"
    return [
        # name, (B, H, Sq, Sk, D), dtype, replaces
        ("stage1_self", (2, 16, 32784, 32784, 128), bf, pipelined),
        ("stage1_cross", (16, 16, 2049, 257, 128), bf, one_block),
        ("dinov2_self", (16, 16, 257, 257, 64), bf, one_block),
        ("stage2_self", (5, 8, 32784, 32784, 128), bf, pipelined),
        ("stage2_vertex_cross", (5, 8, n_vertices, 32784, 128), f32, pipelined),
        ("stage0_dit_self", (2, 16, 2049, 2049, 128), bf, one_block),
        ("stage0_dit_cross", (1, 16, 2049, 257, 128), bf, one_block),
        ("stage0_vae_self", (1, 8, 2048, 2048, 128), bf, one_block),
        ("stage0_sdf_query", (1, 8, 1 << 18, 2048, 128), f32, one_block),
    ]


def attention_bound(B, H, Sq, Sk, D, dtype, extra_bytes=0) -> dict:
    """QK^T and PV: 4*B*H*Sq*Sk*D operations; q, k, v read, o written once
    (plus ``extra_bytes`` of other inputs)."""
    size = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * H * Sq * D + 2 * B * H * Sk * D) * size + extra_bytes
    return bound(4 * B * H * Sq * Sk * D, product_rate(dtype), nbytes)


def attention_rates(B, H, Sq, Sk, D, ms, bound_ms, library_ms) -> dict:
    """The products' rate, the share of the bound reached, and the time
    against the library call's."""
    return {"tflops": 4 * B * H * Sq * Sk * D / (ms * 1e-3) / 1e12, "bound_share": bound_ms / ms,
            "vs_library": ms / library_ms if library_ms else None}


def sdpa(q, k, v, attn_mask=None):
    return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)


# fp32 attention is held within 2e-5 of its output's largest magnitude: the
# split products lose ~2^-21 of each product and the sums round in another
# order, ~1e-6 of the output's range, where plain TF32 (10 mantissa bits)
# would be ~1e-3 off.
F32_ATTN_TOL = 2e-5


def library_kernels(calls: dict) -> dict:
    """Names of the device kernels that each call of ``calls`` (name ->
    function) launches, from one torch.profiler session: in this script's
    process a session after the first recorded no device kernel, so every
    call shares one. A call's kernels are those whose midpoint lies inside its
    ``record_function`` range, which a synchronisation closes."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, fn in calls.items():
            with record_function(name):
                fn()
                torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    # the device list holds the ranges' own annotations too: not kernels
    device = [e for e in events if e.device_type == cuda and e.name not in calls]
    names = {}
    for name in calls:
        rng = next(e.time_range for e in events if e.name == name and e.device_type != cuda)
        names[name] = sorted({e.name for e in device
                              if rng.start <= (e.time_range.start + e.time_range.end) / 2 <= rng.end})
    return names


def sdpa_fp32_kernels(n_vertices: int) -> dict:
    """The kernels SDPA launches at the fp32 main-path shapes (random
    inputs of those shapes), by case name."""
    gen = torch.Generator(device="cuda").manual_seed(4242)
    calls = {}
    for name, (B, H, Sq, Sk, D), dtype, _ in flash_cases(n_vertices):
        if dtype == torch.float32:
            q, k, v = (heads_view(gen, B, S, H, D, dtype) for S in (Sq, Sk, Sk))
            calls[name] = lambda q=q, k=k, v=v: sdpa(q, k, v)
    names = library_kernels(calls)
    for name, kernels in names.items():
        log(f"sdpa fp32 {name}: launches {kernels}")
    return names


def check_flash(gen, name, shape, dtype, reps=3, masked=False, stats=False,
                library_kernel_names=None) -> dict:
    """Kernel A against ``chunked_attention`` on the same inputs. ``masked``:
    a kv_mask with about a third of the keys masked at random and every key
    of the last batch entry masked; ``stats``: the (m, l) of both too (every
    fp32 row checks them). fp32 rows also give the kernel's distance from
    the plain model of its split arithmetic and SDPA's distance from the
    plain version, carry ``library_kernel_names`` (the kernels SDPA
    launches) and hold the split pre-pass's workspaces bit-equal to
    ``split_kv_reference``."""
    B, H, Sq, Sk, D = shape
    q = heads_view(gen, B, Sq, H, D, dtype)
    k = heads_view(gen, B, Sk, H, D, dtype)
    v = heads_view(gen, B, Sk, H, D, dtype)
    kv_mask = None
    if masked:
        kv_mask = torch.rand((B, Sk), generator=gen, device="cuda") > 0.3
        kv_mask[-1] = False
    f32 = dtype == torch.float32
    with_stats = stats or f32
    out = flash_attention(q, k, v, kv_mask=kv_mask, return_stats=with_stats)
    ref = chunked_attention(q, k, v, kv_mask=kv_mask, return_stats=with_stats)
    torch.cuda.synchronize()
    stats_err = None
    if with_stats:
        (out, (m, l)), (ref, (m_ref, l_ref)) = out, ref
        # fp32 dot products summed in another order: m moves by ~1e-6 of the
        # largest score, and l by the same relative amount
        stats_err = {"m": (m - m_ref).abs().max().item(),
                     "l_rel": ((l - l_ref).abs() / l_ref).max().item()}
        stats_tol = {"m": 1e-4 * max(1.0, m_ref.abs().max().item()), "l_rel": 1e-4}
        del m, l, m_ref, l_ref
    err = (out.float() - ref.float()).abs().max().item()
    finite = bool(torch.isfinite(out).all())
    scale = ref.float().abs().max().item()
    mask4 = None if kv_mask is None else kv_mask[:, None, None, :]
    f32_extra = {}
    if f32:
        model = split_precision_attention_reference(q, k, v, kv_mask=kv_mask)
        f32_extra["model_max_abs_diff"] = (out - model).abs().max().item()
        del model
        lib = sdpa(q, k, v, mask4)
        f32_extra["library_max_abs_diff"] = (lib - ref).abs().max().item()
        del lib
        f32_extra["library_kernels"] = library_kernel_names
        got, want = tf32_split_kv(k, v), split_kv_reference(k, v)
        f32_extra["prepass_bit_equal"] = all(torch.equal(a, b) for a, b in zip(got, want))
        del got, want
    del out, ref
    # bf16: one bf16 rounding of P and of the output, in another order
    tol = (2e-2 if dtype == torch.bfloat16 else F32_ATTN_TOL) * scale
    ms = cuda_ms(lambda: flash_attention(q, k, v, kv_mask=kv_mask, return_stats=stats), reps)
    plain_ms = cuda_ms(lambda: chunked_attention(q, k, v, kv_mask=kv_mask, return_stats=stats), reps)
    # SDPA gives no (m, l): no library call for the stats row
    library_ms = None if stats else library_time(lambda: sdpa(q, k, v, mask4), reps, f"flash {name}")
    bnd = attention_bound(B, H, Sq, Sk, D, dtype, 0 if kv_mask is None else B * Sk * 4)
    rates = attention_rates(B, H, Sq, Sk, D, ms, bnd["bound_ms"], library_ms)
    log(f"flash {name} q{(B, H, Sq, D)} k{(B, H, Sk, D)} {str(dtype)[6:]}"
        + (" kv_mask" if masked else "") + (" stats" if stats else "")
        + f": max_abs_err {err:.3e} (tol {tol:.3e})"
        + (f", stats {stats_err} (tol {stats_tol})" if with_stats else "")
        + (f", from the split model {f32_extra['model_max_abs_diff']:.3e}, sdpa from the plain "
           f"version {f32_extra['library_max_abs_diff']:.3e}, pre-pass bit-equal "
           f"{f32_extra['prepass_bit_equal']}" if f32 else "")
        + f" | kernel {ms:.3f} ms ({rates['tflops']:.1f} TFLOP/s, {100 * rates['bound_share']:.1f}% "
        f"of the bound) | plain {plain_ms:.3f} ms | sdpa {library_ms} ms | "
        f"bound {bnd['bound_ms']:.3f} ms ({bnd['bound_by']})")
    if not (err <= tol and finite):
        raise AssertionError(f"flash {name}: max abs err {err} > {tol} or not finite ({finite})")
    if with_stats and not all(stats_err[n] <= stats_tol[n] for n in stats_err):
        raise AssertionError(f"flash {name}: stats {stats_err} above {stats_tol}")
    if f32 and not f32_extra["prepass_bit_equal"]:
        raise AssertionError(f"flash {name}: the split pre-pass differs from split_kv_reference")
    row = {"name": name, "shape": [B, H, Sq, Sk, D], "dtype": str(dtype)[6:],
           "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, **bnd, **rates, **f32_extra}
    if with_stats:
        row.update(stats_err=stats_err, stats_tol=stats_tol)
    return row


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
    # Without tables the function is rms-norm times the scale, which one
    # PyTorch call computes (bf16 x, fp32 scale: its composite path, which
    # upcasts as the kernel does); no single call also rotates.
    library_ms = lib_err = None
    if norm and tables is None:
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Mismatch dtype between input and weight")
            lib_out = torch.nn.functional.rms_norm(x, (D,), scale, eps=1e-6)
            lib_err = (lib_out.float() - ref.float()).abs().max().item()
            del lib_out
            library_ms = library_time(
                lambda: torch.nn.functional.rms_norm(x, (D,), scale, eps=1e-6), reps,
                f"rms_rope {name}")
    gbs = 2 * x.numel() * 2 / (ms * 1e-3) / 1e9
    # x read and written once (bf16), the scale and tables read once (fp32);
    # about 10 fp32 operations per element
    nbytes = 2 * x.numel() * 2 + sum(t.numel() * 4 for t in (scale, cos, sin) if t is not None)
    bnd = bound(10 * x.numel(), FP32_FLOPS, nbytes)
    log(f"rms_rope {name} {shape} bf16 norm={norm} tables={tables}: max_abs_err "
        f"{err:.3e}, {n_ulp} elements above 1 bf16 ulp, {bad} above the "
        f"tolerance | kernel {ms:.3f} ms "
        f"({gbs:.0f} GB/s of x in+out) | plain {plain_ms:.3f} ms | rms_norm {library_ms} ms "
        f"(max abs diff from the plain version {lib_err}) | bound "
        f"{bnd['bound_ms']:.3f} ms ({bnd['bound_by']})")
    if bad:
        raise AssertionError(f"rms_rope {name}: {bad} elements above the tolerance")
    return {"name": name, "shape": list(shape), "max_abs_err": err,
            "tol": "1 bf16 ulp + 2^-20 max|ref|", "above_1_ulp": n_ulp,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_diff": lib_err, **bnd}


def phase_kernels(n_vertices: int) -> tuple[list, list]:
    """Kernels A and B at the main paths' shapes; ``n_vertices`` is the
    anchor mesh's vertex count (the queries of Stage II's vertex cross)."""
    sdpa_names = sdpa_fp32_kernels(n_vertices)
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flash = []
    for n, s, d, rep in flash_cases(n_vertices):
        flash.append(dict(check_flash(gen, n, s, d, library_kernel_names=sdpa_names.get(n)),
                          replaces=rep))
        torch.cuda.empty_cache()
    # the contract's edges, bf16: a kv_mask over a ragged Sk, the training
    # cross shape with stats, and D = 64 with ragged Sq and Sk
    one_block = "actionmesh_tpu/ops/flash_attention.py:612"
    flash.append(dict(check_flash(gen, "kv_mask", (3, 8, 1000, 1333, 128), torch.bfloat16, masked=True),
                      replaces=one_block))
    flash.append(dict(check_flash(gen, "stats", (32, 16, 2049, 257, 128), torch.bfloat16, stats=True),
                      replaces=one_block))
    flash.append(dict(check_flash(gen, "d64_ragged", (2, 4, 777, 1029, 64), torch.bfloat16),
                      replaces=one_block))
    torch.cuda.empty_cache()
    # first (the kernels line's head): the shape of most of B's launches on
    # the inference path, Stage 0's DiT self-attention q and k
    rope = [
        check_rms_rope(gen, "stage0_dit_self_qk", (2, 16, 2049, 128), True, None),
        check_rms_rope(gen, "stage0_dit_cross_k", (1, 16, 257, 128), True, None),
        check_rms_rope(gen, "stage1_self_qk", (2, 16, 32784, 128), True, 2),
        check_rms_rope(gen, "stage1_cross_q", (16, 16, 2049, 128), True, None),
        check_rms_rope(gen, "stage1_cross_k", (16, 16, 257, 128), True, None),
        check_rms_rope(gen, "stage2_self_qk", (5, 8, 32784, 128), False, 0),
    ]
    return flash, rope


# Kernel F: the Stage-I self shape with interleaved tables from centred
# timesteps (16 frames of 2049 tokens), a ragged small fp32 shape and a
# head-dim-64 shape. One call launches the pre-pass and kernel A's mainloop.
FUSED_CASES = [
    ("stage1_self", (2, 16, 32784, 128), torch.bfloat16),
    ("ragged_f32", (1, 2, 300, 128), torch.float32),
    ("d64", (2, 4, 777, 64), torch.bfloat16),
]


def check_fused(gen, name, shape, dtype, reps=3, compare=False) -> dict:
    """Kernel F against its plain version, timed beside SDPA on q and k
    normalised and rotated beforehand (the plain pre-pass); with
    ``compare`` also beside the unfused composition (kernel B on q and on k
    with half-layout tables, then kernel A)."""
    B, H, S, D = shape
    q, k, v = (heads_view(gen, B, S, H, D, dtype) for _ in range(3))
    # centred timesteps t - t_min of 16 frames, one spacing per batch entry
    frames = -(-S // 2049)
    pos = torch.arange(frames, device="cuda", dtype=torch.float32)[None]
    pos = (pos * (1 + torch.rand((B, 1), generator=gen, device="cuda"))).repeat_interleave(2049, dim=1)[:, :S]
    tables = [compute_rotary_embeddings(D, p, layout="interleaved") for p in pos]
    cos = torch.stack([c for c, _ in tables]).contiguous()
    sin = torch.stack([t for _, t in tables]).contiguous()
    qs = 1 + 0.1 * torch.randn(D, generator=gen, device="cuda")
    ks = 1 + 0.1 * torch.randn(D, generator=gen, device="cuda")
    out = flash_attention_fused(q, k, v, cos, sin, qs, ks)
    ref = flash_attention_fused_reference(q, k, v, cos, sin, qs, ks)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = (2e-2 if dtype == torch.bfloat16 else F32_ATTN_TOL) * ref.float().abs().max().item()
    del out, ref
    ms = cuda_ms(lambda: flash_attention_fused(q, k, v, cos, sin, qs, ks), reps)
    plain_ms = cuda_ms(lambda: flash_attention_fused_reference(q, k, v, cos, sin, qs, ks), reps)
    qn, kn = norm_rope_interleaved(q, qs, cos, sin), norm_rope_interleaved(k, ks, cos, sin)
    library_ms = library_time(lambda: sdpa(qn, kn, v), reps, f"flash_fused {name}")
    del qn, kn
    # the tables and the norm scales are read once too
    bnd = attention_bound(B, H, S, S, D, dtype, (2 * B * S * D + 2 * D) * 4)
    rates = attention_rates(B, H, S, S, D, ms, bnd["bound_ms"], library_ms)
    row = {"name": name, "shape": [B, H, S, D], "dtype": str(dtype)[6:], "max_abs_err": err,
           "tol": tol, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bnd, **rates}
    line = (f"flash_fused {name} {tuple(shape)} {str(dtype)[6:]}: max_abs_err {err:.3e} "
            f"(tol {tol:.3e}) | kernel F {ms:.3f} ms ({rates['tflops']:.1f} TFLOP/s, "
            f"{100 * rates['bound_share']:.1f}% of the bound) | plain {plain_ms:.3f} ms | sdpa on "
            f"q, k normalised and rotated beforehand {library_ms} ms | bound "
            f"{bnd['bound_ms']:.3f} ms ({bnd['bound_by']})")
    if compare:
        half = [compute_rotary_embeddings(D, p, layout="half") for p in pos]
        cos_h = torch.stack([c for c, _ in half]).contiguous()
        sin_h = torch.stack([t for _, t in half]).contiguous()

        def unfused():
            return flash_attention(fused_rms_rope(q, qs, cos_h, sin_h), fused_rms_rope(k, ks, cos_h, sin_h), v)

        row["unfused_b_b_a_ms"] = cuda_ms(unfused, reps)
        line += f" | unfused (B, B, A) {row['unfused_b_b_a_ms']:.3f} ms"
    log(line)
    if not err <= tol:
        raise AssertionError(f"flash_fused {name}: max abs err {err} > {tol}")
    return row


def phase_fused() -> tuple[list, int]:
    gen = torch.Generator(device="cuda").manual_seed(777)
    before = flash_attention_fused.launches
    rows = [check_fused(gen, n, s, d, compare=(i == 0)) for i, (n, s, d) in enumerate(FUSED_CASES)]
    torch.cuda.empty_cache()
    return rows, flash_attention_fused.launches - before


# Stage-I training shapes of kernels C and D: the inflated self-attention
# (2 samples x 16 frames x 2049 tokens) and the per-frame cross-attention
# (32 frames onto 257 DINOv2 tokens), both head dim 128; plus small ragged
# fp32 and D=64 shapes, so every instantiation runs, and the bf16 tiles'
# edges: 129 queries leave one row in the last query tile (64 rows in C,
# 128 in D), 385 keys one key in the last 128-key tile.
BWD_CASES = [
    ("stage1_self", (2, 16, 32784, 32784, 128), torch.bfloat16),
    ("stage1_cross", (32, 16, 2049, 257, 128), torch.bfloat16),
    ("small_f32", (2, 4, 1000, 1100, 128), torch.float32),
    ("small_d64", (2, 4, 777, 1029, 64), torch.bfloat16),
    ("edge_d128", (1, 2, 129, 385, 128), torch.bfloat16),
    ("edge_d64", (1, 2, 129, 385, 64), torch.bfloat16),
]
BWD_DETERMINISM = ("stage1_cross", "small_d64")


def check_flash_bwd(gen, name, shape, dtype, reps=2, with_library=False) -> dict:
    """Kernels C and D against the plain backward (chunked_attention_
    trainable's), from the same q, k, v, o, m, l and dO; for the
    BWD_DETERMINISM shapes a second call must give bit-equal gradients."""
    B, H, Sq, Sk, D = shape
    q, do = heads_view(gen, B, Sq, H, D, dtype), heads_view(gen, B, Sq, H, D, dtype)
    k, v = heads_view(gen, B, Sk, H, D, dtype), heads_view(gen, B, Sk, H, D, dtype)
    o, (m, l) = flash_attention(q, k, v, return_stats=True)
    stats_err = None
    if dtype == torch.float32:
        # kernel A's fp32 stats, which C and D read, against the plain version's
        _, (m_ref, l_ref) = chunked_attention(q, k, v, return_stats=True)
        stats_err = {"m": (m - m_ref).abs().max().item(),
                     "l_rel": ((l - l_ref).abs() / l_ref).max().item()}
        stats_tol = {"m": 1e-4 * max(1.0, m_ref.abs().max().item()), "l_rel": 1e-4}
        del m_ref, l_ref
    got = flash_attention_bwd(q, k, v, o, m, l, do)
    deterministic = None
    if name in BWD_DETERMINISM:
        deterministic = all(torch.equal(a, b) for a, b in zip(got, flash_attention_bwd(q, k, v, o, m, l, do)))
    ref = attention_bwd_reference(q, k, v, o, m, l, do)
    torch.cuda.synchronize()
    # bf16: P and dS rounded to bf16 at other entries than the plain
    # version's (sums in another order), plus one rounding of the result
    rel = 2e-2 if dtype == torch.bfloat16 else 1e-4
    errs, tols = {}, {}
    for n, a, b in zip(("dq", "dk", "dv"), got, ref):
        errs[n] = (a.float() - b.float()).abs().max().item()
        tols[n] = rel * b.float().abs().max().item()
    scale = D ** -0.5
    lse, delta = (x.contiguous() for x in bwd_row_stats(o, m, l, do))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    ms_c = cuda_ms(lambda: launch_bwd_kernels(q, k, v, do, lse, delta, dq, dk, dv, scale, ("dkv",)), reps)
    ms_d = cuda_ms(lambda: launch_bwd_kernels(q, k, v, do, lse, delta, dq, dk, dv, scale, ("dq",)), reps)
    plain_ms = cuda_ms(lambda: attention_bwd_reference(q, k, v, o, m, l, do), reps)

    def sdpa_fwd_bwd():
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        return torch.autograd.grad(sdpa(qg, kg, vg), (qg, kg, vg), do)

    library_ms = library_bwd_ms = None
    if with_library:
        library_ms = library_time(sdpa_fwd_bwd, reps, f"flash_bwd {name}")
        # SDPA's backward alone, over one forward kept for it
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        out = sdpa(qg, kg, vg)
        library_bwd_ms = library_time(
            lambda: torch.autograd.grad(out, (qg, kg, vg), do, retain_graph=True), reps,
            f"flash_bwd {name} (backward alone)")
        del qg, kg, vg, out
    work = B * H * Sq * Sk * D
    tf_c, tf_d = 6 * work / (ms_c * 1e-3) / 1e12, 4 * work / (ms_d * 1e-3) / 1e12
    # The pair's least work is 10*B*H*Sq*Sk*D (S and dP once, then dV, dK,
    # dQ), counted 6 to C and 4 to D; bytes: C reads q, k, v, dO and writes
    # dk, dv, D reads the same and writes dq.
    size, rate = torch.finfo(dtype).bits // 8, product_rate(dtype)
    qb, kb = B * H * Sq * D * size, B * H * Sk * D * size
    bnd_c = bound(6 * work, rate, 2 * qb + 4 * kb)
    bnd_d = bound(4 * work, rate, 3 * qb + 2 * kb)
    log(f"flash_bwd {name} q{(B, H, Sq, D)} k{(B, H, Sk, D)} {str(dtype)[6:]}: max_abs_err "
        + ", ".join(f"{n} {errs[n]:.3e} (tol {tols[n]:.3e})" for n in errs)
        + f" | kernel C {ms_c:.3f} ms ({tf_c:.1f} TFLOP/s, bound {bnd_c['bound_ms']:.3f}), "
        f"kernel D {ms_d:.3f} ms ({tf_d:.1f} TFLOP/s, bound {bnd_d['bound_ms']:.3f}) | plain "
        f"(dq, dk, dv together) {plain_ms:.3f} ms | sdpa forward + backward {library_ms} ms, "
        f"backward alone {library_bwd_ms} ms"
        + ("" if deterministic is None else f" | two calls bit-equal: {deterministic}")
        + ("" if stats_err is None else f" | kernel A's stats {stats_err} (tol {stats_tol})"))
    bad = [n for n in errs if not errs[n] <= tols[n]]
    if bad:
        raise AssertionError(f"flash_bwd {name}: {bad} above tolerance: {errs} vs {tols}")
    if stats_err is not None and not all(stats_err[n] <= stats_tol[n] for n in stats_err):
        raise AssertionError(f"flash_bwd {name}: kernel A's stats {stats_err} above {stats_tol}")
    if deterministic is False:
        raise AssertionError(f"flash_bwd {name}: two calls gave different gradients")
    return {"name": name, "shape": [B, H, Sq, Sk, D], "dtype": str(dtype)[6:],
            "max_abs_err": errs, "tol": tols, "ms_dkv": ms_c, "ms_dq": ms_d,
            "plain_ms": plain_ms, "library_ms": library_ms, "library_bwd_ms": library_bwd_ms,
            "deterministic": deterministic, "forward_stats_err": stats_err, "tflops_dkv": tf_c,
            "tflops_dq": tf_d, "bound_dkv": bnd_c, "bound_dq": bnd_d}


def check_rms_rope_bwd(gen, name, shape, tables, reps=3) -> dict:
    """Kernel B's backward (the autograd.Function: kernel forward, vjp of the
    plain composition) against autograd of the plain composition."""
    B, H, S, D = shape
    x = heads_view(gen, B, S, H, D, torch.bfloat16).detach()
    scale = 1 + 0.1 * torch.randn(D, generator=gen, device="cuda")
    cos = sin = None
    if tables:
        pos = torch.rand((tables, S // 2049 + 1), generator=gen, device="cuda") * 15
        pos = pos.repeat_interleave(2049, dim=1)[:, :S]
        cs = [compute_rotary_embeddings(D, p) for p in pos]
        cos = torch.stack([c for c, _ in cs]).contiguous()
        sin = torch.stack([s for _, s in cs]).contiguous()
    g = heads_view(gen, B, S, H, D, torch.bfloat16)

    def grads(fn):
        xs, ss = x.clone().requires_grad_(), scale.clone().requires_grad_()
        return torch.autograd.grad(fn(xs, ss, cos, sin), (xs, ss), g)

    got, ref = grads(fused_rms_rope), grads(rms_rope_reference)
    torch.cuda.synchronize()
    err_x = (got[0].float() - ref[0].float()).abs().max().item()
    err_s = (got[1] - ref[1]).abs().max().item()
    # the same plain vjp on the same saved inputs: equal up to the sums' order
    tol_x = 2.0**-7 * ref[0].float().abs().max().item()
    tol_s = 1e-4 * ref[1].abs().max().item()
    ms = cuda_ms(lambda: grads(fused_rms_rope), reps)
    plain_ms = cuda_ms(lambda: grads(rms_rope_reference), reps)
    log(f"rms_rope backward {name} {shape}: max_abs_err dx {err_x:.3e} (tol {tol_x:.3e}), "
        f"dscale {err_s:.3e} (tol {tol_s:.3e}) | forward+backward through the kernel "
        f"{ms:.3f} ms | plain {plain_ms:.3f} ms")
    if not (err_x <= tol_x and err_s <= tol_s):
        raise AssertionError(f"rms_rope backward {name}: {err_x}, {err_s}")
    return {"name": name, "shape": list(shape), "max_abs_err": max(err_x, err_s),
            "tol": {"dx": tol_x, "dscale": tol_s}, "ms": ms, "plain_ms": plain_ms}


def phase_backward() -> tuple[list, list]:
    gen = torch.Generator(device="cuda").manual_seed(4321)
    bwd = [check_flash_bwd(gen, n, s, d, with_library=n.startswith("stage1")) for n, s, d in BWD_CASES]
    rope = [
        check_rms_rope_bwd(gen, "stage1_self_qk", (2, 16, 32784, 128), 2),
        check_rms_rope_bwd(gen, "stage1_cross_q", (32, 16, 2049, 128), 0),
    ]
    return bwd, rope


# Kernel E: an index differing from the plain version's is accepted only
# where the float64 squared distances of the two picks agree within
# NN_TIE_REL * (|x|^2 + max |y_pick|^2), the scale of the fp32 terms that
# both sum in their own order (the plain version by a matrix product with
# |x|^2, the kernel by three FMAs without it).
NN_TIE_REL = 1e-6
ICP_POINTS, ICP_INITS, ICP_FRAMES = 10_000, 24, 16


def nn_compare(x, y, got, ref) -> dict:
    """Index mismatches of kernel E against the plain version, judged in float64."""
    diff = got != ref
    r, i = diff.nonzero(as_tuple=True)
    xd = x[r, i].double()
    ya, yb = y[r, got[r, i].long()].double(), y[r, ref[r, i].long()].double()
    da, db = ((xd - ya) ** 2).sum(-1), ((xd - yb) ** 2).sum(-1)
    scale = (xd**2).sum(-1) + torch.maximum((ya**2).sum(-1), (yb**2).sum(-1))
    beyond = int(((da - db).abs() > NN_TIE_REL * scale).sum())
    err = (da - db).abs().max().item() if len(r) else 0.0
    return {"mismatches": len(r), "beyond_tol": beyond, "near_ties": len(r) - beyond,
            "max_abs_err": err}


def check_nn(gen, name, shape, ties=False, reps=3) -> dict:
    """Kernel E against its plain version (with the chunk the ICP gives it at
    16 problems) on the same points, uniform in [-1, 1]^C. ``ties``: y holds
    every point twice, x sits on some of them; the first copy must win."""
    R, N, M, C = shape
    x = torch.rand((R, N, C), generator=gen, device="cuda") * 2 - 1
    y = torch.rand((R, M, C), generator=gen, device="cuda") * 2 - 1
    half = (M + 1) // 2
    if ties:
        y = torch.cat([y[:, :half], y[:, :half]], dim=1)[:, :M]
        x[:, : N // 2] = y[:, : N // 2]
    got = nn_argmin(x, y)
    ref = nn_argmin_reference(x, y, chunk=128)
    torch.cuda.synchronize()
    if got.dtype != torch.int32 or got.shape != (R, N):
        raise AssertionError(f"nn_argmin {name}: {got.dtype} {tuple(got.shape)}")
    cmp = nn_compare(x, y, got, ref)
    if ties and not bool((got < half).all()):
        raise AssertionError(f"nn_argmin {name}: ties not resolved to the smallest index")
    ms = cuda_ms(lambda: nn_argmin(x, y), reps)
    plain_ms = cuda_ms(lambda: nn_argmin_reference(x, y, chunk=128), reps)
    pairs = R * N * M
    # C FMAs per (x, y) pair on the fp32 pipe (2C flop); x, y read, indices written
    bnd = bound(2 * C * pairs, FP32_FLOPS, (R * N * C + R * M * C + R * N) * 4)
    log(f"nn_argmin {name} x{(R, N, C)} y{(R, M, C)}: {cmp['mismatches']} index mismatches, "
        f"{cmp['near_ties']} near-ties (rel {NN_TIE_REL}), {cmp['beyond_tol']} beyond; max abs "
        f"float64 distance diff {cmp['max_abs_err']:.3e} | kernel {ms:.3f} ms "
        f"({pairs / (ms * 1e-3) / 1e9:.0f} G pairs/s) | plain {plain_ms:.3f} ms | bound "
        f"{bnd['bound_ms']:.3f} ms ({bnd['bound_by']})")
    if cmp["beyond_tol"]:
        raise AssertionError(f"nn_argmin {name}: {cmp['beyond_tol']} mismatches beyond the tolerance")
    return {"name": name, "shape": list(shape), **cmp, "tol": f"rel {NN_TIE_REL} of |x|^2 + |y|^2",
            "ms": ms, "plain_ms": plain_ms, "library_ms": None, **bnd,
            "gpairs_per_s": pairs / (ms * 1e-3) / 1e9}


def phase_nn() -> list:
    gen = torch.Generator(device="cuda").manual_seed(99)
    return [
        # ICP at the evaluator's defaults: 16 frames x 24 inits, 10,000 points
        check_nn(gen, "icp_eval", (ICP_FRAMES * ICP_INITS, ICP_POINTS, ICP_POINTS, 3)),
        check_nn(gen, "ragged", (3, 1000, 1037, 3)),
        check_nn(gen, "c5", (2, 777, 1500, 5)),
        check_nn(gen, "ties", (4, 3000, 4001, 3), ties=True),
    ]


def phase_small_icp() -> dict:
    """Gradient ICP for 2 problems (512 points, 50 steps, per-step
    correspondences) on the card and on the CPU, same points."""
    rng = np.random.default_rng(8)
    gt = rng.uniform(-1, 1, (2, 512, 3)).astype(np.float32)
    rot = np.array([[0.36, 0.48, -0.8], [-0.8, 0.6, 0.0], [0.48, 0.64, 0.6]])
    pred = (gt @ rot * np.array([1.1, 0.9, 1.0]) + 0.2 + rng.normal(0, 0.01, gt.shape)).astype(np.float32)
    nn_argmin.launches = 0
    card = gradient_icp_multi(pred, gt, n_iter=50, device="cuda")
    launches = nn_argmin.launches
    cpu = gradient_icp_multi(pred, gt, n_iter=50, device="cpu")
    errs = {k: float(np.abs(getattr(card, k) - getattr(cpu, k)).max()) for k in ("R", "T", "s")}
    # The card's and the CPU's distances round differently, so a near-tied
    # correspondence can resolve to the other neighbour and shift the Adam
    # path slightly; 1e-3 bounds that, far below a wrong basin (~1).
    log(f"small ICP reference: card vs CPU max abs err R {errs['R']:.3e}, T {errs['T']:.3e}, "
        f"s {errs['s']:.3e} (tol 1e-3); kernel E launches {launches} (expected 100)")
    if launches != 100 or not all(e <= 1e-3 for e in errs.values()):
        raise AssertionError(f"small ICP: launches {launches}, errors {errs}")
    return {"max_abs_err": errs, "launches": launches}


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


# A small TripoSG Stage 0 with head dim 64: DiT 3 blocks x 128, VAE decoder
# 2 blocks x 128 with 2 heads, 64 latent tokens; dense depth 5, fine 6,
# prefilter 4.
SMALL_STAGE0_DIT = triposg_dit_config(
    num_tokens=64, in_channels=16, num_layers=3, width=128, num_attention_heads=2,
    cross_attention_dim=128,
)
SMALL_STAGE0_VAE = TripoSGVAEConfig(
    latent_channels=16, num_tokens=64, encoder_width=64, encoder_layers=1, encoder_heads=1,
    decoder_width=128, decoder_layers=2, decoder_heads=2,
)
SMALL_STAGE0_DECODE = dict(dense_octree_depth=5, hierarchical_octree_depth=6, prefilter_octree_depth=4)
SMALL_STAGE0_STEPS = 20


def fine_lattice_signs(pipe: TripoSGPipeline, latents: torch.Tensor) -> np.ndarray:
    """Regularized field values on the whole fine lattice of the small
    decode, through the extraction's fine-pass query."""
    R = (1 << SMALL_STAGE0_DECODE["hierarchical_octree_depth"]) + 1
    idx = np.arange(-(-R**3 // (1 << 18)) * (1 << 18))
    ijk = np.stack([idx // (R * R), (idx // R) % R, idx % R], -1).astype(np.int32)
    kv = decode_kv(pipe.vae_params, pipe.vae_cfg, latents.to(pipe.device))
    return query_sdf_at_ids(
        pipe.vae_params, pipe.vae_cfg, kv, ijk, np.full(3, -1.005), np.full(3, 2.01 / (R - 1)),
        regularizer=_dev_sdf_regularizer_torch,
    )[: R**3]


def phase_small_stage0() -> dict:
    """The small TripoSG Stage 0 in fp32 on the card (kernels A and B) and
    on the CPU (plain versions): same weights, image and noise. Latents
    within 1e-4; meshes with equal faces and vertices within 1e-4; no
    fine-lattice value whose sign differs between the two devices (a flip
    of a near-zero value would change the faces)."""
    cpu_dev, gpu_dev = torch.device("cpu"), torch.device("cuda")
    cpu = TripoSGPipeline.from_random(
        seed=5, dtype=torch.float32, dit_cfg=SMALL_STAGE0_DIT, vae_cfg=SMALL_STAGE0_VAE,
        image_encoder=ImageEncoder(cpu_dev, torch.float32, SMALL_DINO), device=cpu_dev,
    )
    gpu = TripoSGPipeline(
        tree_to(cpu.dit_params, gpu_dev), tree_to(cpu.vae_params, gpu_dev),
        ImageEncoder(gpu_dev, torch.float32, SMALL_DINO, params=tree_to(cpu.image_encoder.params, gpu_dev)),
        dit_cfg=SMALL_STAGE0_DIT, vae_cfg=SMALL_STAGE0_VAE, dtype=torch.float32, device=gpu_dev,
    )
    for pipe in (cpu, gpu):
        pipe.sdf_regularizer = _dev_sdf_regularizer
        pipe.sdf_regularizer_torch = _dev_sdf_regularizer_torch
    image = make_frames(1)[0]
    kw = dict(seed=3, num_inference_steps=SMALL_STAGE0_STEPS, guidance_scale=7.5, **SMALL_STAGE0_DECODE)
    lat_c, mesh_c = cpu(image, **kw)
    reset_counters()
    lat_g, mesh_g = gpu(image, **kw)
    launches = read_counters()
    L = SMALL_STAGE0_DIT.num_layers
    want = {"flash_fwd": SMALL_DINO.num_layers + 2 * L * SMALL_STAGE0_STEPS
            + SMALL_STAGE0_VAE.decoder_layers + sum(gpu.extract_stats.values()),
            "fused_rms_rope": 4 * L * SMALL_STAGE0_STEPS}
    err_lat = (lat_g.cpu() - lat_c).abs().max().item()
    vc, vg = fine_lattice_signs(cpu, lat_c), fine_lattice_signs(gpu, lat_c)
    flips = (vc < 0) != (vg < 0)
    flip_report = {"lattice_values": int(vc.size), "sign_flips": int(flips.sum()),
                   "max_abs_value_flipped": float(np.abs(vc[flips]).max()) if flips.any() else None,
                   "max_abs_value_diff": float(np.abs(vc - vg).max())}
    same_faces = mesh_g.faces.shape == mesh_c.faces.shape and np.array_equal(mesh_g.faces, mesh_c.faces)
    err_v = float(np.abs(mesh_g.vertices - mesh_c.vertices).max()) if same_faces else None
    log(f"small Stage 0 reference: latents card vs CPU max abs err {err_lat:.3e} (tol 1e-4); "
        f"mesh {mesh_c.n_vertices} vertices, {mesh_c.n_faces} faces on the CPU, {mesh_g.n_faces} on "
        f"the card, faces equal {same_faces}, vertex max abs err {err_v} (tol 1e-4); fine lattice "
        f"{flip_report}; chunks {gpu.extract_stats}; launches {launches} (expected {want})")
    if not err_lat <= 1e-4:
        raise AssertionError(f"small Stage 0: latents differ by {err_lat}")
    if not (same_faces and mesh_c.n_faces > 0 and err_v <= 1e-4 and not flips.any()):
        raise AssertionError(f"small Stage 0: meshes differ (faces equal {same_faces}, "
                             f"vertices {err_v}) or fine-lattice signs flip: {flip_report}")
    if launches["flash_fwd"] != want["flash_fwd"] or launches["fused_rms_rope"] != want["fused_rms_rope"]:
        raise AssertionError(f"small Stage 0 launches {launches} != {want}")
    return {"latent_err": err_lat, "vertex_err": err_v, "faces": int(mesh_c.n_faces),
            "fine_lattice": flip_report, "chunks": gpu.extract_stats, "launches": launches}


SMALL_DENOISER = DenoiserConfig(
    num_tokens_nominal=32, temporal_context_size=4, in_channels=8, num_layers=3,
    num_attention_heads=2, width=128, mlp_ratio=2.0, cross_attention_dim=64,
    inflated_layers=(0, 1, 2), gelu_approx=False,
)


def phase_small_train() -> dict:
    """3 fp32 train steps of a small denoiser (head dim 64) on the card
    (kernels A, B, C, D) and on the CPU (plain versions): same initial
    weights, batches and draws; losses and final params agree."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = TrainLoopConfig(total_steps=3, warmup_steps=1, peak_lr=1e-5, ema_decay=0.9)
    rng = np.random.default_rng(5)
    B, T, N = 2, 4, SMALL_DENOISER.num_tokens_nominal
    batches = [{
        "latents": rng.standard_normal((B, T, N, 8)).astype(np.float32),
        "context": rng.standard_normal((B, T, 16, 64)).astype(np.float32),
        "framestep": np.tile(np.arange(T, dtype=np.float32), (B, 1)),
        "mask": (np.arange(T)[None] < np.array([[1], [2]])).astype(np.float32),
    } for _ in range(cfg.total_steps)]
    params = init_denoiser(torch.Generator().manual_seed(2), SMALL_DENOISER)
    runs = {}
    for dev in ("cpu", "cuda"):
        optimizer = make_optimizer(cfg)
        state = init_train_state(tree_to(params, dev), optimizer, ema_decay=cfg.ema_decay)
        step = make_train_step(SMALL_DENOISER, optimizer, p_uncond=0.5, ema_decay=cfg.ema_decay)
        reset_counters()
        losses = []
        for i, batch in enumerate(batches):
            tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            state, loss = step(state, tb, step_generator(0, i))
            losses.append(loss.item())
        runs[dev] = (losses, state, read_counters())
    (l_cpu, s_cpu, _), (l_gpu, s_gpu, counts) = runs["cpu"], runs["cuda"]
    want = expected_train_launches(SMALL_DENOISER, cfg.total_steps)
    if counts != want:
        raise AssertionError(f"small train launches {counts} != {want}")
    err_loss = max(abs(a - b) for a, b in zip(l_cpu, l_gpu))
    err_params = max(
        (a.detach().cpu() - b.detach()).abs().max().item()
        for key in ("params", "ema_params")
        for a, b in zip(leaves(s_gpu[key]), leaves(s_cpu[key]))
    )
    # fp32 everywhere (no TF32); sums in another order on the card
    log(f"small train reference: losses cpu {l_cpu} card {l_gpu}; max abs err loss "
        f"{err_loss:.3e}, params+EMA {err_params:.3e} (tol 1e-4); launches {counts}")
    if not (err_loss <= 1e-4 and err_params <= 1e-4):
        raise AssertionError(f"card and CPU train steps disagree: {err_loss}, {err_params}")
    return {"loss_err": err_loss, "param_err": err_params, "launches": counts}


COUNTERS = ("flash_fwd", "fused_rms_rope", "flash_bwd_dkv", "flash_bwd_dq", "flash_fused")


def reset_counters() -> None:
    flash_attention.launches = fused_rms_rope.launches = flash_attention_fused.launches = 0
    flash_attention_bwd.dkv_launches = flash_attention_bwd.dq_launches = 0


def read_counters() -> dict:
    return dict(zip(COUNTERS, (flash_attention.launches, fused_rms_rope.launches,
                               flash_attention_bwd.dkv_launches, flash_attention_bwd.dq_launches,
                               flash_attention_fused.launches)))


def expected_train_launches(cfg: DenoiserConfig, steps: int) -> dict:
    """Kernel launches of ``steps`` train steps with remat.

    Per block: self and cross attention (kernel A each), rms-norm(+rope) of
    their q and k (kernel B, 4 launches); remat runs the block's forward
    again in the backward, so A and B launch twice per step; kernels C and
    D once per attention.
    """
    L = cfg.num_layers
    return dict(zip(COUNTERS, (2 * 2 * L * steps, 2 * 4 * L * steps, 2 * L * steps, 2 * L * steps, 0)))


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

    Stage 0 (TripoSG): DINOv2 on the anchor, one flash per layer; per DiT
    step and block, self (q, k rms; flash) and cross (q, k rms; flash; the
    unconditional branch skips it); one flash per VAE decoder block; one
    flash per SDF query chunk of the prefilter, band and fine passes (the
    extraction reports them). DINOv2 on all frames: one flash per layer.
    Stage I, per window and step, per block: self (q, k rms+rope; flash) and
    cross (q, k rms; flash; conditional only). Stage II, per window and
    target chunk: one flash and two rope-only launches per self block, one
    flash for the vertex cross block.
    """
    cfg = pipe.cfg
    win1 = len(chunk_from(cfg.anchor_idx, n_frames, cfg.temporal_3D_denoiser.temporal_context_size, cfg.sliding_window_denoiser))
    win2 = chunk_from(cfg.anchor_idx, n_frames, cfg.temporal_3D_vae.temporal_context_size, cfg.sliding_window_autoencoder)
    chunks2 = sum(math.ceil((len(w) - 1) / cfg.decode_target_chunk) for w in win2)
    steps = cfg.scheduler.num_inference_steps
    L1, L2 = cfg.temporal_3D_denoiser.num_layers, cfg.temporal_3D_vae.num_layers
    dino = pipe.image_encoder.config.num_layers
    tripo = pipe.image_to_3d.pipeline
    steps0, L0 = cfg.stage_0.num_inference_steps, tripo.dit_cfg.num_layers
    stage0_flash = dino + 2 * L0 * steps0 + tripo.vae_cfg.decoder_layers + sum(tripo.extract_stats.values())
    flash = stage0_flash + dino + 2 * L1 * steps * win1 + (L2 + 1) * chunks2
    rope = 4 * L0 * steps0 + 4 * L1 * steps * win1 + 2 * L2 * chunks2
    return flash, rope


def phase_slice() -> dict:
    t0 = time.perf_counter()
    pipe = ActionMeshPipeline(
        config_name="actionmesh", weights_dir=None, device=torch.device("cuda"), init_seed=0
    )
    if not isinstance(pipe.image_to_3d, DevTripoSG):
        raise AssertionError(f"Stage 0 is {type(pipe.image_to_3d).__name__}, not DevTripoSG")
    pipe.image_to_3d.pipeline  # build the random-weight TripoSG before the timed call
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frames = make_frames()
    inp = ActionMeshInput(frames=frames, timesteps=np.arange(N_FRAMES, dtype=np.float32))
    preset_stage1_steps = pipe.cfg.scheduler.num_inference_steps  # the call cuts it

    # keep the arguments of the decode's last SDF query, the fine pass's
    fine_query = {}
    query_at_ids = triposg_pipeline.query_sdf_at_ids

    def recording_query(params, cfg, kv, ijk, lo, step, **kw):
        fine_query.update(params=params, cfg=cfg, kv=kv, ijk=ijk, lo=lo, step=step, kw=kw)
        return query_at_ids(params, cfg, kv, ijk, lo, step, **kw)

    triposg_pipeline.query_sdf_at_ids = recording_query
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        meshes = pipe(inp, seed=44, stage_1_steps=STAGE1_STEPS)
        torch.cuda.synchronize()
    finally:
        triposg_pipeline.query_sdf_at_ids = query_at_ids
    total_s = time.perf_counter() - t0
    launches = {"flash_fwd": flash_attention.launches, "rms_rope": fused_rms_rope.launches,
                "flash_fused": flash_attention_fused.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    chunks = dict(pipe.image_to_3d.pipeline.extract_stats)

    want_flash, want_rope = expected_launches(pipe, N_FRAMES)
    log(f"slice: init {init_s:.2f} s | __call__ {total_s:.2f} s | phases "
        + " ".join(f"{k} {v:.2f} s" for k, v in pipe.phase_seconds.items())
        + " | stage0 sub-phases " + " ".join(f"{k} {v:.2f} s" for k, v in pipe.stage0_seconds.items())
        + f" | peak memory {peak_gib:.2f} GiB")
    log(f"slice: launches flash_fwd {launches['flash_fwd']} (expected {want_flash}), "
        f"rms_rope {launches['rms_rope']} (expected {want_rope}); SDF query chunks {chunks}")
    if (launches["flash_fwd"], launches["rms_rope"]) != (want_flash, want_rope):
        raise AssertionError(f"launch counts {launches} != ({want_flash}, {want_rope})")
    if flash_attention_bwd.dkv_launches or flash_attention_bwd.dq_launches or launches["flash_fused"]:
        raise AssertionError("the inference slice launched a backward kernel or kernel F")

    if len(meshes) != N_FRAMES:
        raise AssertionError(f"{len(meshes)} meshes for {N_FRAMES} frames")
    # the anchor frame (index 0) keeps Stage 0's processed mesh
    anchor = meshes[0]
    a_ok = (0 < anchor.n_faces <= pipe.cfg.mesh_process.face_decimation
            and np.isfinite(anchor.vertices).all() and np.abs(anchor.vertices).max() <= 1.005)
    log(f"slice: anchor mesh {anchor.n_vertices} vertices, {anchor.n_faces} faces, "
        f"|v| max {np.abs(anchor.vertices).max():.4f}")
    if not a_ok:
        raise AssertionError("the anchor mesh is empty, above the face budget, not finite or out of bounds")
    faces = anchor.faces
    verts = np.stack([m.vertices for m in meshes])
    if not all(np.array_equal(m.faces, faces) for m in meshes):
        raise AssertionError("meshes do not share the anchor's faces")
    if not np.isfinite(verts).all() or np.abs(verts).max() > 1.005:
        raise AssertionError("vertices are not finite or leave [-1.005, 1.005]")
    motion = float(np.abs(verts[1:] - verts[0]).max())
    if not motion > 0:
        raise AssertionError("no displacement across time")
    log(f"slice: {len(meshes)} meshes, {verts.shape[1]} vertices, {faces.shape[0]} faces, "
        f"max displacement from frame 0 {motion:.4f}")
    stage1_step_s = pipe.phase_seconds["stage1"] / STAGE1_STEPS
    clip_s = total_s + (preset_stage1_steps - STAGE1_STEPS) * stage1_step_s
    log(f"slice: seconds per clip at the preset's {preset_stage1_steps} Stage-I steps, derived "
        f"from this run's {STAGE1_STEPS}-step time: {clip_s:.2f} s")
    phase_s, stage0_s = pipe.phase_seconds, pipe.stage0_seconds
    del pipe
    torch.cuda.empty_cache()
    return {"launches": launches, "phase_seconds": phase_s, "stage0_seconds": stage0_s,
            "init_seconds": init_s,
            "call_seconds": total_s, "peak_gib": peak_gib, "sdf_query_chunks": chunks,
            "anchor_vertices": int(anchor.n_vertices), "anchor_faces": int(anchor.n_faces),
            "derived_clip_seconds": clip_s, "preset_stage1_steps": preset_stage1_steps}, fine_query


def plain_dot_product_attention(q, k, v, scale=None, kv_mask=None, trainable=False):
    return chunked_attention(q, k, v, scale=scale, kv_mask=kv_mask)


def phase_sdf_chunk(fine_query: dict) -> dict:
    """One 2^18-point chunk of the slice's fine SDF pass, on the slice's
    DevTripoSG weights and decoded latent set, queried through kernel A's
    fp32 path and through ``chunked_attention`` on the card. The sign of a
    (regularized) value decides the faces: a flip is allowed only where
    |value| <= 1e-5 of the chunk's largest |value|."""
    q = fine_query
    args = (q["params"], q["cfg"], q["kv"], q["ijk"][:QUERY_CHUNK], q["lo"], q["step"])
    launched = flash_attention.launches
    kernel = query_sdf_at_ids(*args, **q["kw"])
    if flash_attention.launches == launched:
        raise AssertionError("the SDF chunk's query launched no kernel")
    model_layers.dot_product_attention = plain_dot_product_attention
    try:
        plain = query_sdf_at_ids(*args, **q["kw"])
    finally:
        model_layers.dot_product_attention = dot_product_attention
    flips = (kernel < 0) != (plain < 0)
    vmax = float(np.abs(plain).max())
    flipped = float(np.abs(plain[flips]).max()) if flips.any() else None
    report = {"points": int(plain.size), "sign_flips": int(flips.sum()),
              "max_abs_value_flipped": flipped, "max_abs_value": vmax,
              "max_abs_value_diff": float(np.abs(kernel - plain).max()),
              "lattice_step": [float(x) for x in np.asarray(q["step"])]}
    log(f"full-width SDF chunk: {report['points']} fine-pass points, kernel vs plain: "
        f"max abs diff {report['max_abs_value_diff']:.3e} (max |value| {vmax:.3e}), sign flips "
        f"{report['sign_flips']}, largest |value| flipped {flipped} (allowed up to {1e-5 * vmax:.3e})")
    if flipped is not None and flipped > 1e-5 * vmax:
        raise AssertionError(f"full-width SDF chunk: a sign flips at |value| {flipped}")
    return report


def phase_train() -> dict:
    """Full-width Stage-I training through the entry point's code path."""
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    args = train_entry.build_args().parse_args([
        "--synthetic", "--size", "production", "--window", "16", "--batch", "2",
        "--compute-dtype", "bfloat16", "--steps", str(TRAIN_STEPS), "--warmup", "1",
        "--ema-decay", "0.999", "--log-every", "1", "--ckpt-every", "0",
        "--out", str(OUT_DIR), "--no-resume", "--time-phases", "--device", "cuda",
    ])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    state, history, loop_cfg = train_entry.run(args)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counters()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    cfg = train_entry.flow_model_config("production")
    n_params = sum(p.numel() for p in leaves(state["params"]))

    recs = [h for h in history if "loss" in h]
    losses = [h["loss"] for h in recs]
    step_s = [h["forward_s"] + h["backward_s"] + h["update_s"] for h in recs]
    log(f"train: {n_params / 1e9:.3f} B params | {len(recs)} steps, losses {losses} | "
        + " | ".join(f"step {h['step']}: {t:.2f} s (forward {h['forward_s']:.2f}, backward "
                     f"{h['backward_s']:.2f}, update {h['update_s']:.2f})" for h, t in zip(recs, step_s))
        + f" | peak memory {peak_gib:.2f} GiB | run incl. data, init, checkpoint {run_s:.1f} s")
    want = expected_train_launches(cfg, TRAIN_STEPS)
    log(f"train: launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"train launch counts {launches} != {want}")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train losses {losses}")

    # every leaf moved from its initial value (lr > 0 from the second step)
    init = init_denoiser(torch.Generator("cuda").manual_seed(loop_cfg.seed), cfg, device=torch.device("cuda"))
    moved = [
        (name, (p.detach() - p0).abs().max().item())
        for (name, p), p0 in zip(named_leaves(state["params"]), leaves(init))
    ]
    del init
    still = [n for n, d in moved if not d > 0]
    log(f"train: {len(moved) - len(still)}/{len(moved)} param leaves moved, "
        f"max change {max(d for _, d in moved):.3e}")
    if still:
        raise AssertionError(f"params did not move: {still[:5]}")

    ckpt = OUT_DIR / "ckpt_latest.npz"
    t0 = time.perf_counter()
    template = tree_map(lambda t: torch.empty_like(t) if isinstance(t, torch.Tensor) else -1, state)
    restored = restore_train_state(ckpt, template)
    same = all(
        torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        for (_, a), (_, b) in zip(named_leaves(restored), named_leaves(state))
    )
    restore_s = time.perf_counter() - t0
    ckpt_gb = ckpt.stat().st_size / 1e9
    log(f"train: checkpoint {ckpt_gb:.2f} GB restored in {restore_s:.1f} s, equal to the state: {same}")
    if not same:
        raise AssertionError("the restored checkpoint differs from the train state")
    del template, restored, state
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "losses": losses, "step_seconds": step_s,
            "phase_seconds": [{k: h[k] for k in ("forward_s", "backward_s", "update_s")} for h in recs],
            "peak_gib": peak_gib, "params": n_params, "run_seconds": run_s,
            "checkpoint_gb": ckpt_gb, "restore_seconds": restore_s}


def phase_actionbench() -> dict:
    """The synthetic ActionBench suite through the evaluator's entry point on
    the card, at the evaluator's defaults; then a resumed call."""
    root = OUT_DIR / "actionbench"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    uids = ab_synth.build_dataset(root, ICP_FRAMES, n_pts_gt=50_000, per_kind=1)
    build_s = time.perf_counter() - t0
    argv = ["--gt_root", str(root / "gt"), "--pred_root", str(root / "pred"),
            "--output_csv", str(root / "results.csv"), "--device", "cuda"]
    reset_counters()
    nn_argmin.launches = 0
    t0 = time.perf_counter()
    results = ab_eval.main(argv)
    eval_s = time.perf_counter() - t0
    launches = nn_argmin.launches
    others = read_counters()

    samples = results.samples
    per_kind = ab_synth.per_kind_means(samples)
    checks = ab_synth.sanity_checks(per_kind) if len(per_kind) == 4 else {}
    want = len(uids) * 2 * 200  # two neighbour searches per Adam step
    for s in samples:
        log(f"actionbench {s.uid}: {s.status} cd_3d {s.cd_3d:.5f} cd_4d {s.cd_4d:.5f} "
            f"cd_motion {s.cd_motion:.5f} | " + ", ".join(f"{k} {v:.2f} s" for k, v in s.seconds.items())
            + (f" | {s.error_message}" if s.error_message else ""))
    log(f"actionbench: {len(uids)} samples built in {build_s:.1f} s, evaluated in {eval_s:.1f} s "
        f"({eval_s / len(uids):.2f} s per sample); checks {checks}; kernel E launches {launches} "
        f"(expected {want}); other kernels {others}")
    if [s.status for s in samples] != ["success"] * len(uids) or len(uids) != 4:
        raise AssertionError(f"actionbench statuses {[(s.uid, s.status) for s in samples]}")
    if not (per_kind["identity"]["cd_3d"] < 0.012 and checks and all(checks.values())):
        raise AssertionError(f"actionbench metrics: {per_kind}, checks {checks}")
    if launches != want or any(others.values()):
        raise AssertionError(f"actionbench launches {launches} != {want}, others {others}")

    nn_argmin.launches = 0
    resumed = ab_eval.main(argv)
    if nn_argmin.launches or resumed.samples != samples:
        raise AssertionError(f"the resumed call launched {nn_argmin.launches} or changed the results")
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    seconds = {k: [s.seconds[k] for s in samples] for k in samples[0].seconds}
    return {"launches": launches, "per_kind": per_kind, "checks": checks, "build_seconds": build_s,
            "eval_seconds": eval_s, "seconds_per_sample": eval_s / len(uids), "phase_seconds": seconds}


def main() -> None:
    logging.basicConfig(level=logging.WARNING)
    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    info = phase_device()
    build = phase_build()
    sl, fine_query = phase_slice()
    sdf_chunk = phase_sdf_chunk(fine_query)
    del fine_query
    torch.cuda.empty_cache()
    flash, rope = phase_kernels(sl["anchor_vertices"])
    fused, fused_launches = phase_fused()
    bwd, rope_bwd = phase_backward()
    nn = phase_nn()
    small_err = phase_small_reference()
    small_stage0 = phase_small_stage0()
    small_train = phase_small_train()
    tr = phase_train()
    small_icp = phase_small_icp()
    ab = phase_actionbench()

    def summary(name, source, replaces, rows, launches):
        head = rows[0]
        return {"name": name, "route": "cuda" if source.endswith(".cu") else "triton",
                "source": source, "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"], "library_ms": head["library_ms"],
                "shape": head["shape"], "shapes": rows}

    def by_path(name, inference_name):
        return {"inference": sl["launches"][inference_name], "training": tr["launches"][name]}

    def bwd_summary(name, replaces, key):
        rows = [{"name": r["name"], "shape": r["shape"], "dtype": r["dtype"],
                 "max_abs_err": max(r["max_abs_err"][g] for g in key[1]),
                 "tol": min(r["tol"][g] for g in key[1]), "ms": r[f"ms_{key[0]}"],
                 "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                 "library_bwd_ms": r["library_bwd_ms"], "deterministic": r["deterministic"],
                 **r[f"bound_{key[0]}"], "tflops": r[f"tflops_{key[0]}"]} for r in bwd]
        out = summary(name, "actionmesh_tpu_torch/csrc/flash_bwd.cu", replaces, rows,
                      tr["launches"][name])
        out["library_bwd_ms"] = rows[0]["library_bwd_ms"]
        out["launches_by_path"] = {"training": tr["launches"][name]}
        out["plain_ms_note"] = "the plain backward computes dq, dk and dv together"
        out["library_ms_note"] = ("scaled_dot_product_attention forward plus backward: one call "
                                  "pair for kernels A, C and D together; library_bwd_ms is its "
                                  "backward alone over one retained forward, for C and D together")
        return out

    kernels = [
        summary("flash_fwd", "actionmesh_tpu_torch/csrc/flash_fwd.cu",
                "actionmesh_tpu/ops/flash_attention.py:302", flash,
                sl["launches"]["flash_fwd"] + tr["launches"]["flash_fwd"]),
        summary("fused_rms_rope", "actionmesh_tpu_torch/ops/rope_norm.py",
                "actionmesh_tpu/ops/rope_norm.py:94", rope,
                sl["launches"]["rms_rope"] + tr["launches"]["fused_rms_rope"]),
        bwd_summary("flash_bwd_dkv", "actionmesh_tpu/ops/flash_attention_bwd.py:261", ("dkv", ("dk", "dv"))),
        bwd_summary("flash_bwd_dq", "actionmesh_tpu/ops/flash_attention_bwd.py:287", ("dq", ("dq",))),
        summary("nn_argmin", "actionmesh_tpu_torch/csrc/nn_argmin.cu",
                "actionmesh_tpu/ops/nn_argmin.py:148", nn, ab["launches"]),
        summary("flash_attention_fused", "actionmesh_tpu_torch/csrc/flash_fwd.cu",
                "actionmesh_tpu/ops/flash_attention.py:492", fused,
                sl["launches"]["flash_fused"] + tr["launches"]["flash_fused"]),
    ]
    kernels[0]["also_replaces"] = "actionmesh_tpu/ops/flash_attention.py:612"
    kernels[0]["launches_by_path"] = by_path("flash_fwd", "flash_fwd")
    kernels[0]["library_ms_note"] = ("scaled_dot_product_attention on the same q, k, v (the kv_mask "
                                     "as its attn_mask); none for the stats row, as SDPA gives no (m, l)")
    kernels[1]["launches_by_path"] = by_path("fused_rms_rope", "rms_rope")
    kernels[1]["library_ms_note"] = ("torch.nn.functional.rms_norm on the same x and scale for the "
                                     "rows without tables; none for the rows that rotate (no single "
                                     "PyTorch call normalises and rotates)")
    kernels[1]["backward"] = rope_bwd
    kernels[4]["launches_by_path"] = {"actionbench": ab["launches"]}
    kernels[4]["library_ms_note"] = "none: no single PyTorch call gives the nearest index (cdist, then argmin)"
    kernels[4]["max_abs_err_note"] = "float64 squared-distance difference of differing picks"
    kernels[5]["launches_by_path"] = {"inference": sl["launches"]["flash_fused"],
                                      "training": tr["launches"]["flash_fused"],
                                      "smoke": fused_launches}
    kernels[5]["unfused_b_b_a_ms"] = fused[0]["unfused_b_b_a_ms"]
    kernels[5]["library_ms_note"] = ("scaled_dot_product_attention on q, k normalised and rotated "
                                     "beforehand by the plain pre-pass")
    kernels[5]["launches_note"] = "one launch counts a call: the pre-pass and kernel A's mainloop"
    for i in (0, 5):  # the head row's rates, as for ms and bound_ms
        kernels[i].update({k: kernels[i]["shapes"][0][k] for k in ("tflops", "bound_share", "vs_library")})
    print(json.dumps({"kernels": kernels, "build": build,
                      "small_reference_max_abs_err": small_err, "small_stage0_reference": small_stage0,
                      "small_train_reference": small_train, "small_icp_reference": small_icp,
                      "slice": sl, "sdf_chunk": sdf_chunk, "train": tr, "actionbench": ab,
                      "card": info["nvidia_smi"]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
