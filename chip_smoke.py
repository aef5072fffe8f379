"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --cli "--fast" "--distilled4" "--dtype float16"
    python3 chip_smoke.py --distributed
    python3 chip_smoke.py --hunyuan3d

The second form runs only the CLI phase (4 below), once per quoted set of
flags, and prints its results: every set runs and is reported, and the
script exits non-zero when any of them failed. The third runs only the
device mesh's phase (20 below), on every card up to 4. The fourth runs
only Hunyuan3D-2.1's phase (``phase_hunyuan3d``, after the kernel rows in
the full run): kernel A at the shapes of its DiT (4,097 tokens, cross to
1,370), its VAE decoder (4,096 latents, 16 heads of 64) and its SDF query
chunk (fp32 and bf16); its sparse-expert layer's two grouped products at
the DiT's shape against a loop over the experts and against their bound,
and the whole layer; one CFG step of its DiT at the published widths,
which must make no host synchronisation; and one whole Stage-0 call at the
published widths with the kernels' launch counters read around it.

Phases, in order; any failure raises and the script exits non-zero:
  1. device: requires CUDA; prints the card (nvidia-smi name, power limit)
     and the toolchain versions (nvcc, g++);
  2. build: compiles kernels A and F (csrc/flash_fwd.cu), C and D
     (csrc/flash_bwd.cu), E (csrc/nn_argmin.cu), B with its backward
     (csrc/rms_rope.cu) and kernel E's yardstick (csrc/nn_argmin_cuda_core.cu)
     with nvcc, one process per source, and the native geometry library
     (native/actionmesh_native.cpp) with g++, all in parallel, from this
     checkout, and prints each CUDA kernel's registers and spills as ptxas
     reports them (kernel A's and kernels C and D's fp32 kernels and their
     split pre-passes, kernel E, its yardstick and kernel B's kernels must
     spill nothing);
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
  4. the command line: ``python -m actionmesh_tpu_torch.inference.
     video_to_animated_mesh``'s ``main`` in process on the 16 synthetic
     frames written as NN_image.png + NN_mask.png pairs, at the default
     preset (full width, Stage I cut to 4 of its 30 steps) and at --turbo; checks 16
     mesh_XX.glb files that load back with the anchor's topology, the
     deformation arrays, an animated GLB with 16 morph targets, a non-blank
     preview and launch counts equal to what each preset's path implies;
     prints each clip's seconds (load, pipeline phases, export, render), and
     times the host PNG reader (1024^2 RGBA) and GIF writer (16 x 256 x 1024);
 4b. checkpoints: writes a synthetic ``pretrained_weights/`` tree at the
     release's names and shapes under outputs/chip_smoke (ActionMesh
     denoiser and autoencoder bf16, TripoSG transformer and VAE fp16 with
     the VAE's SDF head shaped to a rounded sphere, DINOv2-L fp32, RMBG-1.4
     fp32 with its convs routing the frame's brightness to the matte: a
     random ISNet's matte marks nearly every pixel foreground); reads each
     family back with the port's safetensors reader, converts, verifies and
     moves it to the card (seconds, GB, GB/s, peak host RSS); then runs the
     video-to-4D CLI with ``--weights_dir`` on it at full width and --turbo
     on the 16 frames as RGB PNGs without alpha, so RMBG mattes them at
     1024^2: launch counts as the path implies, alpha on the object, each
     phase's seconds (preprocess with RMBG included); then the same clip
     from the 16 frames as a video that OpenCV writes (mp4v .mp4, or MJPG
     .avi where this OpenCV has no mp4 encoder), decoded by the CLI's
     loader, checked the same way;
 4c. the {video + 3D} CLI (``video_and_3d_to_animated_mesh``) at full width
     on the 16 frame pairs and a textured .glb (TEXCOORD_0, a PNG texture),
     Stage I at the turbo preset's 4 steps: output faces equal the input's,
     uv and glTF payload kept, finite vertices, launch counts as the path
     implies with kernel A once at the VAE encoder's cross shape and once
     per encoder block at its self shape; seconds of the surface sampling,
     the VAE encode and its FPS, Stage I and II;
  5. kernels vs their plain PyTorch versions on the card, at the main
     paths' shapes (Stage 0's included): max abs error against the stated
     tolerance, and CUDA-event times (median of warm runs, each as many
     back-to-back calls as last about 1 ms) of the kernel (kernel B's
     forward rows also its device time from torch.profiler),
     the plain version and, where one PyTorch call computes the same
     function, that call (``library_ms``; the port never calls it); kernel
     A and B's forward also at the fp32 Stage-II decoder training shapes
     (self over 16,392 tokens and the vertex cross, 14 folded targets; B's
     rotation alone with 14 tables) and B at the DiT's fp32 q/k; kernel
     A also with a kv_mask (ragged Sk, one batch entry with every key
     masked), with its stats (m, l) held against the plain version's, and
     at D = 64 with ragged Sq and Sk; every bf16 row again in fp16 (the
     --dtype float16 path; 2.5e-3 of max|ref| against bf16's 2e-2), and
     kernel B's forward at the DiT q/k shape in fp16. fp32 rows (3xTF32: fp32 accuracy on
     TF32 tensor cores) are held within 2e-5 of the output's largest
     magnitude with their stats, and give their distance from the plain
     model of the split arithmetic
     (``split_precision_attention_reference``), SDPA's distance from the
     plain version and the kernels SDPA launches (torch.profiler, one
     session for both fp32 shapes); the split pre-pass's workspaces must
     equal ``split_kv_reference`` bit for bit;
  6. kernel F (qk-norm + interleaved RoPE pre-pass, then kernel A's
     mainloop; on no path) against its plain version at the Stage-I self
     shape, a ragged fp32, a D = 64 and an fp16 shape, timed beside
     scaled_dot_product_attention on q and k normalised and rotated
     beforehand, and at the Stage-I shape beside the unfused composition
     (kernel B twice, then kernel A);
  7. the backward kernels C and D at the Stage-I training shapes in bf16
     and in fp32 (on kernel A's stats), at the Stage-II decoder's training
     shapes in fp32 and the Stage-0 DiT's in fp32 and bf16, timed beside SDPA's forward +
     backward and SDPA's backward alone (over one retained forward), with
     each kernel's share of its bound, at small D = 128 and D = 64 shapes
     and ragged edge shapes (a one-row last query tile, a one-key last key
     tile) in both dtypes, two calls bit-equal at the Stage-I cross and a
     small shape in both;
     and kernel B's backward kernel at the Stage-I training shapes, the
     decoder's rotation alone (14 tables, fp32), the DiT's norm alone (fp32,
     bf16) and small edge cases, against ``rms_rope_backward_reference`` and autograd
     of the plain composition, dscale bit-equal across two calls, timed
     alone and with the forward, beside rms_norm's forward + backward;
  8. kernel E at the evaluator's shape and small shapes (C = 1 to 8, ragged
     N and M, exact duplicates), with its pairs a second and its bounds,
     timed beside its yardstick, the simpler CUDA-core design (three FMAs and
     an fminf a pair; checked the same way, and against the plain model of
     its FMA chain), which the port never calls;
  9. small references: the inference slice (Stage-0 stub) in fp32 (within
     1e-4) and in fp16 (within 1e-3), and a small TripoSG Stage 0 (DiT 3 x
     128, VAE decoder 2 x 128, dense 5 / fine 6 / prefilter 4) in fp32, each
     on the card and on the CPU (plain versions) with the same weights and
     noise, agree (Stage 0: equal faces and no fine-lattice sign flip); and
     a small checkpoint tree (ActionMesh, TripoSG, DINOv2 at small widths,
     RMBG-1.4 at full size) loaded on both: TripoSG's Stage 0 and the slice
     from one anchor within 1e-4, RMBG at 1024^2 in fp32 (TF32 off) within
     1e-4 of its logits' range, one matte level, 0.5% of the alpha;
 10. small train reference: 2 fp32 train steps of a small denoiser on the
     card and on the CPU, same weights, batches and draws, agree; kernel B's
     backward runs 4 L times a step and the plain backward never on the
     card;
 11. the training slice: ``python -m actionmesh_tpu_torch.train``'s code path
     at the production DenoiserConfig (window 16, batch 2, EMA, remat, on
     synthetic clips of production size), 1 step with bf16 compute and 1
     with the entry point's default fp32 (kernels A, C and D on their fp32
     paths); checks finite losses, moved params, launch counts equal to
     what the path implies, and (bf16) the checkpoint's entries (names and
     shapes of all, values of every 16th leaf) against the state; prints
     each step's forward, backward and update seconds and the peak memory;
     then the other trainers at full width, each checked for finite
     losses, moved params and launch counts as its path implies: Stage-II
     decoder training (``run_decoder_training``, production
     AutoencoderConfig, fp32, window 8, batch 2, bucket 4096, synthetic
     clips + tracks through DecoderTrackDataset and decoder_batches, 1
     step and one held-out eval with the chamfer metrics, the train
     checkpoint restored whole with every leaf equal, an
     autoencoder.npz export that reloads); distillation (``train.py
     --stage distill``, production DenoiserConfig, window 16, batch 2,
     bf16, a random teacher) in guidance and progressive mode (30 teacher
     steps), 1 step each, timed as teacher and student, the teacher's
     inference launches of A and B counted; and ``--model stage0`` (the
     production TripoSG DiT, fp32, 2 steps, a dit.npz export that reloads);
 12. small ICP reference: gradient ICP (2 problems x 24 inits, 384 points
     0.3 apart, 50 steps) on the card (kernel E) and on the CPU (plain
     version) agree within 1e-3, the winning inits' correspondences checked
     to stay clear of near-ties;
 13. the ActionBench slice: the synthetic suite (16 frames, 50,000 tracked
     GT points, one sample per class) through
     ``python -m actionmesh_tpu_torch.actionbench.evaluate_dataset``'s code
     path at the evaluator's defaults (10,000 ICP points, 100,000 chamfer
     points, 200 Adam steps with per-step correspondences, 24 inits per
     frame); checks 4 successes, the metric-stack sanity checks, 400
     kernel-E launches per sample, and a resumed call that launches none;
 14. VAE training (after the DiT in 11): ``run_vae_training`` at the
     production TripoSGVAEConfig (encoder 8 x 512, decoder 16 x 1024, 2048
     tokens x 64 channels), fp32, batch 4, 16,384 surface points with
     normals and 16,384 exact-TSDF queries (12,288 near-surface, 4,096
     uniform; ``build_sdf_dataset`` on ``make_scene`` anchors) a shape: 2
     steps and one held-out eval; finite losses, moved params, 26 launches
     each of A, C and D a step (+ 26 of A for the eval), a vae.npz export
     that reloads equal; forward, backward and update seconds, peak GiB;
 15. clip preparation: ``python -m actionmesh_tpu_torch.prepare_clips``'s
     ``main`` on the 16 frame pairs at the turbo preset's production widths;
     the clip it writes loads in ``ClipWindowDataset`` with (16, 2048, 64)
     latents and (16, 257, 1024) context;
 16. the closed loop: ``python -m actionmesh_tpu_torch.closed_loop``'s
     ``main`` at the micro spec (head dims 12, 16 and 32) on 2 + 1 scenes:
     build, stage0 (VAE and DiT), train, distill, then eval of the random,
     trained, oracle and video variants; every variant scores every scene
     with finite CD-3D, CD-4D and CD-M, kernels A to E launch, and no plain
     version is handed a CUDA tensor;
 17. the resident server: kernels A, C and D as the first CUDA work of a new
     thread (bf16 and fp32, forward and backward), equal to the main
     thread's; then ``python -m actionmesh_tpu_torch.inference.serve``'s
     ``build_server`` at the turbo preset's full width (random weights) with
     ``--prewarm`` on the 16 frame pairs, served from a thread: /healthz
     reports cuda; a turbo request (16 GLBs with the anchor's topology, the
     deformation arrays, 16 morph targets, launches as the path implies); a
     short request (5 Stage-0 and 2 Stage-I steps) inside ``profile_to``,
     whose trace holds the spans stage1_window_0 and stage2_window_0 and
     kernel A's device kernel; two concurrent short requests, one at a time
     in the pipeline; a bad request answered 400, and the server answering
     after it; prints the prewarm's and each request's seconds;
 18. the bf16 coarse SDF pass: ``decode_latents`` of the slice's Stage-0
     latents (its VAE, the dev regularizer) at prefilter 6 / dense 8 / fine
     9, in fp32 and with ``coarse_decode_dtype="bfloat16"``: kernel A's bf16
     path launches once per prefilter and band chunk, its fp32 path once per
     fine chunk; every coarse sign that differs from the fp32 field lies
     within 2^-7 of the largest |value| of the level; the two meshes'
     symmetric Chamfer distance is below one fine cell (2.01 / 512); prints
     both decodes' seconds;
 19. the extraction variants through the slice's fp32 SDF (kernel A's fp32
     path): the dense extraction at depth 7 with cubes, tetrahedra and
     cubes_numpy, the hierarchical one with tetrahedra at dense 8 / fine 9,
     and its single-level branch (dense 7 = fine 7): finite, non-empty,
     tetrahedra 1.5-4x the faces of cubes, cubes_numpy with the native cubes'
     counts, vertices within 1e-4 and triangles, the single-level branch
     equal to the dense extraction;
 20. the device mesh (``parallel/``): on this card, for sp 2 and 4 and
     bf16, fp32, one rank's S/sp queries of the Stage-I self-attention
     against each KV shard through kernel A with its stats, merged by
     ``merge_partials``, within kernel A's tolerance of one unsharded call
     (also with a kv_mask that leaves a batch entry's keys in one shard),
     and the tp = 2 head shard equal to the unsharded call's heads; then
     one NCCL rank per visible card (at most 4; ``torchrun``'s environment
     set by hand), each building the turbo preset's pipeline at full width
     on its world's mesh and running a request through the server's worker
     path (rank 0's ``ActionMeshServer.handle``, the others' ``worker_loop``):
     at world 1 (mesh (dp 1, tp 1)) the vertices are bit-equal to the
     unsharded run's and the launches equal the path's; at 4 cards the
     layouts (dp 2, tp 2), (dp 2, sp 2), (dp 1, sp 4), each also on a small
     fp32 slice within 1e-4 of unsharded, each layout warmed by one request
     before the timed one, whose pipeline and Stage-0 phase seconds every
     rank reports; prints the world, each layout's seconds and its largest
     difference from the unsharded run. The ring backward on this card:
     for sp 2 and 4 and bf16, fp32, one rank's S/sp queries against each
     KV shard through kernels C and D with the whole sequence's log-sum-exp
     and delta, each shard's dQ part, dK and dV within C and D's
     tolerances of the plain version on that shard's inputs, the dQ parts
     summed in fp32 and the dK, dV of each shard within them of one
     unsharded C and D call for those queries, each ring step timed beside its bound and SDPA's backward at
     its shape. Training on the mesh: full-width Stage-I train steps
     (bf16, EMA on; one at world 1, two beyond, the second timed) on the
     rank's mesh against the same steps on one card:
     at world 1 (mesh (dp 1, tp 1)) bit-equal (the loss and every param)
     with the launches the path implies; at 4 cards (dp 2, tp 2) in bf16 and
     fp32 and (dp 1, tp 2, sp 2) in bf16 (the ring backward), with each
     step's seconds, every rank's peak GiB, the loss and the params
     against the one-card step's (max |dparam| within AdamW's bound for
     flipped signs, few elements off by more than lr); then, at 4 cards,
     ``train.py --mesh dp=2,tp=2`` under ``torchrun`` (one rank a card)
     for two full-width bf16 steps with a checkpoint, resumed with
     ``--steps 2`` (no step; the restored state written back must equal
     the checkpoint bit for bit), then resumed for a third step. A rank
     that fails fails the run.
Kernel A is also checked (5) in bf16 at the device mesh's shapes of the
Stage-I self-attention: a ring step at sp 2 and sp 4 with its stats, and
the tp = 2 head shard, each with SDPA's time at its shape.
Kernel A is also checked (5) in bf16 at the SDF query shape (1, 8, 2^18,
2048, 128), the coarse passes' chunk.
Kernels A, C and D are also checked (5, 7) at the VAE step's four fp32
shapes and at head dims 12, 16 and 32 (zero-padded to 64 by the wrapper),
and kernel B in its three forms (norm and rotation, rotation, norm) at head
dims 12, 16 and 32, forward and backward, bf16 and fp32.
Each kernel's ``bound_ms`` is the least time the card could take for the
work of its main-path call: the larger of its bytes (inputs read once,
outputs written once) at 3.35 TB/s and its operations at the peak rate of
their type, counted from this run's shapes: 989 TFLOP/s for bf16 and fp16 products;
495 / 3 TFLOP/s for fp32 products (kernel A's and F's fp32 rows, C and D's
fp32 rows), since an fp32-accurate product on the tensor cores is three
TF32 products at the data sheet's 495 TFLOP/s; 67 TFLOP/s, the non-tensor
fp32 rate, for kernel B, which is no matrix product. Kernel E's bound is
that of the function's work at fp32 accuracy on the tensor cores: the
distance [-2x, 1].[y, |y|^2] as 3xTF32, 3 (C + 1) products a pair at 495
TFLOP/s, beside at least one CUDA-core operation a pair at 67 / 2 T
operations a second; its design's packed depth (``bound_packed_ms``) and
the earlier design's 2C fp32 FMA flop a pair at 67 TFLOP/s
(``bound_fp32_fma_ms``) are kept beside it. Rows of
kernels A and F also give ``tflops`` (the products' 4*B*H*Sq*Sk*D
operations per second), ``bound_share`` (bound_ms / ms) and
``vs_library`` (ms / library_ms).
The line before the last is a short JSON object, one entry per kernel path
(``kernel_summary``); the line before it the JSON object with every result;
the last line is the device JSON.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import logging
import math
import resource
import shutil
import statistics
import struct
import subprocess
import sys
import threading
import time
import traceback
import warnings
import zipfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from actionmesh_tpu_torch.actionbench import evaluate_dataset as ab_eval
from actionmesh_tpu_torch.actionbench import icp as icp_module
from actionmesh_tpu_torch.actionbench import synthetic as ab_synth
from actionmesh_tpu_torch.actionbench.icp import gradient_icp_multi
from actionmesh_tpu_torch.config import load_config
from actionmesh_tpu_torch.inference import video_and_3d_to_animated_mesh as cli3d
from actionmesh_tpu_torch.inference import video_to_animated_mesh as cli
from actionmesh_tpu_torch.io.mesh import Mesh, load_glb, save_textured_glb
from actionmesh_tpu_torch.io.png import read_png, write_png
from actionmesh_tpu_torch.io.video_input import ActionMeshInput, load_frames, pil_resize
from actionmesh_tpu_torch.render import visualizer
from actionmesh_tpu_torch.render.utils import write_gif
from actionmesh_tpu_torch.models.dinov2 import DinoV2Config, init_dinov2
from actionmesh_tpu_torch import train as train_entry
from actionmesh_tpu_torch.models import image_encoder as image_encoder_module
from actionmesh_tpu_torch.models import rmbg as rmbg_module
from actionmesh_tpu_torch.models.autoencoder import AutoencoderConfig
from actionmesh_tpu_torch.models.denoiser import DenoiserConfig, init_denoiser
from actionmesh_tpu_torch.models.image_encoder import ImageEncoder
from actionmesh_tpu_torch.models.stage0 import DevTripoSG, make_uv_sphere
from actionmesh_tpu_torch.ops.attention import (
    attention_bwd_reference,
    bwd_row_stats,
    chunked_attention,
    dot_product_attention,
    merge_partials,
)
from actionmesh_tpu_torch.ops import attention as attn_ops
from actionmesh_tpu_torch.ops import isosurface
from actionmesh_tpu_torch.ops.chunking import chunk_from
from actionmesh_tpu_torch.models import layers as model_layers
from actionmesh_tpu_torch.models.triposg import pipeline as triposg_pipeline
from actionmesh_tpu_torch.models.triposg import vae as triposg_vae
from actionmesh_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_from_stats,
    flash_attention_fused,
    flash_attention_trainable,
    flash_attention_fused_reference,
    launch_bwd_kernels,
    norm_rope_interleaved,
    split_kv_reference,
    split_precision_attention_reference,
    tf32_split_kv,
)
from actionmesh_tpu_torch.ops import flash_attention as flash_ops
from actionmesh_tpu_torch.ops import rope_norm
from actionmesh_tpu_torch.ops.nn_argmin import (
    kernel_channels,
    fma_distances,
    nn_argmin,
    nn_argmin_model,
    nn_argmin_reference,
    packed_depth,
)
from actionmesh_tpu_torch.ops.rope_norm import (
    fused_rms_rope,
    rms_rope_backward_reference,
    rms_rope_reference,
)
from actionmesh_tpu_torch.models.stage0 import _dev_sdf_regularizer, _dev_sdf_regularizer_torch
from actionmesh_tpu_torch.models.triposg.dit import init_triposg_dit, triposg_dit_config
from actionmesh_tpu_torch.models.triposg.pipeline import (
    TripoSGPipeline,
    triposg_configs,
    triposg_configs_from,
)
from actionmesh_tpu_torch.models.triposg.vae import (
    QUERY_CHUNK,
    TripoSGVAEConfig,
    decode_kv,
    init_triposg_vae,
    query_sdf,
    query_sdf_at_ids,
)
from actionmesh_tpu_torch.ops.rotary import compute_rotary_embeddings
from actionmesh_tpu_torch.pipeline import ActionMeshPipeline
from actionmesh_tpu_torch.preprocessing import background
from actionmesh_tpu_torch.training.flow_train import init_train_state, make_train_step
from actionmesh_tpu_torch.training.loop import TrainLoopConfig, loop_ema_decay, make_optimizer, step_generator
from actionmesh_tpu_torch.utils import cuda_build, native, weights
from actionmesh_tpu_torch.utils.profiling import profile_to
from actionmesh_tpu_torch.utils.tree import leaves, named_leaves
from synthetic_checkpoints import brightness_rmbg, reference_state_dict, shape_vae_sdf, write_checkpoint

STAGE1_STEPS = 2
N_FRAMES = 16
# The production VAE train step's attention shapes (B, H, Sq, Sk, D): batch
# 4, 2,048 tokens, 16,384 surface points and 16,384 SDF queries a shape.
VAE_TRAIN_SHAPES = {
    "enc_cross": (4, 8, 2048, 16384, 64),
    "enc_self": (4, 8, 2048, 2048, 64),
    "dec_self": (4, 8, 2048, 2048, 128),
    "query": (4, 8, 16384, 2048, 128),
}
# The closed loop's head dims below the kernels' instantiated 64: its tiny
# DINOv2 (48 / 4), tiny VAE (64 / 4) and denoiser, decoder and DiT (128 / 4).
SMALL_HEAD_DIMS = (12, 16, 32)
# kernel B's three forms in the closed loop: (name, norm, tables: 16, one
# table a batch entry of the rows below; 0, one (S, D) table; None, none)
CLOSED_LOOP_ROPE_FORMS = (("norm_rope", True, 16), ("rope", False, 0), ("norm", True, None))
# Kernel E's yardstick, the CUDA-core design (csrc/nn_argmin_cuda_core.cu):
# built and timed here only, beside kernel E; the port never calls it.
NN_YARDSTICK = "nn_argmin_cuda_core"
# The full-width trainers take one step each (no warmup, so the step moves
# every parameter): a step's time is a step's (PR 15's R1: steps 1 and 2
# within 2% of each other in each trainer), and the run stays under its
# time limit. The DiT and the VAE, whose steps take about a second, take two.
TRAIN_STEPS = 1      # the bf16 train phase's steps
TRAIN_STEPS_F32 = 1  # the fp32 (the entry point's default dtype) train phase's steps
CKPT_SAMPLE = 16     # the bf16 train phase checks every 16th checkpoint leaf's values
OUT_DIR = Path(__file__).resolve().parent / "outputs" / "chip_smoke"  # git-ignored; removed at the end


T_START = time.perf_counter()


def log(msg: str) -> None:
    """A progress line, after the seconds since the script started."""
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi.splitlines()[0], flush=True)  # as nvidia-smi prints it
    nvcc = subprocess.run(
        [cuda_build.find_nvcc(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    log(
        f"python {sys.version.split()[0]} | torch {torch.__version__} | "
        f"cuda {torch.version.cuda} | nvcc {nvcc}"
    )
    gxx = subprocess.run(
        [native.find_cxx(), "--version"], capture_output=True, text=True, check=True
    ).stdout.splitlines()[0]
    log(f"g++: {gxx}")
    log(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return {"nvidia_smi": smi, "gxx": gxx}


def serialized_in(text: str, kernel: str) -> list[str]:
    """ptxas's lines on serialised wgmma that name ``kernel`` (a name in the
    source: every instantiation of it) or fall in the compile block of one."""
    lines = []
    for block in text.split("Compiling entry function")[1:]:
        head, _, rest = block.partition("\n")
        lines += [line.strip() for line in rest.splitlines()
                  if "serialized" in line and (kernel in head or kernel in line)]
    return lines


def phase_build() -> dict:
    """nvcc for every CUDA source and g++ for the native library, all at once."""
    from actionmesh_tpu_torch.ops.flash_attention import _bwd_library, _library
    from actionmesh_tpu_torch.ops.nn_argmin import _library as _nn_library
    from actionmesh_tpu_torch.ops.rope_norm import _library as _rope_library

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        # the geometry library and the PNG reader's unfilter routine (g++)
        native_job = pool.submit(timed, lambda: (native.build(), native.build(native.PNG_SOURCE, ())))
        # one nvcc per source, in parallel
        nvcc_s = timed(lambda: cuda_build.build(cuda_build.SOURCES + (NN_YARDSTICK,)))
        gxx_s = native_job.result()
    _library()
    _bwd_library()
    _nn_library()
    _rope_library()
    cuda_build.load_library(NN_YARDSTICK)
    native._load()
    native._load_png()
    seconds = time.perf_counter() - t0
    log(f"build: {', '.join(f'{n}.cu' for n in cuda_build.SOURCES + (NN_YARDSTICK,))} compiled with nvcc in "
        f"{nvcc_s:.1f} s, native/actionmesh_native.cpp and csrc/png_unfilter.cpp with g++ in "
        f"{gxx_s:.1f} s, in parallel; "
        f"all loaded in {seconds:.1f} s")
    ptxas = {name: cuda_build.ptxas_report(cuda_build.ptxas_output.get(name, ""))
             for name in cuda_build.SOURCES + (NN_YARDSTICK,)}
    for name, rows in ptxas.items():
        log(f"ptxas {name}.cu: " + "; ".join(
            f"{r['kernel']} {r['registers']} registers, spills {r['spill_store_bytes']} B stored / "
            f"{r['spill_load_bytes']} B loaded" for r in rows))
    # kernel A's 16-bit path (bf16 and fp16 at D 64 and 128), its fp32 path
    # and its pre-pass, kernels C and D's fp32 path and its pre-pass, kernel
    # E (and its yardstick) and kernel B's forward, backward and sums must
    # not spill (a library built by an earlier run in this checkout leaves no
    # report to read)
    no_spill = {"flash_fwd": (("flash_fwd_16bit_kernel", "flash_fwd_tf32x3_kernel", "split_kv_kernel"), 8),
                "flash_bwd": (("flash_bwd_tf32x3_kernel", "split_bwd_kernel"), 6),
                "nn_argmin": (("nn_argmin_tf32x3_kernel", "pack_y_kernel"), 4),
                NN_YARDSTICK: (("nn_argmin_cuda_core_kernel",), 2),
                # 3 dtypes x the head dims x (3 forward + 5 backward forms), and the 2 sums
                "rms_rope": (("rms_rope_fwd_kernel", "rms_rope_bwd_kernel", "sum_rows_kernel",
                              "sum_tables_kernel"), 3 * len(rope_norm.HEAD_DIMS) * 8 + 2)}
    serialized = {}
    for name, (prefixes, count) in no_spill.items():
        if name not in cuda_build.ptxas_output:
            log(f"ptxas: {name}.cu was built before this run; no report to check")
            continue
        rows = [r for r in ptxas[name] if r["kernel"].startswith(prefixes)]
        if len(rows) != count or any(r["spill_store_bytes"] or r["spill_load_bytes"] for r in rows):
            raise AssertionError(f"{name}.cu: ptxas reports {rows} ({count} kernels expected, no spill)")
        # ptxas serialises wgmma where it cannot prove the registers safe
        serialized[name] = [line.strip() for line in cuda_build.ptxas_output[name].splitlines()
                            if "serialized" in line]
        if serialized[name]:
            log(f"ptxas {name}.cu: " + " | ".join(serialized[name]))
    # kernel A's 16-bit softmax runs while its products are in flight: a
    # serialised wgmma there would undo that
    if "flash_fwd" in cuda_build.ptxas_output:
        bad = serialized_in(cuda_build.ptxas_output["flash_fwd"], "flash_fwd_16bit_kernel")
        if bad:
            raise AssertionError(f"flash_fwd.cu: ptxas serialises wgmma in the 16-bit kernel: {bad}")
    return {"seconds": seconds, "nvcc_seconds": nvcc_s, "gxx_seconds": gxx_s, "ptxas": ptxas,
            "wgmma_serialized": serialized}


# Peak rates of one H100 SXM (NVIDIA's data sheet, dense), for the bounds.
# An fp32-accurate product on the tensor cores takes three TF32 products
# (3xTF32), so fp32 attention and its backward are priced at TF32 / 3; fp32
# work that is no matrix product (kernels B, E) at the non-tensor rate.
BF16_FLOPS, TF32_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S = 989e12, 495e12, 67e12, 3.35e12
FP32_PRODUCT_FLOPS = TF32_FLOPS / 3


def product_rate(dtype) -> float:
    """The peak rate of matrix products of ``dtype`` (bf16 and fp16 alike;
    fp32: 3xTF32)."""
    return FP32_PRODUCT_FLOPS if dtype == torch.float32 else BF16_FLOPS


# 16-bit attention is held within 2e-2 of the output's largest magnitude in
# bf16 (one rounding of P and of the output, 8 mantissa bits) and 2.5e-3 in
# fp16, which rounds with 3 more bits.
ATTN_16_TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-2 / 8}


def attention_tol(dtype) -> float:
    return ATTN_16_TOL.get(dtype, F32_ATTN_TOL)


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


def cuda_ms(fn, reps: int, run_ms: float = 1.0) -> float:
    """Median CUDA-event time per call of ``reps`` warm runs, in ms. A run
    is as many back-to-back calls as last about ``run_ms`` (one for a call
    of that or more), so that a short kernel's time is not the host time of
    one call's wrapper. The warm call that sizes the runs is the first run
    when a run is one call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    first = start.elapsed_time(end)
    calls = max(1, min(1000, int(run_ms / max(first, 1e-3))))
    times = [first] if calls == 1 else []
    while len(times) < reps:
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
# and the SDF query of one 2^18-point chunk onto the decoded set, in fp32
# (the fine pass) and in bf16 (the coarse passes of coarse_decode_dtype).
def flash_cases(n_vertices: int):
    bf, f32 = torch.bfloat16, torch.float32
    pipelined, one_block = "actionmesh_tpu/ops/flash_attention.py:302", "actionmesh_tpu/ops/flash_attention.py:612"
    return [
        # name, (B, H, Sq, Sk, D), dtype, replaces
        ("stage1_self", (2, 16, 32784, 32784, 128), bf, pipelined),
        ("stage1_cross", (16, 16, 2049, 257, 128), bf, one_block),
        # the fp32 train step's self-attention (training's default dtype)
        ("stage1_self_f32", (2, 16, 32784, 32784, 128), f32, pipelined),
        ("dinov2_self", (16, 16, 257, 257, 64), bf, one_block),
        ("stage2_self", (5, 8, 32784, 32784, 128), bf, pipelined),
        ("stage2_vertex_cross", (5, 8, n_vertices, 32784, 128), f32, pipelined),
        ("stage0_dit_self", (2, 16, 2049, 2049, 128), bf, one_block),
        ("stage0_dit_cross", (1, 16, 2049, 257, 128), bf, one_block),
        ("stage0_vae_self", (1, 8, 2048, 2048, 128), bf, one_block),
        ("stage0_sdf_query", (1, 8, 1 << 18, 2048, 128), f32, one_block),
        ("stage0_sdf_query_coarse", (1, 8, 1 << 18, 2048, 128), bf, one_block),
        # the {video + 3D} mode's VAE encoder: 2048 FPS queries onto the
        # 16,384 surface points, then its self-attention blocks
        ("vae_encoder_cross", (1, 8, 2048, 16384, 64), bf, one_block),
        ("vae_encoder_self", (1, 8, 2048, 2048, 64), bf, one_block),
        # Stage-II decoder training at its defaults (window 8, batch 2, the
        # bucket of 4096 vertices; 14 folded targets): the self-attention
        # over 8 x 2048 + 8 = 16,392 tokens and the vertex cross, fp32
        ("stage2_train_self_f32", (14, 8, 16392, 16392, 128), f32, pipelined),
        ("stage2_train_cross_f32", (14, 8, 4096, 16392, 128), f32, pipelined),
        # the production VAE train step (batch 4, 16,384 surface points and
        # 16,384 queries a shape), fp32: encoder cross and self, decoder
        # self, the SDF query cross
        *((f"vae_train_{n}_f32", s, f32, pipelined if n == "enc_cross" else one_block)
          for n, s in VAE_TRAIN_SHAPES.items()),
        # the closed loop's head dims, zero-padded to 64 by the wrapper: its
        # tiny DINOv2 (12; 16 frames of 26 tokens), the VAE encoder's cross
        # (16; 16 queries onto 1,024 surface points a frame) and the
        # denoiser's inflated self-attention (32; 8 frames of 17 tokens, the
        # CFG pair), fp32 as the loop runs; then ragged bf16 and fp32 rows
        ("cl_dino_self_d12_f32", (16, 4, 26, 26, 12), f32, one_block),
        ("cl_vae_enc_cross_d16_f32", (16, 4, 16, 1024, 16), f32, one_block),
        ("cl_denoiser_self_d32_f32", (2, 4, 136, 136, 32), f32, one_block),
        *((f"d{d}_ragged{sfx}", (2, 4, 777, 1029, d), dt, one_block)
          for d in SMALL_HEAD_DIMS for dt, sfx in ((bf, ""), (f32, "_f32"))),
    ]


# Kernel A at the device mesh's shapes of the Stage-I self-attention (bf16):
# one ring step at sp 2 and at sp 4 (a rank's S/sp queries against one KV
# shard, with the stats the ring merges), and the tp = 2 head shard of one
# CFG branch (dp 2 holds the other)
MESH_FLASH_CASES = [
    ("stage1_self_ring_sp2", (2, 16, 16392, 16392, 128), True),
    ("stage1_self_ring_sp4", (2, 16, 8196, 8196, 128), True),
    ("stage1_self_tp2", (1, 8, 32784, 32784, 128), False),
]


def flash_cases_fp16(n_vertices: int):
    """The fp16 twin of every bf16 main-path row (``--dtype float16`` runs
    kernel A's fp16 instantiation at these shapes)."""
    return [(f"{name}_fp16", shape, torch.float16, rep)
            for name, shape, dtype, rep in flash_cases(n_vertices) if dtype == torch.bfloat16]


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


def profile_calls(calls: dict, repeat: dict | None = None) -> dict:
    """The device kernels that each call of ``calls`` (name -> function)
    launches, and their summed device time per call in ms, from one
    torch.profiler session: in this script's process a session after the
    first recorded no device kernel, so every call shares one. ``repeat``
    (name -> n) runs a call n times back to back inside its range. A call's
    kernels are those whose midpoint lies inside its ``record_function``
    range, which a synchronisation closes."""
    from torch.profiler import ProfilerActivity, profile, record_function

    repeat = repeat or {}
    for fn in calls.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, fn in calls.items():
            # an idle gap around each range: the host's and the device's
            # clocks in the trace disagree by a fraction of a millisecond,
            # enough to place a short kernel in the neighbouring range
            time.sleep(0.005)
            with record_function(name):
                for _ in range(repeat.get(name, 1)):
                    fn()
                torch.cuda.synchronize()
        time.sleep(0.005)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    # the device list holds the ranges' own annotations too: not kernels
    device = [e for e in events if e.device_type == cuda and e.name not in calls]
    out = {}
    for name in calls:
        rng = next(e.time_range for e in events if e.name == name and e.device_type != cuda)
        inside = [e for e in device if rng.start <= (e.time_range.start + e.time_range.end) / 2 <= rng.end]
        out[name] = {"kernels": sorted({e.name for e in inside}),
                     "device_ms": sum(e.time_range.elapsed_us() for e in inside) / 1e3
                     / repeat.get(name, 1)}
    return out


def sdpa_fp32_calls(n_vertices: int) -> dict:
    """SDPA at the fp32 main-path shapes (random inputs of those shapes), by
    case name, for the profiler session."""
    gen = torch.Generator(device="cuda").manual_seed(4242)
    calls = {}
    for name, (B, H, Sq, Sk, D), dtype, _ in flash_cases(n_vertices):
        if dtype == torch.float32:
            q, k, v = (heads_view(gen, B, S, H, D, dtype) for S in (Sq, Sk, Sk))
            calls[name] = lambda q=q, k=k, v=v: sdpa(q, k, v)
    return calls


def check_flash(gen, name, shape, dtype, reps=3, masked=False, stats=False,
                library_kernel_names=None) -> dict:
    """Kernel A against ``chunked_attention`` on the same inputs. ``masked``:
    a kv_mask with about a third of the keys masked at random and every key
    of the last batch entry masked; ``stats``: the (m, l) of both too (every
    fp32 row checks them). fp32 rows also give the kernel's distance from
    the plain model of its split arithmetic and SDPA's distance from the
    plain version, carry ``library_kernel_names`` (the kernels SDPA
    launches) and hold the split pre-pass's workspaces bit-equal to
    ``split_kv_reference``. A stats row's library time is SDPA's all the
    same, which gives no (m, l)."""
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
        # a head dim below 64 reaches the pre-pass zero-padded (the wrapper's
        # padding), so the pre-pass is checked on the padded k and v
        width = flash_ops.padded_head_dim(D)
        kp, vp = (flash_ops.pad_head_dim(x, width) if width != D else x for x in (k, v))
        got, want = tf32_split_kv(kp, vp), split_kv_reference(kp, vp)
        del kp, vp
        f32_extra["prepass_bit_equal"] = all(torch.equal(a, b) for a, b in zip(got, want))
        del got, want
    del out, ref
    tol = attention_tol(dtype) * scale
    ms = cuda_ms(lambda: flash_attention(q, k, v, kv_mask=kv_mask, return_stats=stats), reps)
    plain_ms = cuda_ms(lambda: chunked_attention(q, k, v, kv_mask=kv_mask, return_stats=stats), reps)
    library_ms = library_time(lambda: sdpa(q, k, v, mask4), reps, f"flash {name}")
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
    if flash_ops.padded_head_dim(D) != D:
        row["padded_to"] = flash_ops.padded_head_dim(D)  # ms includes the wrapper's padding copies
    if with_stats:
        row.update(stats_err=stats_err, stats_tol=stats_tol)
    if stats:
        row["library_note"] = "SDPA at this shape, which gives no (m, l); the row's kernel call returns them"
    return row


# Kernel A's 16-bit pipeline at its edges: key counts of one, two, three and
# many tiles, each with a ragged last tile (a tile holds 160 keys at D = 128
# and 128 at D = 64), over two query tiles with a ragged second.
FLASH_EDGE_SK = (1, 127, 128, 129, 159, 160, 161, 256, 257, 320, 321, 32784)


def phase_flash_edges() -> dict:
    """Kernel A's 16-bit path against ``chunked_attention`` at
    (2, 2, 200, Sk, D) for every Sk of FLASH_EDGE_SK, bf16 and fp16, D 64
    and 128, with and without a kv_mask (a third of the keys masked at random,
    the last batch entry's all) and with and without stats: the output within
    ``attention_tol`` of the output's largest magnitude and finite, (m, l) as
    ``check_flash`` holds them, and a fully masked row's m the plain
    version's to the bit. Checks only, nothing timed."""
    gen = torch.Generator(device="cuda").manual_seed(1236)
    worst, fails, n = {}, [], 0
    for dtype in (torch.bfloat16, torch.float16):
        for D in (128, 64):
            for Sk in FLASH_EDGE_SK:
                q = heads_view(gen, 2, 200, 2, D, dtype)
                k, v = (heads_view(gen, 2, Sk, 2, D, dtype) for _ in range(2))
                for masked in (False, True):
                    kv_mask = None
                    if masked:
                        kv_mask = torch.rand((2, Sk), generator=gen, device="cuda") > 0.3
                        kv_mask[-1] = False
                    ref, (m_ref, l_ref) = chunked_attention(q, k, v, kv_mask=kv_mask, return_stats=True)
                    tol = attention_tol(dtype) * ref.float().abs().max().item()
                    m_tol = 1e-4 * max(1.0, m_ref.abs().max().item())
                    for stats in (False, True):
                        out = flash_attention(q, k, v, kv_mask=kv_mask, return_stats=stats)
                        case = f"{str(dtype)[6:]} D={D} Sk={Sk}" + " kv_mask" * masked + " stats" * stats
                        errs = {}
                        if stats:
                            out, (m, l) = out
                            errs = {"m": (m - m_ref).abs().max().item(),
                                    "l_rel": ((l - l_ref).abs() / l_ref).max().item()}
                            if errs["m"] > m_tol or errs["l_rel"] > 1e-4:
                                fails.append(f"{case}: stats {errs}")
                            if masked and not torch.equal(m[-1], m_ref[-1]):
                                fails.append(f"{case}: a fully masked row's m differs")
                        errs["out"] = (out.float() - ref.float()).abs().max().item() / tol
                        if not (errs["out"] <= 1 and bool(torch.isfinite(out).all())):
                            fails.append(f"{case}: max abs err {errs['out']:.3f} of the tolerance, or not finite")
                        for key, e in errs.items():
                            worst[key] = max(worst.get(key, 0.0), e)
                        n += 1
    log(f"flash edges: {n} cases, {len(fails)} failed; worst: output {worst['out']:.3f} of its "
        f"tolerance, m {worst['m']:.3e}, l {worst['l_rel']:.3e} relative")
    if fails:
        raise AssertionError("flash edges:\n" + "\n".join(fails))
    return {"cases": n, "sk": list(FLASH_EDGE_SK), "worst_err_over_tol": worst["out"],
            "worst_m": worst["m"], "worst_l_rel": worst["l_rel"]}


def rope_tables(gen, B, S, D, tables):
    """Half-layout tables of ``tables`` batches (0: one (S, D) table) from
    positions that repeat per 2049-token frame, or (None, None)."""
    if tables is None:
        return None, None
    pos = torch.rand((max(tables, 1), S // 2049 + 1), generator=gen, device="cuda") * 15
    pos = pos.repeat_interleave(2049, dim=1)[:, :S]
    cs = [compute_rotary_embeddings(D, p) for p in pos]
    cos = torch.stack([c for c, _ in cs]).contiguous()
    sin = torch.stack([s for _, s in cs]).contiguous()
    return (cos[0], sin[0]) if tables == 0 else (cos, sin)


# Kernel B's forward rows: the main paths' shapes (the first, the kernels
# line's head, is the shape of most of B's launches on the inference path:
# Stage 0's DiT self-attention q and k; the Stage-I self q/k also in fp32,
# the fp32 train step's), then an fp32 row with a ragged S, D = 64 and
# per-batch tables.
ROPE_CASES = [
    # name, (B, H, S, D), norm, tables (None, 0: (S, D), n: (n, S, D)), dtype
    ("stage0_dit_self_qk", (2, 16, 2049, 128), True, None, torch.bfloat16),
    ("stage0_dit_cross_k", (1, 16, 257, 128), True, None, torch.bfloat16),
    ("stage1_self_qk", (2, 16, 32784, 128), True, 2, torch.bfloat16),
    ("stage1_self_qk_f32", (2, 16, 32784, 128), True, 2, torch.float32),
    ("stage1_cross_q", (16, 16, 2049, 128), True, None, torch.bfloat16),
    ("stage1_cross_k", (16, 16, 257, 128), True, None, torch.bfloat16),
    ("stage2_self_qk", (5, 8, 32784, 128), False, 0, torch.bfloat16),
    ("ragged_f32_d64", (2, 4, 1001, 64), True, 2, torch.float32),
    ("stage0_dit_self_qk_fp16", (2, 16, 2049, 128), True, None, torch.float16),
    # the fp32 trainers' new forms: the decoder's rotation alone with one
    # table per folded target (14), the Stage-0 DiT's norm alone
    ("stage2_train_qk_f32", (14, 8, 16392, 128), False, 14, torch.float32),
    ("stage0_dit_self_qk_f32", (2, 16, 2049, 128), True, None, torch.float32),
    # the closed loop's three forms at its head dim 32 (denoiser: norm and
    # rotation; decoder: rotation; DiT: norm) and at 12 and 16, in bf16 and
    # fp32, at the denoiser's train q/k shape (batch 16, 8 frames of 17 tokens)
    *((f"cl_{form}_d{d}{sfx}", (16, 4, 136, d), norm, tables, dt)
      for d in (32,) + tuple(x for x in SMALL_HEAD_DIMS if x != 32)
      for form, norm, tables in CLOSED_LOOP_ROPE_FORMS
      for dt, sfx in ((torch.float32, "_f32"), (torch.bfloat16, ""))),
]
ROPE_PROFILE_CALLS = 20  # back-to-back calls a row in the profiler session


def rope_inputs(gen, shape, norm, tables, dtype):
    B, H, S, D = shape
    x = heads_view(gen, B, S, H, D, dtype)
    scale = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")) if norm else None
    cos, sin = rope_tables(gen, B, S, D, tables)
    return x, scale, cos, sin


def rope_bytes(x, *others) -> int:
    """x read and the output written once, the scale and tables read once."""
    return 2 * x.numel() * x.element_size() + sum(t.numel() * 4 for t in others if t is not None)


def check_rms_rope(name, shape, norm, tables, dtype, inputs, device_ms, reps=5) -> dict:
    x, scale, cos, sin = inputs
    B, H, S, D = shape
    out = fused_rms_rope(x, scale, cos, sin)
    ref = rms_rope_reference(x, scale, cos, sin)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    # bf16 (fp16): one bf16 (fp16) ulp of the output, plus fp32 rounding at
    # the tensor's scale: x*cos - rot*sin cancels, so a small output carries
    # the fp32 error of its large terms, which fused multiply-adds round
    # differently. fp32: 2^-20 of the value and of the largest (rsqrt and the
    # products round in another order).
    ref_abs = ref.float().abs()
    if dtype == torch.float32:
        ulp = 2.0**-20 * ref_abs
    else:
        mantissa = 7 if dtype == torch.bfloat16 else 10
        ulp = torch.exp2(torch.floor(torch.log2(ref_abs.clamp_min(1e-30))) - mantissa)
    tol = ulp + 2.0**-20 * ref_abs.max()
    bad = int((diff > tol).sum())
    n_ulp = int((diff > ulp).sum())
    err = diff.max().item()
    del out, ref, diff, ref_abs, ulp, tol
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
            lib_err = (lib_out.float() - rms_rope_reference(x, scale, cos, sin).float()).abs().max().item()
            del lib_out
            library_ms = library_time(
                lambda: torch.nn.functional.rms_norm(x, (D,), scale, eps=1e-6), reps,
                f"rms_rope {name}")
    nbytes = rope_bytes(x, scale, cos, sin)
    gbs = nbytes / (ms * 1e-3) / 1e9
    # about 10 fp32 operations an element
    bnd = bound(10 * x.numel(), FP32_FLOPS, nbytes)
    dt = str(dtype)[6:]
    log(f"rms_rope {name} {shape} {dt} norm={norm} tables={tables}: max_abs_err "
        f"{err:.3e}, {n_ulp} elements above 1 {'2^-20 rel' if dtype == torch.float32 else 'ulp'}, "
        f"{bad} above the tolerance | kernel {ms:.4f} ms per call, device {device_ms:.4f} ms "
        f"({gbs:.0f} GB/s; {100 * bnd['bound_ms'] / device_ms:.0f}% of the bound on device time) | "
        f"plain {plain_ms:.3f} ms | rms_norm {library_ms} ms "
        f"(max abs diff from the plain version {lib_err}) | bound "
        f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})")
    if bad:
        raise AssertionError(f"rms_rope {name}: {bad} elements above the tolerance")
    return {"name": name, "shape": list(shape), "dtype": dt, "max_abs_err": err,
            "tol": "1 ulp of the dtype (bf16, fp16) + 2^-20 max|ref| "
                   "(fp32: 2^-20 |ref| + 2^-20 max|ref|)",
            "above_1_ulp": n_ulp, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_max_abs_diff": lib_err, **bnd,
            "bound_share_device": bnd["bound_ms"] / device_ms}


def phase_kernels(n_vertices: int) -> tuple[list, list]:
    """Kernels A and B at the main paths' shapes; ``n_vertices`` is the
    anchor mesh's vertex count (the queries of Stage II's vertex cross)."""
    # one profiler session (the process's first): the kernels SDPA launches
    # at the fp32 shapes, and kernel B's forward device time at its rows
    gen = torch.Generator(device="cuda").manual_seed(1235)
    rope_in = {c[0]: rope_inputs(gen, *c[1:]) for c in ROPE_CASES}
    calls = sdpa_fp32_calls(n_vertices)
    sdpa_names = list(calls)
    for name, args in rope_in.items():
        calls[f"rms_rope {name}"] = lambda a=args: fused_rms_rope(*a)
    prof = profile_calls(calls, {f"rms_rope {n}": ROPE_PROFILE_CALLS for n in rope_in})
    sdpa_names = {n: prof[n]["kernels"] for n in sdpa_names}
    for name, kernels in sdpa_names.items():
        log(f"sdpa fp32 {name}: launches {kernels}")
    del calls
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(1234)
    flash = []
    for n, s, d, rep in flash_cases(n_vertices) + flash_cases_fp16(n_vertices):
        flash.append(dict(check_flash(gen, n, s, d, library_kernel_names=sdpa_names.get(n)),
                          replaces=rep))
        torch.cuda.empty_cache()
    # the contract's edges, bf16 and fp16: a kv_mask over a ragged Sk, the
    # training cross shape with stats, and D = 64 with ragged Sq and Sk
    one_block = "actionmesh_tpu/ops/flash_attention.py:612"
    for dtype, suffix in ((torch.bfloat16, ""), (torch.float16, "_fp16")):
        flash.append(dict(check_flash(gen, "kv_mask" + suffix, (3, 8, 1000, 1333, 128), dtype,
                                      masked=True), replaces=one_block))
        flash.append(dict(check_flash(gen, "stats" + suffix, (32, 16, 2049, 257, 128), dtype,
                                      stats=True), replaces=one_block))
        flash.append(dict(check_flash(gen, "d64_ragged" + suffix, (2, 4, 777, 1029, 64), dtype),
                          replaces=one_block))
        torch.cuda.empty_cache()
    for name, shape, stats in MESH_FLASH_CASES:
        flash.append(dict(check_flash(gen, name, shape, torch.bfloat16, stats=stats),
                          replaces="actionmesh_tpu/ops/flash_attention.py:302"))
        torch.cuda.empty_cache()
    rope = []
    for name, shape, norm, tables, dtype in ROPE_CASES:
        kernels = prof[f"rms_rope {name}"]["kernels"]
        if len(kernels) != 1 or "rms_rope_fwd_kernel" not in kernels[0]:
            raise AssertionError(f"rms_rope {name}: the profiler saw {kernels}")
        rope.append(check_rms_rope(name, shape, norm, tables, dtype, rope_in.pop(name),
                                   prof[f"rms_rope {name}"]["device_ms"]))
    return flash, rope


# Hunyuan3D-2.1's Stage 0 (models/hunyuan3d/): the DiT over 4,097 tokens
# (2 CFG branches self, the conditional one cross to DINOv2-L at 518^2:
# 1,370 tokens), its VAE decoder over 4,096 latents with 16 heads of 64,
# and one 2^18-point SDF query chunk onto them, fp32 (the fine pass) and
# bf16 (the coarse passes)
HUNYUAN_FLASH_CASES = [
    ("hunyuan_dit_self", (2, 16, 4097, 4097, 128), torch.bfloat16),
    ("hunyuan_dit_cross", (1, 16, 4097, 1370, 128), torch.bfloat16),
    ("hunyuan_vae_self", (1, 16, 4096, 4096, 64), torch.bfloat16),
    ("hunyuan_sdf_query", (1, 16, 1 << 18, 4096, 64), torch.float32),
    ("hunyuan_sdf_query_coarse", (1, 16, 1 << 18, 4096, 64), torch.bfloat16),
]


def check_moe(gen) -> dict:
    """The sparse-expert feed-forward at the DiT's shape (2 CFG branches x
    4,097 tokens, width 2,048, 8 experts of 8,192, top 2, bf16): its two
    grouped products over the routed rows against a loop of ``F.linear``
    over the experts (host sizes, the plain way), each timed, and the
    whole layer (router, permutation, the products, the shared expert).
    Bound of the products: 2 rows x 2 x 2048 x 8192 FLOPs at the bf16 peak
    against the bytes of the 9 experts' weights; of the layer: the shared
    expert's products added."""
    from actionmesh_tpu_torch.models.layers import (
        grouped_linear,
        init_moe_feed_forward,
        moe_dispatch,
        moe_feed_forward,
        moe_route,
    )

    W, Fi, E, k, n = 2048, 8192, 8, 2, 2 * 4097
    params = init_moe_feed_forward(torch.Generator(device="cuda").manual_seed(7), W, Fi, E,
                                   torch.bfloat16, torch.device("cuda"))
    h = torch.randn((n, W), generator=gen, device="cuda").to(torch.bfloat16)
    _, _, experts = moe_route(params["gate"]["weight"], h, k)
    order, eid, counts, offsets = moe_dispatch(experts, E)
    rows = h[order // k]
    net0, net2 = params["experts"]["net_0"], params["experts"]["net_2"]
    hid = F.gelu(grouped_linear(rows, net0, offsets, eid))
    sizes = counts.tolist()

    def loop(x, net):
        outs, a = [], 0
        for e, c in enumerate(sizes):
            outs.append(F.linear(x[a:a + c], net["weight"][e], net["bias"][e]))
            a += c
        return torch.cat(outs)

    errs = {}
    for name, x, net in (("net_0", rows, net0), ("net_2", hid, net2)):
        got, want = grouped_linear(x, net, offsets, eid), loop(x, net)
        # bf16 products summed in another order: within a bf16 rounding of the largest value
        errs[name] = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
                      "tol": 2 ** -7 * want.float().abs().max().item()}
        if not errs[name]["max_abs_err"] <= errs[name]["tol"]:
            raise AssertionError(f"grouped {name}: {errs[name]}")
    ms = cuda_ms(lambda: (grouped_linear(rows, net0, offsets, eid), grouped_linear(hid, net2, offsets, eid)), 5)
    loop_ms = cuda_ms(lambda: (loop(rows, net0), loop(hid, net2)), 5)
    layer_ms = cuda_ms(lambda: moe_feed_forward(params, h, k), 5)
    m = n * k
    flop = 2.0 * m * 2 * W * Fi
    nbytes = (E + 1) * 2 * W * Fi * 2
    bnd = bound(flop, BF16_FLOPS, nbytes)
    layer_bnd = bound(flop + 2.0 * n * 2 * W * Fi, BF16_FLOPS, nbytes)
    row = {"name": "moe_grouped", "rows": m, "routed_rows_per_expert": sizes, "ms": ms,
           "loop_ms": loop_ms, "tflops": flop / ms / 1e9, **bnd,
           "bound_share": bnd["bound_ms"] / ms, "layer_ms": layer_ms,
           "layer_bound_ms": layer_bnd["bound_ms"], "layer_bound_share": layer_bnd["bound_ms"] / layer_ms,
           "errors": errs}
    log(f"moe grouped products ({m} routed rows, {sizes}): {ms:.3f} ms ({row['tflops']:.1f} TFLOP/s, "
        f"{100 * row['bound_share']:.1f}% of the bound {bnd['bound_ms']:.3f} ms, {bnd['bound_by']}) | "
        f"loop over experts {loop_ms:.3f} ms | whole layer {layer_ms:.3f} ms "
        f"({100 * row['layer_bound_share']:.1f}% of {layer_bnd['bound_ms']:.3f} ms) | {errs}")
    return row


def hunyuan_dit_step() -> dict:
    """One CFG step of Hunyuan3D-2.1's DiT at its published widths (random
    weights): no host synchronisation inside it
    (``torch.cuda.set_sync_debug_mode("error")`` raises on one), and its
    time against 33.73 TFLOP at the bf16 peak (``portbench/work/hunyuan3d21.py``)."""
    from actionmesh_tpu_torch.models.hunyuan3d.dit import hunyuan3d_dit_config
    from actionmesh_tpu_torch.models.triposg.dit import init_triposg_dit, triposg_dit_forward

    cfg = hunyuan3d_dit_config()
    params = init_triposg_dit(torch.Generator(device="cuda").manual_seed(3), cfg, torch.bfloat16,
                              torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((1, 4096, 64), generator=gen, device="cuda").to(torch.bfloat16)
    ctx = torch.randn((1, 1370, 1024), generator=gen, device="cuda").to(torch.bfloat16)
    lat, cx = torch.cat([x, x]), torch.cat([torch.zeros_like(ctx), ctx])
    t = torch.full((2,), 0.5, device="cuda")

    def step():
        return triposg_dit_forward(params, cfg, lat, cx, t, uncond_batch=1)

    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    finite = bool(torch.isfinite(out).all())
    ms = cuda_ms(step, 3)
    flop = 33.72663488512e12
    row = {"sync_free": True, "finite": finite, "ms": ms, "tflops": flop / ms / 1e9,
           "mfu": flop / ms / 1e9 / (BF16_FLOPS / 1e12)}
    log(f"hunyuan DiT step (CFG, bf16): no host synchronisation; {ms:.2f} ms, "
        f"{row['tflops']:.1f} TFLOP/s ({100 * row['mfu']:.1f}% of the bf16 peak)")
    if not finite:
        raise AssertionError("hunyuan DiT step: non-finite output")
    return row


def hunyuan_stage0_launches(steps: int = 50) -> dict:
    """One Stage-0 call of Hunyuan3D-2.1 at its published widths (random
    weights, ``models/stage0.py:DevHunyuan3D``; ``steps`` CFG steps and the
    fast preset's decode, as the benchmark's ``hunyuan3d21_fast`` runs it)
    with the launch counters zeroed just before it: what its path launches.
    Kernel B runs only in the DiT (per-head rms-norm on q and k of both
    attentions: 4 a block-step); the ShapeVAE's qk-norm is a layer norm."""
    from actionmesh_tpu_torch.models.stage0 import DevHunyuan3D

    s0 = DevHunyuan3D(torch.device("cuda"), (2048, 64), dtype=torch.bfloat16, seed=5)
    pipe = s0.pipeline  # built outside the count
    rgba = make_frames()[0]
    image = np.where(rgba[..., 3:] > 0, rgba[..., :3], 255).astype(np.uint8)
    reset_counters()
    s0(image, seed=3, num_inference_steps=steps, guidance_scale=5.0, prefilter_octree_depth=6)
    torch.cuda.synchronize()
    launches = read_counters()
    blocks = pipe.dit_cfg.num_layers
    dit_flash = 2 * blocks * steps  # self (both CFG branches in one launch) and cross (the conditional one)
    row = {"steps": steps, "launches": launches, "dit_flash_fwd": dit_flash,
           "chunks": pipe.extract_stats, "seconds": pipe.phase_seconds}
    log(f"hunyuan Stage 0 ({steps} steps): launches {launches} (the DiT's kernel A {dit_flash}); "
        f"chunks {pipe.extract_stats}")
    if launches["fused_rms_rope"] != 4 * blocks * steps or launches["flash_fwd"] <= dit_flash:
        raise AssertionError(f"hunyuan Stage 0 launches {launches}")
    return row


def phase_hunyuan3d() -> dict:
    """Hunyuan3D-2.1's Stage 0: kernel A at its five rows, the grouped
    expert products, one DiT step with no host synchronisation and the
    launches of one Stage-0 call."""
    gen = torch.Generator(device="cuda").manual_seed(2201)
    one_block = "actionmesh_tpu/ops/flash_attention.py:612"
    flash = []
    for name, shape, dtype in HUNYUAN_FLASH_CASES:
        flash.append(dict(check_flash(gen, name, shape, dtype), replaces=one_block))
        torch.cuda.empty_cache()
    moe = check_moe(gen)
    torch.cuda.empty_cache()
    step = hunyuan_dit_step()
    torch.cuda.empty_cache()
    stage0 = hunyuan_stage0_launches()
    torch.cuda.empty_cache()
    return {"flash": flash, "moe": moe, "dit_step": step, "stage0": stage0}


# Kernel F: the Stage-I self shape with interleaved tables from centred
# timesteps (16 frames of 2049 tokens), a ragged small fp32 shape and a
# head-dim-64 shape. One call launches the pre-pass and kernel A's mainloop.
FUSED_CASES = [
    ("stage1_self", (2, 16, 32784, 128), torch.bfloat16),
    ("ragged_f32", (1, 2, 300, 128), torch.float32),
    ("d64", (2, 4, 777, 64), torch.bfloat16),
    ("fp16", (2, 4, 777, 128), torch.float16),
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
    tol = attention_tol(dtype) * ref.float().abs().max().item()
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
# (32 frames onto 257 DINOv2 tokens), both head dim 128, in bf16 and in
# fp32 (the default training dtype); plus small ragged D=128 and D=64
# shapes, so every instantiation runs, and the tiles' edges: 129 queries
# leave one row in the last query tile (bf16: 64 rows in C, 128 in D; fp32:
# 32-row steps in C, 128 rows in D), 385 keys one key in the last 128-key
# tile (bf16 D's step, fp32 C's tile) and in the last 32-key step of fp32 D.
BWD_CASES = [
    ("stage1_self", (2, 16, 32784, 32784, 128), torch.bfloat16),
    ("stage1_cross", (32, 16, 2049, 257, 128), torch.bfloat16),
    ("stage1_self_f32", (2, 16, 32784, 32784, 128), torch.float32),
    ("stage1_cross_f32", (32, 16, 2049, 257, 128), torch.float32),
    ("small_f32", (2, 4, 1000, 1100, 128), torch.float32),
    ("small_d64", (2, 4, 777, 1029, 64), torch.bfloat16),
    ("small_d64_f32", (2, 4, 777, 1029, 64), torch.float32),
    ("edge_d128", (1, 2, 129, 385, 128), torch.bfloat16),
    ("edge_d64", (1, 2, 129, 385, 64), torch.bfloat16),
    ("edge_d128_f32", (1, 2, 129, 385, 128), torch.float32),
    ("edge_d64_f32", (1, 2, 129, 385, 64), torch.float32),
    # Stage-II decoder training (fp32, its default): self over 16,392 tokens
    # (the last 128-key tile holds 8 keys) and the vertex cross; the Stage-0
    # DiT's training shapes, self and cross onto 257 DINOv2 tokens, in fp32
    # (--model stage0's default) and bf16
    ("stage2_train_self_f32", (14, 8, 16392, 16392, 128), torch.float32),
    ("stage2_train_cross_f32", (14, 8, 4096, 16392, 128), torch.float32),
    ("dit_self_f32", (2, 16, 2049, 2049, 128), torch.float32),
    ("dit_cross_f32", (2, 16, 2049, 257, 128), torch.float32),
    ("dit_self", (2, 16, 2049, 2049, 128), torch.bfloat16),
    ("dit_cross", (2, 16, 2049, 257, 128), torch.bfloat16),
    # the production VAE train step's four shapes (VAE_TRAIN_SHAPES), fp32
    ("vae_train_enc_cross_f32", (4, 8, 2048, 16384, 64), torch.float32),
    ("vae_train_enc_self_f32", (4, 8, 2048, 2048, 64), torch.float32),
    ("vae_train_dec_self_f32", (4, 8, 2048, 2048, 128), torch.float32),
    ("vae_train_query_f32", (4, 8, 16384, 2048, 128), torch.float32),
]
# The closed loop's head dims, zero-padded to 64 by the wrapper (kept apart
# from BWD_CASES, whose shapes bwd_times.py hands the kernels unpadded): the
# denoiser's train self-attention (batch 16, 8 frames of 17 tokens) in fp32,
# the VAE encoder's cross in fp32, and the tiles' edges in bf16 and fp32.
PADDED_BWD_CASES = [
    ("cl_denoiser_train_self_d32_f32", (16, 4, 136, 136, 32), torch.float32),
    ("cl_vae_enc_cross_d16_f32", (2, 4, 16, 1024, 16), torch.float32),
    ("edge_d12", (1, 2, 129, 385, 12), torch.bfloat16),
    ("edge_d12_f32", (1, 2, 129, 385, 12), torch.float32),
    ("edge_d16", (1, 2, 129, 385, 16), torch.bfloat16),
    ("edge_d16_f32", (1, 2, 129, 385, 16), torch.float32),
    ("edge_d32", (1, 2, 129, 385, 32), torch.bfloat16),
    ("edge_d32_f32", (1, 2, 129, 385, 32), torch.float32),
]
BWD_DETERMINISM = ("stage1_cross", "small_d64", "stage1_cross_f32", "small_d64_f32")


def check_flash_bwd(gen, name, shape, dtype) -> dict:
    """Kernels C and D against the plain backward (chunked_attention_
    trainable's), from the same q, k, v, o, m, l and dO; for the
    BWD_DETERMINISM shapes a second call must give bit-equal gradients."""
    B, H, Sq, Sk, D = shape
    f32 = dtype == torch.float32
    reps = 1 if f32 and B * H * Sq * Sk * D > 1e12 else 2  # a Stage-I self fp32 call is seconds of plain work
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
    # C and D timed alone on what the wrapper hands them: a head dim below
    # 64 zero-padded to 64 (the padding copies are the wrapper's, not timed)
    width = flash_ops.padded_head_dim(D)
    qt, kt, vt, dot = (flash_ops.pad_head_dim(x, width) if width != D else x for x in (q, k, v, do))
    dq, dk, dv = (torch.empty_like(x) for x in (qt, kt, vt))
    ms_c = cuda_ms(lambda: launch_bwd_kernels(qt, kt, vt, dot, lse, delta, dq, dk, dv, scale, ("dkv",)), reps)
    ms_d = cuda_ms(lambda: launch_bwd_kernels(qt, kt, vt, dot, lse, delta, dq, dk, dv, scale, ("dq",)), reps)
    del qt, kt, vt, dot, dq, dk, dv
    plain_ms = cuda_ms(lambda: attention_bwd_reference(q, k, v, o, m, l, do), reps)

    def sdpa_fwd_bwd():
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        return torch.autograd.grad(sdpa(qg, kg, vg), (qg, kg, vg), do)

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
    share_c, share_d = bnd_c["bound_ms"] / ms_c, bnd_d["bound_ms"] / ms_d
    vs_bwd = (ms_c + ms_d) / library_bwd_ms if library_bwd_ms else None
    log(f"flash_bwd {name} q{(B, H, Sq, D)} k{(B, H, Sk, D)} {str(dtype)[6:]}: max_abs_err "
        + ", ".join(f"{n} {errs[n]:.3e} (tol {tols[n]:.3e})" for n in errs)
        + f" | kernel C {ms_c:.3f} ms ({tf_c:.1f} TFLOP/s, bound {bnd_c['bound_ms']:.3f}, "
        f"{100 * share_c:.1f}%), kernel D {ms_d:.3f} ms ({tf_d:.1f} TFLOP/s, bound "
        f"{bnd_d['bound_ms']:.3f}, {100 * share_d:.1f}%) | plain "
        f"(dq, dk, dv together) {plain_ms:.3f} ms | sdpa forward + backward {library_ms} ms, "
        f"backward alone {library_bwd_ms} ms (C + D {vs_bwd if vs_bwd is None else round(vs_bwd, 3)}x)"
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
            "tflops_dq": tf_d, "bound_dkv": bnd_c, "bound_dq": bnd_d, "bound_share_dkv": share_c,
            "bound_share_dq": share_d, "vs_library_bwd": vs_bwd,
            **({"padded_to": width} if width != D else {})}


# Kernel B's backward: the Stage-I training shapes (self q/k with per-batch
# tables, in bf16 and fp32; cross q with the norm only), then small edge
# cases: D = 64 with a ragged S in fp32, the rotation alone, one (S, D)
# table, fp16 with (cb, S, D) tables; the edge cases also ask for the
# tables' gradients.
ROPE_BWD_CASES = [
    # name, (B, H, S, D), norm, tables, dtype, table grads
    ("stage1_self_qk", (2, 16, 32784, 128), True, 2, torch.bfloat16, False),
    ("stage1_self_qk_f32", (2, 16, 32784, 128), True, 2, torch.float32, False),
    ("stage1_cross_q", (32, 16, 2049, 128), True, None, torch.bfloat16, False),
    ("d64_ragged_f32", (2, 3, 333, 64), True, 2, torch.float32, True),
    ("rope_only", (2, 4, 300, 128), False, 0, torch.bfloat16, True),
    ("shared_table", (3, 4, 257, 128), True, 0, torch.bfloat16, True),
    ("tables_fp16_d64", (2, 2, 129, 64), True, 2, torch.float16, True),
    # the decoder's rotation alone (no scale, no dscale) with 14 per-target
    # tables, and the Stage-0 DiT's norm alone, in fp32 and bf16
    ("stage2_train_qk_rot_f32", (14, 8, 16392, 128), False, 14, torch.float32, False),
    ("dit_qk_norm_f32", (2, 16, 2049, 128), True, None, torch.float32, False),
    ("dit_qk_norm", (2, 16, 2049, 128), True, None, torch.bfloat16, False),
    # the closed loop's three forms at head dims 32, 12 and 16, bf16 and fp32
    # (the rotation forms also with the tables' gradients at D = 12)
    *((f"cl_{form}_d{d}{sfx}", (16, 4, 136, d), norm, tables, dt, d == 12 and tables is not None)
      for d in (32,) + tuple(x for x in SMALL_HEAD_DIMS if x != 32)
      for form, norm, tables in CLOSED_LOOP_ROPE_FORMS
      for dt, sfx in ((torch.float32, "_f32"), (torch.bfloat16, ""))),
]
# the rows timed (the training paths' shapes); the edge cases are checks only
ROPE_BWD_TIMED = ("stage1_self_qk", "stage1_self_qk_f32", "stage1_cross_q", "stage2_train_qk_rot_f32",
                  "dit_qk_norm_f32", "dit_qk_norm", "cl_norm_rope_d32_f32", "cl_rope_d32_f32",
                  "cl_norm_d32_f32")


def check_rms_rope_bwd(gen, name, shape, norm, tables, dtype, table_grads, reps=3) -> dict:
    """Kernel B's backward kernel against ``rms_rope_backward_reference``
    and against autograd of the plain composition, from the same x, scale,
    tables and g; two calls must give a bit-equal dscale. Times the
    backward alone and forward + backward through the autograd.Function,
    each beside the plain version's and its bound; at the cross q shape
    (no tables) also rms_norm's forward + backward."""
    B, H, S, D = shape
    x = heads_view(gen, B, S, H, D, dtype)
    scale = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")) if norm else None
    cos, sin = rope_tables(gen, B, S, D, tables)
    g = heads_view(gen, B, S, H, D, dtype)
    eps = 1e-6
    before = fused_rms_rope.bwd_launches
    got = rope_norm._rms_rope_backward(x, scale, cos, sin, g, eps, table_grads)
    again = rope_norm._rms_rope_backward(x, scale, cos, sin, g, eps, table_grads)
    deterministic = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
    del again
    ref = rms_rope_backward_reference(x, scale, cos, sin, g, eps, table_grads)
    # autograd of the plain composition, in every differentiable input asked for
    leaves_ = [x.detach().requires_grad_()]
    for t, need in ((scale, norm), (cos, table_grads), (sin, table_grads)):
        leaves_.append(t.detach().requires_grad_() if t is not None and need else t)
    wrt = [t for t in leaves_ if t is not None and t.requires_grad]
    auto = iter(torch.autograd.grad(rms_rope_reference(*leaves_, eps), wrt, g))
    auto = [next(auto) if t is not None and t.requires_grad else None for t in leaves_]
    torch.cuda.synchronize()
    names = ("dx", "dscale", "dcos", "dsin")
    # dx: one rounding to the input dtype plus fp32 sums in another order
    # (2^-7 of the largest); dscale, dcos, dsin: fp32 sums over up to 1e6
    # rows in another order (1e-4 of the largest)
    rel = {"dx": 2.0**-7, "dscale": 1e-4, "dcos": 1e-4, "dsin": 1e-4}
    errs, tols = {}, {}
    for n, a, r, au in zip(names, got, ref, auto):
        if a is None:
            continue
        scale_ref = r.float().abs().max().item()
        errs[n] = max((a.float() - r.float()).abs().max().item(), (a.float() - au.float()).abs().max().item())
        tols[n] = rel[n] * scale_ref
    if (got[1] is not None) != norm or (got[2] is not None) != (table_grads and tables is not None):
        raise AssertionError(f"rms_rope backward {name}: gradients {[t is not None for t in got]}")
    del got, ref, auto
    launches = fused_rms_rope.bwd_launches - before
    row = {"name": name, "shape": list(shape), "dtype": str(dtype)[6:], "max_abs_err": max(errs.values()),
           "errors": errs, "tol": tols, "deterministic": deterministic, "launches": launches}
    line = (f"rms_rope backward {name} {shape} {row['dtype']} norm={norm} tables={tables}: max_abs_err "
            + ", ".join(f"{n} {errs[n]:.3e} (tol {tols[n]:.3e})" for n in errs)
            + f" | two calls bit-equal {deterministic}")
    if name in ROPE_BWD_TIMED:
        xs = x.detach().requires_grad_()
        ss = None if scale is None else scale.detach().requires_grad_()
        wrt_fb = (xs,) if ss is None else (xs, ss)

        def fwd_bwd(fn):
            return torch.autograd.grad(fn(xs, ss, cos, sin), wrt_fb, g)

        # runs of ~5 ms: a forward + backward through autograd is ~0.1 ms of
        # host work a call, which a run of one call would time
        ms = cuda_ms(lambda: rope_norm._rms_rope_backward(x, scale, cos, sin, g, eps, False), reps, 5.0)
        ms_fb = cuda_ms(lambda: fwd_bwd(fused_rms_rope), reps, 5.0)
        plain_ms = cuda_ms(lambda: rms_rope_backward_reference(x, scale, cos, sin, g, eps, False), reps, 5.0)
        plain_fb_ms = cuda_ms(lambda: fwd_bwd(rms_rope_reference), reps, 5.0)
        library_ms = None
        if norm and tables is None:  # rms_norm's forward + backward computes the same
            with warnings.catch_warnings():
                warnings.filterwarnings("ignore", "Mismatch dtype between input and weight")
                library_ms = cuda_ms(
                    lambda: fwd_bwd(lambda a, w, c, s_: torch.nn.functional.rms_norm(a, (D,), w, eps=eps)),
                    reps, 5.0)
        # backward: x and g read, dx written, the scale and tables read and
        # dscale written (the rotation alone is linear: its dx needs g and
        # the tables, not x); forward + backward adds x read and y written
        nbytes = rope_bytes(x, scale, cos, sin, scale) + g.numel() * g.element_size()
        if not norm:
            nbytes -= x.numel() * x.element_size()
        bnd = bound(30 * x.numel(), FP32_FLOPS, nbytes)
        bnd_fb = bound(40 * x.numel(), FP32_FLOPS, nbytes + rope_bytes(x, scale, cos, sin))
        row.update(ms=ms, plain_ms=plain_ms, fwd_bwd_ms=ms_fb, plain_fwd_bwd_ms=plain_fb_ms,
                   library_ms=library_ms, **bnd, fwd_bwd_bound_ms=bnd_fb["bound_ms"])
        line += (f" | backward kernel {ms:.3f} ms (bound {bnd['bound_ms']:.3f}, {bnd['bound_by']}), plain "
                 f"{plain_ms:.3f} ms | forward + backward {ms_fb:.3f} ms (bound {bnd_fb['bound_ms']:.3f}), "
                 f"plain {plain_fb_ms:.3f} ms, rms_norm {library_ms} ms")
    log(line)
    bad = [n for n in errs if not errs[n] <= tols[n]]
    if bad:
        raise AssertionError(f"rms_rope backward {name}: {bad} above tolerance: {errs} vs {tols}")
    if not deterministic:
        raise AssertionError(f"rms_rope backward {name}: two calls gave different gradients")
    if launches != 2:
        raise AssertionError(f"rms_rope backward {name}: {launches} counted launches for 2 calls")
    return row


def phase_backward() -> tuple[list, list]:
    gen = torch.Generator(device="cuda").manual_seed(4321)
    bwd = []
    for n, s, d in BWD_CASES + PADDED_BWD_CASES:
        bwd.append(check_flash_bwd(gen, n, s, d))
        torch.cuda.empty_cache()
    rope = [check_rms_rope_bwd(gen, *case) for case in ROPE_BWD_CASES]
    torch.cuda.empty_cache()
    return bwd, rope


# Kernel E: an index differing from the plain version's is accepted only
# where the float64 squared distances of the two picks agree within
# NN_TIE_REL * (|x|^2 + max |y_pick|^2), the scale of the fp32 terms that
# both sum in their own order (the plain version by an fp32 matrix product
# with |x|^2, the kernel by split TF32 products without it).
NN_TIE_REL = 1e-6
ICP_POINTS, ICP_INITS, ICP_FRAMES = 10_000, 24, 16
NN_FMA_MS = 10.3  # kernel E's fp32-FMA design at the ICP shape (10.251-10.444 ms, H100 80GB HBM3, 700 W)
NN_OP_RATE = FP32_FLOPS / 2  # CUDA-core operations a second (an FMA is 2 flop)


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


def nn_argmin_cuda_core(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Kernel E's yardstick (the CUDA-core design) on CUDA tensors, with
    kernel E's padding of C to 3 or 8; (R, N) int32."""
    lib = cuda_build.load_library(NN_YARDSTICK)
    C = x.shape[2]
    cp = kernel_channels(C)
    x = torch.nn.functional.pad(x.float(), (0, cp - C)).contiguous()
    y = torch.nn.functional.pad(y.float(), (0, cp - C)).contiguous()
    out = torch.empty(x.shape[:2], dtype=torch.int32, device=x.device)
    err = lib.nn_argmin_cuda_core(
        ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        x.shape[0], x.shape[1], y.shape[1], cp, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"{NN_YARDSTICK} launch failed: CUDA error {err}")
    return out


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
    # the yardstick: within the near-ties of the plain version, ties to the
    # first copy, and (small shapes) the first smallest of its fp32 FMA chain
    alt = nn_argmin_cuda_core(x, y)
    alt_cmp = nn_compare(x, y, alt, ref)
    if alt_cmp["beyond_tol"] or (ties and not bool((alt < half).all())):
        raise AssertionError(f"{NN_YARDSTICK} {name}: {alt_cmp}, ties {ties}")
    # the plain model of the kernel's arithmetic (on the CPU), small shapes
    model_mismatches = alt_model_mismatches = None
    if R * N * y.shape[1] <= 2e7:
        model_mismatches = int((got.cpu() != nn_argmin_model(x, y)).sum())
        cp = kernel_channels(C)
        d = fma_distances(*(torch.nn.functional.pad(v.cpu(), (0, cp - C)) for v in (x, y)))
        first = (d == d.min(-1, keepdim=True).values).int().argmax(-1)
        alt_model_mismatches = int((alt.cpu() != first).sum())
        if alt_model_mismatches:
            raise AssertionError(f"{NN_YARDSTICK} {name}: {alt_model_mismatches} picks differ from its FMA model")
    ms = cuda_ms(lambda: nn_argmin(x, y), reps)
    alt_ms = cuda_ms(lambda: nn_argmin_cuda_core(x, y), reps)
    plain_ms = cuda_ms(lambda: nn_argmin_reference(x, y, chunk=128), reps)
    pairs = R * N * M
    nbytes = (R * N * C + R * M * C + R * N) * 4  # x, y read, indices written
    # The function's work at fp32 accuracy on the tensor cores: the distance
    # [-2x, 1].[y, |y|^2] as 3xTF32, 3 (C + 1) products (6 (C + 1) flop) a
    # pair, beside one CUDA-core operation a pair (the running minimum).
    t_tc, t_min = 6 * (C + 1) * pairs / TF32_FLOPS * 1e3, pairs / NN_OP_RATE * 1e3
    bnd = bound(6 * (C + 1) * pairs, TF32_FLOPS, nbytes)
    if t_min > bnd["bound_ms"]:
        bnd = {"bound_ms": t_min, "bound_by": "operations"}
    # this design's packed depth K (its row-offset and zero columns included),
    # 2K flop a pair; and the earlier design's C FMAs a pair on the fp32 pipe
    t_packed = 2 * packed_depth(kernel_channels(C)) * pairs / TF32_FLOPS * 1e3
    old = bound(2 * C * pairs, FP32_FLOPS, nbytes)
    log(f"nn_argmin {name} x{(R, N, C)} y{(R, M, C)}: {cmp['mismatches']} index mismatches, "
        f"{cmp['near_ties']} near-ties (rel {NN_TIE_REL}), {cmp['beyond_tol']} beyond; max abs "
        f"float64 distance diff {cmp['max_abs_err']:.3e}; differs from the plain model of its "
        f"arithmetic at {model_mismatches} | kernel {ms:.3f} ms ({pairs / (ms * 1e-3) / 1e9:.0f} G "
        f"pairs/s) | plain {plain_ms:.3f} ms | bound {bnd['bound_ms']:.3f} ms ({bnd['bound_by']}: "
        f"3xTF32 products {t_tc:.3f}, one CUDA-core op a pair {t_min:.3f}); this design's packed "
        f"products {t_packed:.3f} ms; the fp32-FMA design's {old['bound_ms']:.3f} ms | yardstick "
        f"(CUDA-core design) {alt_ms:.3f} ms, {alt_cmp['near_ties']} near-ties from the plain version, "
        f"differs from its FMA model at {alt_model_mismatches}"
        + (f" | {NN_FMA_MS / ms:.2f}x the {NN_FMA_MS} ms before the redesign" if name == "icp_eval" else ""))
    if cmp["beyond_tol"]:
        raise AssertionError(f"nn_argmin {name}: {cmp['beyond_tol']} mismatches beyond the tolerance")
    return {"name": name, "shape": list(shape), **cmp, "tol": f"rel {NN_TIE_REL} of |x|^2 + |y|^2",
            "model_mismatches": model_mismatches, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            **bnd, "bound_tensor_core_ms": t_tc, "bound_min_op_ms": t_min, "bound_packed_ms": t_packed,
            "bound_fp32_fma_ms": old["bound_ms"], "gpairs_per_s": pairs / (ms * 1e-3) / 1e9,
            "cuda_core_ms": alt_ms, "cuda_core_near_ties": alt_cmp["near_ties"],
            "cuda_core_model_mismatches": alt_model_mismatches}


def phase_nn() -> list:
    gen = torch.Generator(device="cuda").manual_seed(99)
    return [
        # ICP at the evaluator's defaults: 16 frames x 24 inits, 10,000 points
        check_nn(gen, "icp_eval", (ICP_FRAMES * ICP_INITS, ICP_POINTS, ICP_POINTS, 3)),
        check_nn(gen, "ragged", (3, 1000, 1037, 3)),
        check_nn(gen, "c5", (2, 777, 1500, 5)),
        check_nn(gen, "ties", (4, 3000, 4001, 3), ties=True),
        check_nn(gen, "c1", (2, 1000, 1200, 1)),
        check_nn(gen, "c8", (2, 700, 1100, 8)),
    ]


def spaced_points(rng, n: int, half: float, sep: float) -> np.ndarray:
    """n points uniform in [-half, half]^3, each at least ``sep`` from the
    points drawn before it (rejection sampling)."""
    pts = np.empty((0, 3))
    while len(pts) < n:
        c = rng.uniform(-half, half, 3)
        if not len(pts) or ((pts - c) ** 2).sum(-1).min() >= sep * sep:
            pts = np.vstack([pts, c])
    return pts


def nn_gaps(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The smallest gap, per problem r, between each query's nearest and
    second-nearest point in float64, relative to NN_TIE_REL's scale."""
    x, y = x.double(), y.double()
    two = torch.cdist(x, y).square().topk(2, dim=-1, largest=False)
    near = [torch.gather(y, 1, two.indices[..., k, None].expand(-1, -1, 3)) for k in (0, 1)]
    scale = (x**2).sum(-1) + torch.maximum((near[0] ** 2).sum(-1), (near[1] ** 2).sum(-1))
    return ((two.values[..., 1] - two.values[..., 0]) / scale).amin(-1)


def phase_small_icp() -> dict:
    """Gradient ICP for 2 problems (384 points, 50 steps, per-step
    correspondences) on the card and on the CPU with the plain version, same
    points, within 1e-3; every pick of kernel E held against the plain version
    on the same inputs (judged in float64 as in check_nn).

    The points keep ICP's result clear of near-ties: gt is drawn with a 0.3
    spacing, and pred is gt moved by 3 degrees, a few percent of scale and
    ~0.03 of translation from one of the 24 rotation inits, so that init wins
    and its correspondences stay unambiguous; the run checks both (the
    winner's nearest-neighbour gaps above 100 NN_TIE_REL in every call, the
    next init's loss above 100x the winner's). Near-ties that the kernel and
    the plain version resolve differently then fall only in losing inits."""
    rng = np.random.default_rng(8)
    gt = np.stack([spaced_points(rng, 384, 1.5, 0.3) for _ in range(2)]).astype(np.float32)
    axis = np.array([1.0, 2.0, 3.0]) / np.sqrt(14.0)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    t = np.deg2rad(3.0)
    rot = (np.eye(3) + np.sin(t) * k + (1 - np.cos(t)) * k @ k) @ icp_module.canonical_rotation_matrices()[7].T
    pred = (gt @ rot * np.array([1.03, 0.98, 1.0]) + np.array([0.02, -0.01, 0.03])
            + rng.normal(0, 0.003, gt.shape)).astype(np.float32)
    calls = []

    def recording(x, y, chunk=2048):
        picks = nn_argmin(x, y, chunk)
        calls.append((x.detach().clone(), y.detach().clone(), picks.clone()))
        return picks

    nn_argmin.launches = 0
    icp_module.nn_argmin = recording
    try:
        card = gradient_icp_multi(pred, gt, n_iter=50, device="cuda")
    finally:
        icp_module.nn_argmin = nn_argmin
    launches = nn_argmin.launches
    cpu = gradient_icp_multi(pred, gt, n_iter=50, device="cpu")
    cmp = [nn_compare(x, y, p, nn_argmin_reference(x, y, chunk=128)) for x, y, p in calls]
    beyond, near = sum(c["beyond_tol"] for c in cmp), sum(c["near_ties"] for c in cmp)
    # the winning init of each problem: the least pred -> gt loss at the last refresh
    x, y, p = calls[-2]
    loss = (x.double() - torch.gather(y, 1, p.long()[..., None].expand(-1, -1, 3)).double()).square()
    loss = loss.sum(-1).mean(-1).reshape(len(gt), -1).sort(dim=1)
    winners = loss.indices[:, 0] + torch.arange(len(gt), device=x.device) * loss.indices.shape[1]
    margin = float((loss.values[:, 1] / loss.values[:, 0]).min())
    gap = float(torch.stack([nn_gaps(x[winners], y[winners]) for x, y, _ in calls]).min())
    errs = {k: float(np.abs(getattr(card, k) - getattr(cpu, k)).max()) for k in ("R", "T", "s")}
    # With the winner's correspondences unambiguous, the card and the CPU
    # differ only by the rounding of the rest of the step: 1e-3 is far above
    # that and far below a wrong basin (~1).
    log(f"small ICP reference: card vs CPU (plain version) max abs err R {errs['R']:.3e}, T "
        f"{errs['T']:.3e}, s {errs['s']:.3e} (tol 1e-3); {len(calls)} kernel-E calls, picks differing "
        f"from the plain version's at {near} near-ties and {beyond} beyond NN_TIE_REL; winning inits' "
        f"smallest nearest-neighbour gap {gap:.3e} (needs > {100 * NN_TIE_REL:g}), next init's loss "
        f"{margin:.0f}x the winner's (needs > 100); kernel E launches {launches} (expected 100)")
    if gap <= 100 * NN_TIE_REL or margin <= 100:
        raise AssertionError(f"small ICP: the points do not keep the result clear of near-ties "
                             f"(gap {gap}, margin {margin})")
    if launches != 100 or beyond or not all(e <= 1e-3 for e in errs.values()):
        raise AssertionError(f"small ICP: launches {launches}, {beyond} picks beyond the tolerance, "
                             f"errors {errs}")
    return {"max_abs_err": errs, "near_ties": near, "beyond_tol": beyond, "winner_gap": gap,
            "winner_margin": margin, "launches": launches}


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


# Card vs CPU at small width. fp32 everywhere (no TF32): sums in another
# order on the card. fp16 compute (fp16 weights, fp32 islands as on the main
# path): this configuration's fp16 run is 1.0e-4 from its fp32 run on the
# CPU, so 1e-3 leaves ten times that for fp16 rounding in another order.
SMALL_REFERENCE_TOL = {torch.float32: 1e-4, torch.float16: 1e-3}


def phase_small_reference() -> dict:
    """The slice at a small width in fp32 and in fp16, on the card (kernels)
    and on the CPU (plain versions), same weights, seeds and frames:
    vertices agree within SMALL_REFERENCE_TOL."""
    errs = {}
    for dtype, tol in SMALL_REFERENCE_TOL.items():
        pipes = {}
        for dev in ("cpu", "cuda"):
            pipe = ActionMeshPipeline(
                config_updates=dict(SMALL_UPDATES), device=torch.device(dev), dtype=dtype
            )
            pipe.image_encoder = ImageEncoder(torch.device(dev), dtype, SMALL_DINO)
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
        name = str(dtype)[6:]
        log(f"small reference {name}: {out.shape[0]} meshes x {out.shape[1]} vertices, "
            f"card vs CPU max abs err {err:.3e} (tol {tol:g}), finite {bool(np.isfinite(out).all())}")
        if not (err <= tol and np.isfinite(out).all()):
            raise AssertionError(f"card and CPU disagree at small width in {name}: {err}")
        errs[name] = err
    return errs


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
    """2 fp32 train steps of a small denoiser (head dim 64) on the card
    (kernels A, B, C, D) and on the CPU (plain versions): same initial
    weights, batches and draws; losses and final params agree."""
    torch.backends.cudnn.allow_tf32 = False
    cfg = TrainLoopConfig(total_steps=2, warmup_steps=1, peak_lr=1e-5, ema_decay=0.9)
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
        with no_plain_backward_on_card():
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


COUNTERS = ("flash_fwd", "fused_rms_rope", "flash_bwd_dkv", "flash_bwd_dq", "flash_fused",
            "fused_rms_rope_bwd")


def reset_counters() -> None:
    flash_attention.launches = fused_rms_rope.launches = flash_attention_fused.launches = 0
    flash_attention_bwd.dkv_launches = flash_attention_bwd.dq_launches = 0
    fused_rms_rope.bwd_launches = 0


def read_counters() -> dict:
    return dict(zip(COUNTERS, (flash_attention.launches, fused_rms_rope.launches,
                               flash_attention_bwd.dkv_launches, flash_attention_bwd.dq_launches,
                               flash_attention_fused.launches, fused_rms_rope.bwd_launches)))


@contextlib.contextmanager
def no_plain_backward_on_card():
    """Fails the run if kernel B's or kernels C and D's plain backward is
    handed a CUDA tensor (the autograd.Functions must launch the backward
    kernels there)."""
    plains = ((rope_norm, "rms_rope_backward_reference", "kernel B's"),
              (flash_ops, "attention_bwd_reference", "kernels C and D's"),
              (attn_ops, "attention_bwd_stats_reference", "the ring backward's kernels C and D's"))

    def guard(plain, what):
        def guarded(x, *args, **kw):
            if x.is_cuda:
                raise AssertionError(f"{what} plain backward was called with a CUDA tensor")
            return plain(x, *args, **kw)
        return guarded

    saved = [getattr(module, attr) for module, attr, _ in plains]
    for (module, attr, what), plain in zip(plains, saved):
        setattr(module, attr, guard(plain, what))
    try:
        yield
    finally:
        for (module, attr, _), plain in zip(plains, saved):
            setattr(module, attr, plain)


def expected_train_launches(cfg: DenoiserConfig, steps: int) -> dict:
    """Kernel launches of ``steps`` train steps with remat.

    Per block: self and cross attention (kernel A each), rms-norm(+rope) of
    their q and k (kernel B, 4 launches); remat runs the block's forward
    again in the backward, so A and B launch twice per step; kernels C and
    D once per attention, kernel B's backward once per B call (4 a block).
    """
    L = cfg.num_layers
    return dict(zip(COUNTERS, (2 * 2 * L * steps, 2 * 4 * L * steps, 2 * L * steps, 2 * L * steps, 0,
                               4 * L * steps)))


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


def expected_launches(pipe: ActionMeshPipeline, n_frames: int, stage0: bool = True,
                      stage0_steps: int | None = None, stage1_steps: int | None = None) -> tuple[int, int]:
    """Kernel launches the main path implies for ``n_frames`` frames, at
    the preset's steps or the call's overrides (``stage0_steps``,
    ``stage1_steps``: a call's overrides hold for that call only).

    Stage 0 (TripoSG): DINOv2 on the anchor, one flash per layer; per DiT
    step and block, self (q, k rms; flash) and cross (q, k rms; flash; the
    unconditional branch skips it); one flash per VAE decoder block; one
    flash per SDF query chunk of the prefilter, band and fine passes (the
    extraction reports them). DINOv2 on all frames: one flash per layer.
    Stage I, per window and step, per block: self (q, k rms+rope; flash) and
    cross (q, k rms; flash; conditional only). Stage II, per window and
    target chunk: one flash and two rope-only launches per self block, one
    flash for the vertex cross block.

    The guidance-free branches count the same: a distilled preset's Stage I
    (guidance [[1, 1]]) runs one conditional branch, and turbo's Stage 0
    (guidance_scale 0) one conditional DiT forward a step, each still one
    self and one cross launch per block. ``split_cfg_batch`` (the low-RAM
    presets) runs each Stage-I branch in its own forward, so every launch of
    a Stage-I block repeats once per branch (the unconditional one's cross
    attention on zero context). Stage 0 is TripoSG's, loaded or the
    development one; ``stage0=False`` leaves it out (the {video + 3D} mode).
    """
    cfg = pipe.cfg
    win1 = len(chunk_from(cfg.anchor_idx, n_frames, cfg.temporal_3D_denoiser.temporal_context_size, cfg.sliding_window_denoiser))
    win2 = chunk_from(cfg.anchor_idx, n_frames, cfg.temporal_3D_vae.temporal_context_size, cfg.sliding_window_autoencoder)
    chunks2 = sum(math.ceil((len(w) - 1) / cfg.decode_target_chunk) for w in win2)
    steps = stage1_steps or cfg.scheduler.num_inference_steps
    L1, L2 = cfg.temporal_3D_denoiser.num_layers, cfg.temporal_3D_vae.num_layers
    dino = pipe.image_encoder.config.num_layers
    stage0_flash = stage0_rope = 0
    if stage0:
        tripo = getattr(pipe.image_to_3d, "pipeline", pipe.image_to_3d)
        steps0, L0 = stage0_steps or cfg.stage_0.num_inference_steps, tripo.dit_cfg.num_layers
        stage0_flash = dino + 2 * L0 * steps0 + tripo.vae_cfg.decoder_layers + sum(tripo.extract_stats.values())
        stage0_rope = 4 * L0 * steps0
    guidance = cfg.cf_guidance
    branches = len(guidance.guidance_at_inference) if guidance.inference_enabled else 1
    per_branch = branches if cfg.scheduler.split_cfg_batch and branches > 1 else 1
    flash = stage0_flash + dino + 2 * L1 * steps * win1 * per_branch + (L2 + 1) * chunks2
    rope = stage0_rope + 4 * L1 * steps * win1 * per_branch + 2 * L2 * chunks2
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
    preset_stage1_steps = pipe.cfg.scheduler.num_inference_steps  # the call cuts it (for itself)

    # keep the arguments of the decode's last SDF query, the fine pass's,
    # and the latents it decoded (the later decode and extraction phases')
    fine_query = {}
    query_at_ids = triposg_pipeline.query_sdf_at_ids

    def recording_query(params, cfg, kv, ijk, lo, step, **kw):
        fine_query.update(params=params, cfg=cfg, kv=kv, ijk=ijk, lo=lo, step=step, kw=kw)
        return query_at_ids(params, cfg, kv, ijk, lo, step, **kw)

    triposg_pipeline.query_sdf_at_ids = recording_query
    tripo = pipe.image_to_3d.pipeline
    decode = tripo.decode_latents

    def recording_decode(latents, **kw):
        fine_query["latents"] = latents
        return decode(latents, **kw)

    tripo.decode_latents = recording_decode
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

    want_flash, want_rope = expected_launches(pipe, N_FRAMES, stage1_steps=STAGE1_STEPS)
    log(f"slice: init {init_s:.2f} s | __call__ {total_s:.2f} s | phases "
        + " ".join(f"{k} {v:.2f} s" for k, v in pipe.phase_seconds.items())
        + " | stage0 sub-phases " + " ".join(f"{k} {v:.2f} s" for k, v in pipe.stage0_seconds.items())
        + f" | peak memory {peak_gib:.2f} GiB")
    log(f"slice: launches flash_fwd {launches['flash_fwd']} (expected {want_flash}), "
        f"rms_rope {launches['rms_rope']} (expected {want_rope}); SDF query chunks {chunks}")
    if (launches["flash_fwd"], launches["rms_rope"]) != (want_flash, want_rope):
        raise AssertionError(f"launch counts {launches} != ({want_flash}, {want_rope})")
    if (flash_attention_bwd.dkv_launches or flash_attention_bwd.dq_launches or launches["flash_fused"]
            or fused_rms_rope.bwd_launches):
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


def write_frame_pairs(directory: Path, frames: list[np.ndarray]) -> None:
    """The frames as NN_image.png (RGB) + NN_mask.png (the alpha), the
    layout ``load_from_image_mask_pairs`` reads."""
    directory.mkdir(parents=True, exist_ok=True)
    for i, frame in enumerate(frames):
        write_png(directory / f"{i:02d}_image.png", frame[..., :3])
        write_png(directory / f"{i:02d}_mask.png", frame[..., 3])


def glb_json(path: Path) -> dict:
    """The JSON chunk of a binary glTF file."""
    raw = path.read_bytes()
    length, _ = struct.unpack_from("<II", raw, 12)
    return json.loads(raw[20 : 20 + length])


def flag_value(flags: list[str], name: str) -> int | None:
    """The integer after ``name`` in a CLI's flags, None without it."""
    return int(flags[flags.index(name) + 1]) if name in flags else None


def run_cli(name: str, flags: list[str], frames_dir: Path, out_dir: Path) -> dict:
    """One in-process call of the CLI's ``main`` on the frame pairs at full
    width, then its outputs checked: 16 mesh_XX.glb with the anchor's
    topology, the deformation arrays, an animated GLB with 16 morph targets,
    a non-blank preview, and kernel launches equal to what the preset's path
    implies. Returns the seconds of each step and the counts."""
    frames_seen = []
    write = visualizer.write_mp4

    def recording_write(frames, path, fps=8):
        frames_seen.append(frames)
        return write(frames, path, fps=fps)

    visualizer.write_mp4 = recording_write
    reset_counters()
    t0 = time.perf_counter()
    try:
        result = cli.main(["--input", str(frames_dir), "--output_dir", str(out_dir),
                           "--seed", "44", *flags])
        torch.cuda.synchronize()
    finally:
        visualizer.write_mp4 = write
    wall_s = time.perf_counter() - t0
    launches = read_counters()
    pipe, meshes = result.pop("pipeline"), result.pop("meshes")
    steps0 = flag_value(flags, "--stage_0_steps") or pipe.cfg.stage_0.num_inference_steps
    steps1 = flag_value(flags, "--stage_1_steps") or pipe.cfg.scheduler.num_inference_steps
    want_flash, want_rope = expected_launches(pipe, N_FRAMES, stage0_steps=steps0, stage1_steps=steps1)
    phase_s = dict(pipe.phase_seconds)
    del pipe
    seconds = result["seconds"]
    clip_s = sum(seconds.values())
    log(f"cli {name} ({result['preset']}, {' '.join(flags) or 'no flags'}; Stage 0 {steps0} "
        f"steps, Stage I {steps1}): clip {clip_s:.2f} s = load {seconds['load']:.2f} + pipeline "
        f"{seconds['pipeline']:.2f} (" + " ".join(f"{k} {v:.2f}" for k, v in phase_s.items())
        + f") + export {seconds['export']:.2f} + render {seconds.get('render', 0.0):.2f} s; "
        f"with the pipeline's set-up {wall_s:.2f} s")
    log(f"cli {name}: launches flash_fwd {launches['flash_fwd']} (expected {want_flash}), "
        f"rms_rope {launches['fused_rms_rope']} (expected {want_rope})")
    if (launches["flash_fwd"], launches["fused_rms_rope"]) != (want_flash, want_rope):
        raise AssertionError(f"cli {name}: launch counts {launches} != ({want_flash}, {want_rope})")
    if any(launches[k] for k in COUNTERS[2:]):
        raise AssertionError(f"cli {name}: a backward kernel or kernel F launched: {launches}")

    if len(meshes) != N_FRAMES:
        raise AssertionError(f"cli {name}: {len(meshes)} meshes for {N_FRAMES} frames")
    anchor = meshes[0]
    verts = np.stack([m.vertices for m in meshes])
    if not np.isfinite(verts).all():
        raise AssertionError(f"cli {name}: vertices are not finite")
    for i, mesh in enumerate(meshes):
        glb = load_glb(out_dir / f"mesh_{i:02d}.glb")
        if not (np.array_equal(glb.faces, anchor.faces) and glb.n_vertices == anchor.n_vertices
                and np.abs(glb.vertices - mesh.vertices).max() <= 1e-6):
            raise AssertionError(f"cli {name}: mesh_{i:02d}.glb does not hold the mesh with the anchor's faces")
    dv = np.load(out_dir / "deformations_vertices.npy")
    df = np.load(out_dir / "deformations_faces.npy")
    if dv.shape != (N_FRAMES, anchor.n_vertices, 3) or df.shape != (anchor.n_faces, 3):
        raise AssertionError(f"cli {name}: deformation arrays {dv.shape} {df.shape}")
    targets = glb_json(out_dir / "animated_mesh.glb")["meshes"][0]["primitives"][0]["targets"]
    if len(targets) != N_FRAMES:
        raise AssertionError(f"cli {name}: animated_mesh.glb has {len(targets)} morph targets")
    preview = result["preview"]
    if preview is None or not Path(preview).is_file() or Path(preview).stat().st_size == 0:
        raise AssertionError(f"cli {name}: no preview was written ({preview})")
    # the three mesh views (right of the input frame) are not all background
    grids = np.stack(frames_seen[-1])
    covered = float((grids[:, :, grids.shape[2] // 4 :] != 255).any(axis=-1).mean())
    if not covered > 0.01:
        raise AssertionError(f"cli {name}: the preview's mesh views are blank ({covered:.4f} covered)")
    log(f"cli {name}: {len(meshes)} GLBs with the anchor's {anchor.n_vertices} vertices / "
        f"{anchor.n_faces} faces, deformations {dv.shape}, {len(targets)} morph targets, preview "
        f"{Path(preview).name} ({Path(preview).stat().st_size} bytes, {100 * covered:.1f}% of the "
        f"mesh views covered)")
    return {"preset": result["preset"], "flags": flags, "clip_seconds": clip_s, "seconds": seconds,
            "phase_seconds": phase_s, "wall_seconds": wall_s, "stage0_steps": steps0,
            "stage1_steps": steps1, "launches": launches,
            "expected_launches": {"flash_fwd": want_flash, "fused_rms_rope": want_rope},
            "anchor_vertices": int(anchor.n_vertices), "anchor_faces": int(anchor.n_faces),
            "preview": Path(preview).name, "preview_covered": covered}


# the CLI phase's presets: the default, its Stage I cut from 30 steps to
# 10 (the slice phase derives the clip at the preset's 30), and turbo
CLI_PRESETS = {"default": ["--stage_1_steps", "4"], "turbo": ["--turbo"]}


def phase_cli(presets: dict) -> dict:
    """The video-to-4D command line on 16 synthetic frames written as
    image + mask PNG pairs, once per preset, at full width."""
    work = OUT_DIR / "cli"
    shutil.rmtree(work, ignore_errors=True)
    frames_dir = work / "frames"
    write_frame_pairs(frames_dir, make_frames())
    try:
        out = {name: run_cli(name, flags, frames_dir, work / "".join(c for c in name if c.isalnum()))
               for name, flags in presets.items()}
        out["host_io"] = host_io_seconds(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def host_io_seconds(work: Path) -> dict:
    """This host's time for the two host codecs at their target sizes: one
    1024 x 1024 RGBA PNG read (target 0.5 s) and a 16-frame 256 x 1024 GIF
    written (target 2 s)."""
    rng = np.random.default_rng(0)
    y, x = np.mgrid[:1024, :1024]
    png = np.stack([x % 256, y % 256, (x + y) % 256, (x ^ y) % 256], -1).astype(np.uint8)
    png = png + rng.integers(0, 4, png.shape, dtype=np.uint8)
    write_png(work / "frame_1024.png", png)
    t0 = time.perf_counter()
    if not np.array_equal(read_png(work / "frame_1024.png"), png):
        raise AssertionError("read_png does not give back the 1024 x 1024 RGBA frame")
    png_s = time.perf_counter() - t0
    frames = [rng.integers(0, 256, (256, 1024, 3), dtype=np.uint8) for _ in range(N_FRAMES)]
    t0 = time.perf_counter()
    write_gif(frames, work / "grid.gif")
    gif_s = time.perf_counter() - t0
    log(f"host codecs: read_png 1024 x 1024 RGBA {png_s:.3f} s (target 0.5), write_gif "
        f"{N_FRAMES} x 256 x 1024 {gif_s:.3f} s (target 2)")
    return {"read_png_1024_rgba_seconds": png_s, "write_gif_16x256x1024_seconds": gif_s}


def plain_dot_product_attention(q, k, v, scale=None, kv_mask=None, trainable=False, mesh=None,
                                sequence_parallel=False):
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


def phase_train(compute_dtype: str | None = "bfloat16") -> dict:
    """Full-width Stage-I training through the entry point's code path:
    ``--compute-dtype bfloat16`` for TRAIN_STEPS steps, then the written
    checkpoint is compared with the state; or, with ``compute_dtype`` None,
    the entry point's default fp32 for TRAIN_STEPS_F32 steps (kernels A, C
    and D on their fp32 paths, B on fp32 q and k)."""
    steps = TRAIN_STEPS if compute_dtype else TRAIN_STEPS_F32
    label = f"train {compute_dtype or 'float32'}"
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    args = train_entry.build_args().parse_args([
        "--synthetic", "--size", "production", "--window", "16", "--batch", "2",
        *(["--compute-dtype", compute_dtype] if compute_dtype else []),
        "--steps", str(steps), "--warmup", "0",
        "--ema-decay", "0.999", "--log-every", "1", "--ckpt-every", "0",
        "--out", str(OUT_DIR), "--no-resume", "--time-phases", "--device", "cuda",
    ])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    with no_plain_backward_on_card():
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
    log(f"{label}: {n_params / 1e9:.3f} B params | {len(recs)} steps, losses {losses} | "
        + " | ".join(f"step {h['step']}: {t:.2f} s (forward {h['forward_s']:.2f}, backward "
                     f"{h['backward_s']:.2f}, update {h['update_s']:.2f})" for h, t in zip(recs, step_s))
        + f" | peak memory {peak_gib:.2f} GiB | run incl. data, init, checkpoint {run_s:.1f} s")
    want = expected_train_launches(cfg, steps)
    log(f"{label}: launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{label} launch counts {launches} != {want}")
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label} losses {losses}")

    # every leaf moved from its initial value (no warmup: lr > 0 from the first step)
    init = init_denoiser(torch.Generator("cuda").manual_seed(loop_cfg.seed), cfg, device=torch.device("cuda"))
    moved = [
        (name, (p.detach() - p0).abs().max().item())
        for (name, p), p0 in zip(named_leaves(state["params"]), leaves(init))
    ]
    del init
    still = [n for n, d in moved if not d > 0]
    log(f"{label}: {len(moved) - len(still)}/{len(moved)} param leaves moved, "
        f"max change {max(d for _, d in moved):.3e}")
    if still:
        raise AssertionError(f"{label}: params did not move: {still[:5]}")
    out = {"dtype": compute_dtype or "float32", "launches": launches, "losses": losses,
           "step_seconds": step_s,
           "phase_seconds": [{k: h[k] for k in ("forward_s", "backward_s", "update_s")} for h in recs],
           "peak_gib": peak_gib, "params": n_params, "run_seconds": run_s}
    if compute_dtype is not None:  # the checkpoint, checked once
        # every entry's name and shape, and the values of every CKPT_SAMPLE-th
        # leaf and the counters (reading all 23 GB back cost 32-47 s; the CPU
        # tests restore whole checkpoints, the four-card run resumes one)
        ckpt = OUT_DIR / "ckpt_latest.npz"
        t0 = time.perf_counter()
        want = dict(named_leaves(state))
        sample = sorted(want)[::CKPT_SAMPLE] + ["step", "opt_state.count"]
        with zipfile.ZipFile(ckpt) as zf:
            shapes = {}
            for name in zf.namelist():
                with zf.open(name) as fh:
                    read_header = (np.lib.format.read_array_header_1_0 if np.lib.format.read_magic(fh) == (1, 0)
                                   else np.lib.format.read_array_header_2_0)
                    shapes[name[:-4]] = read_header(fh)[0]
            same = shapes == {n: tuple(t.shape) if isinstance(t, torch.Tensor) else () for n, t in want.items()}
            for name in sample:
                with zf.open(f"{name}.npy") as fh:
                    arr = np.lib.format.read_array(fh)
                leaf = want[name]
                same = same and (np.array_equal(arr, leaf.detach().cpu().numpy()) if isinstance(leaf, torch.Tensor)
                                 else int(arr) == leaf)
        out["check_seconds"] = time.perf_counter() - t0
        out["checkpoint_gb"] = ckpt.stat().st_size / 1e9
        log(f"{label}: checkpoint {out['checkpoint_gb']:.2f} GB: {len(shapes)} entries' names and shapes, "
            f"{len(sample)} leaves' values equal to the state: {same} ({out['check_seconds']:.1f} s)")
        if not same:
            raise AssertionError("the checkpoint differs from the train state")
    del state
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# Stage-II decoder training at the JAX CLI's defaults: window 8 (7 targets),
# batch 2, the bucket of 4096 vertices, fp32; 4 synthetic clips of 10 frames
# with 4096, 3584, 3072 and 2560 tracked vertices, a quarter of the windows
# held out for one eval with the chamfer metrics.
DECODER_STEPS = 1
DECODER_WINDOW, DECODER_BATCH, DECODER_BUCKET = 8, 2, 4096


def expected_decoder_launches(cfg: AutoencoderConfig, steps: int, evals: int) -> dict:
    """Kernel launches of ``steps`` decoder train steps and ``evals`` eval
    forwards. A step: each self block runs A once and B twice (q and k,
    rotation only) in the forward and again under remat, C, D and B's
    backward (twice) once; the final vertex cross-attention A, C and D once
    (no norm, no rotation, not rematerialised). An eval forward: A once a
    block, B twice a self block."""
    L = cfg.num_layers
    return dict(zip(COUNTERS, (steps * (2 * L + 1) + evals * (L + 1), steps * 4 * L + evals * 2 * L,
                               steps * (L + 1), steps * (L + 1), 0, steps * 2 * L)))


def train_summary(label: str, history: list, peak_gib: float, run_s: float) -> tuple[list, list, list]:
    """Log each step's phase seconds; returns (losses, per-step seconds,
    per-step phase seconds)."""
    recs = [h for h in history if "loss" in h]
    losses = [h["loss"] for h in recs]
    phases = [{k: h[k] for k in ("teacher_s", "forward_s", "backward_s", "update_s") if k in h} for h in recs]
    step_s = [sum(ph.values()) for ph in phases]
    log(f"{label}: {len(recs)} steps, losses {losses} | "
        + " | ".join(f"step {h['step']}: {t:.2f} s (" + ", ".join(f"{k[:-2]} {v:.2f}" for k, v in ph.items())
                     + ")" for h, t, ph in zip(recs, step_s, phases))
        + f" | peak memory {peak_gib:.2f} GiB | run incl. data, init, checkpoint {run_s:.1f} s")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{label} losses {losses}")
    return losses, step_s, phases


def check_moved(label: str, params, init) -> None:
    moved = [(name, (p.detach() - p0).abs().max().item())
             for (name, p), p0 in zip(named_leaves(params), leaves(init))]
    still = [n for n, d in moved if not d > 0]
    log(f"{label}: {len(moved) - len(still)}/{len(moved)} param leaves moved, "
        f"max change {max(d for _, d in moved):.3e}")
    if still:
        raise AssertionError(f"{label}: params did not move: {still[:5]}")


def phase_train_decoder() -> dict:
    """Stage-II decoder training at the production AutoencoderConfig on the
    default fp32 compute, DECODER_STEPS steps on synthetic clips + tracks
    through DecoderTrackDataset, split_windows and decoder_batches, then one
    held-out eval with the chamfer metrics (``run_decoder_training`` with
    ``eval_chamfer``, keeping ckpt_best.npz by eval_score); checks finite
    losses and metrics, moved params, the launch counts, the train
    checkpoint restored whole (``restore_train_state``) into a fresh state
    with every leaf equal to the run's, and an autoencoder.npz export that
    reloads."""
    from actionmesh_tpu_torch.models.autoencoder import init_autoencoder
    from actionmesh_tpu_torch.training import decoder_train
    from actionmesh_tpu_torch.training.checkpoint import export_for_inference, restore_train_state
    from actionmesh_tpu_torch.training.data import (
        DecoderTrackDataset,
        decoder_batches,
        split_windows,
        synthesize_track_dir,
    )
    from actionmesh_tpu_torch.training.loop import run_decoder_training
    from actionmesh_tpu_torch.utils.weights import load_npz

    label = "train decoder float32"
    work = OUT_DIR / "decoder"
    shutil.rmtree(work, ignore_errors=True)
    cfg = AutoencoderConfig()
    t0 = time.perf_counter()
    clips, tracks = synthesize_track_dir(work / "data", n_clips=4, frames=10, tokens=2048,
                                         channels=cfg.latent_channels, vertices=DECODER_BUCKET)
    dataset = DecoderTrackDataset(clips, tracks, window=DECODER_WINDOW)
    train_ds, eval_ds = split_windows(dataset, 0.25, seed=0)
    eval_set = list(decoder_batches(eval_ds, DECODER_BATCH, vertex_bucket=DECODER_BUCKET, seed=0, epochs=1))[:1]
    data_s = time.perf_counter() - t0
    loop_cfg = TrainLoopConfig(total_steps=DECODER_STEPS, warmup_steps=0, log_every=1, ckpt_every=0,
                               eval_every=DECODER_STEPS, keep_best_eval=True, best_metric="eval_score",
                               out_dir=str(work / "run"), resume=False, time_phases=True)
    eval_s = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    with no_plain_backward_on_card(), recording(decoder_train, "decoder_eval_metrics", timed_on_card(eval_s)):
        state, history = run_decoder_training(
            cfg, decoder_batches(train_ds, DECODER_BATCH, vertex_bucket=DECODER_BUCKET, seed=0), loop_cfg,
            device=torch.device("cuda"), eval_batches=eval_set, eval_chamfer=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counters()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses, step_s, phases = train_summary(label, history, peak_gib, run_s)
    evals = [h for h in history if "eval_loss" in h]
    want = expected_decoder_launches(cfg, DECODER_STEPS, len(evals))
    log(f"{label}: {len(train_ds)} train / {len(eval_ds)} held-out windows of {DECODER_WINDOW} frames "
        f"(data {data_s:.1f} s) | eval {evals} in {sum(eval_s):.2f} s | launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{label} launch counts {launches} != {want}")
    if len(losses) != DECODER_STEPS or len(evals) != 1 or not all(
            math.isfinite(evals[0][k]) for k in ("eval_loss", "eval_cd", "eval_motion", "eval_score")):
        raise AssertionError(f"{label}: losses {losses}, evals {evals}")
    if not (work / "run" / "ckpt_best.npz").exists():
        raise AssertionError(f"{label}: no ckpt_best.npz")
    init = init_autoencoder(torch.Generator("cuda").manual_seed(loop_cfg.seed), cfg, device=torch.device("cuda"))
    check_moved(label, state["params"], init)
    ckpt = work / "run" / "ckpt_latest.npz"
    t0 = time.perf_counter()
    restored = restore_train_state(ckpt, init_train_state(init, make_optimizer(loop_cfg)))
    restore_s = time.perf_counter() - t0
    pairs = list(zip(named_leaves(restored), named_leaves(state)))
    restored_equal = all(na == nb and (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
                         for (na, a), (nb, b) in pairs) and len(pairs) == len(list(named_leaves(state)))
    log(f"{label}: checkpoint {ckpt.stat().st_size / 1e9:.2f} GB restored whole in {restore_s:.1f} s, "
        f"{len(pairs)} leaves equal to the state: {restored_equal}")
    if not restored_equal:
        raise AssertionError(f"{label}: the restored checkpoint differs from the train state")
    del init, restored, pairs
    path = export_for_inference(state, work / "export", stage="decoder")
    reloaded = load_npz(path, device=torch.device("cuda"))
    exported = named_leaves(reloaded)
    same = [(n, a.dtype, a.shape) for n, a in exported] == [
        (n, a.dtype, a.shape) for n, a in named_leaves(decoder_train.cast_params_for_compute(
            state["params"], torch.bfloat16))]
    log(f"{label}: exported {path.name} ({path.stat().st_size / 1e9:.2f} GB), reloaded with the "
        f"params' names, dtypes and shapes: {same}")
    if not (path.name == "autoencoder.npz" and same):
        raise AssertionError(f"{label}: the export does not reload as the params")
    n_params = sum(p.numel() for p in leaves(state["params"]))
    del state, reloaded
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"dtype": "float32", "params": n_params, "launches": launches, "expected_launches": want,
            "losses": losses, "step_seconds": step_s, "phase_seconds": phases, "eval": evals[0],
            "eval_seconds": eval_s, "peak_gib": peak_gib, "run_seconds": run_s, "data_seconds": data_s,
            "restore_seconds": restore_s,
            "shape": {"window": DECODER_WINDOW, "batch": DECODER_BATCH, "bucket": DECODER_BUCKET}}


def expected_distill_launches(cfg: DenoiserConfig, mode: str, steps: int) -> dict:
    """The student's train-step launches (``expected_train_launches``) plus
    the teacher's inference forwards: a guided teacher call (the CFG pair,
    the unconditional branch's cross-attention skipped) and an unguided one
    each launch A twice and B 4 times a block; guidance takes one guided
    call a step, progressive two unguided ones."""
    L = cfg.num_layers
    teacher_calls = 1 if mode == "guidance" else 2
    out = expected_train_launches(cfg, steps)
    out["flash_fwd"] += teacher_calls * 2 * L * steps
    out["fused_rms_rope"] += teacher_calls * 4 * L * steps
    return out


def run_train_entry(flags: list[str], steps: int) -> tuple:
    """``python -m actionmesh_tpu_torch.train`` at production size on the
    card through its code path (the checkpoint under OUT_DIR), with the
    plain backwards barred; returns (state, history, loop config, launches,
    peak GiB, seconds)."""
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    args = train_entry.build_args().parse_args([
        "--synthetic", "--size", "production", "--steps", str(steps), "--warmup", "0",
        "--log-every", "1", "--ckpt-every", "0", "--out", str(OUT_DIR), "--no-resume",
        "--time-phases", "--device", "cuda", *flags,
    ])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    with no_plain_backward_on_card():
        state, history, loop_cfg = train_entry.run(args)
    torch.cuda.synchronize()
    return state, history, loop_cfg, read_counters(), torch.cuda.max_memory_allocated() / 2**30, \
        time.perf_counter() - t0


DISTILL_STEPS = 1


def phase_distill(mode: str) -> dict:
    """Distillation (``--stage distill --distill-mode MODE``) at the
    production DenoiserConfig, window 16, batch 2, bf16 compute, from a
    random teacher (progressive: --teacher-steps 30): DISTILL_STEPS steps,
    each timed as the teacher's targets and the student's forward, backward
    and update; finite losses, a student moved off the teacher, launch
    counts with the teacher's inference launches of A and B."""
    label = f"distill {mode} bfloat16"
    state, history, loop_cfg, launches, peak_gib, run_s = run_train_entry([
        "--stage", "distill", "--distill-mode", mode, "--teacher-steps", "30",
        "--window", "16", "--batch", "2", "--compute-dtype", "bfloat16", "--ema-decay", "0.999",
    ], DISTILL_STEPS)
    cfg = train_entry.flow_model_config("production")
    losses, step_s, phases = train_summary(label, history, peak_gib, run_s)
    want = expected_distill_launches(cfg, mode, DISTILL_STEPS)
    log(f"{label}: launches {launches} (expected {want})")
    if launches != want or len(losses) != DISTILL_STEPS:
        raise AssertionError(f"{label}: launch counts {launches} != {want} or losses {losses}")
    teacher = init_denoiser(torch.Generator("cuda").manual_seed(loop_cfg.seed + 7), cfg, device=torch.device("cuda"))
    check_moved(label, state["params"], teacher)
    del teacher, state
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"mode": mode, "dtype": "bfloat16", "launches": launches, "expected_launches": want,
            "losses": losses, "step_seconds": step_s, "phase_seconds": phases, "peak_gib": peak_gib,
            "run_seconds": run_s}


STAGE0_STEPS = 2


def phase_train_stage0() -> dict:
    """``--model stage0 --stage flow``: the Stage-0 TripoSG DiT at the
    production triposg_dit_config on single-frame windows (no conditioning
    frame), fp32, STAGE0_STEPS steps (kernels A, C and D at (2, 16, 2049,
    2049 | 257, 128) and B's norm alone); finite losses, moved params, the
    launch counts, and a dit.npz export that reloads."""
    from actionmesh_tpu_torch.utils.weights import load_npz

    label = "train stage0 DiT float32"
    export = OUT_DIR.parent / "chip_smoke_dit"
    shutil.rmtree(export, ignore_errors=True)
    state, history, loop_cfg, launches, peak_gib, run_s = run_train_entry(
        ["--model", "stage0", "--batch", "2", "--export-inference", str(export)], STAGE0_STEPS)
    cfg = train_entry.flow_model_config("production", "stage0")
    losses, step_s, phases = train_summary(label, history, peak_gib, run_s)
    want = expected_train_launches(cfg, STAGE0_STEPS)
    log(f"{label}: launches {launches} (expected {want})")
    if launches != want or len(losses) != STAGE0_STEPS:
        raise AssertionError(f"{label}: launch counts {launches} != {want} or losses {losses}")
    init = init_denoiser(torch.Generator("cuda").manual_seed(loop_cfg.seed), cfg, device=torch.device("cuda"))
    check_moved(label, state["params"], init)
    del init
    files = sorted(p.name for p in export.iterdir())
    reloaded = load_npz(export / "dit.npz", device=torch.device("cuda"))
    shapes_equal = [a.shape for a in leaves(reloaded)] == [a.shape for a in leaves(state["params"])]
    log(f"{label}: exported {files}, reloaded with the params' shapes: {shapes_equal}")
    if files != ["dit.npz"] or not shapes_equal:
        raise AssertionError(f"{label}: export {files}, shapes equal {shapes_equal}")
    del state, reloaded
    shutil.rmtree(export, ignore_errors=True)
    shutil.rmtree(OUT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"dtype": "float32", "launches": launches, "expected_launches": want, "losses": losses,
            "step_seconds": step_s, "phase_seconds": phases, "peak_gib": peak_gib, "run_seconds": run_s}


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


# -- checkpoints: a synthetic pretrained_weights/ tree at the release's names
# and shapes, read back, converted and verified, then through the CLI ----------

CKPT_DIR = OUT_DIR / "pretrained_weights"
CKPT_SHARD_BYTES = 2 << 30  # a family above this is written as shards with an index
TRIPOSG_CONFIGS = {
    "transformer": {"_class_name": "TripoSGDiTModel", "_diffusers_version": "0.30.0", "num_tokens": 2048,
                    "in_channels": 64, "out_channels": 64, "num_layers": 21, "width": 2048,
                    "num_attention_heads": 16, "cross_attention_dim": 1024},
    "vae": {"_class_name": "TripoSGVAEModel", "_diffusers_version": "0.30.0", "latent_channels": 64,
            "num_tokens": 2048, "embed_frequency": 8, "width_encoder": 512, "num_layers_encoder": 8,
            "width_decoder": 1024, "num_layers_decoder": 16},
}
DINOV2_CONFIG = {"architectures": ["Dinov2Model"], "model_type": "dinov2", "hidden_size": 1024,
                 "num_hidden_layers": 24, "num_attention_heads": 16, "patch_size": 14, "image_size": 518,
                 "mlp_ratio": 4, "layerscale_value": 1.0, "torch_dtype": "float32"}


def host_peak_rss_gib() -> float:
    """This process's peak resident set so far (getrusage), GiB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def write_synthetic_tree(root: Path) -> dict:
    """All four families at production widths: ActionMesh denoiser and
    autoencoder bf16 (the development weights of the default preset),
    TripoSG transformer and VAE fp16 (the VAE's SDF head shaped to a rounded
    sphere, ``shape_vae_sdf``: a random decoder's field has no surface),
    DINOv2-L fp32, RMBG-1.4 fp32 (``brightness_rmbg``). Returns per family
    the GB written and the seconds."""
    shutil.rmtree(root, ignore_errors=True)
    cuda = torch.device("cuda")
    written = {}

    def put(name, directory, state, dtype, config=None):
        t0 = time.perf_counter()
        nbytes = write_checkpoint(directory, state, dtype=dtype, config=config, shard_bytes=CKPT_SHARD_BYTES)
        written[name] = {"gb": nbytes / 1e9, "write_seconds": time.perf_counter() - t0,
                         "files": sorted(p.name for p in Path(directory).iterdir())}

    dev = ActionMeshPipeline(config_name="actionmesh", weights_dir=None, device=cuda, init_seed=0)
    put("denoiser", root / "ActionMesh" / "denoiser",
        reference_state_dict("denoiser", dev.denoiser_params, dev.denoiser_config.num_attention_heads),
        torch.bfloat16, {"_class_name": "ActionMeshDenoiser", **dataclasses.asdict(dev.denoiser_config)})
    put("autoencoder", root / "ActionMesh" / "autoencoder",
        reference_state_dict("autoencoder", dev.autoencoder_params, dev.autoencoder_config.num_attention_heads),
        None, {"_class_name": "ActionMeshAutoencoder", **dataclasses.asdict(dev.autoencoder_config)})
    put("dinov2", root / "dinov2", reference_state_dict("dinov2", dev.image_encoder.params), torch.float32,
        DINOV2_CONFIG)
    del dev
    gen = torch.Generator(device=cuda).manual_seed(12)
    dit_cfg, vae_cfg = triposg_configs_from(TRIPOSG_CONFIGS["transformer"], TRIPOSG_CONFIGS["vae"])
    put("triposg_dit", root / "TripoSG" / "transformer",
        reference_state_dict("triposg_dit", init_triposg_dit(gen, dit_cfg, torch.float16, cuda)),
        torch.float16, TRIPOSG_CONFIGS["transformer"])
    vae_state = reference_state_dict("triposg_vae", init_triposg_vae(gen, vae_cfg, torch.float16, cuda))
    put("triposg_vae", root / "TripoSG" / "vae", shape_vae_sdf(vae_state, vae_cfg), torch.float16,
        TRIPOSG_CONFIGS["vae"])
    del vae_state
    rmbg_state = reference_state_dict("rmbg", rmbg_module.init_rmbg(gen, device=cuda))
    put("rmbg", root / "RMBG", brightness_rmbg(rmbg_state), torch.float32)
    torch.cuda.empty_cache()
    return written


def read_tree(root: Path) -> dict:
    """Each family read with the port's reader (memory-mapped, every float
    checked finite), converted, shape-verified and placed on the card:
    seconds, GB, GB/s and the process's peak host RSS after it."""
    cuda = torch.device("cuda")
    cfg = load_config("actionmesh")
    dc, ac = cfg.temporal_3D_denoiser, cfg.temporal_3D_vae
    den_cfg = DenoiserConfig(
        num_tokens_nominal=dc.num_tokens_nominal, temporal_context_size=dc.temporal_context_size,
        in_channels=dc.in_channels, num_layers=dc.num_layers, num_attention_heads=dc.num_attention_heads,
        width=dc.width, mlp_ratio=dc.mlp_ratio, cross_attention_dim=dc.cross_attention_dim,
        inflated_layers=tuple(dc.inflated_layers), gelu_approx=dc.gelu_approx,
    )
    ae_cfg = AutoencoderConfig(
        temporal_context_size=ac.temporal_context_size, in_channels=ac.in_channels,
        in_extra_channels=ac.in_extra_channels, out_dim=ac.out_dim, latent_channels=ac.latent_channels,
        width=ac.width, num_layers=ac.num_layers, num_attention_heads=ac.num_attention_heads,
        embed_frequency=ac.embed_frequency, embed_include_pi=ac.embed_include_pi,
        prediction_mode=ac.prediction_mode, gelu_approx=ac.gelu_approx,
    )
    dit_cfg, vae_cfg = triposg_configs(root / "TripoSG")
    bf = torch.bfloat16
    families = {
        "denoiser": (root / "ActionMesh" / "denoiser", lambda s: weights.convert_denoiser(s, den_cfg, bf)),
        "autoencoder": (root / "ActionMesh" / "autoencoder",
                        lambda s: weights.convert_autoencoder(s, ae_cfg, bf)),
        "triposg_dit": (root / "TripoSG" / "transformer", lambda s: weights.convert_triposg_dit(s, dit_cfg, bf)),
        "triposg_vae": (root / "TripoSG" / "vae", lambda s: weights.convert_triposg_vae(s, vae_cfg, bf)),
        "dinov2": (root / "dinov2", lambda s: weights.convert_dinov2(s, DinoV2Config(), bf)),
        "rmbg": (root / "RMBG", rmbg_module.convert_rmbg_weights),
    }
    out = {}
    for name, (path, convert) in families.items():
        t0 = time.perf_counter()
        state = weights.load_safetensors_dir(path)
        nbytes = sum(t.numel() * t.element_size() for t in state.values())
        t1 = time.perf_counter()
        tree = convert(state)
        t2 = time.perf_counter()
        params = (rmbg_module.conv_weights(tree, cuda) if name == "rmbg" else weights.params_from_jax(tree, cuda))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        n_leaves = len(leaves(params))
        del state, tree, params
        out[name] = {"gb": nbytes / 1e9, "seconds": t3 - t0, "read_seconds": t1 - t0,
                     "convert_verify_seconds": t2 - t1, "to_card_seconds": t3 - t2,
                     "gb_per_s": nbytes / 1e9 / (t3 - t0), "peak_host_rss_gib": host_peak_rss_gib(),
                     "leaves": n_leaves}
        log(f"checkpoint {name}: {nbytes / 1e9:.3f} GB in {t3 - t0:.2f} s ({nbytes / 1e9 / (t3 - t0):.2f} GB/s: "
            f"read + finite check {t1 - t0:.2f} s, convert + verify {t2 - t1:.2f} s, to the card "
            f"{t3 - t2:.2f} s), {n_leaves} leaves; peak host RSS {out[name]['peak_host_rss_gib']:.2f} GiB")
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def recording(module, name: str, record):
    """Replace ``module.name`` by ``record(original)`` for the block."""
    original = getattr(module, name)
    setattr(module, name, record(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def timed_on_card(seconds: list):
    """A wrapper that appends each call's synchronised seconds to ``seconds``."""
    def wrap(fn):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            return out
        return timed
    return wrap


def check_clip(name: str, meshes: list, out_dir: Path, faces=None) -> dict:
    """16 finite meshes on one topology (``faces`` if given), the per-frame
    GLBs, the deformation arrays and the animated GLB's 16 morph targets."""
    if len(meshes) != N_FRAMES:
        raise AssertionError(f"{name}: {len(meshes)} meshes for {N_FRAMES} frames")
    faces = meshes[0].faces if faces is None else faces
    verts = np.stack([m.vertices for m in meshes])
    if not (np.isfinite(verts).all() and all(np.array_equal(m.faces, faces) for m in meshes)):
        raise AssertionError(f"{name}: vertices not finite or faces not shared")
    for i in range(N_FRAMES):
        if not np.array_equal(load_glb(out_dir / f"mesh_{i:02d}.glb").faces, faces):
            raise AssertionError(f"{name}: mesh_{i:02d}.glb does not hold the faces")
    dv = np.load(out_dir / "deformations_vertices.npy")
    targets = glb_json(out_dir / "animated_mesh.glb")["meshes"][0]["primitives"][0]["targets"]
    if dv.shape != (N_FRAMES, len(meshes[0].vertices), 3) or len(targets) != N_FRAMES:
        raise AssertionError(f"{name}: deformations {dv.shape}, {len(targets)} morph targets")
    return {"vertices": int(verts.shape[1]), "faces": int(len(faces)),
            "max_displacement": float(np.abs(verts[1:] - verts[0]).max())}


def write_video(path: Path, frames: list[np.ndarray], fps: int = 8) -> str:
    """The RGB of ``frames`` as a video OpenCV writes: MPEG-4 Part 2
    (``mp4v``) in an .mp4 where this OpenCV can encode it, else Motion JPEG
    in an .avi beside it. Returns the fourcc used."""
    import cv2

    h, w = frames[0].shape[:2]
    for fourcc, suffix in (("mp4v", ".mp4"), ("MJPG", ".avi")):
        out = path.with_suffix(suffix)
        writer = cv2.VideoWriter(str(out), cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
        if writer.isOpened():
            for f in frames:
                writer.write(cv2.cvtColor(np.ascontiguousarray(f[..., :3]), cv2.COLOR_RGB2BGR))
            writer.release()
            return fourcc
    raise RuntimeError("this OpenCV can encode neither mp4v nor MJPG")


def weights_cli(name: str, input_path: Path, out_dir: Path) -> dict:
    """The video-to-4D CLI with ``--weights_dir`` on the synthetic tree at
    full width and --turbo, on frames without alpha (RMBG mattes them):
    launch counts, RMBG's alpha on the object, the clip's files."""
    rmbg_seen = []

    def record_rmbg(fn):
        def process_images(self, frames_in):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(self, frames_in)
            torch.cuda.synchronize()
            rmbg_seen.append({"seconds": time.perf_counter() - t, "alphas": [o[..., 3] for o in out]})
            return out
        return process_images

    reset_counters()
    t0 = time.perf_counter()
    with recording(background.BackgroundRemover, "process_images", record_rmbg):
        result = cli.main(["--input", str(input_path), "--output_dir", str(out_dir), "--seed", "44",
                           "--weights_dir", str(CKPT_DIR), "--turbo", "--no_render"])
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counters()
    pipe = result.pop("pipeline")
    if not (isinstance(pipe.image_to_3d, TripoSGPipeline) and pipe.background_removal._model is not None):
        raise AssertionError(f"{name}: the CLI did not load TripoSG and RMBG from the tree")
    want_flash, want_rope = expected_launches(pipe, N_FRAMES)
    phase_s, seconds = dict(pipe.phase_seconds), result["seconds"]
    stage0_s = dict(pipe.stage0_seconds)
    del pipe
    alphas = rmbg_seen[0]["alphas"]
    coverage = [float((a > 0).mean()) for a in alphas]
    in_object = [float((a[64:192, 32 + 4 * i : 160 + 4 * i] > 0).mean()) for i, a in enumerate(alphas)]
    clip = check_clip(name, result["meshes"], out_dir)
    log(f"{name} (turbo, --weights_dir): clip {sum(seconds.values()):.2f} s = "
        + " + ".join(f"{k} {v:.2f}" for k, v in seconds.items()) + " | pipeline phases "
        + " ".join(f"{k} {v:.2f}" for k, v in phase_s.items()) + " | stage0 "
        + " ".join(f"{k} {v:.2f}" for k, v in stage0_s.items())
        + f" | RMBG {rmbg_seen[0]['seconds']:.2f} s for {N_FRAMES} frames at 1024^2 | with the "
        f"pipeline's set-up (reading the tree) {wall_s:.2f} s")
    log(f"{name}: alpha covers {min(coverage):.3f}-{max(coverage):.3f} of each frame, "
        f"{min(in_object):.3f}-{max(in_object):.3f} of the object; mesh {clip}; launches flash_fwd "
        f"{launches['flash_fwd']} (expected {want_flash}), rms_rope {launches['fused_rms_rope']} "
        f"(expected {want_rope})")
    if (launches["flash_fwd"], launches["fused_rms_rope"]) != (want_flash, want_rope) or not want_flash:
        raise AssertionError(f"{name}: launch counts {launches} != ({want_flash}, {want_rope})")
    if any(launches[k] for k in COUNTERS[2:]):
        raise AssertionError(f"{name}: a backward kernel or kernel F launched: {launches}")
    if not (min(in_object) > 0.95 and max(coverage) < 0.5):
        raise AssertionError(f"{name}: RMBG's alpha does not follow the object: {coverage} {in_object}")
    return {"launches": launches, "expected_launches": {"flash_fwd": want_flash, "fused_rms_rope": want_rope},
            "seconds": seconds, "phase_seconds": phase_s, "stage0_seconds": stage0_s,
            "rmbg_seconds": rmbg_seen[0]["seconds"], "alpha_coverage": coverage,
            "alpha_in_object": in_object, "wall_seconds": wall_s, "clip": clip}


def phase_checkpoints() -> dict:
    """The synthetic production tree written, read back (per family: s, GB,
    GB/s, peak host RSS), then the video-to-4D CLI with ``--weights_dir`` on
    it at full width and the turbo preset twice: on 16 RGB PNG frames
    without alpha, and on the same frames as a video that OpenCV writes and
    the loader decodes (RMBG mattes both)."""
    t0 = time.perf_counter()
    written = write_synthetic_tree(CKPT_DIR)
    write_s = time.perf_counter() - t0
    log(f"checkpoints: synthetic tree written in {write_s:.1f} s: " + ", ".join(
        f"{k} {v['gb']:.3f} GB ({len(v['files'])} files, {v['write_seconds']:.1f} s)" for k, v in written.items()))
    read = read_tree(CKPT_DIR)

    work = OUT_DIR / "weights_cli"
    shutil.rmtree(work, ignore_errors=True)
    frames = make_frames()
    (work / "frames").mkdir(parents=True)
    for i, f in enumerate(frames):  # RGB only: no alpha, so RMBG runs
        write_png(work / "frames" / f"{i:02d}.png", f[..., :3])
    out = weights_cli("checkpoints cli", work / "frames", work / "out")
    fourcc = write_video(work / "clip", frames)
    video = next(work.glob("clip.*"))
    t0 = time.perf_counter()
    decoded = load_frames(video)
    load_s = time.perf_counter() - t0
    log(f"video cli: {video.name} ({fourcc}, {video.stat().st_size} bytes) decodes to "
        f"{decoded.n_frames} frames of {decoded.frames[0].shape} in {load_s:.3f} s")
    if decoded.n_frames != N_FRAMES or decoded.frames[0].shape != frames[0].shape:
        raise AssertionError(f"video cli: {decoded.n_frames} frames of {decoded.frames[0].shape}")
    video_run = dict(weights_cli("video cli", video, work / "video_out"), video=video.name, fourcc=fourcc,
                     decode_seconds=load_s)
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"written": written, "write_seconds": write_s, "read": read, **out, "video": video_run}


# -- the small tree: card vs CPU from one checkpoint -------------------------------

# TripoSG at small width with head dim 64 everywhere: config.json carries no
# VAE heads (8 by default), so the VAE is 512 wide; the latent is the small
# configuration's (32, 8)
SMALL_TRIPOSG_CONFIGS = {
    "transformer": {"num_tokens": 32, "in_channels": 8, "num_layers": 3, "width": 128,
                    "num_attention_heads": 2, "cross_attention_dim": SMALL_DINO.hidden_size},
    "vae": {"latent_channels": 8, "num_tokens": 32, "embed_frequency": 8, "width_encoder": 512,
            "num_layers_encoder": 1, "width_decoder": 512, "num_layers_decoder": 2},
}
SMALL_CKPT_UPDATES = {"stage_0.num_inference_steps": 4, "stage_0.prefilter_octree_depth": 4}
RMBG_FRAMES = 2


@contextlib.contextmanager
def small_dinov2():
    """The pipelines' default DINOv2 config is SMALL_DINO for the block."""
    with recording(image_encoder_module, "DinoV2Config", lambda _: lambda: SMALL_DINO):
        yield


def phase_small_checkpoint() -> dict:
    """A small tree (ActionMesh at SMALL_UPDATES, TripoSG and DINOv2 small,
    RMBG-1.4 at full size, random) loaded on the card and on the CPU:
    TripoSG's Stage 0 (latents and meshes within 1e-4, equal faces), then
    the slice from the CPU's anchor on both (vertices within 1e-4, fp32, no
    TF32); RMBG at 1024² on both: logits within 1e-4 of their largest
    magnitude, mattes within one level, refined alphas in all but 0.5% of
    the pixels."""
    torch.backends.cudnn.allow_tf32 = False
    root = OUT_DIR / "small_weights"
    shutil.rmtree(root, ignore_errors=True)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    dev = ActionMeshPipeline(config_updates=dict(SMALL_UPDATES), weights_dir=None, device=cpu,
                             dtype=torch.float32)
    write_checkpoint(root / "ActionMesh" / "denoiser",
                     reference_state_dict("denoiser", dev.denoiser_params, dev.denoiser_config.num_attention_heads))
    write_checkpoint(root / "ActionMesh" / "autoencoder",
                     reference_state_dict("autoencoder", dev.autoencoder_params,
                                          dev.autoencoder_config.num_attention_heads))
    gen = torch.Generator().manual_seed(13)
    write_checkpoint(root / "dinov2", reference_state_dict("dinov2", init_dinov2(gen, SMALL_DINO)))
    dit_cfg, vae_cfg = triposg_configs_from(SMALL_TRIPOSG_CONFIGS["transformer"], SMALL_TRIPOSG_CONFIGS["vae"])
    write_checkpoint(root / "TripoSG" / "transformer",
                     reference_state_dict("triposg_dit", init_triposg_dit(gen, dit_cfg)),
                     config=SMALL_TRIPOSG_CONFIGS["transformer"])
    write_checkpoint(root / "TripoSG" / "vae",
                     shape_vae_sdf(reference_state_dict("triposg_vae", init_triposg_vae(gen, vae_cfg)), vae_cfg),
                     config=SMALL_TRIPOSG_CONFIGS["vae"])
    write_checkpoint(root / "RMBG", reference_state_dict("rmbg", rmbg_module.init_rmbg(gen)))
    del dev
    pipes, stage0 = {}, {}
    with small_dinov2():
        for name, device in (("cpu", cpu), ("cuda", cuda)):
            pipes[name] = ActionMeshPipeline(config_updates=dict(SMALL_UPDATES, **SMALL_CKPT_UPDATES),
                                             weights_dir=root, device=device, dtype=torch.float32)
    for name, pipe in pipes.items():
        tripo = pipe.image_to_3d

        def anchor(image, _tripo=tripo, _name=name, **kw):
            stage0[_name] = _tripo(image, **{**kw, **SMALL_STAGE0_DECODE})
            lat, mesh = stage0["cpu"]  # the CPU's anchor for both
            return lat.to(_tripo.device), Mesh(vertices=mesh.vertices, faces=mesh.faces)

        pipe.image_to_3d = anchor
    inp = ActionMeshInput(frames=make_frames(), timesteps=np.arange(N_FRAMES, dtype=np.float32))
    ref = np.stack([m.vertices for m in pipes["cpu"](inp, seed=3)])
    reset_counters()
    out = np.stack([m.vertices for m in pipes["cuda"](inp, seed=3)])
    launches = read_counters()
    (lat_c, mesh_c), (lat_g, mesh_g) = stage0["cpu"], stage0["cuda"]
    lat_err = (lat_g.cpu() - lat_c).abs().max().item()
    same_faces = np.array_equal(mesh_c.faces, mesh_g.faces)
    mesh_err = float(np.abs(mesh_c.vertices - mesh_g.vertices).max()) if same_faces else None
    err = float(np.abs(out - ref).max())
    log(f"small checkpoint: Stage 0 latents card vs CPU {lat_err:.3e}, mesh {mesh_c.n_faces} faces, equal "
        f"{same_faces}, vertices {mesh_err}; slice {out.shape[0]} meshes x {out.shape[1]} vertices, max abs "
        f"err {err:.3e} (tol 1e-4); launches {launches}")
    if not (lat_err <= 1e-4 and same_faces and mesh_c.n_faces > 0 and mesh_err <= 1e-4):
        raise AssertionError(f"small checkpoint: Stage 0 differs: {lat_err}, {same_faces}, {mesh_err}")
    if not (err <= 1e-4 and np.isfinite(out).all() and launches["flash_fwd"] and launches["fused_rms_rope"]):
        raise AssertionError(f"small checkpoint: card and CPU disagree ({err}) or no kernel ran ({launches})")

    # RMBG-1.4 at its 1024² input, fp32 without TF32, on both
    models = {n: p.background_removal._model for n, p in pipes.items()}
    rgb = [f[..., :3] for f in make_frames(RMBG_FRAMES)]
    x = torch.from_numpy(np.stack([pil_resize(f, (1024, 1024), "bilinear") for f in rgb]))
    x = (x.permute(0, 3, 1, 2).float() / 255.0 - 0.5) / 1.0
    with torch.no_grad():
        logit_c = rmbg_module.rmbg_forward(models["cpu"].params, x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logit_g = rmbg_module.rmbg_forward(models["cuda"].params, x.to(cuda))
        torch.cuda.synchronize()
        rmbg_s = time.perf_counter() - t0
    logit_err = (logit_g.cpu() - logit_c).abs().max().item()
    logit_max = logit_c.abs().max().item()
    mattes = {n: m.predict_mattes(rgb) for n, m in models.items()}
    matte_err = max(int(np.abs(a.astype(int) - b).max()) for a, b in zip(mattes["cpu"], mattes["cuda"]))
    alphas = {n: pipes[n].background_removal.process_images(rgb) for n in pipes}
    differ = max(float((a[..., 3] != b[..., 3]).mean()) for a, b in zip(alphas["cpu"], alphas["cuda"]))
    log(f"small checkpoint RMBG 1024^2 fp32 ({RMBG_FRAMES} frames): logits card vs CPU {logit_err:.3e} "
        f"(max |logit| {logit_max:.3e}, tol {1e-4 * logit_max:.3e}), mattes {matte_err} levels, refined "
        f"alphas differ in {100 * differ:.3f}% of the pixels; card forward {rmbg_s:.3f} s")
    if not (logit_err <= 1e-4 * logit_max and matte_err <= 1 and differ <= 0.005):
        raise AssertionError(f"small checkpoint: RMBG card vs CPU {logit_err}, {matte_err}, {differ}")
    del pipes, models
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"stage0_latent_err": lat_err, "stage0_vertex_err": mesh_err, "vertex_err": err,
            "launches": launches, "rmbg_logit_err": logit_err, "rmbg_logit_max": logit_max,
            "rmbg_matte_levels": matte_err, "rmbg_alpha_differ_share": differ,
            "rmbg_card_forward_seconds": rmbg_s, "rmbg_frames": RMBG_FRAMES}


# -- {video + 3D mesh} -> 4D through its CLI at full width ------------------------

VIDEO_3D_STAGE1_STEPS = 4  # the turbo preset's Stage-I steps
ENCODER_SHAPES = {"vae_encoder_cross": ((1, 8, 2048, 64), (1, 8, 16384, 64)),
                  "vae_encoder_self": ((1, 8, 2048, 64), (1, 8, 2048, 64))}


def textured_anchor(seed: int = 0) -> Mesh:
    """A UV sphere off centre, every face on its own three vertices (so the
    merge map has work), a uv per vertex."""
    s = make_uv_sphere(n_lat=48, n_lon=96)
    v = s.vertices[s.faces].reshape(-1, 3) * 0.7 + np.array([0.3, -0.2, 0.1])
    uv = np.random.default_rng(seed).uniform(0, 1, (len(v), 2))
    return Mesh(vertices=v, faces=np.arange(len(v)).reshape(-1, 3), uv=uv)


def expected_launches_3d(pipe, n_frames: int, stage1_steps: int | None = None) -> tuple[int, int]:
    """``expected_launches`` with Stage 0 the VAE encode: one cross launch
    onto all surface points and one per encoder block (no qk-norm, no
    RoPE), DINOv2 on the frames only."""
    flash, rope = expected_launches(pipe, n_frames, stage0=False, stage1_steps=stage1_steps)
    vae_cfg = getattr(pipe.vae, "pipeline", pipe.vae).vae_cfg
    return flash + 1 + vae_cfg.encoder_layers, rope


def phase_video_3d() -> dict:
    """``python -m actionmesh_tpu_torch.inference.video_and_3d_to_animated_mesh``'s
    ``main`` at full width on the 16 frame pairs and a textured .glb with
    TEXCOORD_0, Stage I at the turbo preset's 4 steps: faces equal the
    input's, uv and glTF payload kept, vertices finite, launches as the path
    implies, kernel A at the two encoder shapes; seconds of sampling, FPS,
    the VAE encode, Stage I and II."""
    work = OUT_DIR / "video_3d"
    shutil.rmtree(work, ignore_errors=True)
    write_frame_pairs(work / "frames", make_frames())
    anchor = textured_anchor()
    save_textured_glb(anchor, work / "anchor.glb", np.random.default_rng(1).integers(0, 255, (64, 64, 3), np.uint8))
    shapes, fps_s, encode_s = [], [], []

    def record_attention(fn):
        def attend(q, k, v, **kw):
            shapes.append((tuple(q.shape), tuple(k.shape), q.dtype))
            return fn(q, k, v, **kw)
        return attend

    reset_counters()
    t0 = time.perf_counter()
    with recording(model_layers, "dot_product_attention", record_attention), \
            recording(triposg_vae, "farthest_point_sampling", timed_on_card(fps_s)), \
            recording(triposg_pipeline, "encode_surface", timed_on_card(encode_s)):
        result = cli3d.main(["--input", str(work / "frames"), "--mesh_input", str(work / "anchor.glb"),
                             "--output_dir", str(work / "out"), "--seed", "44",
                             "--stage_1_steps", str(VIDEO_3D_STAGE1_STEPS), "--no_render"])
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counters()
    pipe = result.pop("pipeline")
    want_flash, want_rope = expected_launches_3d(pipe, N_FRAMES, VIDEO_3D_STAGE1_STEPS)
    want_shapes = {"vae_encoder_cross": 1,
                   "vae_encoder_self": getattr(pipe.vae, "pipeline", pipe.vae).vae_cfg.encoder_layers}
    phase_s, stage0_s, seconds = dict(pipe.phase_seconds), dict(pipe.stage0_seconds), result["seconds"]
    del pipe
    by_shape = {name: sum(1 for q, k, _ in shapes if (q, k) == want) for name, want in ENCODER_SHAPES.items()}
    meshes, loaded = result["meshes"], result["anchor_mesh"]
    clip = check_clip("video_3d", meshes, work / "out", faces=anchor.faces)
    uv_kept = all(m.uv is loaded.uv for m in meshes) and np.allclose(loaded.uv, anchor.uv.astype(np.float32))
    visual_kept = all(m.visual is loaded.visual for m in meshes) and "images" in loaded.visual["gltf"]
    log(f"video_3d (turbo Stage-I steps {VIDEO_3D_STAGE1_STEPS}): clip {sum(seconds.values()):.2f} s = "
        + " + ".join(f"{k} {v:.2f}" for k, v in seconds.items()) + " | phases "
        + " ".join(f"{k} {v:.2f}" for k, v in phase_s.items())
        + f" | stage0: sampling {stage0_s['sample']:.3f} s, VAE encode {encode_s[0]:.3f} s of which FPS "
        f"{fps_s[0]:.3f} s (stage0 phase {stage0_s['vae_encode']:.3f} s, the random TripoSG built at its "
        f"first use included) | with set-up {wall_s:.2f} s")
    log(f"video_3d: {clip['vertices']} vertices / {clip['faces']} faces (the input's {anchor.n_vertices} / "
        f"{anchor.n_faces}), uv kept {uv_kept}, glTF payload kept {visual_kept}; launches flash_fwd "
        f"{launches['flash_fwd']} (expected {want_flash}), rms_rope {launches['fused_rms_rope']} (expected "
        f"{want_rope}); kernel A at the encoder shapes {by_shape}")
    if (launches["flash_fwd"], launches["fused_rms_rope"]) != (want_flash, want_rope):
        raise AssertionError(f"video_3d: launch counts {launches} != ({want_flash}, {want_rope})")
    if by_shape != want_shapes or any(launches[k] for k in COUNTERS[2:]):
        raise AssertionError(f"video_3d: encoder launches {by_shape}, others {launches}")
    if not (uv_kept and visual_kept and clip["vertices"] == anchor.n_vertices):
        raise AssertionError("video_3d: the output lost the input's uv, payload or vertex count")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "expected_launches": {"flash_fwd": want_flash, "fused_rms_rope": want_rope},
            "encoder_launches": by_shape, "seconds": seconds, "phase_seconds": phase_s,
            "sample_seconds": stage0_s["sample"], "vae_encode_seconds": encode_s[0], "fps_seconds": fps_s[0],
            "wall_seconds": wall_s, "clip": clip, "uv_kept": uv_kept}


VAE_STEPS = 2
VAE_BATCH, VAE_NEAR, VAE_UNIFORM = 4, 12288, 4096  # 16,384 queries a shape, 3:1 near:uniform
VAE_POINTS = VAE_NEAR + VAE_UNIFORM  # also the surface points a shape


def expected_vae_launches(cfg: TripoSGVAEConfig, steps: int, evals: int) -> dict:
    """Kernel launches of ``steps`` VAE train steps and ``evals`` held-out
    eval forwards: the encoder cross, each encoder and decoder block's self
    attention and the SDF query cross, kernel A once each a forward; C and
    D once each a step (no remat); no qk-norm or rotation (no B)."""
    n = 2 + cfg.encoder_layers + cfg.decoder_layers
    return dict(zip(COUNTERS, (n * (steps + evals), 0, n * steps, n * steps, 0, 0)))


def phase_train_vae() -> dict:
    """VAE training (``run_vae_training``) at the production TripoSGVAEConfig
    on fp32 (TF32 off): VAE_STEPS steps of batch 4 on exact-TSDF pools of
    ``make_scene`` anchors (``build_sdf_dataset``: 16,384 surface points
    with normals and 12,288 near-surface + 4,096 uniform queries a shape),
    then one held-out eval (posterior-mean TSDF MSE) of 4 more scenes;
    checks finite losses, moved params, the launch counts, and a vae.npz
    export that reloads equal to the params."""
    from actionmesh_tpu_torch.training.checkpoint import export_for_inference
    from actionmesh_tpu_torch.training.closed_loop import CascadeSpec, build_sdf_dataset, load_sdf_dataset
    from actionmesh_tpu_torch.training.loop import run_vae_training
    from actionmesh_tpu_torch.training.vae_train import sdf_batches
    from actionmesh_tpu_torch.utils.weights import load_npz

    label = "train VAE float32"
    work = OUT_DIR / "vae"
    shutil.rmtree(work, ignore_errors=True)
    cfg = TripoSGVAEConfig()
    uids = [f"scene_{i:04d}" for i in range(2 * VAE_BATCH)]
    t0 = time.perf_counter()
    # one host thread a scene: the exact TSDF is numpy over (query x face)
    # tiles, ~14 s a scene of 16,384 queries in one thread
    spec = CascadeSpec(surface_samples=VAE_POINTS)
    with ThreadPoolExecutor(len(uids)) as pool:
        list(pool.map(lambda uid: build_sdf_dataset(work, spec, [uid], n_near=VAE_NEAR,
                                                    n_uniform=VAE_UNIFORM), uids))
    train_scenes = load_sdf_dataset(work, uids[:VAE_BATCH])
    eval_set = list(sdf_batches(load_sdf_dataset(work, uids[VAE_BATCH:]), VAE_BATCH, VAE_POINTS,
                                seed=123, epochs=1))
    data_s = time.perf_counter() - t0
    loop_cfg = TrainLoopConfig(total_steps=VAE_STEPS, warmup_steps=1, ema_decay=None, log_every=1,
                               ckpt_every=0, eval_every=VAE_STEPS, keep_best_eval=True,
                               out_dir=str(work / "run"), resume=False, time_phases=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    with no_plain_version_on_card():
        state, history = run_vae_training(
            cfg, sdf_batches(train_scenes, VAE_BATCH, VAE_POINTS, seed=0), loop_cfg,
            device=torch.device("cuda"), eval_batches=eval_set)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counters()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    losses, step_s, phases = train_summary(label, history, peak_gib, run_s)
    evals = [h for h in history if "eval_loss" in h]
    want = expected_vae_launches(cfg, VAE_STEPS, len(evals))
    log(f"{label}: batch {VAE_BATCH}, {VAE_POINTS} surface points and {VAE_POINTS} queries a shape "
        f"(exact TSDF of {len(uids)} scenes, data {data_s:.1f} s) | eval {evals} | launches {launches} "
        f"(expected {want})")
    if launches != want:
        raise AssertionError(f"{label} launch counts {launches} != {want}")
    if len(losses) != VAE_STEPS or len(evals) != 1 or not math.isfinite(evals[0]["eval_loss"]):
        raise AssertionError(f"{label}: losses {losses}, evals {evals}")
    init = init_triposg_vae(torch.Generator("cuda").manual_seed(loop_cfg.seed), cfg, device=torch.device("cuda"))
    check_moved(label, state["params"], init)
    del init
    path = export_for_inference(state, work / "export", stage="stage0_vae", compute_dtype=None)
    reloaded = load_npz(path, device=torch.device("cuda"))
    same = all(n == m and torch.equal(a, b) for (n, a), (m, b) in
               zip(named_leaves(reloaded), named_leaves(state["params"])))
    same = same and len(leaves(reloaded)) == len(leaves(state["params"]))
    log(f"{label}: exported {path.name} ({path.stat().st_size / 1e9:.2f} GB), reloaded equal to the "
        f"params: {same}")
    if not (path.name == "vae.npz" and same):
        raise AssertionError(f"{label}: the export does not reload as the params")
    n_params = sum(p.numel() for p in leaves(state["params"]))
    del state, reloaded
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"dtype": "float32", "params": n_params, "launches": launches, "expected_launches": want,
            "losses": losses, "step_seconds": step_s, "phase_seconds": phases, "eval": evals[0],
            "peak_gib": peak_gib, "run_seconds": run_s, "data_seconds": data_s,
            "shape": {"batch": VAE_BATCH, "surface_points": VAE_POINTS, "queries": VAE_POINTS,
                      "attention": VAE_TRAIN_SHAPES}}


@contextlib.contextmanager
def no_plain_version_on_card():
    """Fails the run if a plain version of kernels A-E (forward or
    backward) is handed a CUDA tensor: on the card every wrapper must
    launch its kernel."""
    from actionmesh_tpu_torch.ops import nn_argmin as nn_module

    plains = ((flash_ops, "chunked_attention", "kernel A's"),
              (flash_ops, "chunked_attention_trainable", "kernels A, C and D's"),
              (rope_norm, "rms_rope_reference", "kernel B's"),
              (nn_module, "nn_argmin_reference", "kernel E's"))

    def guard(plain, what):
        def guarded(x, *args, **kw):
            if x.is_cuda:
                raise AssertionError(f"{what} plain version was called with a CUDA tensor")
            return plain(x, *args, **kw)
        return guarded

    saved = [getattr(module, attr) for module, attr, _ in plains]
    for (module, attr, what), plain in zip(plains, saved):
        setattr(module, attr, guard(plain, what))
    try:
        with no_plain_backward_on_card():
            yield
    finally:
        for (module, attr, _), plain in zip(plains, saved):
            setattr(module, attr, plain)


def phase_prepare_clips() -> dict:
    """``python -m actionmesh_tpu_torch.prepare_clips``'s ``main`` on the 16
    synthetic frame pairs at the turbo preset (full widths, random weights,
    DevTripoSG's 25 guidance-free Stage-0 steps, 4 Stage-I steps): one clip
    npz that ``ClipWindowDataset`` loads, with the production shapes,
    finite values and timesteps in order."""
    from actionmesh_tpu_torch import prepare_clips
    from actionmesh_tpu_torch.ops import nn_argmin as nn_module
    from actionmesh_tpu_torch.training.data import ClipWindowDataset

    work = OUT_DIR / "prepare_clips"
    shutil.rmtree(work, ignore_errors=True)
    write_frame_pairs(work / "in" / "clip_0", make_frames())
    reset_counters()
    nn_module.nn_argmin.launches = 0
    t0 = time.perf_counter()
    with no_plain_version_on_card():
        rc = prepare_clips.main(["--input", str(work / "in"), "--out", str(work / "out"),
                                 "--config-name", "actionmesh_turbo", "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counters()
    item = ClipWindowDataset(work / "out", window=N_FRAMES)[0]
    shapes = {k: list(v.shape) for k, v in item.items()}
    finite = all(bool(np.isfinite(v).all()) for v in item.values())
    log(f"prepare_clips turbo: rc {rc}, {seconds:.1f} s (pipeline built in the call), clip {shapes}, "
        f"finite {finite}, launches {launches}")
    want = {"latents": [N_FRAMES, 2048, 64], "context": [N_FRAMES, 257, 1024], "framestep": [N_FRAMES]}
    if rc != 0 or shapes != want or not finite or not np.array_equal(item["framestep"], np.arange(N_FRAMES)):
        raise AssertionError(f"prepare_clips: rc {rc}, shapes {shapes}, finite {finite}")
    if not (launches["flash_fwd"] and launches["fused_rms_rope"]):
        raise AssertionError(f"prepare_clips: kernels A and B not launched: {launches}")
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"seconds": seconds, "shapes": shapes, "launches": launches}


# The closed loop at the micro spec of tests/test_closed_loop.py (head dims
# 32 in the denoiser and decoder, 32 in the DiT, 16 in the VAE, 12 in
# DINOv2), 2 train + 1 eval scenes, through its entry point's phases.
CLOSED_LOOP_SPEC = dict(image_size=96, surface_samples=256, track_points=128, gt_points=2000, n_lat=12,
                        n_lon=16, denoiser_width=64, denoiser_layers=2, denoiser_heads=2,
                        decoder_width=64, decoder_layers=2, decoder_heads=2, num_inference_steps=2)
CLOSED_LOOP_STEPS = {"vae": 100, "dit": 25, "flow": 20, "decoder": 20, "distill": 4}
CLOSED_LOOP_VARIANTS = ("random", "trained", "oracle", "video")


def phase_closed_loop() -> dict:
    """``python -m actionmesh_tpu_torch.closed_loop``'s ``main`` at the micro
    spec on the card: build, stage0 (VAE on exact TSDF, DiT), train (flow,
    decoder), distill, then eval of the random, trained, oracle and video
    (Stage 0 from the anchor frame) variants with the ActionBench harness at
    its closed-loop settings (200 ICP steps, 5,000 ICP points). Every
    variant must score every scene with finite CDs; kernels A to E must
    launch and no plain version run on the card."""
    from actionmesh_tpu_torch import closed_loop as cl_entry
    from actionmesh_tpu_torch.ops import nn_argmin as nn_module

    root = OUT_DIR / "closed_loop"
    shutil.rmtree(root, ignore_errors=True)
    common = ["--root", str(root), "--device", "cuda", "--batch", "2"]
    spec = [f for k, v in CLOSED_LOOP_SPEC.items() for f in ("--spec", f"{k}={v}")]
    st = CLOSED_LOOP_STEPS
    runs = [
        ("build", ["build", "--n-train", "2", "--n-eval", "1", *spec]),
        ("stage0", ["stage0", "--vae-steps", str(st["vae"]), "--dit-steps", str(st["dit"]),
                    "--vae-query-points", "512"]),
        ("train", ["train", "--flow-steps", str(st["flow"]), "--decoder-steps", str(st["decoder"])]),
        ("distill", ["distill", "--distill-steps", str(st["distill"])]),
        ("eval", ["eval", "--variants", ",".join(CLOSED_LOOP_VARIANTS)]),
    ]
    reset_counters()
    nn_module.nn_argmin.launches = 0
    seconds, report = {}, {}
    with no_plain_version_on_card():
        for name, argv in runs:
            t0 = time.perf_counter()
            out = cl_entry.main([*argv, *common])
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            if name == "eval":
                report = out
    launches = {**read_counters(), "nn_argmin": nn_module.nn_argmin.launches}
    log(f"closed loop (micro spec): seconds {seconds} | launches {launches} | report {report}")
    bad = [v for v in CLOSED_LOOP_VARIANTS if v not in report
           or report[v]["n_success"] != report[v]["n_samples"]
           or not all(math.isfinite(report[v][k]) for k in ("cd_3d", "cd_4d", "cd_motion"))]
    if bad:
        raise AssertionError(f"closed loop: variants {bad} did not score every scene: {report}")
    missing = [k for k in ("flash_fwd", "fused_rms_rope", "flash_bwd_dkv", "flash_bwd_dq",
                           "fused_rms_rope_bwd", "nn_argmin") if not launches[k]]
    if missing:
        raise AssertionError(f"closed loop: {missing} never launched on the card: {launches}")
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"seconds": seconds, "launches": launches, "report": report, "steps": st,
            "spec": CLOSED_LOOP_SPEC}


SERVE_SHORT = {"stage_0_steps": 5, "stage_1_steps": 2}  # the profiled and concurrent requests
KERNEL_A_16BIT = "flash_fwd_16bit_kernel"  # kernel A's bf16 / fp16 device function


class ServedPipeline:
    """The server's pipeline behind a counter of the requests inside it at
    once; ``profile_dir`` set runs the next request inside ``profile_to``
    (on the handler thread: torch.profiler records the thread that starts
    it) and keeps that profiler as ``profiled``."""

    def __init__(self, pipe):
        self.pipe, self.device = pipe, pipe.device
        self.in_flight = self.max_in_flight = 0
        self.profile_dir, self.profiled = None, None
        self._lock = threading.Lock()

    def __call__(self, inp, **kw):
        with self._lock:
            self.in_flight += 1
            self.max_in_flight = max(self.max_in_flight, self.in_flight)
            profile_dir, self.profile_dir = self.profile_dir, None
        try:
            if profile_dir is None:
                return self.pipe(inp, **kw)
            with profile_to(profile_dir) as prof:
                out = self.pipe(inp, **kw)
                torch.cuda.synchronize()
            self.profiled = prof
            return out
        finally:
            with self._lock:
                self.in_flight -= 1


def fresh_thread_launches() -> dict:
    """Kernels A, C and D as the first CUDA work of a new thread, as in a
    server's request thread (whose tensors the allocator may serve from its
    cache without binding the card's context to the thread): attention
    forward and backward through ``flash_attention_trainable`` in bf16 and
    fp32, equal bit for bit to the same calls on the main thread (the
    kernels are deterministic)."""
    gen = torch.Generator(device="cuda").manual_seed(77)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (heads_view(gen, 1, S, 2, 128, dtype).detach().requires_grad_() for S in (300, 500, 500))
        do = heads_view(gen, 1, 300, 2, 128, dtype)

        def run():
            o = flash_attention_trainable(q, k, v)
            grads = torch.autograd.grad(o, (q, k, v), do)
            torch.cuda.synchronize()
            return (o.detach(), *grads)

        results, errors = [], []

        def in_thread():
            try:
                results.append(run())
            except Exception as e:  # reported below, on the main thread
                errors.append(f"{type(e).__name__}: {e}")

        thread = threading.Thread(target=in_thread)
        thread.start()
        thread.join()
        if errors:
            raise AssertionError(f"kernels A, C, D in a new thread ({dtype}): {errors[0]}")
        same = all(torch.equal(a, b) for a, b in zip(results[0], run()))
        out[str(dtype)[6:]] = same
        if not same:
            raise AssertionError(f"kernels A, C, D in a new thread ({dtype}) differ from the main thread's")
    log(f"fresh-thread launches of A, C, D equal the main thread's: {out}")
    return out


def http_json(url: str, body: dict | None = None) -> tuple[int, dict, float]:
    """GET (``body`` None) or POST ``body`` as JSON: (status, reply, seconds)."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"},
                                 method="GET" if body is None else "POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.status, json.loads(r.read()), time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), time.perf_counter() - t0


def phase_serve() -> dict:
    """Kernels A, C and D launched first thing in a new thread
    (``fresh_thread_launches``); then
    ``python -m actionmesh_tpu_torch.inference.serve``'s ``build_server``
    at the turbo preset's full width (random weights) with ``--prewarm`` on
    the 16 frame pairs, served from a thread: /healthz reports cuda; a short
    request (5 Stage-0 steps, 2 Stage-I steps) inside ``profile_to`` leaves
    the spans stage1_window_0 and stage2_window_0 and kernel A's device
    kernel in the trace; a turbo request after it gives 16 GLBs with the
    anchor's topology, the deformation arrays, an animated GLB with 16 morph
    targets and the launches of the preset's steps (the short request's
    overrides did not outlive it); two concurrent short requests
    enter the pipeline one at a time; a bad request is answered 400 and the
    server answers again after it."""
    from actionmesh_tpu_torch.inference import serve as serve_entry

    fresh = fresh_thread_launches()
    work = OUT_DIR / "serve"
    shutil.rmtree(work, ignore_errors=True)
    frames_dir = work / "frames"
    write_frame_pairs(frames_dir, make_frames())
    t0 = time.perf_counter()
    httpd, srv = serve_entry.build_server([
        "--config", "actionmesh_turbo", "--port", "0", "--weights_dir", str(work / "no_weights"),
        "--prewarm", str(frames_dir)])
    build_s, prewarm_s = time.perf_counter() - t0, srv.prewarm_seconds
    log(f"serve: build_server {build_s:.2f} s, of which the prewarm run {prewarm_s:.2f} s")
    pipe = srv.pipeline
    served = srv.pipeline = ServedPipeline(pipe)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    totals = dict.fromkeys(COUNTERS, 0)
    requests = {}

    def request(name: str, body: dict, concurrent: int = 1) -> list:
        """POST ``body`` ``concurrent`` times at once; check each reply and
        the launches against what the path implies for each request."""
        replies = []
        reset_counters()
        threads = [threading.Thread(target=lambda i=i: replies.append(http_json(
            f"{url}/v1/video_to_4d", {**body, "output_dir": str(work / f"{name}_{i}")})))
            for i in range(concurrent)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        launches = read_counters()
        for k in COUNTERS:
            totals[k] += launches[k]
        bad = [r for r in replies if r[0] != 200]
        if len(replies) != concurrent or bad:
            raise AssertionError(f"serve {name}: replies {replies}")
        # from the request's own overrides: they hold for that request only
        want_flash, want_rope = expected_launches(pipe, N_FRAMES, stage0_steps=body.get("stage_0_steps"),
                                                  stage1_steps=body.get("stage_1_steps"))
        want = {"flash_fwd": concurrent * want_flash, "fused_rms_rope": concurrent * want_rope}
        if {k: launches[k] for k in want} != want or any(launches[k] for k in COUNTERS[2:]):
            raise AssertionError(f"serve {name}: launches {launches} != {want}")
        for i, (_, reply, wall_s) in enumerate(replies):
            out_dir = work / f"{name}_{i}"
            meshes = [load_glb(p) for p in reply["artifacts"]["meshes"]]
            clip = check_clip(f"serve {name}", meshes, out_dir)
            requests[f"{name}_{i}" if concurrent > 1 else name] = {
                "generation_seconds": reply["generation_seconds"], "wall_seconds": wall_s,
                "clip": clip}
            log(f"serve {name}[{i}]: generation {reply['generation_seconds']} s, wall {wall_s:.2f} s, "
                f"{clip['vertices']} vertices / {clip['faces']} faces, launches {launches} "
                f"(expected {want})")
        return replies

    try:
        status, health, _ = http_json(f"{url}/healthz")
        if status != 200 or health["backend"] != "cuda" or health["n_devices"] < 1:
            raise AssertionError(f"serve: /healthz {status} {health}")
        # the short request first: the turbo request after it runs at the
        # preset's steps, its launches say so (a request's overrides hold
        # for that request only)
        served.profile_dir = work / "trace"
        request("profiled", {"input": str(frames_dir), "seed": 44, **SERVE_SHORT})
        request("turbo", {"input": str(frames_dir), "seed": 44})
        prof = served.profiled
        names = {e.name for e in prof.events()}
        device = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
        kernel_a = sorted(n for n in device if KERNEL_A_16BIT in n)
        (trace,) = (work / "trace").glob("trace_*.json")
        trace_names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
        spans = {"stage1_window_0", "stage2_window_0"}
        log(f"serve profiled: spans {sorted(n for n in names if 'window' in n)}, kernel A "
            f"{kernel_a}, trace {trace.name} {trace.stat().st_size / 1e6:.1f} MB")
        if not (spans <= names and spans <= trace_names and kernel_a
                and set(kernel_a) <= trace_names):
            raise AssertionError(f"serve: the profiled request's trace lacks {spans} or kernel A")
        served.max_in_flight = 0
        request("concurrent", {"input": str(frames_dir), "seed": 44, **SERVE_SHORT}, concurrent=2)
        if served.max_in_flight != 1:
            raise AssertionError(f"serve: {served.max_in_flight} requests in the pipeline at once")
        status, reply, _ = http_json(f"{url}/v1/video_to_4d", {"input": str(work / "no_frames")})
        status_after, health, _ = http_json(f"{url}/healthz")
        log(f"serve: bad request {status} {reply}; then /healthz {status_after} {health}")
        if status != 400 or status_after != 200 or health["requests"] != 4 or srv.lock.locked():
            raise AssertionError(f"serve: bad request {status}, then {status_after} {health}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
        shutil.rmtree(work, ignore_errors=True)
        del pipe, served, srv
        torch.cuda.empty_cache()
    return {"build_seconds": build_s, "prewarm_seconds": prewarm_s, "requests": requests,
            "fresh_thread_launches": fresh, "launches": totals}


def tallied_decode(tripo: TripoSGPipeline, latents: torch.Tensor, coarse_decode_dtype) -> dict:
    """One ``decode_latents`` at the default depths (prefilter 6, dense 8,
    fine 9), its SDF attention calls tallied by the dtype of q (the VAE
    decoder's blocks in the model's bf16 included) and its coarse queries
    recorded (arguments and results) for the sign comparison."""
    tally, coarse = {}, []
    at_ids, grid_inside = triposg_pipeline.query_sdf_at_ids, triposg_pipeline.query_sdf_grid_inside

    def tallied(attn):
        def fn(q, k, v, **kw):
            tally[str(q.dtype)[6:]] = tally.get(str(q.dtype)[6:], 0) + 1
            return attn(q, k, v, **kw)
        return fn

    def recorded(query):
        def fn(*args, **kw):
            out = query(*args, **kw)
            if kw.get("compute_dtype") is not None:
                coarse.append((query, args, kw, out))
            return out
        return fn

    launched = flash_attention.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with recording(model_layers, "dot_product_attention", tallied), \
            recording(triposg_pipeline, "query_sdf_at_ids", recorded), \
            recording(triposg_pipeline, "query_sdf_grid_inside", recorded):
        mesh = tripo.decode_latents(latents, prefilter_octree_depth=6,
                                    coarse_decode_dtype=coarse_decode_dtype)[0]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = flash_attention.launches - launched
    if launches != sum(tally.values()):
        raise AssertionError(f"decode: {launches} kernel-A launches for {tally} attention calls")
    return {"mesh": mesh, "seconds": seconds, "by_dtype": tally, "launches": launches,
            "chunks": dict(tripo.extract_stats), "coarse": coarse}


def coarse_sign_flips(q: dict, coarse: list) -> dict:
    """Each recorded bf16 coarse query against fp32 values at its points (the
    same query without ``compute_dtype``): how many signs differ and the
    largest |fp32 value| among them, beside the largest |fp32 value|."""
    params, cfg, kv = q["params"], q["cfg"], q["kv"]
    flips = points = 0
    flipped_max = value_max = 0.0
    for query, args, kw, out in coarse:
        reg = kw.get("regularizer")
        if query is triposg_vae.query_sdf_grid_inside:
            _, _, _, lo, step, level, Rc = args
            idx = np.arange(-(-Rc**3 // QUERY_CHUNK) * QUERY_CHUNK)
            ijk = np.stack([idx // (Rc * Rc), (idx // Rc) % Rc, idx % Rc], -1).astype(np.int32)
            vals = query_sdf_at_ids(params, cfg, kv, ijk, lo, step, regularizer=reg)[: Rc**3] - level
            signs = out[: Rc**3].astype(bool)
        else:
            _, _, _, ijk, lo, step = args
            vals = query_sdf_at_ids(params, cfg, kv, ijk, lo, step, regularizer=reg)
            signs = out < 0
        differ = signs != (vals < 0)
        flips += int(differ.sum())
        points += int(vals.size)
        value_max = max(value_max, float(np.abs(vals).max()))
        if differ.any():
            flipped_max = max(flipped_max, float(np.abs(vals[differ]).max()))
    return {"points": points, "sign_flips": flips, "max_abs_value_flipped": flipped_max,
            "max_abs_value": value_max}


def chamfer(a: np.ndarray, b: np.ndarray) -> float:
    """Symmetric Chamfer distance of two vertex sets: the mean distance to
    the nearest point of the other set, summed over both directions."""
    from scipy.spatial import cKDTree

    return float(cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())


COARSE_FLIP_REL = 2.0**-7  # bf16's relative rounding: a flipped sign lies within it of the level


def phase_coarse_bf16(q: dict) -> tuple[dict, Mesh]:
    """``decode_latents`` of the slice's Stage-0 latents (its DevTripoSG VAE
    at full width, bf16, the dev regularizer) at the default depths, once in
    fp32 and once with ``coarse_decode_dtype="bfloat16"``: the bf16 decode
    launches kernel A's bf16 path once per prefilter and band chunk and its
    fp32 path once per fine chunk; every coarse sign that differs from the
    fp32 field lies within 2^-7 of the largest |value| of the level; the
    meshes' symmetric Chamfer distance is below one fine cell. Returns the
    report and the fp32 decode's mesh."""
    tripo = TripoSGPipeline(None, q["params"], None, vae_cfg=q["cfg"], dtype=torch.bfloat16,
                            device=q["kv"].device)
    tripo.sdf_regularizer = _dev_sdf_regularizer
    tripo.sdf_regularizer_torch = _dev_sdf_regularizer_torch
    dec_layers = q["cfg"].decoder_layers
    reset_counters()
    runs = {name: tallied_decode(tripo, q["latents"], dtype)
            for name, dtype in (("fp32", None), ("bf16", "bfloat16"))}
    launches = read_counters()
    f32, bf16 = runs["fp32"], runs["bf16"]
    ch = bf16["chunks"]
    want = {"bfloat16": dec_layers + ch["prefilter"] + ch["band"], "float32": ch["fine"]}
    flips = coarse_sign_flips(q, bf16["coarse"])
    fine_cell = 2.01 / (1 << 9)
    cd = chamfer(f32["mesh"].vertices, bf16["mesh"].vertices)
    log(f"coarse bf16: fp32 decode {f32['seconds']:.3f} s, chunks {f32['chunks']}, attention "
        f"{f32['by_dtype']} | bf16 decode {bf16['seconds']:.3f} s, chunks {ch}, attention "
        f"{bf16['by_dtype']} (expected {want}: {dec_layers} VAE decoder blocks in bf16 beside the "
        f"queries) | coarse signs {flips} (allowed |value| <= {COARSE_FLIP_REL} x max) | meshes "
        f"{f32['mesh'].n_faces} / {bf16['mesh'].n_faces} faces, Chamfer {cd:.3e} (one fine cell "
        f"{fine_cell:.3e})")
    if bf16["by_dtype"] != want or f32["by_dtype"] != {"bfloat16": dec_layers, "float32": sum(
            f32["chunks"].values())}:
        raise AssertionError(f"coarse bf16: kernel A's paths {bf16['by_dtype']} != {want}, or the "
                             f"fp32 decode's {f32['by_dtype']}")
    if flips["max_abs_value_flipped"] > COARSE_FLIP_REL * flips["max_abs_value"]:
        raise AssertionError(f"coarse bf16: a sign flips at |value| {flips['max_abs_value_flipped']}")
    if not (bf16["mesh"].n_faces > 0 and np.isfinite(bf16["mesh"].vertices).all() and cd < fine_cell):
        raise AssertionError(f"coarse bf16: the mesh is empty, not finite or {cd} from the fp32 one")
    return {"seconds": {k: r["seconds"] for k, r in runs.items()},
            "chunks": {k: r["chunks"] for k, r in runs.items()},
            "by_dtype": {k: r["by_dtype"] for k, r in runs.items()}, "sign_flips": flips,
            "chamfer": cd, "faces": {k: int(r["mesh"].n_faces) for k, r in runs.items()},
            "launches": launches}, f32["mesh"]


def phase_extraction(q: dict, cubes_mesh: Mesh) -> dict:
    """The extraction variants through the slice's fp32 ``sdf_fn`` (kernel
    A's fp32 path, the dev regularizer): ``extract_geometry_dense`` at depth
    7 with cubes, tetrahedra and cubes_numpy; the hierarchical extraction
    with tetrahedra at the default depths (dense 8, fine 9) and its
    single-level branch (dense 7 = fine 7). Every mesh finite and
    non-empty; tetrahedra 1.5-4x the faces of cubes (at depth 7, and at the
    default depths against ``cubes_mesh``, the fp32 decode's); cubes_numpy
    the native cubes' vertex and face counts, vertices within 1e-4 after
    nearest-point matching and the same triangles; the single-level branch
    the dense extraction's mesh."""
    from scipy.spatial import cKDTree

    params, cfg, kv = q["params"], q["cfg"], q["kv"]

    def sdf_fn(pts: np.ndarray) -> np.ndarray:
        pts_t = torch.as_tensor(pts, dtype=torch.float32, device=kv.device)
        return _dev_sdf_regularizer(pts, query_sdf(params, cfg, kv, pts_t[None])[0].cpu().numpy())

    runs = {
        "dense7_cubes": lambda: isosurface.extract_geometry_dense(sdf_fn, octree_depth=7),
        "dense7_tetrahedra": lambda: isosurface.extract_geometry_dense(sdf_fn, octree_depth=7,
                                                                       method="tetrahedra"),
        "dense7_cubes_numpy": lambda: isosurface.extract_geometry_dense(sdf_fn, octree_depth=7,
                                                                        method="cubes_numpy"),
        "hierarchical_tetrahedra": lambda: isosurface.hierarchical_extract_geometry(
            sdf_fn, method="tetrahedra"),
        "single_level7": lambda: isosurface.hierarchical_extract_geometry(
            sdf_fn, dense_octree_depth=7, hierarchical_octree_depth=7),
    }
    meshes, seconds = {}, {}
    reset_counters()
    for name, run in runs.items():
        t0 = time.perf_counter()
        meshes[name] = run()
        seconds[name] = time.perf_counter() - t0
    launches = read_counters()
    faces = {name: len(f) for name, (_, f) in meshes.items()}
    (v_np, f_np), (v_nat, f_nat) = meshes["dense7_cubes_numpy"], meshes["dense7_cubes"]
    d, perm = cKDTree(v_np).query(v_nat)

    def canon(f):
        first = np.argmin(f, axis=1)
        return set(map(tuple, np.stack([np.roll(t, -s) for t, s in zip(f, first)])))

    numpy_ok = v_np.shape == v_nat.shape and f_np.shape == f_nat.shape and d.max() < 1e-4 \
        and canon(perm[f_nat]) == canon(f_np)
    (v1, f1), (vd, fd) = meshes["single_level7"], meshes["dense7_cubes"]
    single_ok = np.array_equal(f1, fd) and np.array_equal(v1, vd)
    ratios = {"dense7": faces["dense7_tetrahedra"] / faces["dense7_cubes"],
              "hierarchical": faces["hierarchical_tetrahedra"] / cubes_mesh.n_faces}
    log(f"extraction: faces {faces} (hierarchical cubes {cubes_mesh.n_faces}), tetrahedra / cubes "
        f"{ratios}; cubes_numpy vs cubes: vertices within {d.max():.2e}, same triangles {numpy_ok}; "
        f"single-level = dense {single_ok}; seconds "
        + " ".join(f"{k} {v:.2f}" for k, v in seconds.items()) + f"; launches {launches}")
    if not all(len(f) and np.isfinite(v).all() for v, f in meshes.values()):
        raise AssertionError(f"extraction: an empty or non-finite mesh: {faces}")
    if not all(1.5 <= r <= 4 for r in ratios.values()):
        raise AssertionError(f"extraction: tetrahedra / cubes face ratios {ratios}")
    if not (numpy_ok and single_ok):
        raise AssertionError(f"extraction: cubes_numpy agrees {numpy_ok}, single-level agrees {single_ok}")
    return {"faces": faces, "ratios": ratios, "seconds": seconds, "launches": launches,
            "cubes_numpy_max_vertex_diff": float(d.max())}


RING_SHAPE = (2, 16, 32784, 128)  # the Stage-I self-attention: B, H, S, D


def phase_ring_merge() -> dict:
    """The sequence-parallel ring's arithmetic on one card: for sp in 2, 4
    and bf16, fp32, one rank's S/sp queries of the Stage-I self-attention
    against each of the sp KV shards through kernel A with its stats,
    merged by ``merge_partials``, against one unsharded kernel-A call for
    those queries; and with a kv_mask that masks a third of the keys at
    random and, for the second batch entry, every key outside the first
    shard (so its other partials have l > 0 over masked keys only and must
    weigh nothing). Also the tp = 2 head shard against the unsharded call's
    heads (heads are independent: equal). Errors against kernel A's
    tolerance rows (2e-2 of max|ref| in bf16, 2e-5 in fp32)."""
    gen = torch.Generator(device="cuda").manual_seed(2025)
    B, H, S, D = RING_SHAPE
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (heads_view(gen, B, S, H, D, dtype) for _ in range(3))
        mask = torch.rand((B, S), generator=gen, device="cuda") > 0.3
        for sp in (2, 4):
            n = S // sp
            mask_sp = mask.clone()
            mask_sp[1, n:] = False  # the second entry's keys all in the first shard
            for masked in (False, True):
                kv_mask = mask_sp if masked else None
                q0 = q[:, :, :n]  # rank 0's query rows
                ref = flash_attention(q0, k, v, kv_mask=kv_mask)
                parts = [flash_attention(q0, k[:, :, j * n:(j + 1) * n], v[:, :, j * n:(j + 1) * n],
                                         kv_mask=None if kv_mask is None else kv_mask[:, j * n:(j + 1) * n],
                                         return_stats=True) for j in range(sp)]
                merged = merge_partials(parts, dtype)
                err = (merged.float() - ref.float()).abs().max().item()
                tol = attention_tol(dtype) * ref.float().abs().max().item()
                finite = bool(torch.isfinite(merged).all())
                name = f"sp{sp}_{str(dtype)[6:]}" + ("_masked" if masked else "")
                out[name] = {"max_abs_err": err, "tol": tol}
                log(f"ring merge {name}: q{tuple(q0.shape)} against {sp} KV shards of {n} keys: "
                    f"max abs err vs unsharded kernel A {err:.3e} (tol {tol:.3e}), finite {finite}")
                if not (err <= tol and finite):
                    raise AssertionError(f"ring merge {name}: {err} > {tol} or not finite")
                del ref, parts, merged
        if dtype == torch.bfloat16:
            ref = flash_attention(q[:1], k[:1], v[:1])[:, : H // 2]
            shard = flash_attention(q[:1, : H // 2], k[:1, : H // 2], v[:1, : H // 2])
            out["tp2_bf16"] = {"max_abs_err": (shard.float() - ref.float()).abs().max().item(), "tol": 0.0}
            log(f"tp2 head shard: max abs err vs the unsharded call's heads {out['tp2_bf16']['max_abs_err']}")
            if out["tp2_bf16"]["max_abs_err"] != 0.0:
                raise AssertionError("the tp = 2 head shard differs from the unsharded call's heads")
            del ref, shard
        del q, k, v
        torch.cuda.empty_cache()
    return out


def check_ring_bwd(gen, sp: int, dtype) -> dict:
    """The ring backward's kernel work on one card: rank 0's S/sp queries of
    the Stage-I self-attention (RING_SHAPE) and their dO, the log-sum-exp
    and delta of the whole sequence (kernel A's stats over all keys), then
    kernels C and D on each of the sp KV shards (``flash_attention_bwd_
    from_stats``, as ``ring_attention_trainable``'s backward calls them):
    each shard's dQ part, dK and dV held against the plain version on that
    shard's inputs (``attention_bwd_stats_reference``), and the dQ parts
    summed in fp32 with the shards' dK, dV concatenated held against one
    unsharded C and D call for those queries; both within C and D's
    tolerances (2e-2 of max|ref| in bf16, 1e-4 in fp32). Each ring step
    (one shard's C, then D) is timed on what the step hands the kernels,
    beside its bound (10 B H (S/sp)^2 D split 6:4), the plain version at
    the step's shape and SDPA's backward there. The row has
    ``check_flash_bwd``'s keys, its ``max_abs_err`` and ``tol`` those
    against the plain version (the worst shard)."""
    B, H, S, D = RING_SHAPE
    n = S // sp
    f32 = dtype == torch.float32
    reps = 1 if f32 else 2
    q, k, v, do = (heads_view(gen, B, S, H, D, dtype) for _ in range(4))
    q0, do0 = q[:, :, :n], do[:, :, :n]  # rank 0's rows
    o0, (m, l) = flash_attention(q0, k, v, return_stats=True)
    lse, delta = (x.contiguous() for x in bwd_row_stats(o0, m, l, do0))
    del o0, m, l
    scale = D ** -0.5
    ref = flash_attention_bwd_from_stats(q0, k, v, do0, lse, delta, scale)
    shards = [(k[:, :, j * n:(j + 1) * n], v[:, :, j * n:(j + 1) * n]) for j in range(sp)]
    rel = 2e-2 if dtype == torch.bfloat16 else 1e-4
    grads = ("dq", "dk", "dv")
    dq, dks, dvs = None, [], []
    plain_errs, plain_tols = [], []  # per shard, against the plain version
    for kj, vj in shards:
        parts = flash_attention_bwd_from_stats(q0, kj, vj, do0, lse, delta, scale)
        plain = attn_ops.attention_bwd_stats_reference(q0, kj, vj, lse, delta, do0, scale)
        plain_errs.append({g: (a.float() - b.float()).abs().max().item() for g, a, b in zip(grads, parts, plain)})
        plain_tols.append({g: rel * b.float().abs().max().item() for g, b in zip(grads, plain)})
        del plain
        dq_j, dk_j, dv_j = parts
        dq = dq_j.float() if dq is None else dq + dq_j.float()
        dks.append(dk_j)
        dvs.append(dv_j)
        del parts, dq_j
    got = (dq.to(dtype), torch.cat(dks, dim=2), torch.cat(dvs, dim=2))
    del dq, dks, dvs
    errs, tols = {}, {}  # the ring's sums against one unsharded call
    for name, a, b in zip(grads, got, ref):
        errs[name] = (a.float() - b.float()).abs().max().item()
        tols[name] = rel * b.float().abs().max().item()
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    del got, ref
    # the shard nearest its tolerance, for each gradient and over all three
    by_grad = {g: max(range(sp), key=lambda j: plain_errs[j][g] / plain_tols[j][g]) for g in grads}
    worst = max(range(sp), key=lambda j: max(plain_errs[j][g] / plain_tols[j][g] for g in grads))
    buffers = [torch.empty_like(x) for x in (q0, shards[0][0], shards[0][1])]
    steps_c, steps_d = [], []
    for kj, vj in shards:  # every ring step, each on its own shard's memory
        kc, vc = kj.contiguous(), vj.contiguous()
        steps_c.append(cuda_ms(lambda: launch_bwd_kernels(q0, kc, vc, do0, lse, delta, *buffers, scale,
                                                          ("dkv",)), reps))
        steps_d.append(cuda_ms(lambda: launch_bwd_kernels(q0, kc, vc, do0, lse, delta, *buffers, scale,
                                                          ("dq",)), reps))
        del kc, vc
    ms_c, ms_d = statistics.median(steps_c), statistics.median(steps_d)
    k0, v0 = (x.contiguous() for x in shards[0])
    plain_ms = cuda_ms(lambda: attn_ops.attention_bwd_stats_reference(q0, k0, v0, lse, delta, do0, scale), 1)

    def sdpa_fwd_bwd():
        qg, kg, vg = (x.detach().requires_grad_() for x in (q0, k0, v0))
        return torch.autograd.grad(sdpa(qg, kg, vg), (qg, kg, vg), do0)

    library_ms = library_time(sdpa_fwd_bwd, reps, f"ring bwd sp{sp}")
    qg, kg, vg = (x.detach().requires_grad_() for x in (q0, k0, v0))
    out = sdpa(qg, kg, vg)
    library_bwd_ms = library_time(lambda: torch.autograd.grad(out, (qg, kg, vg), do0, retain_graph=True),
                                  reps, f"ring bwd sp{sp} (backward alone)")
    del qg, kg, vg, out, q, k, v, do, shards, buffers, k0, v0
    torch.cuda.empty_cache()
    work = B * H * n * n * D
    size, rate = torch.finfo(dtype).bits // 8, product_rate(dtype)
    qb = B * H * n * D * size
    bnd_c, bnd_d = bound(6 * work, rate, 6 * qb), bound(4 * work, rate, 5 * qb)
    tf_c, tf_d = 6 * work / (ms_c * 1e-3) / 1e12, 4 * work / (ms_d * 1e-3) / 1e12
    vs_bwd = (ms_c + ms_d) / library_bwd_ms if library_bwd_ms else None
    name = f"stage1_self_ring_sp{sp}" + ("_f32" if f32 else "")
    log(f"ring bwd {name} q{(B, H, n, D)} x {sp} KV shards of {n} keys, {str(dtype)[6:]}: each shard "
        f"against the plain version, worst shard {worst}: "
        + ", ".join(f"{g} {plain_errs[worst][g]:.3e} (tol {plain_tols[worst][g]:.3e})" for g in grads)
        + " | the sums against one unsharded C and D call: "
        + ", ".join(f"{g} {errs[g]:.3e} (tol {tols[g]:.3e})" for g in errs)
        + f", finite {finite} | a ring step: kernel C {ms_c:.3f} ms (steps {[round(t, 3) for t in steps_c]}; "
        f"{tf_c:.1f} TFLOP/s, bound {bnd_c['bound_ms']:.3f}), kernel D {ms_d:.3f} ms (steps "
        f"{[round(t, 3) for t in steps_d]}; {tf_d:.1f} TFLOP/s, bound {bnd_d['bound_ms']:.3f}) | plain "
        f"{plain_ms:.3f} ms | sdpa forward + backward {library_ms} ms, backward alone {library_bwd_ms} ms")
    bad = [g for g in errs if not errs[g] <= tols[g]]
    bad_plain = [(j, g) for j in range(sp) for g in grads if not plain_errs[j][g] <= plain_tols[j][g]]
    if bad or bad_plain or not finite:
        raise AssertionError(f"ring bwd {name}: above tolerance against unsharded {bad} ({errs} vs {tols}), "
                             f"against the plain version (shard, grad) {bad_plain} ({plain_errs} vs "
                             f"{plain_tols}), or not finite")
    return {"name": name, "shape": [B, H, n, n, D], "dtype": str(dtype)[6:], "sp": sp,
            "max_abs_err": {g: plain_errs[by_grad[g]][g] for g in grads},
            "tol": {g: plain_tols[by_grad[g]][g] for g in grads},
            "plain_errs_per_shard": plain_errs, "plain_tols_per_shard": plain_tols,
            "unsharded_max_abs_err": errs, "unsharded_tol": tols, "ms_dkv": ms_c, "ms_dq": ms_d,
            "ring_steps_ms_dkv": steps_c, "ring_steps_ms_dq": steps_d,
            "plain_ms": plain_ms, "library_ms": library_ms, "library_bwd_ms": library_bwd_ms,
            "deterministic": None, "forward_stats_err": None, "tflops_dkv": tf_c, "tflops_dq": tf_d,
            "bound_dkv": bnd_c, "bound_dq": bnd_d, "bound_share_dkv": bnd_c["bound_ms"] / ms_c,
            "bound_share_dq": bnd_d["bound_ms"] / ms_d, "vs_library_bwd": vs_bwd,
            "against": "the plain version per shard; the ring's sums also against unsharded C and D"}


def phase_ring_backward() -> list:
    """``check_ring_bwd`` for sp 2 and 4, bf16 and fp32."""
    gen = torch.Generator(device="cuda").manual_seed(2026)
    rows = [check_ring_bwd(gen, sp, dtype) for dtype in (torch.bfloat16, torch.float32) for sp in (2, 4)]
    torch.cuda.empty_cache()
    return rows


# One full-width Stage-I train step on the mesh, per world: (layout, compute
# dtype); each against the same step on one card
MESH_TRAIN = {1: ((dict(dp=1, tp=1), "bfloat16"),),
              4: ((dict(dp=2, tp=2), "bfloat16"), (dict(dp=2, tp=2), None),
                  (dict(dp=1, tp=2, sp=2), "bfloat16"))}


def mesh_train_batch(cfg: DenoiserConfig, device) -> dict:
    """A Stage-I batch at the production shapes (2 clips of the window, 257
    context tokens), drawn on the CPU from a fixed seed: the same on every
    rank."""
    gen = torch.Generator().manual_seed(7)
    B, T = 2, cfg.temporal_context_size
    batch = {"latents": torch.randn((B, T, cfg.num_tokens_nominal, cfg.in_channels), generator=gen),
             "context": torch.randn((B, T, 257, cfg.cross_attention_dim), generator=gen),
             "framestep": torch.arange(T, dtype=torch.float32).repeat(B, 1),
             "mask": (torch.arange(T)[None] < torch.tensor([[1], [3]])).float()}
    return {k: x.to(device) for k, x in batch.items()}


def expected_mesh_train_launches(cfg: DenoiserConfig, sp: int) -> dict:
    """A rank's launches in one train step: ``expected_train_launches``'
    with each self-attention a ring of sp steps (A sp times a forward, C
    and D sp times a backward)."""
    L = cfg.num_layers
    return dict(zip(COUNTERS, (2 * (sp + 1) * L, 8 * L, (sp + 1) * L, (sp + 1) * L, 0, 4 * L)))


def mesh_train_step(cfg: DenoiserConfig, mesh, dtype_name, device, steps: int = 1):
    """``steps`` Stage-I steps of fresh weights (seed 0; EMA on, AdamW at
    the loop's defaults, no warmup) on ``mesh`` (None: one card), each on
    the same batch with its step's draws, ``dtype_name`` the compute dtype
    (None: fp32), through ``make_train_step`` with no plain version allowed
    on the card. Returns the last step's loss, seconds and launches, every
    step's seconds, the peak GiB, and the full params after the steps
    (gathered over tp, a collective)."""
    from actionmesh_tpu_torch.parallel.mesh import denoiser_param_shardings, gather_params, shard_params

    params = init_denoiser(torch.Generator(device).manual_seed(0), cfg, device=device)
    shardings = None
    if mesh is not None:
        shardings = denoiser_param_shardings(params, mesh, cfg.num_attention_heads)
        params = shard_params(params, shardings, mesh)
    loop_cfg = TrainLoopConfig(total_steps=steps + 1, warmup_steps=0, compute_dtype=dtype_name)
    opt = make_optimizer(loop_cfg)
    state = init_train_state(params, opt, ema_decay=loop_ema_decay(loop_cfg))
    del params
    step = make_train_step(cfg, opt, compute_dtype=getattr(torch, dtype_name) if dtype_name else None,
                           ema_decay=loop_ema_decay(loop_cfg), mesh=mesh, shardings=shardings)
    batch = mesh_train_batch(cfg, device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    seconds = []
    with no_plain_version_on_card():
        for i in range(steps):
            reset_counters()
            t0 = time.perf_counter()
            state, loss = step(state, batch, step_generator(0, i))
            loss = loss.item()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
    out = {"loss": loss, "seconds": seconds[-1], "step_seconds": seconds,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": read_counters()}
    params = state["params"] if mesh is None else gather_params(state["params"], shardings, mesh)
    del state, batch
    return out, params


# A sharded step's params against one card's: AdamW moves an element by at
# most about lr a step (|m|/sqrt(v) <= 1 after bias correction, 1.0014 at
# the second step), so a sign that the other order of the sums flips (a
# gradient near 0) costs at most 2 lr a step; a wrong gradient flips about
# half the elements, a correct one those near 0 only.
MESH_PARAM_LR_STEPS = 2.0  # max |dparam| <= this * lr * steps
MESH_FLIP_SHARE = 0.05     # the share of elements off by more than lr


def train_on_mesh(rank: int, world: int, device) -> list:
    """MESH_TRAIN's steps of this world: rank 0 first takes each dtype's
    steps on its card alone (the others wait), then every rank the mesh's;
    rank 0 holds the gathered params against the one-card steps' (bit for
    bit at world 1; beyond, within MESH_PARAM_LR_STEPS and MESH_FLIP_SHARE)
    and the launches of a step against the path's. At world 1 one step;
    beyond, two, the second timed warm (the first pays for the groups'
    NCCL set-up and first launches). Returns rank 0's rows ([] on the
    others)."""
    from actionmesh_tpu_torch.parallel.mesh import axis_size, layout, make_mesh

    specs = MESH_TRAIN.get(world, ())
    steps = 1 if world == 1 else 2
    cfg = DenoiserConfig()
    refs, rows = {}, []
    if rank == 0:
        for dt in dict.fromkeys(d for _, d in specs):
            ref, params = mesh_train_step(cfg, None, dt, device, steps)
            # world 1 keeps them on the card for the bitwise check; beside a
            # mesh's shards the host holds them
            refs[dt] = (ref, [p.detach() if world == 1 else p.detach().cpu() for p in leaves(params)])
            del params
            torch.cuda.empty_cache()
            log(f"train on one card ({dt or 'float32'}): loss {ref['loss']:.6f}, s/step "
                f"{[round(t, 2) for t in ref['step_seconds']]}, peak {ref['peak_gib']:.2f} GiB")
    torch.distributed.barrier()
    for lay, dt in specs:
        mesh = make_mesh(**lay)
        name = "x".join(f"{a}{n}" for a, n in layout(mesh).items())
        got, params = mesh_train_step(cfg, mesh, dt, device, steps)
        per_rank = [None] * world
        torch.distributed.all_gather_object(per_rank, {k: got[k] for k in ("seconds", "peak_gib")})
        if rank == 0:
            ref, ref_leaves = refs[dt]
            lr = TrainLoopConfig().peak_lr
            diffs, over, elements = [], 0, 0
            for p, r in zip(leaves(params), ref_leaves):
                d = (p.detach() - r.to(p.device)).abs()
                diffs.append(d.max().item())
                over += int((d > lr).sum())
                elements += d.numel()
                del d
            bit_equal = got["loss"] == ref["loss"] and all(
                torch.equal(p.detach(), r.to(p.device)) for p, r in zip(leaves(params), ref_leaves))
            want = expected_mesh_train_launches(cfg, axis_size(mesh, "sp"))
            row = {"layout": layout(mesh), "dtype": dt or "float32", "loss": got["loss"],
                   "one_card_loss": ref["loss"], "loss_rel_diff": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
                   "max_abs_param_diff": max(diffs), "leaves_differing": sum(d > 0 for d in diffs),
                   "param_tol": MESH_PARAM_LR_STEPS * lr * steps, "share_over_lr": over / elements,
                   "leaves": len(diffs), "bit_equal": bit_equal, "seconds": got["seconds"],
                   "seconds_per_rank": [r["seconds"] for r in per_rank],
                   "peak_gib_per_rank": [r["peak_gib"] for r in per_rank],
                   "one_card_seconds": ref["seconds"], "one_card_peak_gib": ref["peak_gib"],
                   "step_seconds": got["step_seconds"], "one_card_step_seconds": ref["step_seconds"],
                   "launches": got["launches"], "expected_launches": want}
            log(f"train on mesh {name} ({row['dtype']}): loss {got['loss']:.6f} (one card "
                f"{ref['loss']:.6f}, rel diff {row['loss_rel_diff']:.2e}), max |dparam| vs one card "
                f"{row['max_abs_param_diff']:.3e} (tol {row['param_tol']:.1e}; {row['leaves_differing']}/"
                f"{row['leaves']} leaves differ, {row['share_over_lr']:.2e} of elements by more than lr "
                f"{lr:.0e}, tol {MESH_FLIP_SHARE}), "
                f"bit-equal {bit_equal} | after {steps} step(s): s/step of the last per rank "
                f"{[round(t, 2) for t in row['seconds_per_rank']]} (one card {ref['seconds']:.2f}; rank 0's "
                f"steps {[round(t, 2) for t in got['step_seconds']]}) | peak GiB per rank "
                f"{[round(g, 2) for g in row['peak_gib_per_rank']]} (one card {ref['peak_gib']:.2f}) | "
                f"launches {got['launches']} (expected {want})")
            if got["launches"] != want:
                raise AssertionError(f"train on mesh {name}: launches {got['launches']} != {want}")
            if world == 1 and not bit_equal:
                raise AssertionError(f"train on mesh {name}: differs from the one-card step")
            # bf16: the sums over tp and the ring round in another order
            tol = 2e-2 if dt else 1e-4
            if not (math.isfinite(got["loss"]) and row["loss_rel_diff"] <= tol):
                raise AssertionError(f"train on mesh {name}: loss {got['loss']} vs {ref['loss']}")
            if not (row["max_abs_param_diff"] <= row["param_tol"] and row["share_over_lr"] <= MESH_FLIP_SHARE):
                raise AssertionError(f"train on mesh {name}: params off one card's: max {row['max_abs_param_diff']} "
                                     f"(tol {row['param_tol']}), {row['share_over_lr']} of elements by > lr")
            rows.append(row)
        del params
        torch.cuda.empty_cache()
    return rows


# The layouts each world runs ({}: make_mesh()'s default, dp 2 when the
# world is even, the rest tp)
DIST_LAYOUTS = {1: ({},), 2: ({},), 3: ({},), 4: ({}, {"dp": 2, "tp": 1, "sp": 2}, {"dp": 1, "tp": 1, "sp": 4})}
DIST_SMALL_TOL = 1e-4  # the small fp32 slice, sharded against unsharded


def distributed_rank(rank: int, world: int, port: int, work: str) -> None:
    """One rank of the distributed phase (a spawned process, one card): joins
    the NCCL group, then for each of its world's layouts builds the turbo
    pipeline at full width on the mesh and runs one request through the
    server's worker path (rank 0's ``ActionMeshServer.handle``, the others'
    ``worker_loop``); at world 1 rank 0 also runs the request unsharded
    (its vertices must be bit-equal), at a larger world a small fp32 slice
    sharded against unsharded (within DIST_SMALL_TOL). Rank 0 writes the
    results to ``work/results.json``; any failure raises, so the rank's exit
    code is not 0."""
    import os

    from actionmesh_tpu_torch.inference.serve import ActionMeshServer, worker_loop
    from actionmesh_tpu_torch.parallel.mesh import init_distributed, layout, make_mesh

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    # one host: NCCL's bootstrap over the loopback (its data goes by NVLink)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    logging.basicConfig(level=logging.WARNING)
    device = init_distributed()
    work = Path(work)
    frames = str(work / "frames")
    results = {"world": world, "layouts": []}

    def serve_once(pipe, out_dir: Path, distributed: bool, warm: bool = False) -> dict:
        """The request through the server's path (``warm``: one more before
        it, untimed); every rank's pipeline and Stage-0 phase seconds of the
        timed one on rank 0 (``phases``)."""
        server = ActionMeshServer(pipe, distributed=distributed)
        if rank != 0:
            failed = worker_loop(pipe)
            if failed:
                raise AssertionError(f"rank {rank}: {failed} worker call(s) raised")
            return {}
        body = {"input": frames, "output_dir": str(out_dir), "seed": 44}
        try:
            if warm:
                server.handle(body)
            reset_counters()
            t0 = time.perf_counter()
            reply = server.handle(body)
        finally:
            server.stop_workers()
        torch.cuda.synchronize()
        return {"seconds": time.perf_counter() - t0, "generation_seconds": reply["generation_seconds"],
                "launches": read_counters(), "n_frames": reply["n_frames"],
                "vertices": np.load(reply["artifacts"]["deformation_vertices"])}

    def phases_per_rank(pipe) -> list:
        mine = {"phase_seconds": dict(getattr(pipe, "phase_seconds", None) or {}),
                "stage0_seconds": dict(getattr(pipe, "stage0_seconds", None) or {})}
        if world == 1:
            return [mine]
        every = [None] * world
        torch.distributed.all_gather_object(every, mine)
        return every

    def turbo(mesh):
        return ActionMeshPipeline(config_name="actionmesh_turbo", weights_dir=str(work / "no_weights"),
                                  device=device, device_mesh=mesh)

    unsharded = None
    if rank == 0:
        pipe = turbo(None)
        unsharded = serve_once(pipe, work / "unsharded", distributed=False, warm=world > 1)
        unsharded["phases"] = {"phase_seconds": dict(pipe.phase_seconds), "stage0_seconds": dict(pipe.stage0_seconds)}
        results["unsharded_seconds"] = unsharded["seconds"]
        results["unsharded_phases"] = unsharded["phases"]
        del pipe
        torch.cuda.empty_cache()
    for lay in DIST_LAYOUTS[world]:
        mesh = make_mesh(**lay)
        name = "x".join(f"{a}{n}" for a, n in layout(mesh).items())
        pipe = turbo(mesh)
        got = serve_once(pipe, work / name, distributed=True, warm=world > 1)
        phases = phases_per_rank(pipe)
        if rank == 0:
            want_flash, want_rope = expected_launches(pipe, N_FRAMES)
            # at world > 1 the bf16 sums over tp and the ring round in
            # another order, so the anchor's extraction may give another
            # vertex count: no diff then (the small fp32 slice below is the
            # sharded-vs-unsharded check)
            same_shape = got["vertices"].shape == unsharded["vertices"].shape
            diff = float(np.abs(got["vertices"] - unsharded["vertices"]).max()) if same_shape else None
            finite = bool(np.isfinite(got["vertices"]).all())
            row = {"layout": layout(mesh), "seconds": got["seconds"],
                   "generation_seconds": got["generation_seconds"], "launches": got["launches"],
                   "max_abs_diff_vs_unsharded": diff, "vertices_shape": list(got["vertices"].shape),
                   "unsharded_vertices_shape": list(unsharded["vertices"].shape), "finite": finite,
                   "warmed": world > 1, "phases_per_rank": phases,
                   "unsharded_phases": unsharded["phases"]}
            log(f"distributed world {world} layout {name}: per-rank phase seconds " + json.dumps(
                [{k: {n: round(t, 2) for n, t in v.items()} for k, v in r.items()} for r in phases]))
            log(f"distributed world {world} layout {name}: turbo request {got['seconds']:.2f} s "
                f"(unsharded {unsharded['seconds']:.2f} s), max abs diff vs unsharded {diff}, vertices "
                f"{row['vertices_shape']} (unsharded {row['unsharded_vertices_shape']}), launches "
                f"{got['launches']} (unsharded path: flash_fwd {want_flash}, rms_rope {want_rope})")
            if not (finite and got["n_frames"] == N_FRAMES and got["vertices"].shape[0] == N_FRAMES):
                raise AssertionError(f"distributed {name}: {got['n_frames']} frames, finite {finite}")
            if not (got["launches"]["flash_fwd"] and got["launches"]["fused_rms_rope"]):
                raise AssertionError(f"distributed {name}: kernels A and B did not launch: {got['launches']}")
            if world == 1:
                # a mesh of one rank runs the unsharded arithmetic: equal bits, equal launches
                if diff != 0.0 or (got["launches"]["flash_fwd"], got["launches"]["fused_rms_rope"]) != (
                        want_flash, want_rope):
                    raise AssertionError(f"distributed {name}: differs from the unsharded run ({diff})")
            results["layouts"].append(row)
        del pipe
        torch.cuda.empty_cache()
        if world > 1:
            small = {}
            for key, m in (("sharded", mesh), ("unsharded", None)):
                if m is None and rank != 0:
                    continue
                pipe = ActionMeshPipeline(config_updates=dict(SMALL_UPDATES), device=device,
                                          dtype=torch.float32, device_mesh=m,
                                          image_encoder=ImageEncoder(device, torch.float32, SMALL_DINO))
                inp = ActionMeshInput(frames=make_frames(), timesteps=np.arange(N_FRAMES, dtype=np.float32))
                small[key] = np.stack([x.vertices for x in pipe(inp, seed=3)])
                del pipe
            if rank == 0:
                err = float(np.abs(small["sharded"] - small["unsharded"]).max())
                log(f"distributed world {world} layout {name}: small fp32 slice sharded vs unsharded "
                    f"max abs err {err:.3e} (tol {DIST_SMALL_TOL:g})")
                if not err <= DIST_SMALL_TOL:
                    raise AssertionError(f"distributed {name}: small slice {err} > {DIST_SMALL_TOL}")
                results["layouts"][-1]["small_fp32_max_abs_err"] = err
    results["train"] = train_on_mesh(rank, world, device)
    if rank == 0:
        (work / "results.json").write_text(json.dumps(results))
    torch.distributed.destroy_process_group()


def phase_distributed() -> dict:
    """The device mesh (``parallel/mesh.py``): the ring merge on this card
    (``phase_ring_merge``), then one NCCL rank per visible card, at most 4,
    spawned (``distributed_rank``): each rank runs the turbo request at full
    width through the server's worker path on its world's layouts. A rank
    that fails fails the run (``torch.multiprocessing.start_processes``
    raises on any exit code but 0)."""
    import socket

    import torch.multiprocessing as mp

    ring = phase_ring_merge()
    ring_bwd = phase_ring_backward()
    world = min(torch.cuda.device_count(), 4)
    work = OUT_DIR / "distributed"
    shutil.rmtree(work, ignore_errors=True)
    write_frame_pairs(work / "frames", make_frames())
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        mp.start_processes(distributed_rank, args=(world, port, str(work)), nprocs=world, join=True,
                           start_method="spawn")
        results = json.loads((work / "results.json").read_text())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t0
    cli_run = train_cli_on_mesh(world) if world == 4 else None
    log("distributed: " + json.dumps({
        "world": world, "seconds": round(seconds, 2), "unsharded_turbo_s": round(results["unsharded_seconds"], 2),
        "layouts": [{"layout": r["layout"], "turbo_s": round(r["seconds"], 2),
                     "max_abs_diff_vs_unsharded": r["max_abs_diff_vs_unsharded"],
                     **({"small_fp32_max_abs_err": r["small_fp32_max_abs_err"]}
                        if "small_fp32_max_abs_err" in r else {})} for r in results["layouts"]],
        "ring_merge_max_abs_err": {k: v["max_abs_err"] for k, v in ring.items()},
        "train": [{k: r[k] for k in ("layout", "dtype", "seconds", "peak_gib_per_rank", "loss_rel_diff",
                                     "max_abs_param_diff", "bit_equal")} for r in results["train"]]}))
    return {"world": world, "seconds": seconds, "ring_merge": ring, "ring_backward": ring_bwd, **results,
            "train_cli": cli_run,
            "launches": {k: sum(r["launches"][k] for r in results["layouts"]) for k in COUNTERS},
            "train_launches": {k: sum(r["launches"][k] for r in results["train"]) for k in COUNTERS}}


# ``train.py`` under torchrun in the four-card run: full width, bf16, on
# (dp 2, tp 2); the steps and the output directory are added per run
TRAIN_CLI_MESH = ["--synthetic", "--size", "production", "--window", "16", "--batch", "2",
                  "--compute-dtype", "bfloat16", "--warmup", "0", "--log-every", "1", "--ckpt-every", "0",
                  "--mesh", "dp=2,tp=2", "--device", "cuda"]
def differing_entries(a: Path, b: Path) -> list:
    """The entries in which two npz files differ (name, dtype, shape or a
    value), read side by side one entry at a time."""
    with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
        names = za.namelist()
        if names != zb.namelist():
            return sorted(set(names) ^ set(zb.namelist())) or ["<entry order>"]
        out = []
        for name in names:
            with za.open(name) as fa, zb.open(name) as fb:
                x, y = np.lib.format.read_array(fa), np.lib.format.read_array(fb)
            if x.dtype != y.dtype or not np.array_equal(x, y):
                out.append(name[:-4])
        return out


def train_cli_on_mesh(world: int, args: list = TRAIN_CLI_MESH) -> dict:
    """``train.py ARGS`` under ``torchrun`` (``python -m
    torch.distributed.run``, one rank a card, the rendezvous on this
    host's loopback), three times in one directory: two steps and the
    end's checkpoint (a full tree, rank 0 writes it); ``--steps 2`` again,
    which resumes at step 2, takes no step and writes the restored state
    back (each rank reads the full tree and keeps its slices, then the
    slices are gathered and written), so the rewritten checkpoint must
    equal the first in every entry, bit for bit; then ``--steps 3``
    resumes for a third step. Checks the log's steps 1, 2, 3 and finite
    losses. (As in JAX's loop, a resumed run's data stream starts again,
    so its third step is not an uninterrupted run's.)"""
    import os
    import socket

    out = OUT_DIR / "train_mesh"
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, NCCL_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join(filter(None, [str(Path(__file__).resolve().parent),
                                                        os.environ.get("PYTHONPATH")])))
    mesh_spec = args[args.index("--mesh") + 1]
    ckpt, first = out / "ckpt_latest.npz", out / "ckpt_step2_written.npz"
    runs = []
    try:
        for steps in (2, 2, 3):
            with socket.socket() as sock:
                sock.bind(("127.0.0.1", 0))
                port = sock.getsockname()[1]
            cmd = [sys.executable, "-m", "torch.distributed.run", f"--nproc-per-node={world}", "--nnodes=1",
                   "--node-rank=0", "--master-addr=127.0.0.1", f"--master-port={port}",
                   "-m", "actionmesh_tpu_torch.train", *args, "--steps", str(steps), "--out", str(out)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, env=env, capture_output=True,
                                  text=True, timeout=900)
            seconds = time.perf_counter() - t0
            tail = (proc.stdout + proc.stderr)[-3000:]
            log(f"torchrun train.py --mesh {mesh_spec} --steps {steps}: rc {proc.returncode}, {seconds:.1f} s\n{tail}")
            if proc.returncode != 0:
                raise AssertionError(f"torchrun train.py --mesh --steps {steps}: rc {proc.returncode}")
            recs = [json.loads(x) for x in (out / "log.jsonl").read_text().splitlines()]
            runs.append({"steps": steps, "seconds": seconds, "log": recs, "checkpoint_gb": ckpt.stat().st_size / 1e9})
            if len(runs) == 1:
                os.link(ckpt, first)  # the rewrite replaces ckpt_latest.npz; the link keeps the first
            elif len(runs) == 2:
                t0 = time.perf_counter()
                differ = differing_entries(first, ckpt)
                compare_s = time.perf_counter() - t0
                log(f"torchrun train.py --mesh {mesh_spec}: the checkpoint restored and written back "
                    f"({runs[-1]['checkpoint_gb']:.2f} GB, compared in {compare_s:.1f} s) differs from the "
                    f"written one in {len(differ)} entries {differ[:5]}")
                if differ or [r["step"] for r in recs] != [1, 2]:
                    raise AssertionError(f"torchrun train.py --mesh: the restored state written back differs in "
                                         f"{differ[:5]}, or it took steps: {recs}")
                first.unlink()
        steps_logged = [r["step"] for r in runs[-1]["log"]]
        losses = [r["loss"] for r in runs[-1]["log"]]
        log(f"torchrun train.py --mesh: log steps {steps_logged}, losses {losses}, checkpoint "
            f"{runs[-1]['checkpoint_gb']:.2f} GB")
        if steps_logged != [1, 2, 3] or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"torchrun train.py --mesh: log steps {steps_logged}, losses {losses}")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    return {"runs": runs, "losses": losses, "rewrite_differs_in": differ, "compare_seconds": compare_s}


SHARE_MAX = 1.05  # bound_ms / ms; above 1 only by the timer's noise


def kernel_summary(flash, rope, rope_bwd, bwd, nn, fused) -> dict:
    """The short kernels line (under 4 KB), printed just before the last
    line so that the tail of the output always holds it: one entry per
    kernel path with its head row's shape, ``ms``, ``share`` (bound_ms /
    ms), ``x_lib`` (ms / the library call's ms; for C and D SDPA's backward
    alone, which computes both, so the pair's factor is the sum of theirs),
    and its largest error ``err`` beside its tolerance ``tol``. Kernel B's
    forward is timed on the device (torch.profiler) at the Stage-I self q/k
    row, whose 180 MB do not fit in L2 (the DiT rows' back-to-back calls
    read from L2, under the DRAM-byte bound); its tolerance is per element.
    Raises when a share is above ``SHARE_MAX``: no kernel beats its bound,
    so such a share is a mis-timed row or a wrong bound. The long line
    before it holds every row."""

    def row(rows, name):
        return next(r for r in rows if r["name"] == name)

    def entry(path, r, ms, bound_ms, library_ms, err, tol):
        return {"path": path, "shape": r["shape"], "ms": float(f"{ms:.4g}"),
                "share": float(f"{bound_ms / ms:.3g}"),
                "x_lib": float(f"{ms / library_ms:.3g}") if library_ms else None,
                "err": float(f"{err:.3g}"), "tol": tol if isinstance(tol, str) else float(f"{tol:.3g}")}

    out = []
    for path, name in (("A bf16", "stage1_self"), ("A fp32", "stage1_self_f32"),
                       ("A fp16", "stage1_self_fp16")):
        r = row(flash, name)
        out.append(entry(path, r, r["ms"], r["bound_ms"], r["library_ms"], r["max_abs_err"], r["tol"]))
    r = row(rope, "stage1_self_qk")
    out.append(entry("B fwd", r, r["device_ms"], r["bound_ms"], r["library_ms"], r["max_abs_err"],
                     "1 ulp + 2^-20 max|ref|, per element"))
    r = row(rope_bwd, "stage1_self_qk")
    out.append(entry("B bwd", r, r["ms"], r["bound_ms"], r["library_ms"], r["errors"]["dx"], r["tol"]["dx"]))
    for dtype, name in (("bf16", "stage1_self"), ("fp32", "stage1_self_f32")):
        r = row(bwd, name)
        for kernel, key, grads in (("C", "dkv", ("dk", "dv")), ("D", "dq", ("dq",))):
            out.append(entry(f"{kernel} {dtype}", r, r[f"ms_{key}"], r[f"bound_{key}"]["bound_ms"],
                             r["library_bwd_ms"], max(r["max_abs_err"][g] for g in grads),
                             min(r["tol"][g] for g in grads)))
    r = nn[0]
    out.append(entry("E", r, r["ms"], r["bound_ms"], r["library_ms"], r["max_abs_err"], r["tol"]))
    r = fused[0]
    out.append(entry("F", r, r["ms"], r["bound_ms"], r["library_ms"], r["max_abs_err"], r["tol"]))
    above = [(e["path"], e["share"]) for e in out if e["share"] > SHARE_MAX]
    if above:
        raise AssertionError(f"kernel summary: shares above {SHARE_MAX} of the bound: {above}")
    return {"kernel_summary": out}


def main() -> None:
    logging.basicConfig(level=logging.WARNING)
    torch.backends.cuda.matmul.allow_tf32 = False  # the default, stated
    info = phase_device()
    build = phase_build()
    sl, fine_query = phase_slice()
    sdf_chunk = phase_sdf_chunk(fine_query)
    torch.cuda.empty_cache()
    cli_runs = phase_cli(CLI_PRESETS)
    ckpt = phase_checkpoints()
    v3d = phase_video_3d()
    flash, rope = phase_kernels(sl["anchor_vertices"])
    hunyuan = phase_hunyuan3d()
    flash_edges = phase_flash_edges()
    fused, fused_launches = phase_fused()
    bwd, rope_bwd = phase_backward()
    nn = phase_nn()
    small_err = phase_small_reference()
    small_stage0 = phase_small_stage0()
    small_ckpt = phase_small_checkpoint()
    small_train = phase_small_train()
    tr = phase_train()
    tr32 = phase_train(None)
    dec = phase_train_decoder()
    distill = {mode: phase_distill(mode) for mode in ("guidance", "progressive")}
    dit = phase_train_stage0()
    vae = phase_train_vae()
    small_icp = phase_small_icp()
    ab = phase_actionbench()
    prep = phase_prepare_clips()
    loop = phase_closed_loop()
    served = phase_serve()
    coarse, cubes_mesh = phase_coarse_bf16(fine_query)
    extraction = phase_extraction(fine_query, cubes_mesh)
    del fine_query, cubes_mesh
    torch.cuda.empty_cache()
    dist = phase_distributed()
    bwd = bwd + dist["ring_backward"]  # C and D's ring-step rows
    for name, key in (("stage1_self_ring_sp2", "sp2_bfloat16"), ("stage1_self_ring_sp4", "sp4_bfloat16"),
                      ("stage1_self_tp2", "tp2_bf16")):  # the mesh rows: their error against unsharded A
        next(r for r in flash if r["name"] == name)["unsharded_max_abs_err"] = dist["ring_merge"][key]["max_abs_err"]

    def summary(name, source, replaces, rows, launches):
        head = rows[0]
        return {"name": name, "route": "cuda" if source.endswith(".cu") else "triton",
                "source": source, "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"], "library_ms": head["library_ms"],
                "shape": head["shape"], "shapes": rows}

    train_runs = {"training": tr, "training_fp32": tr32, "decoder_fp32": dec,
                  "distill_guidance": distill["guidance"], "distill_progressive": distill["progressive"],
                  "stage0_dit_fp32": dit, "vae_fp32": vae, "closed_loop": loop,
                  "train_mesh": {"launches": dist["train_launches"]}}

    def trained(name):  # every train phase: Stage I bf16 and fp32, decoder, distillation, DiT, VAE, closed loop
        return sum(run["launches"][name] for run in train_runs.values())

    def train_paths(name):
        return {path: run["launches"][name] for path, run in train_runs.items()}

    def by_path(name, inference_name):
        return {"inference": sl["launches"][inference_name], **train_paths(name),
                **{f"cli_{preset}": run["launches"][name] for preset, run in cli_runs.items()
                   if preset in CLI_PRESETS},
                "cli_checkpoints": ckpt["launches"][name], "cli_video": ckpt["video"]["launches"][name],
                "video_3d": v3d["launches"][name], "prepare_clips": prep["launches"][name],
                "serve": served["launches"][name], "coarse_bf16": coarse["launches"][name],
                "extraction": extraction["launches"][name], "distributed": dist["launches"][name],
                "hunyuan3d": hunyuan["stage0"]["launches"][name]}

    def cli_launches(name):  # the entry points' paths: CLIs, clip preparation, the server
        return (sum(cli_runs[preset]["launches"][name] for preset in CLI_PRESETS)
                + ckpt["launches"][name] + ckpt["video"]["launches"][name] + v3d["launches"][name]
                + prep["launches"][name] + served["launches"][name])

    def decode_launches(name):  # the bf16 coarse pass's decodes, the extraction variants, the mesh
        return coarse["launches"][name] + extraction["launches"][name] + dist["launches"][name]

    def bwd_summary(name, replaces, key):
        rows = [{"name": r["name"], "shape": r["shape"], "dtype": r["dtype"],
                 "max_abs_err": max(r["max_abs_err"][g] for g in key[1]),
                 "tol": min(r["tol"][g] for g in key[1]), "ms": r[f"ms_{key[0]}"],
                 "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                 "library_bwd_ms": r["library_bwd_ms"], "deterministic": r["deterministic"],
                 **r[f"bound_{key[0]}"], "tflops": r[f"tflops_{key[0]}"]} for r in bwd]
        out = summary(name, "actionmesh_tpu_torch/csrc/flash_bwd.cu", replaces, rows, trained(name))
        out["library_bwd_ms"] = rows[0]["library_bwd_ms"]
        out["launches_by_path"] = train_paths(name)
        out["plain_ms_note"] = "the plain backward computes dq, dk and dv together"
        out["library_ms_note"] = ("scaled_dot_product_attention forward plus backward: one call "
                                  "pair for kernels A, C and D together; library_bwd_ms is its "
                                  "backward alone over one retained forward, for C and D together")
        return out

    kernels = [
        summary("flash_fwd", "actionmesh_tpu_torch/csrc/flash_fwd.cu",
                "actionmesh_tpu/ops/flash_attention.py:302", flash,
                sl["launches"]["flash_fwd"] + trained("flash_fwd") + cli_launches("flash_fwd")
                + decode_launches("flash_fwd") + hunyuan["stage0"]["launches"]["flash_fwd"]),
        summary("fused_rms_rope", "actionmesh_tpu_torch/csrc/rms_rope.cu",
                "actionmesh_tpu/ops/rope_norm.py:94", rope,
                sl["launches"]["rms_rope"] + trained("fused_rms_rope")
                + cli_launches("fused_rms_rope") + decode_launches("fused_rms_rope")
                + hunyuan["stage0"]["launches"]["fused_rms_rope"]),
        bwd_summary("flash_bwd_dkv", "actionmesh_tpu/ops/flash_attention_bwd.py:261", ("dkv", ("dk", "dv"))),
        bwd_summary("flash_bwd_dq", "actionmesh_tpu/ops/flash_attention_bwd.py:287", ("dq", ("dq",))),
        summary("nn_argmin", "actionmesh_tpu_torch/csrc/nn_argmin.cu",
                "actionmesh_tpu/ops/nn_argmin.py:148", nn, ab["launches"] + loop["launches"]["nn_argmin"]),
        summary("flash_attention_fused", "actionmesh_tpu_torch/csrc/flash_fwd.cu",
                "actionmesh_tpu/ops/flash_attention.py:492", fused,
                sl["launches"]["flash_fused"] + trained("flash_fused")),
    ]
    kernels[0]["also_replaces"] = "actionmesh_tpu/ops/flash_attention.py:612"
    kernels[0]["launches_by_path"] = by_path("flash_fwd", "flash_fwd")
    kernels[0]["library_ms_note"] = ("scaled_dot_product_attention on the same q, k, v (the kv_mask "
                                     "as its attn_mask); none for the stats row, as SDPA gives no (m, l)")
    kernels[1]["launches_by_path"] = by_path("fused_rms_rope", "rms_rope")
    kernels[1]["library_ms_note"] = ("torch.nn.functional.rms_norm on the same x and scale for the "
                                     "rows without tables; none for the rows that rotate (no single "
                                     "PyTorch call normalises and rotates)")
    kernels[1]["device_ms"] = rope[0]["device_ms"]
    # kernel B's backward kernel: the head row is the Stage-I self q/k shape
    timed = [r for r in rope_bwd if "ms" in r]
    bwd_b = summary("fused_rms_rope_bwd", "actionmesh_tpu_torch/csrc/rms_rope.cu",
                    "actionmesh_tpu/ops/rope_norm.py:132", timed + [r for r in rope_bwd if "ms" not in r],
                    trained("fused_rms_rope_bwd"))
    bwd_b["library_ms"] = next((r["library_ms"] for r in timed if r["library_ms"] is not None), None)
    bwd_b["launches_by_path"] = train_paths("fused_rms_rope_bwd")
    bwd_b["replaces_note"] = ("the JAX custom VJP's backward (_fused_bwd, the vjp of the plain "
                              "composition); the TPU kernel has no backward of its own")
    bwd_b["library_ms_note"] = ("torch.nn.functional.rms_norm forward + backward at the Stage-I "
                                "cross q shape (no tables), beside that row's fwd_bwd_ms")
    bwd_b["launches_note"] = "one launch counts a call: the backward kernel and its fixed-order sums"
    kernels.insert(2, bwd_b)
    kernels[5]["launches_by_path"] = {"actionbench": ab["launches"],
                                      "closed_loop": loop["launches"]["nn_argmin"]}
    kernels[5]["library_ms_note"] = "none: no single PyTorch call gives the nearest index (cdist, then argmin)"
    kernels[5]["max_abs_err_note"] = "float64 squared-distance difference of differing picks"
    kernels[5].update({k: nn[0][k] for k in ("bound_tensor_core_ms", "bound_min_op_ms",
                                             "bound_fp32_fma_ms", "gpairs_per_s")})
    kernels[6]["launches_by_path"] = {"inference": sl["launches"]["flash_fused"],
                                      "training": trained("flash_fused"),
                                      "smoke": fused_launches}
    kernels[6]["unfused_b_b_a_ms"] = fused[0]["unfused_b_b_a_ms"]
    kernels[6]["library_ms_note"] = ("scaled_dot_product_attention on q, k normalised and rotated "
                                     "beforehand by the plain pre-pass")
    kernels[6]["launches_note"] = "one launch counts a call: the pre-pass and kernel A's mainloop"
    for i in (0, 6):  # the head row's rates, as for ms and bound_ms
        kernels[i].update({k: kernels[i]["shapes"][0][k] for k in ("tflops", "bound_share", "vs_library")})
    print(json.dumps({"kernels": kernels, "build": build, "flash_edges": flash_edges,
                      "small_reference_max_abs_err": small_err, "small_stage0_reference": small_stage0,
                      "small_train_reference": small_train, "small_icp_reference": small_icp,
                      "small_checkpoint": small_ckpt, "checkpoints": ckpt, "video_3d": v3d,
                      "slice": sl, "sdf_chunk": sdf_chunk, "cli": cli_runs, "train": tr,
                      "train_fp32": tr32, "train_decoder": dec, "distill": distill,
                      "train_stage0_dit": dit, "train_vae": vae, "prepare_clips": prep,
                      "closed_loop": loop, "serve": served, "coarse_bf16": coarse,
                      "extraction": extraction, "distributed": dist,
                      "actionbench": ab, "hunyuan3d": hunyuan,
                      "card": info["nvidia_smi"]}),
          flush=True)
    # a short line the tool's tail always keeps: the long line above can
    # fall outside it
    print(json.dumps(kernel_summary(flash, rope, rope_bwd, bwd, nn, fused)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main_cli_runs(specs: list[str]) -> None:
    """``chip_smoke.py --cli "FLAGS" ...``: only the CLI phase, once for each
    quoted set of CLI flags (e.g. "--fast", "--dtype float16"), each checked
    as in the full run. Every set runs and is reported, a failed one with
    its error; prints one JSON object of the results, then exits non-zero
    when any run failed."""
    logging.basicConfig(level=logging.WARNING)
    info = phase_device()
    phase_build()
    out = {}
    for spec in specs:
        try:
            out[spec] = phase_cli({spec: spec.split()})[spec]
        except Exception as e:  # a report of each run: record the failure, go on
            log(f"cli {spec}: FAILED:\n{traceback.format_exc()}")
            out[spec] = {"error": f"{type(e).__name__}: {e}"}
    print(json.dumps({"cli": out, "card": info["nvidia_smi"]}), flush=True)
    failed = [spec for spec, result in out.items() if "error" in result]
    if failed:
        raise SystemExit(f"chip_smoke.py --cli: {len(failed)} of {len(out)} runs failed: {failed}")


def main_distributed() -> None:
    """``chip_smoke.py --distributed``: only the device mesh's phase (the ring
    merge on one card, then one rank per card, at most 4, on its world's
    layouts), checked as in the full run; prints its results, then the
    device line."""
    logging.basicConfig(level=logging.WARNING)
    info = phase_device()
    phase_build()
    dist = phase_distributed()
    print(json.dumps({"distributed": dist, "card": info["nvidia_smi"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main_hunyuan3d() -> None:
    """``chip_smoke.py --hunyuan3d``: only Hunyuan3D-2.1's phase, checked as
    in the full run; prints its results, then the device line."""
    logging.basicConfig(level=logging.WARNING)
    info = phase_device()
    phase_build()
    print(json.dumps({"hunyuan3d": phase_hunyuan3d(), "card": info["nvidia_smi"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli"]:
        main_cli_runs(sys.argv[2:])
    elif sys.argv[1:] == ["--hunyuan3d"]:
        main_hunyuan3d()
    elif sys.argv[1:] == ["--distributed"]:
        main_distributed()
    else:
        main()
