"""Times kernels C (dK, dV) and D (dQ) alone on one NVIDIA GPU, at the fp32
rows of this checkout's ``chip_smoke.BWD_CASES``, for the
``actionmesh_tpu_torch`` package of this checkout or of another one:

    python3 bwd_times.py                  # this checkout's kernels
    python3 bwd_times.py --tree DIR       # the package under DIR (e.g. an
                                          # unpacked `git archive` of a parent)

Each kernel builds from its checkout's sources at first use. Inputs are
random (B, H, S, D) fp32 views of (B, S, H*D) tensors from a fixed seed, the
row statistics from that package's kernel A. Prints the card (nvidia-smi name
and power limit), a line per shape, then one JSON object: per shape C's and
D's CUDA-event ms (that checkout's ``chip_smoke.cuda_ms``), their TFLOP/s
(C 6U, D 4U of least work, U = B*H*Sq*Sk*D) and their share of the 3xTF32
bound (495 / 3 TFLOP/s). To compare two versions, run both in one call on
one card, in turns (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import ast
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FP32_PRODUCT_FLOPS = 495e12 / 3
REPS = 3  # timed calls a shape; one where a call is seconds (Stage-I self)


def fp32_shapes() -> dict:
    """name: (B, H, Sq, Sk, D) of the fp32 rows of this checkout's
    ``chip_smoke.BWD_CASES``, read from its source: importing it would
    import this checkout's package before the one timed."""
    tree = ast.parse((HERE / "chip_smoke.py").read_text())
    cases = next(node.value for node in tree.body if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", None) == "BWD_CASES")
    return {ast.literal_eval(name): ast.literal_eval(shape) for name, shape, dtype in
            (row.elts for row in cases.elts) if ast.unparse(dtype) == "torch.float32"}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=HERE,
                        help="checkout whose actionmesh_tpu_torch package is timed")
    args = parser.parse_args()
    shapes = fp32_shapes()
    sys.path.insert(0, str(args.tree.resolve()))
    import torch

    from actionmesh_tpu_torch.ops.attention import bwd_row_stats
    from actionmesh_tpu_torch.ops.flash_attention import flash_attention, launch_bwd_kernels
    from chip_smoke import cuda_ms  # the tree's own smoke script, for its timing

    if not torch.cuda.is_available():
        raise SystemExit("bwd_times.py needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(4321)
    out = {}
    for name, (B, H, Sq, Sk, D) in shapes.items():
        def heads(S):
            x = torch.randn((B, S, H * D), generator=gen, device="cuda")
            return x.view(B, S, H, D).transpose(1, 2)

        q, do, k, v = heads(Sq), heads(Sq), heads(Sk), heads(Sk)
        o, (m, l) = flash_attention(q, k, v, return_stats=True)
        lse, delta = (x.contiguous() for x in bwd_row_stats(o, m, l, do))
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        scale, work = D ** -0.5, B * H * Sq * Sk * D
        reps = 1 if work > 1e12 else REPS
        row = {"shape": [B, H, Sq, Sk, D]}
        for kernel, which, flop in (("C", "dkv", 6 * work), ("D", "dq", 4 * work)):
            ms = cuda_ms(lambda: launch_bwd_kernels(q, k, v, do, lse, delta, dq, dk, dv, scale, (which,)),
                         reps)
            row[kernel] = {"ms": ms, "tflops": flop / (ms * 1e-3) / 1e12,
                           "bound_share": flop / FP32_PRODUCT_FLOPS * 1e3 / ms}
        print(f"{name} {tuple(row['shape'])}: C {row['C']['ms']:.3f} ms ({row['C']['tflops']:.1f} "
              f"TFLOP/s, {100 * row['C']['bound_share']:.1f}% of the bound), D {row['D']['ms']:.3f} ms "
              f"({row['D']['tflops']:.1f} TFLOP/s, {100 * row['D']['bound_share']:.1f}%)", flush=True)
        out[name] = row
        del q, do, k, v, o, m, l, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "tree": str(args.tree), "bwd_f32": out}), flush=True)


if __name__ == "__main__":
    main()
