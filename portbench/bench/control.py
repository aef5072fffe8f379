"""Readings of the program and of its control, cell by cell and seed by
seed, for setting the comparison's limits (``checks/<workload>.json``).

    python3 -m portbench.bench.control --workload <name> --seeds 11,12,13

Each seed is one run of the cell (one clip in the window) followed by the
reference in fp32 and in fp8 on the same captured inputs; one JSON line
per seed: the program's numbers and the control's. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

from portbench.bench import driver, manifest


def readings(root, workload: str, seeds, seconds: float = 1.0, device=None):
    for seed in seeds:
        out = driver.run(root, workload, seed, seconds, False, time.perf_counter(), device=device,
                         control=True)
        yield {"workload": workload, "seed": seed, "correct": out["correct"],
               "program": {k: c["value"] for k, c in out["compared"].items()},
               "limits": {k: c["limit"] for k, c in out["compared"].items()},
               "control": out["control"], "clip_s": out["metrics"].get("clip_s", {}).get("value")}


def control_fails(reading: dict) -> list[str]:
    """The numbers on which the control exceeds its limit."""
    return [k for k, v in reading["control"].items() if v > reading["limits"][k]]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    for r in readings(manifest.ROOT, args.workload, seeds):
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
