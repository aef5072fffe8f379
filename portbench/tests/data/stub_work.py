"""Model FLOPs of a clip of the stub family: DINOv2, Stage I and Stage II
(``bench/work.py``); the stub's Stage 0 computes no model."""

from portbench.bench.work import clip_flops


def flops_per_clip(cfg: dict, mix: dict, vertices: int) -> float:
    return clip_flops(cfg, mix, vertices, [])
