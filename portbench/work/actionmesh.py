"""Model FLOPs of one ActionMesh clip with TripoSG as Stage 0, from a
configuration's widths and a traffic mix's shapes (never read from the
program). DINOv2, Stage I and Stage II are counted as ``bench/work.py``
says; Stage 0 adds:
  * DINOv2 on the anchor frame once more for TripoSG (video mode);
  * the TripoSG DiT (video mode): steps x CFG branches over one frame of
    N + 1 tokens (the time token), its 21 blocks with U-skips; the
    unconditional branch's cross-attention is left out, since with an
    all-zero image it is exactly the output bias and the program skips it;
  * the TripoSG VAE: the decoder's self blocks over the latent set once
    (video mode), or the encoder from the surface samples ({video + 3D}:
    point projection, one cross-attention from K picked points, its self
    blocks); FPS and the SDF queries are left out: the query count depends
    on the field and on the extraction method.
"""

from __future__ import annotations

from portbench.bench.work import attn, clip_flops, context_tokens, flow_transformer


def vae_decode(v: dict) -> float:
    k, w = v["num_tokens"], v["decoder_width"]
    f = 2.0 * k * v["latent_channels"] * w
    return f + v["decoder_layers"] * (8.0 * k * w * w + attn(k, k, w) + 16.0 * k * w * w)


def vae_encode(v: dict, points: int) -> float:
    k, w = v["num_tokens"], v["encoder_width"]
    f = 2.0 * points * (3 * (2 * v["embed_frequency"] + 1) + 3) * w
    f += 4.0 * k * w * w + 4.0 * points * w * w + attn(k, points, w)
    f += v["encoder_layers"] * (8.0 * k * w * w + attn(k, k, w) + 16.0 * k * w * w)
    return f + 2.0 * k * w * 2 * v["latent_channels"]


def flops_per_clip(cfg: dict, mix: dict, vertices: int) -> float:
    m, p = cfg["model"], cfg["pipeline"]
    if mix["mode"] != "video":
        return clip_flops(cfg, mix, vertices, [vae_encode(m["triposg_vae"], cfg["surface_samples"])])
    dit = m["triposg_dit"]
    cfg_on = p["stage_0.guidance_scale"] > 0
    sample = p["stage_0.num_inference_steps"] * flow_transformer(
        dit, 2 if cfg_on else 1, 1, dit["num_tokens"], context_tokens(m), 1, inflated=False)
    return clip_flops(cfg, mix, vertices, [sample, vae_decode(m["triposg_vae"])], stage0_images=1)
