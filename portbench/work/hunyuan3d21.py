"""Model FLOPs of one ActionMesh clip with Hunyuan3D-2.1's shape model as
Stage 0, from a configuration's widths and a traffic mix's shapes (never
read from the program). DINOv2, Stage I and Stage II are counted as
``bench/work.py`` says; Stage 0 adds:
  * the conditioner's DINOv2 on the anchor at its own image size (518^2:
    1,370 tokens);
  * the DiT: steps x CFG branches over N + 1 tokens (the time token), as
    ``bench/work.py:flow_transformer`` counts a flow transformer at one
    frame with the unconditional branch's cross-attention left out; each
    expert block adds its router (2 x E products a token) and, beyond the
    one dense feed-forward counted, top-k more: k routed experts and the
    shared one a token;
  * the ShapeVAE decoder's self blocks over the latent set once, and the
    handoff: TripoSG's VAE encoder from the surface samples
    (``work/actionmesh.py``); FPS and the SDF queries are left out, as
    there.
"""

from __future__ import annotations

from portbench.bench.work import attn, clip_flops, flow_transformer
from portbench.work.actionmesh import vae_decode, vae_encode


def dinov2_at(d: dict, size: int) -> float:
    """DINOv2 on one image of ``size``^2."""
    w, p = d["hidden_size"], d["patch_size"]
    g = size // p
    s = g * g + 1
    f = 2.0 * g * g * 3 * p * p * w
    return f + d["num_layers"] * (8.0 * s * w * w + attn(s, s, w) + 4.0 * s * w * w * d["mlp_ratio"])


def dit_step(d: dict, batch: int, ctx_tokens: int) -> float:
    w, n = d["width"], d["num_tokens"]
    rows = batch * (n + 1)
    f = flow_transformer(d, batch, 1, n, ctx_tokens, 1, inflated=False)
    ffn = 4.0 * rows * w * d["mlp_ratio"] * w
    return f + d["num_moe_layers"] * (2.0 * rows * w * d["num_experts"] + d["moe_top_k"] * ffn)


def flops_per_clip(cfg: dict, mix: dict, vertices: int) -> float:
    m, p = cfg["model"], cfg["pipeline"]
    if mix["mode"] != "video":
        raise ValueError("the hunyuan3d21 family runs the video mode only")
    c, d, v = m["hunyuan3d_dinov2"], m["hunyuan3d_dit"], m["hunyuan3d_vae"]
    ctx = (c["image_size"] // c["patch_size"]) ** 2 + 1
    sample = p["stage_0.num_inference_steps"] * dit_step(
        d, 2 if p["stage_0.guidance_scale"] > 0 else 1, ctx)
    decode = vae_decode({"num_tokens": v["num_tokens"], "decoder_width": v["width"],
                         "latent_channels": v["latent_channels"], "decoder_layers": v["layers"]})
    return clip_flops(cfg, mix, vertices, [dinov2_at(c, c["image_size"]), sample, decode,
                                           vae_encode(m["triposg_vae"], cfg["surface_samples"])])
