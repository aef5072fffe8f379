"""Model FLOPs of one ActionMesh clip, from a configuration's widths and a
traffic mix's shapes (never read from the program).

A matrix product of (m, k) by (k, n) is 2*m*k*n FLOPs; attention over Sq
queries and Sk keys of width W (all heads) is 4*Sq*Sk*W (q.k and p.v).
Counted per clip:
  * DINOv2 on every frame, and on the anchor frame once more for TripoSG
    (video mode): patch embedding, 4 projections, attention, MLP;
  * the TripoSG DiT (video mode): steps x CFG branches over one frame of
    N + 1 tokens (the time token), its 21 blocks with U-skips; the
    unconditional branch's cross-attention is left out, since with an
    all-zero image it is exactly the output bias and the program skips it;
  * the TripoSG VAE: the decoder's self blocks over the latent set once
    (video mode), or the encoder from the surface samples ({video + 3D}:
    point projection, one cross-attention from K picked points, its self
    blocks); FPS and the SDF queries are left out: the query count depends
    on the field and on the extraction method;
  * Stage I: every window x steps x guidance branches over T frames of
    N + 1 tokens, self-attention over all T*(N+1) of a branch, cross to
    each frame's image tokens (none in branches without the image);
  * Stage II: every window's targets (the window's frames but its first)
    over [T*N | T] tokens through the self blocks, then the final cross
    block from the anchor's V vertices (k, v over the tokens per target).
"""

from __future__ import annotations

from portbench.bench.check import windows


def attn(sq: int, sk: int, w: int) -> float:
    return 4.0 * sq * sk * w


def dinov2(d: dict, images: int) -> float:
    w, p = d["hidden_size"], d["patch_size"]
    g = 224 // p
    s = g * g + 1
    per = 2.0 * g * g * 3 * p * p * w
    per += d["num_layers"] * (8.0 * s * w * w + attn(s, s, w) + 4.0 * s * w * w * d["mlp_ratio"])
    return images * per


def flow_transformer(c: dict, batch: int, frames: int, tokens: int, ctx_tokens: int,
                     cond_rows: int, inflated: bool) -> float:
    """One forward: ``batch`` entries of ``frames`` frames of ``tokens``
    latent tokens; ``cond_rows`` entries see the image (cross-attention)."""
    w, L, cin = c["width"], c["num_layers"], c["in_channels"]
    ffw = c.get("mlp_ratio", 4.0) * w
    m = batch * frames * (tokens + 1)
    f = 2.0 * batch * frames * tokens * cin * w * 2  # proj_in, proj_out
    f += 2.0 * batch * frames * (w * 4 * w + 4 * w * w)  # time projection
    seq = frames * (tokens + 1) if inflated else tokens + 1
    n_seq = batch if inflated else batch * frames
    rows_x = cond_rows * frames
    for i in range(L):
        f += 8.0 * m * w * w + n_seq * attn(seq, seq, w)
        f += rows_x * (4.0 * (tokens + 1) * w * w + 4.0 * ctx_tokens * c["cross_attention_dim"] * w
                       + attn(tokens + 1, ctx_tokens, w))
        f += 4.0 * m * w * ffw
        if i > L // 2:
            f += 4.0 * m * w * w
    return f


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


def autoencoder(a: dict, frames: int, tokens: int, vertices: int) -> float:
    """One Stage-II window of ``frames`` frames: targets = frames - 1."""
    w = a["width"]
    targets = frames - 1
    s = frames * tokens + frames
    f = 2.0 * frames * tokens * a["latent_channels"] * w
    per = a["num_layers"] * (8.0 * s * w * w + attn(s, s, w) + 16.0 * s * w * w)
    q_in = a["in_channels"] * (2 * a["embed_frequency"] + 1) + a["in_extra_channels"]
    per += 4.0 * s * w * w  # k, v of the final cross block over the tokens
    per += 4.0 * vertices * w * w + attn(vertices, s, w) + 16.0 * vertices * w * w
    per += 2.0 * vertices * w * a["out_dim"]
    return f + 2.0 * vertices * q_in * w + targets * per


def flops_per_clip(cfg: dict, mix: dict, vertices: int) -> float:
    m, p = cfg["model"], cfg["pipeline"]
    T = mix["frames"]
    video = mix["mode"] == "video"
    den, ae = m["denoiser"], m["autoencoder"]
    ctx = (224 // m["dinov2"]["patch_size"]) ** 2 + 1
    f = dinov2(m["dinov2"], T + (1 if video else 0))
    if video:
        dit = m["triposg_dit"]
        cfg_on = p["stage_0.guidance_scale"] > 0
        f += p["stage_0.num_inference_steps"] * flow_transformer(
            dit, 2 if cfg_on else 1, 1, dit["num_tokens"], ctx, 1, inflated=False)
        f += vae_decode(m["triposg_vae"])
    else:
        f += vae_encode(m["triposg_vae"], cfg["surface_samples"])
    flags = p["cf_guidance.guidance_at_inference"]
    cond = sum(1 for fl in flags if fl[0])
    for w in windows(T, den["temporal_context_size"], p["sliding_window_denoiser"]):
        f += p["scheduler.num_inference_steps"] * flow_transformer(
            den, len(flags), len(w), den["num_tokens_nominal"], ctx, cond, inflated=True)
    for w in windows(T, ae["temporal_context_size"], p["sliding_window_autoencoder"]):
        f += autoencoder(ae, len(w), den["num_tokens_nominal"], vertices)
    return f
