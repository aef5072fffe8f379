"""Model FLOPs of the stages every model family runs, from a configuration's
widths and a traffic mix's shapes (never read from the program); a
family's ``work/<family>.py`` adds its Stage 0 through ``clip_flops``.

A matrix product of (m, k) by (k, n) is 2*m*k*n FLOPs; attention over Sq
queries and Sk keys of width W (all heads) is 4*Sq*Sk*W (q.k and p.v).
Counted per clip:
  * DINOv2 on every frame (patch embedding, 4 projections, attention,
    MLP), and on the images Stage 0 conditions on;
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


def context_tokens(model: dict) -> int:
    """DINOv2's tokens an image: the patches of a 224-pixel crop and CLS."""
    return (224 // model["dinov2"]["patch_size"]) ** 2 + 1


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


def clip_flops(cfg: dict, mix: dict, vertices: int, stage0: list[float],
               stage0_images: int = 0) -> float:
    """One clip: DINOv2 on the frames and on ``stage0_images`` more, the
    family's Stage-0 terms in order, Stage I and Stage II."""
    m, p = cfg["model"], cfg["pipeline"]
    T = mix["frames"]
    den, ae = m["denoiser"], m["autoencoder"]
    f = dinov2(m["dinov2"], T + stage0_images)
    for term in stage0:
        f += term
    flags = p["cf_guidance.guidance_at_inference"]
    cond = sum(1 for fl in flags if fl[0])
    for w in windows(T, den["temporal_context_size"], p["sliding_window_denoiser"]):
        f += p["scheduler.num_inference_steps"] * flow_transformer(
            den, len(flags), len(w), den["num_tokens_nominal"], context_tokens(m), cond,
            inflated=True)
    for w in windows(T, ae["temporal_context_size"], p["sliding_window_autoencoder"]):
        f += autoencoder(ae, len(w), den["num_tokens_nominal"], vertices)
    return f
