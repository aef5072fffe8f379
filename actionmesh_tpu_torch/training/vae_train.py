"""TSDF-supervised training of the TripoSG vecset VAE.

Counterpart of ``actionmesh_tpu/training/vae_train.py``. The closed loop's
Stage-0 phase trains the VAE from scratch: encode a surface point cloud to
the token posterior, decode, and supervise ``query_sdf`` against the exact
truncated signed distance of the source mesh
(``preprocessing/sdf.mesh_tsdf``, negative inside, the ``value < level``
extraction convention of ``ops/isosurface``).

Loss = TSDF MSE at mixed near-surface + uniform query points
     + kl_weight * KL(posterior || N(0, 1))

The step is the other trainers' (``training/flow_train.make_step``): fp32
masters, clip and AdamW, no EMA, no remat (as JAX's step), and every
attention the trainable one (kernels A, C and D on the card). FPS picks
its tokens deterministically (all points, first pick index 0), as JAX's
default and the inference encode without a seed. The posterior noise is an
argument of ``vae_loss``; the train step draws it from the step's CPU
generator (JAX draws it from its key: the two cannot give the same bits).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from actionmesh_tpu_torch.models.triposg.vae import (
    TripoSGVAEConfig,
    decode_kv,
    encode_moments,
    query_sdf,
)
from actionmesh_tpu_torch.training.flow_train import make_step


def vae_loss(
    params,
    cfg: TripoSGVAEConfig,
    batch: dict,
    noise: Optional[torch.Tensor] = None,
    *,
    kl_weight: float = 1e-4,
    trainable: bool = True,
) -> tuple[torch.Tensor, dict]:
    """(loss, {"mse": ..., "kl": ...}) for one batch.

    batch: ``surface`` (B, N, 6) points and normals, ``points`` (B, Q, 3)
    query positions, ``tsdf`` (B, Q) truncated signed-distance targets.
    ``noise`` (B, K, C): the posterior sample mean + exp(logvar / 2) *
    noise is decoded; None decodes the posterior mean (JAX's
    ``sample_posterior=False``). ``trainable``: every attention the
    trainable one (with no gradient to take, the inference one gives the
    same values).
    """
    mean, logvar = encode_moments(params, cfg, batch["surface"], trainable=trainable)
    if noise is not None:
        latent = mean + torch.exp(0.5 * logvar) * noise.to(device=mean.device, dtype=mean.dtype)
    else:
        latent = mean
    kv = decode_kv(params, cfg, latent, trainable=trainable)
    pred = query_sdf(params, cfg, kv, batch["points"], trainable=trainable)
    mse = torch.mean((pred - batch["tsdf"].float()) ** 2)
    kl = 0.5 * torch.mean(torch.sum(mean**2 + torch.exp(logvar) - 1.0 - logvar, dim=-1))
    return mse + kl_weight * kl, {"mse": mse, "kl": kl}


def make_vae_train_step(
    cfg: TripoSGVAEConfig,
    optimizer,
    *,
    kl_weight: float = 1e-4,
    time_phases: bool = False,
):
    """The VAE's train step, ``(state, batch, gen) -> (state, loss)``: the
    loss of the fp32 masters with posterior noise drawn from ``gen``, then
    clip and AdamW. The state has no EMA, as JAX's."""

    def loss_fn(params, batch, gen):
        shape = (batch["surface"].shape[0], cfg.num_tokens, cfg.latent_channels)
        noise = torch.randn(shape, generator=gen, dtype=torch.float32)  # on the CPU
        return vae_loss(params, cfg, batch, noise, kl_weight=kl_weight)[0]

    return make_step(loss_fn, optimizer, time_phases=time_phases)


def sdf_batches(
    scenes: list[dict],
    batch_size: int,
    q_points: int,
    *,
    seed: int = 0,
    epochs: Optional[int] = None,
):
    """Yield VAE training batches from per-scene SDF sample pools.

    ``scenes``: list of {"surface" (N, 6), "points" (P, 3), "tsdf" (P,)}
    host arrays with P >= q_points. Each draw picks ``batch_size`` scenes
    (with reshuffled epochs) and subsamples ``q_points`` fresh query points
    per scene, so successive epochs see different supervision subsets. The
    same numpy draws as JAX's, so the same seed gives the same batches.
    """
    if len(scenes) < batch_size:
        raise ValueError(f"{len(scenes)} scenes < batch_size {batch_size}")
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(scenes))
        for lo in range(0, len(order) - batch_size + 1, batch_size):
            items = [scenes[int(i)] for i in order[lo : lo + batch_size]]
            sel = [rng.choice(len(it["points"]), q_points, replace=False) for it in items]
            yield {
                "surface": np.stack([it["surface"] for it in items]),
                "points": np.stack([it["points"][s] for it, s in zip(items, sel)]),
                "tsdf": np.stack([it["tsdf"][s] for it, s in zip(items, sel)]),
            }
        epoch += 1
