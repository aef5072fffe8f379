"""Supervised training step for the Stage-II deformation decoder.

Counterpart of ``actionmesh_tpu/training/decoder_train.py``. The decoder
regresses absolute per-vertex positions in (-1, 1) from (latents, vertex
queries), so training is a masked MSE against tracked ground-truth
positions (the ActionBench (T, V, 6) layout), with the Stage-I trainer's
structure: fp32 masters cast for compute, per-block remat, the flash
backward (kernels C and D on the card), clip and AdamW, and no EMA.

Vertex counts vary per mesh, so queries pad to a bucket and padded rows
carry mask 0: they are left out of the loss and of the chamfer metrics.
``mesh=`` shards the decode as ``autoencoder_forward(mesh=)`` does (whole
batch in, whole prediction out, ``shard_params`` weights), as JAX's.
"""

from __future__ import annotations

from typing import Optional

import torch

from actionmesh_tpu_torch.models.autoencoder import AutoencoderConfig, autoencoder_forward
from actionmesh_tpu_torch.training.flow_train import cast_params_for_compute, make_step


def masked_position_mse(
    pred: torch.Tensor, target: torch.Tensor, vertex_mask: Optional[torch.Tensor]
) -> torch.Tensor:
    """MSE over real (non-padding) vertices. pred/target (B, T_out, V, 3);
    vertex_mask (B, V), 1 = real vertex. An all-padding batch gives 0."""
    err = (pred.float() - target.float()) ** 2
    if vertex_mask is None:
        return err.mean()
    w = vertex_mask.float()
    num = torch.einsum("btvc,bv->", err, w)
    den = w.sum() * err.shape[1] * err.shape[3]
    return num / torch.clamp(den, min=1.0)


def chamfer_eval_metrics(
    pred: torch.Tensor, target: torch.Tensor, vertex_mask: Optional[torch.Tensor] = None
) -> dict:
    """Chamfer-proxy metrics of decoder outputs (B, T_out, V, 3) against
    tracked ground truth, as JAX's (the ActionBench definitions without ICP):

      eval_cd      per-frame symmetric chamfer (both directional
                   nearest-neighbour distance means), averaged over frames
                   and batch;
      eval_motion  nearest indices matched on frame 0, tracked L2 averaged
                   over time, both directions summed.

    Padded vertices (mask 0) are excluded from the argmin targets and the
    means. The (B, V, V) distances are formed one frame at a time with
    JAX's arithmetic (its (B, T, V, V, 3) broadcast is 2.8 GB at B = 2,
    T = 7, V = 4096).
    """
    p, g = pred.float(), target.float()
    B, T, V, _ = p.shape
    w = torch.ones((B, V), device=p.device) if vertex_mask is None else vertex_mask.float()
    n_valid = torch.clamp(w.sum(dim=1), min=1.0)  # (B,)
    invalid = 1e9 * (1.0 - w)  # (B, V)

    def distances(t: int) -> torch.Tensor:  # (B, V_pred, V_gt)
        sq = ((p[:, t, :, None, :] - g[:, t, None, :, :]) ** 2).sum(-1)
        return torch.sqrt(torch.clamp(sq, min=1e-12))

    d0 = distances(0)
    per_frame = []
    for t in range(T):
        d = d0 if t == 0 else distances(t)
        min_pg = (d + invalid[:, None, :]).amin(dim=2)  # each pred point's nearest gt
        min_gp = (d + invalid[:, :, None]).amin(dim=1)  # each gt point's nearest pred
        per_frame.append(((min_pg * w).sum(1) + (min_gp * w).sum(1)) / n_valid)
        del d
    eval_cd = torch.stack(per_frame, dim=1).mean()

    idx_gt_to_pred = (d0 + invalid[:, :, None]).argmin(dim=1)  # (B, V_gt)
    idx_pred_to_gt = (d0 + invalid[:, None, :]).argmin(dim=2)  # (B, V_pred)
    p_matched = torch.gather(p, 2, idx_gt_to_pred[:, None, :, None].expand(B, T, V, 3))
    g_matched = torch.gather(g, 2, idx_pred_to_gt[:, None, :, None].expand(B, T, V, 3))
    l2_1 = torch.linalg.vector_norm(p_matched - g, dim=-1).mean(dim=1)  # (B, V_gt)
    l2_2 = torch.linalg.vector_norm(g_matched - p, dim=-1).mean(dim=1)  # (B, V_pred)
    eval_motion = (((l2_1 * w).sum(1) + (l2_2 * w).sum(1)) / n_valid).mean()
    return {"eval_cd": eval_cd, "eval_motion": eval_motion}


def _decode(params, cfg, batch, compute_dtype, train: bool, mesh=None) -> torch.Tensor:
    """The forward on the batch: ``train`` takes the trainable attention and
    remat (the same values as without)."""
    fwd_params = params if compute_dtype is None else cast_params_for_compute(params, compute_dtype)
    return autoencoder_forward(
        fwd_params, cfg, batch["latents"], batch["framestep"], batch["source_alpha"],
        batch["target_alphas"], batch["query"], compute_dtype=compute_dtype or torch.float32,
        trainable=train, remat=train, mesh=mesh,
    )


def decoder_loss(
    params,
    cfg: AutoencoderConfig,
    batch: dict,
    *,
    compute_dtype: Optional[torch.dtype] = None,
    mesh=None,
) -> torch.Tensor:
    """Masked position MSE for one batch.

    batch: ``latents`` (B,T,N,C), ``framestep`` (B,T), ``source_alpha`` (B,),
    ``target_alphas`` (B,T_out), ``query`` (B,V,3|6) anchor vertices
    (+ normals), ``positions`` (B,T_out,V,3) tracked positions in [-1, 1],
    optional ``vertex_mask`` (B,V). Attention is the trainable one (JAX's
    ``auto_train``), each self-attention block rematerialised.
    """
    pred = _decode(params, cfg, batch, compute_dtype, train=True, mesh=mesh)
    return masked_position_mse(pred, batch["positions"], batch.get("vertex_mask"))


@torch.no_grad()
def decoder_eval_metrics(
    params,
    cfg: AutoencoderConfig,
    batch: dict,
    *,
    compute_dtype: Optional[torch.dtype] = None,
    with_chamfer: bool = False,
    mesh=None,
) -> dict:
    """One forward -> {eval_loss[, eval_cd, eval_motion]} as floats; the
    MSE and the chamfer metrics share it. No gradient, so the inference
    attention and no remat (the same values)."""
    pred = _decode(params, cfg, batch, compute_dtype, train=False, mesh=mesh)
    mask = batch.get("vertex_mask")
    out = {"eval_loss": masked_position_mse(pred, batch["positions"], mask)}
    if with_chamfer:
        out.update(chamfer_eval_metrics(pred, batch["positions"], mask))
    return {k: float(v) for k, v in out.items()}


def make_decoder_train_step(
    cfg: AutoencoderConfig,
    optimizer,
    *,
    compute_dtype: Optional[torch.dtype] = None,
    time_phases: bool = False,
    mesh=None,
    shardings=None,
):
    """The decoder's train step, ``(state, batch, gen) -> (state, loss)``
    (``gen`` unused: the loss draws nothing); the state has no EMA, as in
    JAX. ``mesh`` and ``shardings``: ``make_step``'s."""

    def loss_fn(params, batch, _gen):
        return decoder_loss(params, cfg, batch, compute_dtype=compute_dtype, mesh=mesh)

    return make_step(loss_fn, optimizer, time_phases=time_phases, mesh=mesh, shardings=shardings)
