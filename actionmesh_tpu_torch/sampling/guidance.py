"""Classifier-free guidance: CFG branch batch and aggregation.

Counterpart of ``actionmesh_tpu/sampling/guidance.py``. Branch flags
(a, b) keep (1) or zero (0) the image context and the anchor-latent
conditioning mask; the branches ride a leading batch axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class ClassifierFreeGuidance:
    inference_enabled: bool = True
    guidance_at_inference: tuple[tuple[int, int], ...] = ((0, 0), (0, 1), (1, 1))
    guidance_scales: tuple[float, ...] = (1.0, 1.0)

    def __post_init__(self):
        if len(self.guidance_at_inference) != len(self.guidance_scales) + 1:
            raise ValueError("need one more guidance branch than scales")

    @property
    def n_branches(self) -> int:
        return len(self.guidance_at_inference) if self.inference_enabled else 1

    @property
    def leading_uncond_image_branches(self) -> int:
        """How many leading branches zero the image context ((0, *) flags)."""
        if not self.inference_enabled:
            return 0
        n = 0
        for use_image, _ in self.guidance_at_inference:
            if use_image:
                break
            n += 1
        return n

    def get_unobserved_mask(self, mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """True where the latent is denoised (not ground-truth conditioned)."""
        if mask is None:
            return None
        return mask == 0

    def cfg_at_inference(self, latent, context, mask, framestep):
        """Stack the branches on the batch axis: (B, ...) -> (G*B, ...)."""
        if not self.inference_enabled:
            return latent, context, mask, framestep
        g = len(self.guidance_at_inference)
        latent_out = torch.cat([latent] * g, dim=0)
        framestep_out = torch.cat([framestep] * g, dim=0) if framestep is not None else None
        context_list, mask_list = [], []
        for use_image, use_latent in self.guidance_at_inference:
            context_list.append(context if use_image else torch.zeros_like(context))
            if mask is not None:
                mask_list.append(mask if use_latent else torch.zeros_like(mask))
        context_out = torch.cat(context_list, dim=0)
        mask_out = torch.cat(mask_list, dim=0) if mask is not None else None
        return latent_out, context_out, mask_out, framestep_out

    def aggregate_cfg(self, stacked: torch.Tensor) -> torch.Tensor:
        """v0 + sum_i s_i * (v_{i+1} - v_i) over the branch axis."""
        if not self.inference_enabled:
            return stacked
        outputs = torch.chunk(stacked, len(self.guidance_at_inference), dim=0)
        result = outputs[0]
        for i, scale in enumerate(self.guidance_scales):
            result = result + scale * (outputs[i + 1] - outputs[i])
        return result


def make_guidance(
    guidance_at_inference: Sequence[Sequence[int]],
    guidance_scales: Sequence[float],
    inference_enabled: bool = True,
) -> ClassifierFreeGuidance:
    return ClassifierFreeGuidance(
        inference_enabled=inference_enabled,
        guidance_at_inference=tuple(tuple(g) for g in guidance_at_inference),
        guidance_scales=tuple(guidance_scales),
    )
