"""Hunyuan3D-2.1's shape model as Stage 0: image -> (TripoSG latent, mesh).

tencent/Hunyuan3D-2.1 (``hy3dshape``): the conditioner (DINOv2-L at 518^2
on the image recentred with a 0.15 border: 1,370 tokens of 1,024), an
Euler flow loop of the sparse-expert DiT (``models/hunyuan3d/dit.py``)
with classifier-free guidance, and the ShapeVAE's SDF decode over 4,096
latents, which is TripoSG's decoder code at another configuration
(``hunyuan3d_vae_config``), extracted by the port's hierarchical marching
cubes. The sampler and the decode are the TripoSG pipeline's
(``flow_sample``, ``decode_latents``); only the time differs: the DiT sees
sigma = 1 - t / 1000 (noise at 0, data at 1, as the release's scheduler
counts) on the shifted schedule at the release's shift 1.

Stage I runs in TripoSG's latent space (2,048 x 64), so the generated mesh
is handed over as {video + 3D} hands over a user's mesh: 16,384
area-weighted surface samples with normals, encoded by TripoSG's VAE
encoder (``handoff``, a ``TripoSGPipeline`` without a DiT). ``__call__``
returns that latent with the mesh; ``encode_to_latent`` is the handoff's,
so {video + 3D} behind this backend encodes as behind TripoSG.

A call runs TripoSG's spans ``encode``, ``dit_sample`` (``dit_step`` a
step, a ``moe`` span in each expert block) and ``decode`` (``decode_kv``,
``extract``), then ``handoff`` (``sample``, ``vae_encode``), which ends in
a device synchronisation; ``phase_seconds`` reads the four.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from actionmesh_tpu_torch.models.dinov2 import DinoV2Config, dinov2_forward, init_dinov2
from actionmesh_tpu_torch.models.hunyuan3d.dit import hunyuan3d_dit_config
from actionmesh_tpu_torch.models.image_encoder import IMAGENET_MEAN, IMAGENET_STD, resize_bicubic
from actionmesh_tpu_torch.models.triposg.dit import init_triposg_dit
from actionmesh_tpu_torch.models.triposg.pipeline import TripoSGPipeline
from actionmesh_tpu_torch.models.triposg.vae import ShapeVAEConfig, TripoSGVAEConfig, init_triposg_vae
from actionmesh_tpu_torch.preprocessing.mesh import sample_surface
from actionmesh_tpu_torch.utils.profiling import span

BORDER_RATIO = 0.15
IMAGE_SIZE = 518
SURFACE_SAMPLES = 16384


def hunyuan3d_vae_config(num_tokens: int = 4096, latent_channels: int = 64, width: int = 1024,
                         layers: int = 16, heads: int = 16) -> ShapeVAEConfig:
    """The ShapeVAE decoder (``hunyuan3d-vae-v2-1``): 4,096 latents of 64,
    width 1,024, 16 layers, 16 heads of 64, a layer-norm qk-norm, layer
    norms at eps 1e-6, the geometry decoder's feed-forward after its query
    cross-attention, scale factor 1.0039506158752403. Stage 0 runs no
    encoder of it (none is drawn)."""
    return ShapeVAEConfig(
        latent_channels=latent_channels, num_tokens=num_tokens, embed_frequency=8,
        encoder_layers=0, decoder_width=width, decoder_layers=layers, decoder_heads=heads,
        decoder_qk_norm=True, decoder_out_bias=True, decoder_norm_eps=1e-6,
        decoder_query_mlp=True, scale_factor=1.0039506158752403,
    )


def recenter(image: np.ndarray, border_ratio: float = BORDER_RATIO) -> np.ndarray:
    """(H, W, 3|4) uint8 on white -> (S, S, 3), S = max(H, W): the object's
    box (its non-white pixels) resized so that its longer side is
    int(S (1 - border_ratio)), centred on white, as the release's
    ``ImageProcessorV2.recenter`` places its alpha box."""
    rgb = np.ascontiguousarray(image[..., :3])
    fg = (rgb < 255).any(-1)
    rows, cols = np.nonzero(fg.any(1))[0], np.nonzero(fg.any(0))[0]
    if len(rows) == 0:
        raise ValueError("recenter: the image has no foreground")
    y0, y1, x0, x1 = rows[0], rows[-1] + 1, cols[0], cols[-1] + 1
    size = max(rgb.shape[:2])
    scale = int(size * (1 - border_ratio)) / max(y1 - y0, x1 - x0)
    h, w = max(1, int((y1 - y0) * scale)), max(1, int((x1 - x0) * scale))
    out = np.full((size, size, 3), 255, np.uint8)
    top, left = (size - h) // 2, (size - w) // 2
    out[top:top + h, left:left + w] = resize_bicubic(rgb[y0:y1, x0:x1], h, w)
    return out


def conditioner_pixels(image: np.ndarray, size: int = IMAGE_SIZE) -> np.ndarray:
    """The conditioner's input: recentred, resized to ``size``^2 (bicubic),
    ImageNet-normalised (size, size, 3) float32."""
    img = resize_bicubic(recenter(image), size, size).astype(np.float32) / 255.0
    return (img - IMAGENET_MEAN) / IMAGENET_STD


class Conditioner:
    """DINOv2-L at 518^2 with its own weights: ``encode_images`` gives
    (B, 1 + 37^2, 1024) features, as ``ImageEncoder`` does at 224."""

    def __init__(self, params, config: DinoV2Config, dtype: torch.dtype, device):
        self.params, self.config, self._dtype, self.device = params, config, dtype, device

    def encode_images(self, images: list[np.ndarray]) -> torch.Tensor:
        pixels = np.stack([conditioner_pixels(im, self.config.image_size) for im in images])
        return dinov2_forward(self.params, self.config,
                              torch.as_tensor(pixels, device=self.device).to(self._dtype))


class Hunyuan3DPipeline(TripoSGPipeline):
    """Image -> (TripoSG latent (1, 2048, 64) fp32, mesh) backend for Stage
    0 (see the module doc). ``handoff``: the TripoSG VAE's encode path
    (anything with ``encode_to_latent(surface, seed)``)."""

    def __init__(
        self,
        dit_params,
        vae_params,
        conditioner: Conditioner,
        handoff,
        dit_cfg=None,
        vae_cfg: Optional[ShapeVAEConfig] = None,
        dtype: torch.dtype = torch.bfloat16,
        device: torch.device = torch.device("cuda"),
        shift: float = 1.0,
        surface_samples: int = SURFACE_SAMPLES,
    ):
        super().__init__(dit_params, vae_params, conditioner,
                         dit_cfg=dit_cfg or hunyuan3d_dit_config(),
                         vae_cfg=vae_cfg or hunyuan3d_vae_config(),
                         dtype=dtype, device=device, num_train_timesteps=1000, shift=shift)
        self.handoff = handoff
        self.surface_samples = surface_samples

    @classmethod
    def from_random(cls, seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                    device: torch.device = torch.device("cuda"), dit_cfg=None, vae_cfg=None,
                    conditioner_cfg: Optional[DinoV2Config] = None, handoff=None,
                    handoff_cfg: Optional[TripoSGVAEConfig] = None) -> "Hunyuan3DPipeline":
        """Random weights: the DiT, the decoder, the conditioner and (without
        a ``handoff``) TripoSG's VAE, from generators ``seed`` .. ``seed + 3``."""
        device = torch.device(device)
        dit_cfg = dit_cfg or hunyuan3d_dit_config()
        vae_cfg = vae_cfg or hunyuan3d_vae_config()
        cond_cfg = conditioner_cfg or DinoV2Config()
        gens = [torch.Generator(device=device).manual_seed(seed + i) for i in range(4)]
        if handoff is None:
            hcfg = handoff_cfg or TripoSGVAEConfig()
            handoff = TripoSGPipeline(None, init_triposg_vae(gens[3], hcfg, dtype, device), None,
                                      vae_cfg=hcfg, dtype=dtype, device=device)
        return cls(
            init_triposg_dit(gens[0], dit_cfg, dtype=dtype, device=device),
            init_triposg_vae(gens[1], vae_cfg, dtype=dtype, device=device),
            Conditioner(init_dinov2(gens[2], cond_cfg, dtype, device), cond_cfg, dtype, device),
            handoff, dit_cfg=dit_cfg, vae_cfg=vae_cfg, dtype=dtype, device=device,
        )

    @classmethod
    def from_pretrained(cls, path: str | Path, handoff, dtype: torch.dtype = torch.bfloat16,
                        device: torch.device = torch.device("cuda")) -> "Hunyuan3DPipeline":
        """The release's weights from ``path`` (``models/hunyuan3d/convert.py``)
        at the published configuration."""
        from actionmesh_tpu_torch.models.hunyuan3d.convert import load

        device = torch.device(device)
        dit_cfg, vae_cfg, cond_cfg = hunyuan3d_dit_config(), hunyuan3d_vae_config(), DinoV2Config()
        dit, vae, cond = load(path, dit_cfg, vae_cfg, cond_cfg, dtype, device)
        return cls(dit, vae, Conditioner(cond, cond_cfg, dtype, device), handoff,
                   dit_cfg=dit_cfg, vae_cfg=vae_cfg, dtype=dtype, device=device)

    def schedule(self, num_inference_steps: int) -> tuple[np.ndarray, np.ndarray]:
        ts, dist = super().schedule(num_inference_steps)
        return 1.0 - ts / self._num_train_timesteps, dist

    @torch.no_grad()
    def __call__(self, image: np.ndarray, seed: int = 44, num_inference_steps: int = 50,
                 guidance_scale: float = 5.0, **decode) -> tuple[torch.Tensor, object]:
        """(TripoSG latent (1, K, C) fp32, mesh) from one (H, W, 3|4) uint8
        image; ``decode`` as ``TripoSGPipeline.__call__``'s extraction
        arguments."""
        _, mesh = super().__call__(image, seed=seed, num_inference_steps=num_inference_steps,
                                   guidance_scale=guidance_scale, **decode)
        with span("handoff") as handoff:
            with span("sample"):
                surface = sample_surface(mesh, self.surface_samples, seed=seed, with_normals=True)
            with span("vae_encode"):
                latent = self.handoff.encode_to_latent(surface[None], seed=seed)
            self._sync()
        self._phase_spans.append(handoff)
        return latent, mesh

    def encode_to_latent(self, surface, seed: Optional[int] = None) -> torch.Tensor:
        return self.handoff.encode_to_latent(surface, seed=seed)
