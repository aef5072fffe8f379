"""RMBG-1.4 background matting (BriaRMBG / ISNet-DIS, the U2-Net RSU family).

Counterpart of ``actionmesh_tpu/models/rmbg.py``: a stride-2 input conv,
six RSU (residual U-block) encoder stages, five RSU decoder stages with skip
concatenations, 3x3 side heads; the matte is sigmoid(side1). The parameter
tree is the JAX package's (HWIO ``kernel`` + ``bias`` per conv, BatchNorm
folded into the conv by ``convert_rmbg_weights``); ``conv_weights`` turns
it into torch's OIHW ``weight`` once, when a model is built, and
``rmbg_forward`` runs on that, NCHW.

The convolutions are cuDNN's (``torch.nn.functional.conv2d``): the JAX
package has no Pallas kernel here, XLA lowers them. ``rmbg_forward`` runs
them with TF32 off, so an fp32 matte on the card stays within float
rounding of the CPU's. Translations of the JAX ops: max pooling "SAME"
with -inf padding is ``max_pool2d(ceil_mode=True)``; ``jax.image.resize``
bilinear, which here only upsamples, is half-pixel ``interpolate(
mode="bilinear", align_corners=False)``; ``conv_in``'s stride-2 padding is
(1, 1). ``predict_alpha`` resizes as PIL's BILINEAR does, in PIL's
fixed-point arithmetic (``io/video_input.py:pil_resize``).
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from actionmesh_tpu_torch.io.video_input import pil_resize

logger = logging.getLogger(__name__)

Params = dict

# (name, type, in, mid, out) per ISNet/BriaRMBG stage
STAGES = [
    ("stage1", "RSU7", 64, 32, 64),
    ("stage2", "RSU6", 64, 32, 128),
    ("stage3", "RSU5", 128, 64, 256),
    ("stage4", "RSU4", 256, 128, 512),
    ("stage5", "RSU4F", 512, 256, 512),
    ("stage6", "RSU4F", 512, 256, 512),
]
DSTAGES = [
    ("stage5d", "RSU4F", 1024, 256, 512),
    ("stage4d", "RSU4", 1024, 128, 256),
    ("stage3d", "RSU5", 512, 64, 128),
    ("stage2d", "RSU6", 256, 32, 64),
    ("stage1d", "RSU7", 128, 16, 64),
]
RSU_HEIGHT = {"RSU7": 7, "RSU6": 6, "RSU5": 5, "RSU4": 4, "RSU4F": 4}
SIDE_IN = [64, 64, 128, 256, 512, 512]


@dataclasses.dataclass(frozen=True)
class RMBGConfig:
    in_ch: int = 3
    out_ch: int = 1
    input_size: int = 1024


def _init_conv(gen, in_ch: int, out_ch: int, device, ksize: int = 3) -> Params:
    std = (2.0 / (in_ch * ksize * ksize)) ** 0.5
    w = torch.randn((ksize, ksize, in_ch, out_ch), generator=gen, device=device) * std
    return {"kernel": w, "bias": torch.zeros(out_ch, device=device)}


def init_rmbg(gen: torch.Generator, cfg: RMBGConfig = RMBGConfig(), device=None) -> Params:
    """Random development weights (He-normal convs, zero biases, identity
    BatchNorm), in the JAX package's HWIO tree."""
    params: Params = {"conv_in": _init_conv(gen, cfg.in_ch, 64, device)}
    for name, kind, cin, mid, cout in STAGES + DSTAGES:
        h = RSU_HEIGHT[kind]
        sub = {"rebnconvin": _init_conv(gen, cin, cout, device)}
        for i in range(1, h + 1):
            sub[f"rebnconv{i}"] = _init_conv(gen, cout if i == 1 else mid, mid, device)
        for i in range(h - 1, 0, -1):
            sub[f"rebnconv{i}d"] = _init_conv(gen, 2 * mid, cout if i == 1 else mid, device)
        params[name] = sub
    for i in range(6):
        params[f"side{i + 1}"] = _init_conv(gen, SIDE_IN[i], cfg.out_ch, device)
    return params


def convert_rmbg_weights(state: dict) -> Params:
    """briaai/RMBG-1.4 state dict -> the JAX package's tree, BatchNorm folded
    into each conv in the JAX converter's numpy arithmetic (so the leaves
    are its bits): w * gamma / sqrt(var + 1e-5), (b - mean) * that + beta.

    Names: ``conv_in.{weight,bias}``, ``stageN.rebnconvM.conv_s1.*`` with
    ``stageN.rebnconvM.bn_s1.{weight,bias,running_mean,running_var}``,
    ``side1..side6.*``.
    """
    arrays = {
        k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() if isinstance(v, torch.Tensor)
        else np.asarray(v)
        for k, v in state.items()
    }

    def fold(conv_prefix: str, bn_prefix: Optional[str]) -> Params:
        w = arrays[f"{conv_prefix}.weight"]  # OIHW
        b = arrays.get(f"{conv_prefix}.bias")
        b = np.zeros(w.shape[0]) if b is None else b
        if bn_prefix is not None and f"{bn_prefix}.weight" in arrays:
            gamma = arrays[f"{bn_prefix}.weight"]
            beta = arrays[f"{bn_prefix}.bias"]
            mean = arrays[f"{bn_prefix}.running_mean"]
            var = arrays[f"{bn_prefix}.running_var"]
            scale = gamma / np.sqrt(var + 1e-5)
            w = w * scale[:, None, None, None]
            b = (b - mean) * scale + beta
        # jnp.asarray keeps float32 and rounds float64 to it
        return {
            "kernel": torch.from_numpy(np.ascontiguousarray(w.transpose(2, 3, 1, 0), np.float32)),
            "bias": torch.from_numpy(np.asarray(b, np.float32)),
        }

    try:
        params: Params = {"conv_in": fold("conv_in", None)}
        for name, kind, *_ in STAGES + DSTAGES:
            h = RSU_HEIGHT[kind]
            sub = {"rebnconvin": fold(f"{name}.rebnconvin.conv_s1", f"{name}.rebnconvin.bn_s1")}
            for i in range(1, h + 1):
                sub[f"rebnconv{i}"] = fold(f"{name}.rebnconv{i}.conv_s1", f"{name}.rebnconv{i}.bn_s1")
            for i in range(h - 1, 0, -1):
                sub[f"rebnconv{i}d"] = fold(f"{name}.rebnconv{i}d.conv_s1", f"{name}.rebnconv{i}d.bn_s1")
            params[name] = sub
        for i in range(1, 7):
            params[f"side{i}"] = fold(f"side{i}", None)
    except KeyError as e:
        from actionmesh_tpu_torch.utils.weights import describe_state_dict

        raise KeyError(
            f"RMBG key mapping mismatch: missing {e}.\nCheckpoint structure:\n"
            + describe_state_dict(state)
        ) from e
    return params


def conv_weights(tree: Params, device=None) -> Params:
    """The JAX tree's HWIO kernels as torch's OIHW ``weight`` (contiguous),
    biases as they are, on ``device``."""
    if "kernel" in tree:
        return {"weight": tree["kernel"].permute(3, 2, 0, 1).contiguous().to(device),
                "bias": tree["bias"].to(device)}
    return {k: conv_weights(v, device) for k, v in tree.items()}


def _conv(p: Params, x: torch.Tensor, stride: int = 1, dilation: int = 1) -> torch.Tensor:
    return F.conv2d(x, p["weight"], p["bias"], stride=stride, padding=dilation, dilation=dilation)


def _rebnconv(p: Params, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """Conv (BatchNorm folded in) + ReLU."""
    return F.relu(_conv(p, x, dilation=dilation))


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _upsample_to(x: torch.Tensor, hw) -> torch.Tensor:
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)


def _rsu_forward(p: Params, x: torch.Tensor, kind: str) -> torch.Tensor:
    hxin = _rebnconv(p["rebnconvin"], x)
    if kind == "RSU4F":
        # fully dilated: no pooling, dilations 1, 2, 4, 8 then 4, 2, 1
        hx1 = _rebnconv(p["rebnconv1"], hxin, 1)
        hx2 = _rebnconv(p["rebnconv2"], hx1, 2)
        hx3 = _rebnconv(p["rebnconv3"], hx2, 4)
        hx4 = _rebnconv(p["rebnconv4"], hx3, 8)
        hx3d = _rebnconv(p["rebnconv3d"], torch.cat([hx4, hx3], 1), 4)
        hx2d = _rebnconv(p["rebnconv2d"], torch.cat([hx3d, hx2], 1), 2)
        hx1d = _rebnconv(p["rebnconv1d"], torch.cat([hx2d, hx1], 1), 1)
        return hx1d + hxin
    # the standard RSU: encoder with pools, innermost dilated, decoder with ups
    h = RSU_HEIGHT[kind]
    enc = []
    hx = hxin
    for i in range(1, h):
        hx = _rebnconv(p[f"rebnconv{i}"], hx)
        enc.append(hx)
        if i < h - 1:
            hx = _maxpool2(hx)
    hx = _rebnconv(p[f"rebnconv{h}"], enc[-1], dilation=2)
    for i in range(h - 1, 0, -1):
        hx = _rebnconv(p[f"rebnconv{i}d"], torch.cat([hx, enc[i - 1]], 1))
        if i > 1:
            hx = _upsample_to(hx, enc[i - 2].shape[2:])
    return hx + hxin


def rmbg_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, 3, H, W) normalised -> matte logits (B, 1, H, W) (side1).
    ``params``: ``conv_weights`` of the tree, on x's device."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        in_hw = x.shape[2:]
        hxin = _conv(params["conv_in"], x, stride=2)
        hx1 = _rsu_forward(params["stage1"], hxin, "RSU7")
        hx2 = _rsu_forward(params["stage2"], _maxpool2(hx1), "RSU6")
        hx3 = _rsu_forward(params["stage3"], _maxpool2(hx2), "RSU5")
        hx4 = _rsu_forward(params["stage4"], _maxpool2(hx3), "RSU4")
        hx5 = _rsu_forward(params["stage5"], _maxpool2(hx4), "RSU4F")
        hx6 = _rsu_forward(params["stage6"], _maxpool2(hx5), "RSU4F")
        hx = _rsu_forward(params["stage5d"], torch.cat([_upsample_to(hx6, hx5.shape[2:]), hx5], 1), "RSU4F")
        hx = _rsu_forward(params["stage4d"], torch.cat([_upsample_to(hx, hx4.shape[2:]), hx4], 1), "RSU4")
        hx = _rsu_forward(params["stage3d"], torch.cat([_upsample_to(hx, hx3.shape[2:]), hx3], 1), "RSU5")
        hx = _rsu_forward(params["stage2d"], torch.cat([_upsample_to(hx, hx2.shape[2:]), hx2], 1), "RSU6")
        hx = _rsu_forward(params["stage1d"], torch.cat([_upsample_to(hx, hx1.shape[2:]), hx1], 1), "RSU7")
        return _upsample_to(_conv(params["side1"], hx), in_hw)


class RMBGModel:
    """BriaRMBG matting: (H, W, 3|4) uint8 frames -> (H, W) uint8 alpha."""

    def __init__(self, params: Params, device: torch.device, cfg: RMBGConfig = RMBGConfig(),
                 batch_size: int = 4):
        """``params``: the JAX-layout tree (``convert_rmbg_weights``,
        ``init_rmbg``), turned into OIHW weights on ``device`` here, once."""
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = conv_weights(params, self.device)
        self.batch_size = batch_size

    @classmethod
    def from_pretrained(cls, path: str | Path, device: torch.device, **kw) -> "RMBGModel":
        from actionmesh_tpu_torch.utils.weights import load_safetensors_dir

        return cls(convert_rmbg_weights(load_safetensors_dir(Path(path))), device, **kw)

    @torch.no_grad()
    def predict_mattes(self, frames: list[np.ndarray]) -> list[np.ndarray]:
        """Each frame's 8-bit matte at the model's input size, before the
        resize back: the RGB resized to input_size² (PIL BILINEAR),
        normalised (x / 255 - 0.5), sigmoid(side1), min-max stretched per
        frame, truncated to uint8. Frames go through the model
        ``batch_size`` at a time."""
        size = self.cfg.input_size
        mattes = []
        for b0 in range(0, len(frames), self.batch_size):
            batch = np.stack([pil_resize(f[..., :3], (size, size), "bilinear")
                              for f in frames[b0 : b0 + self.batch_size]])
            x = torch.from_numpy(batch).to(self.device).permute(0, 3, 1, 2).float()
            x = (x / 255.0 - 0.5) / 1.0  # RMBG-1.4 normalisation: mean 0.5, std 1.0
            matte = torch.sigmoid(rmbg_forward(self.params, x))[:, 0]
            lo = matte.amin(dim=(1, 2), keepdim=True)
            hi = matte.amax(dim=(1, 2), keepdim=True)
            matte = (matte - lo) / torch.clamp(hi - lo, min=1e-8)
            mattes += list((matte * 255).to(torch.uint8).cpu().numpy())
        return mattes

    def predict_alphas(self, frames: list[np.ndarray]) -> list[np.ndarray]:
        """(H, W) uint8 alpha of each frame: its matte resized back to the
        frame's size (PIL BILINEAR)."""
        return [
            pil_resize(m, (f.shape[1], f.shape[0]), "bilinear")
            for m, f in zip(self.predict_mattes(frames), frames)
        ]

    def predict_alpha(self, frame: np.ndarray) -> np.ndarray:
        return self.predict_alphas([frame])[0]
