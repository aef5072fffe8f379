"""Pipeline configuration: the eight presets as Python values.

Mirrors ``actionmesh_tpu/config.py`` with the values of
``actionmesh_tpu/configs/*.yaml`` written in, so the port needs no yaml
reader: the dataclass defaults are the ``actionmesh`` preset, and each other
preset is the preset it builds on (the YAML file's ``defaults``) plus its own
values, applied in the same order. Knobs that exist only for the TPU runtime
(``steps_per_launch``, ``attn_impl``, ``compute_dtype``, ``clear_autocast``)
are left out; ``tests/test_torch_presets.py`` pins every preset against the
JAX ``load_config(name)``. ``load_config(config_dir=...)`` reads a directory
of YAML presets as JAX's does (``defaults`` composed first), with ``yaml``
imported only there; the TPU runtime knobs in such a file are skipped.
"""

from __future__ import annotations

import copy
import dataclasses
from pathlib import Path
from typing import Any, Optional

# preset -> (the preset it builds on, its own values as dotted-path updates)
_PRESET_LAYERS: dict[str, tuple[Optional[str], dict]] = {
    "actionmesh": (None, {}),
    "actionmesh_fast": ("actionmesh", {
        "stage_0.num_inference_steps": 50,
        "scheduler.num_inference_steps": 15,
    }),
    "actionmesh_lowram": ("actionmesh", {"scheduler.split_cfg_batch": True}),
    "actionmesh_fast_lowram": ("actionmesh", {
        "stage_0.num_inference_steps": 50,
        "scheduler.num_inference_steps": 15,
        "scheduler.split_cfg_batch": True,
    }),
    # guidance-distilled, 30 -> 8 Euler steps, one conditional forward a step
    "actionmesh_distilled": ("actionmesh", {
        "scheduler.num_inference_steps": 8,
        "cf_guidance.guidance_at_inference": [[1, 1]],
        "cf_guidance.guidance_scales": [],
    }),
    "actionmesh_distilled4": ("actionmesh_distilled", {"scheduler.num_inference_steps": 4}),
    "actionmesh_distilled4_fast": ("actionmesh_distilled4", {"stage_0.num_inference_steps": 50}),
    # both stages distilled: guidance_scale 0 takes Stage 0's guidance-free path
    "actionmesh_turbo": ("actionmesh_distilled4", {
        "stage_0.num_inference_steps": 25,
        "stage_0.guidance_scale": 0.0,
    }),
}
PRESETS = tuple(_PRESET_LAYERS)


@dataclasses.dataclass
class SchedulerConfig:
    num_inference_steps: int = 30
    num_train_timesteps: int = 1000
    shift: float = 3.0
    is_additive: bool = True
    # run the guidance branches one after the other (low-RAM mode)
    split_cfg_batch: bool = False


@dataclasses.dataclass
class GuidanceConfig:
    inference_enabled: bool = True
    guidance_at_inference: list = dataclasses.field(
        default_factory=lambda: [[0, 1], [1, 1]]
    )
    guidance_scales: list = dataclasses.field(default_factory=lambda: [7.5])


@dataclasses.dataclass
class MeshProcessConfig:
    face_decimation: int = 40000
    floaters_threshold: float = 0.02


@dataclasses.dataclass
class Stage0Config:
    num_inference_steps: int = 100
    guidance_scale: float = 7.5
    # SDF decode knobs (models/triposg/pipeline.py:decode_latents): the
    # preset's two-level coarse pass from a 65^3 sign grid; the JAX
    # package's reduced-precision coarse queries (kept for its configs; not
    # ported, so any value but None raises at the decode)
    prefilter_octree_depth: Optional[int] = 6
    coarse_decode_dtype: Optional[str] = None


@dataclasses.dataclass
class DenoiserModelConfig:
    num_tokens_nominal: int = 2048
    temporal_context_size: int = 16
    num_attention_heads: int = 16
    width: int = 2048
    in_channels: int = 64
    num_layers: int = 21
    cross_attention_dim: int = 1024
    mlp_ratio: float = 4.0
    inflated_layers: list = dataclasses.field(
        default_factory=lambda: list(range(21))
    )
    # tanh GELU, the JAX package's default (actionmesh_tpu/models/denoiser.py)
    gelu_approx: bool = True


@dataclasses.dataclass
class AutoencoderModelConfig:
    temporal_context_size: int = 16
    in_channels: int = 3
    in_extra_channels: int = 3
    out_dim: int = 3
    latent_channels: int = 64
    width: int = 1024
    num_attention_heads: int = 8
    num_layers: int = 16
    embed_frequency: int = 8
    embed_include_pi: bool = False
    prediction_mode: str = "direct"
    gelu_approx: bool = True


@dataclasses.dataclass
class PipelineConfig:
    stage_0: Stage0Config = dataclasses.field(default_factory=Stage0Config)
    mesh_process: MeshProcessConfig = dataclasses.field(
        default_factory=MeshProcessConfig
    )
    temporal_3D_denoiser: DenoiserModelConfig = dataclasses.field(
        default_factory=DenoiserModelConfig
    )
    scheduler: SchedulerConfig = dataclasses.field(default_factory=SchedulerConfig)
    cf_guidance: GuidanceConfig = dataclasses.field(default_factory=GuidanceConfig)
    temporal_3D_vae: AutoencoderModelConfig = dataclasses.field(
        default_factory=AutoencoderModelConfig
    )
    anchor_idx: int = 0
    sliding_window_denoiser: int = 15
    sliding_window_autoencoder: int = 15
    subsampling_level: int = 1
    # Stage II decodes target timesteps in chunks of this many
    decode_target_chunk: int = 5

    @property
    def denoiser_latent_shape(self) -> tuple[int, int]:
        return (
            self.temporal_3D_denoiser.num_tokens_nominal,
            self.temporal_3D_denoiser.in_channels,
        )


def _apply_updates(obj: Any, updates: dict) -> None:
    """Apply {'a.b.c': v} dotted-path updates onto nested dataclasses."""
    for path, value in updates.items():
        parts = path.split(".")
        target = obj
        for p in parts[:-1]:
            target = getattr(target, p)
        if not hasattr(target, parts[-1]):
            raise KeyError(f"Unknown config key: {path}")
        setattr(target, parts[-1], value)


# Keys of the JAX YAML presets that set the TPU runtime only; the port has
# no such knob, so a preset file's values for them are skipped.
TPU_RUNTIME_KEYS = {
    "temporal_3D_denoiser.clear_autocast", "scheduler.steps_per_launch",
    "compute_dtype", "attn_impl",
}


def _merge_dict_into(obj: Any, data: dict, prefix: str = "") -> None:
    """Set a YAML mapping's values onto nested dataclasses; an unknown key
    raises unless it is a TPU runtime knob."""
    for k, v in data.items():
        path = f"{prefix}{k}"
        if path in TPU_RUNTIME_KEYS:
            continue
        if not hasattr(obj, k):
            raise KeyError(f"Unknown config key: {path}")
        current = getattr(obj, k)
        if dataclasses.is_dataclass(current) and isinstance(v, dict):
            _merge_dict_into(current, v, prefix=f"{path}.")
        else:
            setattr(obj, k, v)


def _load_yaml_preset(config_dir: Path, name: str) -> "PipelineConfig":
    """``config_dir/<name>.yaml`` over the dataclass defaults, each file's
    ``defaults`` applied before its own values (JAX ``load_config``)."""
    import yaml

    cfg = PipelineConfig()
    # JAX's field default, which its base preset file sets to 6 (the port's
    # dataclass default is the base preset's value)
    cfg.stage_0.prefilter_octree_depth = None

    def apply_file(preset: str) -> None:
        data = yaml.safe_load((config_dir / f"{preset}.yaml").read_text()) or {}
        for base in data.pop("defaults", []):
            apply_file(base)
        _merge_dict_into(cfg, data)

    apply_file(name)
    return cfg


def load_config(
    config_name: str = "actionmesh",
    config_dir: Optional[str] = None,
    updates: Optional[dict] = None,
) -> PipelineConfig:
    """The named preset (with or without ``.yaml``) plus dotted-path
    overrides: one of ``PRESETS``, or ``config_dir/<name>.yaml`` when
    ``config_dir`` is given."""
    name = config_name.removesuffix(".yaml")
    if config_dir is not None:
        cfg = _load_yaml_preset(Path(config_dir), name)
        if updates:
            _apply_updates(cfg, updates)
        return cfg
    if name not in _PRESET_LAYERS:
        raise ValueError(f"Unknown preset {config_name!r}; the port has {PRESETS}")
    chain = []
    while name is not None:
        base, values = _PRESET_LAYERS[name]
        chain.append(values)
        name = base
    cfg = PipelineConfig()
    for values in reversed(chain):
        _apply_updates(cfg, copy.deepcopy(values))
    if updates:
        _apply_updates(cfg, updates)
    return cfg
