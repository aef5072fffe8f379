"""The port's eight presets against the JAX package's ``load_config``.

Each preset is written in ``actionmesh_tpu_torch/config.py`` as Python values
composed in the YAML files' ``defaults`` order; here every field the port
keeps must equal the JAX preset's, and the fields it leaves out must be
exactly the TPU runtime knobs.
"""

import dataclasses
from pathlib import Path

import pytest

from actionmesh_tpu.config import load_config as jload_config
from actionmesh_tpu_torch.config import PRESETS, load_config as tload_config

# TPU runtime knobs the port leaves out (clear_autocast: the reference's
# autocast cache, a no-op under XLA and absent from the port)
OMITTED = {
    "temporal_3D_denoiser.clear_autocast",
    "scheduler.steps_per_launch", "compute_dtype", "attn_impl",
}
JAX_PRESETS = (
    "actionmesh", "actionmesh_fast", "actionmesh_lowram", "actionmesh_fast_lowram",
    "actionmesh_distilled", "actionmesh_distilled4", "actionmesh_distilled4_fast",
    "actionmesh_turbo",
)


def flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_the_port_has_every_jax_preset():
    assert set(PRESETS) == set(JAX_PRESETS)


@pytest.mark.parametrize("name", JAX_PRESETS)
def test_preset_matches_jax(name):
    port = flat(dataclasses.asdict(tload_config(name)))
    ref = flat(dataclasses.asdict(jload_config(name)))
    assert set(ref) - set(port) == OMITTED
    assert set(port) <= set(ref)
    assert port == {k: v for k, v in ref.items() if k in port}
    # the suffix is optional, as in JAX
    assert dataclasses.asdict(tload_config(name + ".yaml")) == dataclasses.asdict(tload_config(name))


def test_guidance_free_presets():
    """Turbo's Stage 0 takes the guidance-free path (scale 0) and the
    distilled presets one conditional Stage-I branch with no scales."""
    turbo = tload_config("actionmesh_turbo")
    assert turbo.stage_0.guidance_scale == 0.0 and turbo.stage_0.num_inference_steps == 25
    assert turbo.scheduler.num_inference_steps == 4
    for name in ("actionmesh_distilled", "actionmesh_distilled4", "actionmesh_turbo"):
        cfg = tload_config(name)
        assert cfg.cf_guidance.guidance_at_inference == [[1, 1]]
        assert cfg.cf_guidance.guidance_scales == []


def test_presets_do_not_share_state():
    """Updating one loaded preset leaves the next load untouched."""
    cfg = tload_config("actionmesh_distilled")
    cfg.cf_guidance.guidance_at_inference.append([0, 1])
    assert tload_config("actionmesh_distilled").cf_guidance.guidance_at_inference == [[1, 1]]


def test_unknown_preset_config_dir_and_keys_raise(tmp_path):
    """An unknown preset or key raises; in a config_dir, a key that is
    neither a port field nor a TPU runtime knob raises, as in JAX."""
    with pytest.raises(ValueError, match="Unknown preset"):
        tload_config("actionmesh_nonexistent")
    (tmp_path / "bad.yaml").write_text("defaults:\n  - base\nscheduler:\n  no_such_knob: 1\n")
    (tmp_path / "base.yaml").write_text("scheduler:\n  num_inference_steps: 7\n")
    with pytest.raises(KeyError, match="scheduler.no_such_knob"):
        tload_config("bad", config_dir=tmp_path)
    with pytest.raises(KeyError, match="scheduler.no_such_knob"):
        jload_config("bad", config_dir=tmp_path)
    with pytest.raises(KeyError):
        tload_config("actionmesh_fast", updates={"scheduler.steps_per_launch": 5})


CONFIG_DIR = Path(__file__).resolve().parents[1] / "actionmesh_tpu" / "configs"


@pytest.mark.parametrize("name", JAX_PRESETS)
def test_config_dir_matches_jax(name):
    """``load_config(config_dir=...)`` reads the JAX package's YAML presets
    (yaml imported lazily) into what JAX's ``load_config`` gives, less the
    TPU runtime knobs, and into the port's own preset of that name."""
    port = flat(dataclasses.asdict(tload_config(name, config_dir=CONFIG_DIR)))
    ref = flat(dataclasses.asdict(jload_config(name, config_dir=CONFIG_DIR)))
    assert set(ref) - set(port) == OMITTED
    assert port == {k: v for k, v in ref.items() if k in port}
    assert port == flat(dataclasses.asdict(tload_config(name)))


def test_config_dir_composes_defaults_and_updates(tmp_path):
    """A user preset built on another by ``defaults``, with dotted updates
    on top, equals JAX's reading of it."""
    (tmp_path / "base.yaml").write_text(
        "scheduler:\n  num_inference_steps: 12\n  steps_per_launch: 3\nattn_impl: auto\n")
    (tmp_path / "mine.yaml").write_text(
        "defaults:\n  - base\nstage_0:\n  num_inference_steps: 40\n"
        "cf_guidance:\n  guidance_scales: [3.0]\n")
    upd = {"mesh_process.face_decimation": 1000}
    port = flat(dataclasses.asdict(tload_config("mine.yaml", config_dir=tmp_path, updates=upd)))
    ref = flat(dataclasses.asdict(jload_config("mine", config_dir=tmp_path, updates=upd)))
    assert port == {k: v for k, v in ref.items() if k in port}
    assert port["scheduler.num_inference_steps"] == 12 and port["stage_0.num_inference_steps"] == 40
    assert port["cf_guidance.guidance_scales"] == [3.0] and port["mesh_process.face_decimation"] == 1000
