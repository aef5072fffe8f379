"""One command from a downloaded checkpoint to a verified npz checkpoint.

    python -m actionmesh_tpu_torch.ingest_weights SNAPSHOT --out DIR \
        [--family auto|actionmesh|triposg|dinov2|rmbg] [--dtype bfloat16|float32] \
        [--device cuda|cpu]

Counterpart of ``scripts/ingest_weights.py``. For a Hugging Face snapshot
directory it detects the family (ActionMesh Stage I/II, TripoSG, DINOv2,
RMBG), maps config.json to the architecture failing on any key it does not
know, converts and shape-verifies the weights (``utils/weights.py``), runs
one deterministic forward on ``--device`` (cuda by default; it raises
without a card) and records its output statistics, and writes the npz
checkpoint(s) with ``utils/weights.save_npz`` (which the JAX package's
``load_params`` reads, leaf for leaf as its own ingest writes them) plus
``PROVENANCE.json``. Re-ingesting the same snapshot on the same device
reproduces the same statistics; they are the port's own, not the JAX
package's.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from actionmesh_tpu_torch.utils.weights import check_config_keys, read_config

logger = logging.getLogger(__name__)

# Hugging Face Dinov2Config keys -> DinoV2Config fields (None: fixed by the architecture)
DINOV2_KEYS = {
    "hidden_size": "hidden_size", "num_hidden_layers": "num_layers",
    "num_attention_heads": "num_heads", "patch_size": "patch_size", "image_size": "image_size",
    **{k: None for k in (
        "layerscale_value", "mlp_ratio", "hidden_act", "qkv_bias", "initializer_range",
        "layer_norm_eps", "drop_path_rate", "attention_probs_dropout_prob",
        "hidden_dropout_prob", "use_swiglu_ffn", "apply_layernorm", "reshape_hidden_states",
        "out_features", "out_indices", "stage_names", "use_mask_token", "num_channels",
        "id2label", "label2id",
    )},
}


def build_config(raw: dict, cfg_cls, family: str):
    """config.json -> ``cfg_cls``; a key that is neither a field nor
    metadata raises."""
    fields = {f.name for f in dataclasses.fields(cfg_cls)}
    check_config_keys(raw, fields, family)
    kwargs = {k: v for k, v in raw.items() if k in fields}
    if "inflated_layers" in kwargs:
        kwargs["inflated_layers"] = tuple(kwargs["inflated_layers"])
    return cfg_cls(**kwargs)


def detect_family(path: Path) -> str:
    """Classify a snapshot directory by its layout and weight names."""
    from actionmesh_tpu_torch.utils import safetensors

    if (path / "denoiser").is_dir() or (path / "autoencoder").is_dir():
        return "actionmesh"
    if (path / "transformer").is_dir() and (path / "vae").is_dir():
        return "triposg"
    raw = read_config(path)
    if raw.get("model_type") == "dinov2" or "Dinov2Model" in str(raw.get("architectures", "")):
        return "dinov2"
    keys = set()
    for f in safetensors.shard_files(path) if path.is_dir() else []:
        keys |= set(safetensors.load_file(f))
    if any(k.startswith(("stage1.rebnconv", "side1")) for k in keys):
        return "rmbg"
    if any(k.startswith("encoder.layer.") for k in keys):
        return "dinov2"
    raise ValueError(
        f"Cannot detect checkpoint family under {path}: expected an ActionMesh (denoiser/ + "
        "autoencoder/), TripoSG (transformer/ + vae/), DINOv2, or RMBG snapshot layout."
    )


def stats(name: str, t) -> dict:
    """Statistics of a forward's output: shape, mean, std, the first 8
    values and a short sha256 of its fp32 bytes."""
    a = (t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)).astype(np.float32)
    return {
        "probe": name,
        "shape": list(a.shape),
        "mean": float(a.mean()),
        "std": float(a.std()),
        "first8": [float(x) for x in a.reshape(-1)[:8]],
        "sha256_f32": hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16],
    }


# -- the families: each returns (files written, golden records, configs) -----


def ingest_actionmesh(src: Path, out: Path, dtype: torch.dtype, device: torch.device):
    from actionmesh_tpu_torch.models.autoencoder import AutoencoderConfig, autoencoder_forward
    from actionmesh_tpu_torch.models.denoiser import DenoiserConfig, denoiser_forward
    from actionmesh_tpu_torch.utils import weights as w

    files, golden, configs = [], [], {}
    if (src / "denoiser").is_dir():
        cfg = build_config(read_config(src / "denoiser"), DenoiserConfig, "denoiser")
        configs["denoiser"] = dataclasses.asdict(cfg)
        tree = w.convert_denoiser(w.load_safetensors_dir(src / "denoiser"), cfg, dtype)
        rng = np.random.default_rng(0)
        T = 2
        x = torch.tensor(rng.standard_normal((1, T, cfg.num_tokens_nominal, cfg.in_channels)), dtype=dtype)
        ctx = torch.tensor(rng.standard_normal((1, T, 16, cfg.cross_attention_dim)), dtype=dtype)
        v = denoiser_forward(
            w.params_from_jax(tree, device), cfg, x.to(device), ctx.to(device),
            torch.arange(T, dtype=torch.float32, device=device)[None],
            torch.full((1,), 500.0, device=device),
        )
        golden.append(stats("denoiser_fwd_seed0_T2", v))
        w.save_npz(tree, out / "denoiser.npz")
        files.append("denoiser.npz")
    if (src / "autoencoder").is_dir():
        cfg = build_config(read_config(src / "autoencoder"), AutoencoderConfig, "autoencoder")
        configs["autoencoder"] = dataclasses.asdict(cfg)
        tree = w.convert_autoencoder(w.load_safetensors_dir(src / "autoencoder"), cfg, dtype)
        rng = np.random.default_rng(1)
        T, N, V = 2, 32, 64
        lat = torch.tensor(rng.standard_normal((1, T, N, cfg.latent_channels)), dtype=dtype)
        q = torch.tensor(
            rng.uniform(-0.9, 0.9, (1, V, cfg.in_channels + cfg.in_extra_channels)), dtype=torch.float32
        )
        pred = autoencoder_forward(
            w.params_from_jax(tree, device), cfg, lat.to(device),
            torch.arange(T, dtype=torch.float32, device=device)[None],
            torch.zeros((1,), device=device), torch.ones((1, 1), device=device), q.to(device),
            compute_dtype=dtype,
        )
        golden.append(stats("autoencoder_fwd_seed1_T2_V64", pred))
        w.save_npz(tree, out / "autoencoder.npz")
        files.append("autoencoder.npz")
    if not files:
        raise FileNotFoundError(f"{src}: no denoiser/ or autoencoder/ subdir")
    return files, golden, configs


def ingest_triposg(src: Path, out: Path, dtype: torch.dtype, device: torch.device):
    from actionmesh_tpu_torch.models.triposg.dit import triposg_dit_forward
    from actionmesh_tpu_torch.models.triposg.pipeline import TripoSGPipeline, triposg_configs
    from actionmesh_tpu_torch.utils import weights as w

    # both config.json files parsed failing fast, as from_pretrained parses
    # them; both subfolders converted and shape-verified (no DINOv2 needed)
    dit_cfg, vae_cfg = triposg_configs(src)
    dit_tree = w.convert_triposg_dit(w.load_safetensors_dir(src / "transformer"), dit_cfg, dtype)
    vae_tree = w.convert_triposg_vae(w.load_safetensors_dir(src / "vae"), vae_cfg, dtype)
    w.save_npz(dit_tree, out / "triposg_dit.npz")
    w.save_npz(vae_tree, out / "triposg_vae.npz")
    pipe = TripoSGPipeline(w.params_from_jax(dit_tree, device), w.params_from_jax(vae_tree, device), None,
                           dit_cfg=dit_cfg, vae_cfg=vae_cfg, dtype=dtype, device=device)
    rng = np.random.default_rng(2)
    # golden 1: the VAE encode (posterior mean) of a unit-sphere surface
    n = min(4 * vae_cfg.num_tokens, 4096)
    pts = rng.standard_normal((n, 3))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    surface = np.concatenate([0.8 * pts, pts], axis=1).astype(np.float32)[None]
    golden = [stats("vae_encode_sphere_mean", pipe.encode_to_latent(surface, seed=None))]
    # golden 2: one DiT velocity on seeded noise and zero context
    x = torch.tensor(rng.standard_normal((1, vae_cfg.num_tokens, vae_cfg.latent_channels)), dtype=dtype)
    ctx = torch.zeros((1, 16, dit_cfg.cross_attention_dim), dtype=dtype, device=device)
    v = triposg_dit_forward(pipe.dit_params, dit_cfg, x.to(device), ctx, torch.full((1,), 500.0, device=device))
    golden.append(stats("dit_fwd_seed2_t500", v))
    configs = {"dit": dataclasses.asdict(dit_cfg), "vae": dataclasses.asdict(vae_cfg)}
    return ["triposg_dit.npz", "triposg_vae.npz"], golden, configs


def ingest_dinov2(src: Path, out: Path, dtype: torch.dtype, device: torch.device):
    from actionmesh_tpu_torch.models.dinov2 import DinoV2Config, dinov2_forward
    from actionmesh_tpu_torch.utils import weights as w

    raw = read_config(src)
    check_config_keys(raw, DINOV2_KEYS, "dinov2")
    cfg = DinoV2Config(**{ours: raw[theirs] for theirs, ours in DINOV2_KEYS.items()
                          if ours is not None and theirs in raw})
    tree = w.convert_dinov2(w.load_safetensors_dir(src), cfg, dtype)
    w.save_npz(tree, out / "dinov2.npz")
    # golden: a deterministic gradient image
    size = 224
    g = np.linspace(0, 1, size, dtype=np.float32)
    img = np.stack([np.tile(g, (size, 1)), np.tile(g[:, None], (1, size)),
                    np.full((size, size), 0.5, np.float32)], axis=-1)
    feats = dinov2_forward(w.params_from_jax(tree, device), cfg, torch.from_numpy(img)[None].to(device, dtype))
    return ["dinov2.npz"], [stats("dinov2_gradient224", feats)], {"dinov2": dataclasses.asdict(cfg)}


def ingest_rmbg(src: Path, out: Path, dtype: torch.dtype, device: torch.device):
    del dtype  # RMBG converts and folds its BatchNorm in fp32
    from actionmesh_tpu_torch.models.rmbg import RMBGModel, convert_rmbg_weights
    from actionmesh_tpu_torch.utils.weights import load_safetensors_dir, save_npz

    tree = convert_rmbg_weights(load_safetensors_dir(src))
    save_npz(tree, out / "rmbg.npz")
    img = np.random.default_rng(3).integers(0, 255, (64, 64, 3), dtype=np.uint8)
    alpha = RMBGModel(tree, device).predict_alpha(img)
    return ["rmbg.npz"], [stats("rmbg_alpha_seed3_64px", alpha)], {}


INGESTORS = {
    "actionmesh": ingest_actionmesh,
    "triposg": ingest_triposg,
    "dinov2": ingest_dinov2,
    "rmbg": ingest_rmbg,
}


def ingest(
    src: str | Path, out: str | Path, family: str = "auto", dtype_name: str = "bfloat16",
    device: torch.device = torch.device("cuda"),
) -> dict:
    """Ingest one snapshot into ``out``; returns the provenance record."""
    src, out = Path(src), Path(out)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: CUDA is not available (use --device cpu)")
    if family == "auto":
        family = detect_family(src)
    logger.info("family: %s  (%s -> %s)", family, src, out)
    out.mkdir(parents=True, exist_ok=True)
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    t0 = time.time()
    with torch.no_grad():
        files, golden, configs = INGESTORS[family](src, out, dtype, device)
    record = {
        "family": family,
        "source": str(src),
        "source_files": sorted(
            {str(p.relative_to(src)): p.stat().st_size for p in src.rglob("*") if p.is_file()}.items()
        ),
        "dtype": dtype_name,
        "device": str(device),
        "written": files,
        "configs": configs,
        "golden": golden,
        "ingest_seconds": round(time.time() - t0, 1),
    }
    (out / "PROVENANCE.json").write_text(json.dumps(record, indent=2))
    logger.info(
        "wrote %s + PROVENANCE.json in %.1fs; golden: %s", files, record["ingest_seconds"],
        [(g["probe"], g["sha256_f32"]) for g in golden],
    )
    return record


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("snapshot", type=str, help="Hugging Face snapshot directory")
    ap.add_argument("--out", type=str, default=None, help="output dir (default: <snapshot>_native)")
    ap.add_argument("--family", type=str, default="auto", choices=["auto", *INGESTORS])
    ap.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (the default; raises without a card) or cpu.")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    out = args.out or (args.snapshot.rstrip("/") + "_native")
    return ingest(Path(args.snapshot), Path(out), args.family, args.dtype, torch.device(args.device))


if __name__ == "__main__":
    main()
