"""The port's checkpoint ingestion against ``scripts/ingest_weights.py``.

``detect_family`` agrees with JAX's on every layout of the JAX suite's
test; config.json parsing fails fast the same way; and the npz checkpoints
the port's ingest writes load in the JAX package's ``load_params`` with
every leaf equal to those of JAX's own ingest of the same snapshot.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from actionmesh_tpu.utils.weights import load_params
from actionmesh_tpu_torch import ingest_weights as ting
from actionmesh_tpu_torch.models.denoiser import DenoiserConfig as TDenCfg
from actionmesh_tpu_torch.models.dinov2 import DinoV2Config as TDinoCfg
from actionmesh_tpu_torch.models.dinov2 import init_dinov2
from actionmesh_tpu_torch.utils.tree import named_leaves
from actionmesh_tpu_torch.utils.weights import CONFIG_META_KEYS
from scripts import ingest_weights as jing
from synthetic_checkpoints import reference_state_dict, write_checkpoint
from tests.test_ingest_weights import write_snapshot
from tests.test_torch_checkpoints import leaf_bits, tiny_dino
from tests.test_torch_pipeline import TINY_DINO
from tests.torch_tiny_tree import TINY_TRIPOSG_VAE, tiny_tree  # noqa: F401  (a fixture)

CPU = torch.device("cpu")


def layouts(tmp_path):
    """tests/test_ingest_weights.py's layouts, and the expected family."""
    am = tmp_path / "am"
    (am / "denoiser").mkdir(parents=True)
    tri = tmp_path / "tri"
    (tri / "transformer").mkdir(parents=True)
    (tri / "vae").mkdir()
    dino = tmp_path / "dino"
    dino.mkdir()
    (dino / "config.json").write_text('{"model_type": "dinov2"}')
    dino_keys = tmp_path / "dino_keys"
    dino_keys.mkdir()
    save_file({"encoder.layer.0.norm1.weight": np.ones(4, np.float32)}, str(dino_keys / "model.safetensors"))
    rmbg = tmp_path / "rmbg"
    rmbg.mkdir()
    save_file({"stage1.rebnconvin.conv_s1.weight": np.zeros((1, 1, 3, 3), np.float32)},
              str(rmbg / "model.safetensors"))
    return {am: "actionmesh", tri: "triposg", dino: "dinov2", dino_keys: "dinov2", rmbg: "rmbg"}


def test_detect_family_agrees_with_jax(tmp_path):
    for path, family in layouts(tmp_path).items():
        assert ting.detect_family(path) == jing.detect_family(path) == family
    empty = tmp_path / "empty"
    empty.mkdir()
    for detect in (ting.detect_family, jing.detect_family):
        with pytest.raises(ValueError, match="Cannot detect"):
            detect(empty)


def test_config_parsing_fails_fast():
    with pytest.raises(ValueError, match="mystery_knob"):
        ting.build_config({"width": 64, "mystery_knob": 1}, TDenCfg, "d")
    cfg = ting.build_config({"width": 64, "_class_name": "X", "clear_autocast": True,
                             "inflated_layers": [0, 1]}, TDenCfg, "d")
    assert cfg.width == 64 and cfg.inflated_layers == (0, 1)
    # one metadata set for every family: the JAX ingest's and JAX TripoSG's
    # ("use_cache") together
    assert CONFIG_META_KEYS == jing._META_KEYS | {"use_cache"}


@pytest.fixture
def no_jax_golden(monkeypatch):
    """JAX's ingest without its golden forwards (some 8 s of CPU compile a
    dtype): these tests compare the npz files, which the forwards do not
    touch, and each package's golden statistics are its own."""
    import actionmesh_tpu.models.autoencoder as jae
    import actionmesh_tpu.models.denoiser as jden
    import actionmesh_tpu.models.dinov2 as jdino

    for module, name in ((jden, "denoiser_forward"), (jae, "autoencoder_forward"), (jdino, "dinov2_forward")):
        monkeypatch.setattr(module, name, lambda *a, **k: np.zeros(1, np.float32))


def npz_leaves(path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_actionmesh_ingest_npz_equals_jax(tmp_path, dtype_name, no_jax_golden):
    """The same snapshot (fp16 storage, the release's metadata keys)
    ingested by both: the npz files hold the same keys and bits, and JAX's
    ``load_params`` reads the port's."""
    src, dcfg, _ = write_snapshot(tmp_path / "snap", storage_dtype=np.float16)
    jrec = jing.ingest(src, tmp_path / "jax", dtype_name=dtype_name)
    trec = ting.ingest(src, tmp_path / "port", dtype_name=dtype_name, device=CPU)
    assert trec["family"] == "actionmesh" and sorted(trec["written"]) == sorted(jrec["written"])
    assert trec["configs"] == jrec["configs"]
    for name in trec["written"]:
        t, j = npz_leaves(tmp_path / "port" / name), npz_leaves(tmp_path / "jax" / name)
        assert t.keys() == j.keys()
        for k in j:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        loaded = load_params(tmp_path / "port" / name)
        ref = load_params(tmp_path / "jax" / name)
        for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(ref)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(leaf_bits(a)[0], leaf_bits(b)[0])
    assert len(load_params(tmp_path / "port" / "denoiser.npz")["blocks"]) == dcfg.num_layers
    prov = json.loads((tmp_path / "port" / "PROVENANCE.json").read_text())
    assert prov["golden"] == trec["golden"] and prov["device"] == "cpu"
    for g in trec["golden"]:
        assert np.isfinite(g["mean"]) and g["std"] > 0
    # re-ingesting reproduces the port's golden statistics
    again = ting.ingest(src, tmp_path / "port2", dtype_name=dtype_name, device=CPU)
    assert [g["sha256_f32"] for g in again["golden"]] == [g["sha256_f32"] for g in trec["golden"]]


def test_dinov2_ingest_npz_equals_jax(tmp_path, no_jax_golden):
    """HWIO patch kernel and all: the npz equals JAX's ingest of the same
    snapshot."""
    src = tmp_path / "dinov2"
    params = init_dinov2(torch.Generator().manual_seed(2), TDinoCfg(**TINY_DINO))
    write_checkpoint(src, reference_state_dict("dinov2", params),
                     config={"model_type": "dinov2", "architectures": ["Dinov2Model"], "hidden_size": 32,
                             "num_hidden_layers": 2, "num_attention_heads": 2, "patch_size": 14,
                             "image_size": 70, "mlp_ratio": 4, "layer_norm_eps": 1e-6})
    jing.ingest(src, tmp_path / "jax", dtype_name="bfloat16")
    trec = ting.ingest(src, tmp_path / "port", dtype_name="bfloat16", device=CPU)
    assert trec["configs"]["dinov2"]["hidden_size"] == 32
    t, j = npz_leaves(tmp_path / "port" / "dinov2.npz"), npz_leaves(tmp_path / "jax" / "dinov2.npz")
    assert t.keys() == j.keys() and "patch_embed.kernel::bf16" in t
    for k in j:
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert t["patch_embed.kernel::bf16"].shape == (14, 14, 3, 32)
    (src / "config.json").write_text('{"model_type": "dinov2", "mystery_knob": 1}')
    with pytest.raises(ValueError, match="mystery_knob"):
        ting.ingest(src, tmp_path / "bad", device=CPU)


def test_triposg_and_rmbg_ingest(tmp_path, tiny_tree):
    """The TripoSG and RMBG families of the tiny tree: their npz files hold
    the converted trees (JAX layout), and a wrong config.json raises."""
    from actionmesh_tpu_torch.models.rmbg import convert_rmbg_weights
    from actionmesh_tpu_torch.models.triposg.pipeline import TripoSGPipeline
    from actionmesh_tpu_torch.utils.weights import load_npz, load_safetensors_dir

    root, _ = tiny_tree
    rec = ting.ingest(root / "TripoSG", tmp_path / "tri", dtype_name="float32", device=CPU)
    assert rec["family"] == "triposg" and rec["configs"]["vae"]["decoder_width"] == 32
    with pytest.MonkeyPatch.context() as mp:
        tiny_dino(mp)
        pipe = TripoSGPipeline.from_pretrained(root / "TripoSG", dtype=torch.float32, device=CPU)
    for name, params in (("triposg_dit.npz", pipe.dit_params), ("triposg_vae.npz", pipe.vae_params)):
        loaded = dict(named_leaves(load_npz(tmp_path / "tri" / name)))
        for k, v in named_leaves(params):
            assert torch.equal(loaded[k], v), k
    rec = ting.ingest(root / "RMBG", tmp_path / "rmbg", device=CPU)
    assert rec["family"] == "rmbg" and rec["golden"][0]["shape"] == [64, 64]
    tree = convert_rmbg_weights(load_safetensors_dir(root / "RMBG"))
    npz = npz_leaves(tmp_path / "rmbg" / "rmbg.npz")
    assert npz.keys() == {k for k, _ in named_leaves(tree)}
    for k, v in named_leaves(tree):
        np.testing.assert_array_equal(npz[k], v.numpy())
    bad = tmp_path / "TripoSG"  # a copy: the shared tree stays as written
    shutil.copytree(root / "TripoSG", bad)
    (bad / "vae" / "config.json").write_text(json.dumps(dict(TINY_TRIPOSG_VAE, mystery_knob=2)))
    with pytest.raises(ValueError, match="mystery_knob"):
        ting.ingest(bad, tmp_path / "tri2", device=CPU)


def test_ingest_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ting.main([str(tmp_path), "--out", str(tmp_path / "out")])
