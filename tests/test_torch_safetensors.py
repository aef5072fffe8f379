"""The port's safetensors reader and writer against the ``safetensors`` package.

Files are written here by ``safetensors.numpy`` / ``safetensors.torch`` (and
by the port's writer) and read by both; every tensor must come back bit for
bit, with its dtype and shape. Non-finite leaves are refused, bf16 included.
"""

import json

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file
from safetensors.numpy import save_file as np_save_file
from safetensors.torch import load_file as torch_load_file
from safetensors.torch import save_file as torch_save_file

from actionmesh_tpu_torch.utils import safetensors as st
from actionmesh_tpu_torch.utils.weights import load_safetensors_dir


def numpy_tensors(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "f32": rng.standard_normal((3, 5)).astype(np.float32),
        "f16": rng.standard_normal((7,)).astype(np.float16),
        "f64": rng.standard_normal((2, 2)),
        "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
        "i32": np.arange(-3, 3, dtype=np.int32),
        "u8": np.arange(9, dtype=np.uint8).reshape(3, 3),
        "bool": np.array([True, False, True]),
        "empty": np.zeros((0, 4), np.float32),
        "scalar": np.array(2.5, np.float32),
    }


@pytest.mark.parametrize("name", list(numpy_tensors()))
def test_reader_matches_safetensors_numpy(tmp_path, name):
    arrays = numpy_tensors()
    np_save_file(arrays, str(tmp_path / "m.safetensors"))
    ref = np_load_file(str(tmp_path / "m.safetensors"))
    out = st.load_file(tmp_path / "m.safetensors")
    assert set(out) == set(ref)
    got = out[name].numpy()
    assert got.dtype == ref[name].dtype and got.shape == ref[name].shape
    np.testing.assert_array_equal(got, ref[name])


def test_bf16_matches_safetensors_torch(tmp_path):
    tensors = {"w": torch.randn(33, 17, generator=torch.Generator().manual_seed(1)).bfloat16(),
               "b": torch.tensor([1.0, -2.5, 3e38]).bfloat16()}
    torch_save_file(tensors, str(tmp_path / "m.safetensors"))
    ref = torch_load_file(str(tmp_path / "m.safetensors"))
    out = st.load_file(tmp_path / "m.safetensors")
    for k in tensors:
        assert out[k].dtype == torch.bfloat16
        assert torch.equal(out[k].view(torch.int16), ref[k].view(torch.int16))


def test_writer_is_read_by_safetensors(tmp_path):
    arrays = numpy_tensors(2)
    tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
    tensors["bf16"] = torch.linspace(-3, 3, 11).bfloat16()
    st.save_file(tensors, tmp_path / "m.safetensors", {"format": "pt"})
    ref = torch_load_file(str(tmp_path / "m.safetensors"))
    assert set(ref) == set(tensors)
    for k, t in tensors.items():
        assert ref[k].dtype == t.dtype and ref[k].shape == t.shape
        assert torch.equal(ref[k].reshape(-1).view(torch.uint8), t.reshape(-1).view(torch.uint8))
    # the data section starts 8-byte aligned, so every tensor maps in place
    n = int.from_bytes((tmp_path / "m.safetensors").read_bytes()[:8], "little")
    assert n % 8 == 0


def test_sharded_directory_through_its_index(tmp_path):
    rng = np.random.default_rng(3)
    tensors = {f"layer.{i}.weight": torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
               for i in range(5)}
    files = st.save_sharded(tensors, tmp_path, max_shard_bytes=3 * 64 * 32 * 4)
    assert files == ["model-00001-of-00002.safetensors", "model-00002-of-00002.safetensors"]
    index = json.loads((tmp_path / st.INDEX_NAME).read_text())
    assert set(index["weight_map"]) == set(tensors)
    # a stray file the index does not name is not read
    np_save_file({"stray": np.zeros(3, np.float32)}, str(tmp_path / "zzz.safetensors"))
    out = load_safetensors_dir(tmp_path)
    assert set(out) == set(tensors)
    for k, t in tensors.items():
        np.testing.assert_array_equal(out[k].numpy(), t.numpy())
        ref = np_load_file(str(tmp_path / index["weight_map"][k]))[k]
        np.testing.assert_array_equal(out[k].numpy(), ref)


def test_unindexed_directory_and_missing_files(tmp_path):
    np_save_file({"a": np.ones(2, np.float32)}, str(tmp_path / "a.safetensors"))
    np_save_file({"b": np.zeros(3, np.float32)}, str(tmp_path / "b.safetensors"))
    assert set(load_safetensors_dir(tmp_path)) == {"a", "b"}
    assert set(load_safetensors_dir(tmp_path / "a.safetensors")) == {"a"}
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="No safetensors"):
        load_safetensors_dir(tmp_path / "empty")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_non_finite_leaf_raises(tmp_path, dtype):
    bad = torch.ones(4, 4, dtype=dtype)
    bad[1, 2] = float("inf")
    bad[3, 0] = float("nan")
    torch_save_file({"good": torch.ones(3, dtype=dtype), "bad": bad}, str(tmp_path / "m.safetensors"))
    with pytest.raises(ValueError, match=r"bad: 2/16 non-finite"):
        load_safetensors_dir(tmp_path)
    assert set(st.load_file(tmp_path / "m.safetensors")) == {"good", "bad"}  # the file itself reads


def test_copy_on_write_map_leaves_the_file(tmp_path):
    path = tmp_path / "m.safetensors"
    torch_save_file({"w": torch.zeros(1024)}, str(path))
    before = path.read_bytes()
    out = st.load_file(path)
    out["w"] += 1.0
    assert path.read_bytes() == before
    assert torch.equal(st.load_file(path)["w"], torch.zeros(1024))
