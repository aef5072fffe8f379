"""safetensors files, read and written without the ``safetensors`` package.

The format: an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{...}}``), then the data, offsets counted from its start. ``load_file``
memory-maps the file copy-on-write, so each tensor is a view of the mapped
pages and a multi-GB shard is not held twice; ``load_dir`` reads every
shard of a directory (through ``model.safetensors.index.json`` when there
is one, as the JAX package's ``load_safetensors_dir`` does) and checks that
every floating tensor, bf16 included, is finite. ``save_file`` writes the
format (the chip smoke run's synthetic checkpoints; the card's host has no
``safetensors`` package).
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Optional

import torch

DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {dtype: name for name, dtype in DTYPES.items()}
INDEX_NAME = "model.safetensors.index.json"


def _header(path: Path) -> tuple[dict, int]:
    with open(path, "rb") as f:
        raw = f.read(8)
        if len(raw) != 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than its 8-byte header length)")
        (n,) = struct.unpack("<Q", raw)
        header = json.loads(f.read(n))
    return header, 8 + n


def load_file(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of one .safetensors file, as CPU tensors over a
    copy-on-write memory map (writing to one never reaches the file)."""
    path = Path(path)
    header, data_start = _header(path)
    header.pop("__metadata__", None)
    size = path.stat().st_size
    out: dict[str, torch.Tensor] = {}
    mapped = None
    if size > data_start:
        with open(path, "rb") as f:
            mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    for name, info in header.items():
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, which is not read")
        dtype = DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = 1
        for d in shape:
            count *= d
        if end - begin != count * itemsize or data_start + end > size:
            raise ValueError(
                f"{path}: tensor {name} {info['dtype']}{list(shape)} has data offsets "
                f"[{begin}, {end}] for {count * itemsize} bytes in a {size}-byte file"
            )
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        offset = data_start + begin
        if offset % itemsize:  # an unaligned tensor is copied out of the map
            buf = bytearray(mapped[offset : offset + count * itemsize])
            out[name] = torch.frombuffer(buf, dtype=dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(mapped, dtype=dtype, count=count, offset=offset).reshape(shape)
    return out


def shard_files(path: Path) -> list[Path]:
    """The .safetensors files of a checkpoint directory: those its index
    names, else every one in it, sorted."""
    index = path / INDEX_NAME
    if index.exists():
        names = sorted(set(json.loads(index.read_text())["weight_map"].values()))
        return [path / name for name in names]
    return sorted(path.glob("*.safetensors"))


def check_finite_state(state: dict[str, torch.Tensor], source: str = "<state dict>") -> None:
    """Raise naming every floating tensor (bf16 and fp16 included) that
    holds an inf or a nan."""
    bad = []
    for name, t in state.items():
        if not t.is_floating_point() or t.numel() == 0:
            continue
        n = int(t.numel() - torch.isfinite(t).sum())
        if n:
            bad.append(f"{name}: {n}/{t.numel()} non-finite ({t.dtype}, shape {tuple(t.shape)})")
    if bad:
        raise ValueError(
            f"{source}: checkpoint contains non-finite values in {len(bad)} tensor(s):\n  "
            + "\n  ".join(bad[:20])
            + (f"\n  ... {len(bad) - 20} more" if len(bad) > 20 else "")
        )


def load_dir(path: str | Path) -> dict[str, torch.Tensor]:
    """All tensors of a checkpoint: one .safetensors file, or a directory of
    shards (listed by ``model.safetensors.index.json`` if present), every
    floating one checked to be finite."""
    path = Path(path)
    files = [path] if path.is_file() else shard_files(path) if path.is_dir() else []
    if not files:
        raise FileNotFoundError(f"No safetensors files under {path}")
    state: dict[str, torch.Tensor] = {}
    for f in files:
        state.update(load_file(f))
    check_finite_state(state, str(path))
    return state


def save_file(
    tensors: dict[str, torch.Tensor], path: str | Path, metadata: Optional[dict[str, str]] = None
) -> None:
    """Write ``tensors`` (any device; stored contiguous, in name order) as
    one .safetensors file."""
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    offset = 0
    for name in sorted(tensors):
        t = tensors[name]
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in sorted(tensors):
            t = tensors[name].detach().contiguous().cpu()
            if t.numel():
                f.write(t.reshape(-1).view(torch.uint8).numpy().data)


def save_sharded(
    tensors: dict[str, torch.Tensor], directory: str | Path, max_shard_bytes: int
) -> list[str]:
    """Write ``tensors`` as shards of at most ``max_shard_bytes`` (a larger
    tensor gets a shard of its own) plus ``model.safetensors.index.json``,
    the layout of a sharded Hugging Face checkpoint. Returns the shard names."""
    directory = Path(directory)
    groups: list[list[str]] = [[]]
    size = 0
    for name in sorted(tensors):
        nbytes = tensors[name].numel() * tensors[name].element_size()
        if groups[-1] and size + nbytes > max_shard_bytes:
            groups.append([])
            size = 0
        groups[-1].append(name)
        size += nbytes
    files = [f"model-{i + 1:05d}-of-{len(groups):05d}.safetensors" for i in range(len(groups))]
    weight_map = {}
    for file, names in zip(files, groups):
        save_file({n: tensors[n] for n in names}, directory / file)
        weight_map.update({n: file for n in names})
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    (directory / INDEX_NAME).write_text(
        json.dumps({"metadata": {"total_size": total}, "weight_map": weight_map}, indent=1)
    )
    return files
