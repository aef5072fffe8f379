"""The port's PNG reader and writer against PIL.

``read_png`` must give what ``Image.open(path).convert("RGBA")`` gives, bit
for bit, for every supported color type. PIL chooses the scanline filters
itself when it writes, so the five filter types are covered by files built
here: each row filtered with its own type, then compressed.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from actionmesh_tpu_torch.io.png import read_png, write_png


def pil_rgba(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGBA"))


def sample_image(h=37, w=53, channels=4, seed=0) -> np.ndarray:
    """Smooth gradients plus noise, so that every filter type has work."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([(3 * x + y), (x * y) % 97, (7 * y), 255 - 2 * x], -1)[..., :channels]
    return ((base + rng.integers(0, 12, base.shape)) % 256).astype(np.uint8)


@pytest.mark.parametrize(
    "mode,channels",
    [("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)],
)
def test_pil_written_modes(tmp_path, mode, channels):
    arr = sample_image(channels=channels)
    Image.fromarray(arr[..., 0] if channels == 1 else arr, mode).save(tmp_path / "a.png")
    got = read_png(tmp_path / "a.png")
    np.testing.assert_array_equal(got, pil_rgba(tmp_path / "a.png"))


@pytest.mark.parametrize("with_trns", [False, True])
def test_palette(tmp_path, with_trns):
    img = Image.fromarray(sample_image(channels=3)).quantize(40)
    kw = {"transparency": bytes(range(0, 200, 7))} if with_trns else {}
    img.save(tmp_path / "p.png", **kw)
    got = read_png(tmp_path / "p.png")
    np.testing.assert_array_equal(got, pil_rgba(tmp_path / "p.png"))
    assert (got[..., 3] < 255).any() == with_trns


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_transparent_color_key(tmp_path, mode):
    """tRNS on gray and RGB: the one keyed color becomes transparent."""
    arr = sample_image(channels=1 if mode == "L" else 3)
    arr = arr[..., 0] if mode == "L" else arr
    key = int(arr[0, 0]) if mode == "L" else tuple(int(v) for v in arr[0, 0])
    Image.fromarray(arr, mode).save(tmp_path / "t.png", transparency=key)
    got = read_png(tmp_path / "t.png")
    np.testing.assert_array_equal(got, pil_rgba(tmp_path / "t.png"))
    assert got[0, 0, 3] == 0


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filtered_png(raw: np.ndarray, color: int, depth: int, bpp: int, types) -> bytes:
    """A PNG of ``raw`` (H, stride) bytes, row y filtered with types[y % 5]
    (PNG specification, section 9), written out by hand."""
    h, stride = raw.shape
    x = raw.astype(np.int64)
    rows = []
    for y in range(h):
        t = types[y % len(types)]
        prev = x[y - 1] if y else np.zeros(stride, np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), x[y, :-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = [0, left, prev, (left + prev) // 2, _paeth(left, prev, up_left)][t]
        rows.append(bytes([t]) + ((x[y] - pred) % 256).astype(np.uint8).tobytes())
    width = stride * 8 // (depth * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color])
    header = struct.pack(">IIBBBBB", width, h, depth, color, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(b"".join(rows))) + _chunk(b"IEND", b""))


@pytest.mark.parametrize("types", [(0,), (1,), (2,), (3,), (4,), (4, 3, 1, 0, 2)])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_every_filter_type(tmp_path, types, channels):
    arr = sample_image(channels=channels)
    color = {1: 0, 3: 2, 4: 6}[channels]
    path = tmp_path / "f.png"
    path.write_bytes(filtered_png(arr.reshape(arr.shape[0], -1), color, 8, channels, types))
    got = read_png(path)
    np.testing.assert_array_equal(got, pil_rgba(path))
    want = np.concatenate([np.repeat(arr, 3, -1) if channels == 1 else arr[..., :3],
                           arr[..., 3:] if channels == 4 else np.full(arr.shape[:2] + (1,), 255, np.uint8)], -1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [3, 4])
def test_16_bit_rgb_and_rgba(tmp_path, channels):
    """16-bit samples: PIL keeps the high byte; all filter types."""
    rng = np.random.default_rng(3)
    arr16 = rng.integers(0, 65536, (23, 31, channels), dtype=np.uint16)
    raw = arr16.astype(">u2").view(np.uint8).reshape(23, -1)
    path = tmp_path / "s.png"
    path.write_bytes(filtered_png(raw, {3: 2, 4: 6}[channels], 16, 2 * channels, (0, 1, 2, 3, 4)))
    got = read_png(path)
    np.testing.assert_array_equal(got, pil_rgba(path))
    np.testing.assert_array_equal(got[..., :channels], (arr16 >> 8).astype(np.uint8))


def test_refused_files(tmp_path):
    arr = sample_image(channels=3)
    good = filtered_png(arr.reshape(arr.shape[0], -1), 2, 8, 3, (1,))
    interlaced = bytearray(good)
    interlaced[28] = 1  # IHDR's interlace byte
    interlaced[29:33] = struct.pack(">I", zlib.crc32(bytes(interlaced[12:29])))
    (tmp_path / "i.png").write_bytes(bytes(interlaced))
    with pytest.raises(ValueError, match="interlaced"):
        read_png(tmp_path / "i.png")
    bad_crc = bytearray(good)
    bad_crc[-20] ^= 0xFF  # inside the IDAT chunk
    (tmp_path / "c.png").write_bytes(bytes(bad_crc))
    with pytest.raises(ValueError, match="CRC"):
        read_png(tmp_path / "c.png")
    Image.fromarray(arr[..., 0]).convert("1").save(tmp_path / "b.png")  # bit depth 1
    with pytest.raises(ValueError, match="bit depth 1"):
        read_png(tmp_path / "b.png")
    (tmp_path / "n.txt").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="Not a PNG"):
        read_png(tmp_path / "n.txt")


def test_unknown_filter_type_raises(tmp_path):
    arr = sample_image(channels=3)
    rows = np.concatenate([np.full((arr.shape[0], 1), 5, np.uint8), arr.reshape(arr.shape[0], -1)], 1)
    header = struct.pack(">IIBBBBB", arr.shape[1], arr.shape[0], 8, 2, 0, 0, 0)
    (tmp_path / "u.png").write_bytes(
        b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="unknown filter type in row 0"):
        read_png(tmp_path / "u.png")


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_writer_round_trips_through_pil(tmp_path, channels):
    arr = sample_image(channels=channels)
    arr = arr[..., 0] if channels == 1 else arr
    write_png(tmp_path / "w.png", arr)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "w.png")), arr)
    np.testing.assert_array_equal(read_png(tmp_path / "w.png"), pil_rgba(tmp_path / "w.png"))
    with pytest.raises(ValueError):
        write_png(tmp_path / "f.png", arr.astype(np.float32))
