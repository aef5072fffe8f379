"""PNG reader and writer on zlib and numpy: the port's runtime uses no PIL.

``read_png`` returns (H, W, 4) uint8 RGBA, what PIL's
``Image.open(path).convert("RGBA")`` gives, for non-interlaced files of color
type 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and 6 (RGBA) at bit
depth 8, and 16-bit RGB and RGBA (PIL keeps the high byte of each sample). A
``tRNS`` chunk gives the palette's alpha, or for gray and RGB the one color
that is transparent. Other depths and interlaced files raise. The scanline
filters are undone by a small C++ routine (``csrc/png_unfilter.cpp``, built
with g++ at first use). ``write_png`` writes gray, RGB or RGBA at depth 8
with filter 0 on every row.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}  # channels -> color type, for the writer


def _chunks(raw: bytes, path):
    """(type, data) of each chunk, CRCs checked."""
    if raw[:8] != SIGNATURE:
        raise ValueError(f"Not a PNG file: {path}")
    pos = 8
    while pos + 12 <= len(raw):
        (length,) = struct.unpack_from(">I", raw, pos)
        kind = raw[pos + 4 : pos + 8]
        data = raw[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack_from(">I", raw, pos + 8 + length)
        if zlib.crc32(kind + data) != crc:
            raise ValueError(f"PNG {path}: CRC mismatch in the {kind.decode('latin-1')} chunk")
        yield kind, data
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"PNG {path}: truncated (no IEND chunk)")


def read_png(path: str | Path) -> np.ndarray:
    """The image at ``path`` as (H, W, 4) uint8 RGBA."""
    raw = Path(path).read_bytes()
    header, palette, trns, idat = None, None, None, []
    for kind, data in _chunks(raw, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = data
        elif kind == b"IDAT":
            idat.append(data)
    if header is None:
        raise ValueError(f"PNG {path}: no IHDR chunk")
    width, height, depth, color, compression, filter_method, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"PNG {path}: unknown color type {color}")
    if interlace != 0:
        raise ValueError(f"PNG {path}: interlaced (Adam7) files are not supported")
    if compression != 0 or filter_method != 0:
        raise ValueError(f"PNG {path}: unknown compression or filter method")
    if not (depth == 8 or (depth == 16 and color in (2, 6))):
        raise ValueError(
            f"PNG {path}: bit depth {depth} with color type {color} is not supported "
            "(depth 8, or 16 for RGB and RGBA)"
        )
    from actionmesh_tpu_torch.utils.native import png_unfilter

    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    rows = png_unfilter(
        np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8), height, width * bpp, bpp
    )
    # 16-bit samples are big-endian: keep the high byte, as PIL does
    px = rows.reshape(height, width, channels, depth // 8)[..., 0]
    out = np.empty((height, width, 4), np.uint8)
    if color == 3:
        if palette is None:
            raise ValueError(f"PNG {path}: palette image without a PLTE chunk")
        if px.size and px.max() >= len(palette):
            raise ValueError(f"PNG {path}: palette index beyond the {len(palette)}-entry PLTE")
        alpha = np.full(len(palette), 255, np.uint8)
        if trns is not None:
            entries = np.frombuffer(trns, np.uint8)[: len(palette)]
            alpha[: len(entries)] = entries
        idx = px[..., 0]
        out[..., :3] = palette[idx]
        out[..., 3] = alpha[idx]
        return out
    gray = color in (0, 4)
    out[..., :3] = px[..., :1] if gray else px[..., :3]
    out[..., 3] = px[..., -1] if color in (4, 6) else 255
    if trns is not None and color in (0, 2):
        # one transparent color, as 16-bit samples compared with the pixel as read
        key = np.array(struct.unpack(f">{len(trns) // 2}H", trns), np.int64)
        match = np.all(px.astype(np.int64) == key[: channels], axis=-1)
        out[..., 3][match] = 0
    return out


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(path: str | Path, image: np.ndarray) -> None:
    """Write (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 to ``path``."""
    Path(path).write_bytes(encode_png(image))


def encode_png(image: np.ndarray) -> bytes:
    """(H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA uint8 as PNG bytes."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[..., None]
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] not in _COLOR_TYPES:
        raise ValueError(f"write_png: (H, W[, 3|4]) uint8, got {image.shape} {image.dtype}")
    h, w, c = image.shape
    rows = np.zeros((h, w * c + 1), np.uint8)  # filter type 0 on every row
    rows[:, 1:] = image.reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return (
        SIGNATURE + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b"")
    )
