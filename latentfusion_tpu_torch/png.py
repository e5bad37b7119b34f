"""A small PNG codec in zlib and numpy, for ``Observation.save`` and
``load``: 8-bit RGB, 8-bit grey and 16-bit grey, written without
interlacing. ``read_png`` undoes all five row filters (None, Sub, Up,
Average, Paeth), so it reads what imageio and PIL write in those formats,
with or without alpha."""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels: grey, RGB, grey + alpha, RGBA.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
FILTERS = ("none", "sub", "up", "average", "paeth")


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filter_rows(raw: np.ndarray, bpp: int, filter_type: int) -> bytes:
    """Filter (H, stride) uint8 rows, each with ``filter_type``."""
    rows = raw.astype(np.int32)
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    upleft = np.zeros_like(rows)
    upleft[:, bpp:] = up[:, :-bpp]
    if filter_type == 0:
        out = rows
    elif filter_type == 1:
        out = rows - left
    elif filter_type == 2:
        out = rows - up
    elif filter_type == 3:
        out = rows - (left + up) // 2
    elif filter_type == 4:
        out = rows - _paeth(left, up, upleft)
    else:
        raise ValueError(f"unknown PNG filter type {filter_type}")
    out = (out & 0xFF).astype(np.uint8)
    tagged = np.concatenate(
        (np.full((out.shape[0], 1), filter_type, np.uint8), out), axis=1)
    return tagged.tobytes()


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_png(path, image: np.ndarray, filter_type: int = 0) -> None:
    """Write (H, W) uint8 or uint16 grey, or (H, W, 3) uint8 RGB."""
    image = np.asarray(image)
    if image.ndim == 2 and image.dtype in (np.uint8, np.uint16):
        color_type, channels = 0, 1
    elif image.ndim == 3 and image.shape[2] == 3 and image.dtype == np.uint8:
        color_type, channels = 2, 3
    else:
        raise ValueError(f"unsupported image {image.shape} {image.dtype}")
    height, width = image.shape[:2]
    bit_depth = 8 * image.dtype.itemsize
    raw = image.astype(image.dtype.newbyteorder(">")).tobytes()
    rows = np.frombuffer(raw, np.uint8).reshape(height, -1)
    bpp = channels * image.dtype.itemsize
    header = struct.pack(">IIBBBBB", width, height, bit_depth, color_type, 0, 0, 0)
    data = zlib.compress(_filter_rows(rows, bpp, filter_type))
    Path(path).write_bytes(SIGNATURE + _chunk(b"IHDR", header)
                           + _chunk(b"IDAT", data) + _chunk(b"IEND", b""))


def _unfilter_row(kind: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    if kind == 0:
        return row
    if kind == 2:
        return (row.astype(np.uint16) + prior).astype(np.uint8)
    if kind == 1:
        # Each byte adds the one bpp before: a running sum per byte lane.
        lanes = row.reshape(-1, bpp).astype(np.uint64)
        return (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
    if kind not in (3, 4):
        raise ValueError(f"unknown PNG filter type {kind}")
    out = bytearray(row.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if kind == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path) -> np.ndarray:
    """(H, W) grey or (H, W, C) color, uint8 or uint16, of a non-interlaced
    8- or 16-bit PNG."""
    data = Path(path).read_bytes()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, bit_depth, color_type, _, _, interlace = header
    if color_type not in _CHANNELS or bit_depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: unsupported PNG (color type {color_type}, "
                         f"bit depth {bit_depth}, interlace {interlace})")
    channels = _CHANNELS[color_type]
    bpp = channels * bit_depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:height * (stride + 1)].reshape(height, stride + 1)
    rows = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        prior = rows[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prior, bpp)
    dtype = np.dtype(">u2") if bit_depth == 16 else np.dtype(np.uint8)
    image = np.frombuffer(rows.tobytes(), dtype).astype(dtype.newbyteorder("="))
    image = image.reshape(height, width, channels)
    return image[..., 0] if channels == 1 else image
