"""A baseline JPEG decoder for the host data path, beside ``png.py``: the
texture and background banks of the training recipe are JPEGs.

``csrc/jpeg.cpp`` (Huffman-coded sequential DCT, 8-bit, 1 or 3 components,
any integral sampling factors, restart markers) is compiled with g++ at first
use into ``_build/libjpeg-<hash>.so``, the hash covering the source and the
flags, and bound with ctypes. It gives libjpeg's default output bit for bit
(the accurate integer IDCT, fancy chroma upsampling, the fixed-point YCbCr to
RGB conversion), which is what imageio and Pillow return. A failed build
raises: there is no fallback.

Progressive, lossless, hierarchical, arithmetic-coded, 12-bit and CMYK files
raise ``NoDecoderError``; a damaged file raises ``ValueError``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "jpeg.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
UNSUPPORTED, CORRUPT = 1, 2

_LIB: Optional[ctypes.CDLL] = None


class NoDecoderError(ValueError):
    """An image in a format this package cannot decode."""


def build() -> Path:
    """Compile the decoder if its library is missing; raises on failure."""
    from .data import rasterizer

    return rasterizer.build_host_library(SOURCE, "libjpeg", CXX_FLAGS, rasterizer.BUILD_DIR)


def load_library() -> ctypes.CDLL:
    """The ctypes handle of the decoder, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        int_p = ctypes.POINTER(ctypes.c_int)
        lib.lf_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t, int_p, int_p, int_p]
        lib.lf_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p]
        lib.lf_jpeg_info.restype = lib.lf_jpeg_decode.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(code: int, name: str) -> None:
    if code == UNSUPPORTED:
        raise NoDecoderError(f"{name}: not a baseline 8-bit greyscale or YCbCr JPEG "
                             "(progressive, lossless, arithmetic-coded, 12-bit and CMYK "
                             "files are not decoded)")
    if code:
        raise ValueError(f"{name}: damaged JPEG data")


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes as uint8 (H, W) for greyscale or (H, W, 3) RGB."""
    lib = load_library()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(lib.lf_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                            ctypes.byref(c)), name)
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, c.value)
    out = np.empty(shape, np.uint8)
    _check(lib.lf_jpeg_decode(data, len(data), out.ctypes.data), name)
    return out


def read_jpeg(path) -> np.ndarray:
    """The JPEG file ``path`` as uint8 (H, W) or (H, W, 3)."""
    path = Path(path)
    return decode_jpeg(path.read_bytes(), str(path))
