"""Resizing with the conventions of ``latentfusion_tpu/ops/interpolate.py``.

The output size is ``floor(in * scale_factor)`` per axis, so the source
coordinate scale is ``in / out`` exactly as in the JAX version.

- nearest: ``F.interpolate(mode="nearest")``, torch's legacy ``floor``
  index; its backward sums each input's window without atomics.
- linear, bilinear, trilinear (``align_corners=False``): one product per
  resized axis with a fixed (out, in) weight matrix, the JAX version's form.
  The last axis is ``x @ W.T``; an earlier axis is ``W @ x`` on a view that
  folds the axes after it into one, so no axes move. The backward is two
  more products, so the result is the same bits run to run on the GPU
  (``F.interpolate``'s bilinear backward adds with atomics).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_MODES = ("nearest", "linear", "bilinear", "trilinear")
_WEIGHTS: dict = {}


def _linear_weight_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) interpolation matrix, torch align_corners=False,
    upper tap clamped to the edge."""
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), dtype=np.float32)
    for i in range(out_size):
        src = max((i + 0.5) * scale - 0.5, 0.0)
        i0 = min(int(np.floor(src)), in_size - 1)
        i1 = min(i0 + 1, in_size - 1)
        lam = src - i0
        w[i, i0] += 1.0 - lam
        w[i, i1] += lam
    return w


def _linear_weights(in_size: int, out_size: int, device, dtype) -> torch.Tensor:
    """The (out, in) weight matrix on ``device`` in ``dtype``, cached."""
    key = (in_size, out_size, torch.device(device), dtype)
    w = _WEIGHTS.get(key)
    if w is None:
        w = torch.from_numpy(_linear_weight_matrix(in_size, out_size)).to(
            device=device, dtype=dtype)
        _WEIGHTS[key] = w
    return w


def _resize_linear(x: torch.Tensor, size) -> torch.Tensor:
    for axis, out_size in enumerate(size, start=2):
        in_size = x.shape[axis]
        if in_size == out_size:
            continue
        w = _linear_weights(in_size, out_size, x.device, x.dtype)
        if axis == x.dim() - 1:
            x = x @ w.T
        else:
            shape = x.shape
            x = (w @ x.reshape(*shape[:axis + 1], -1)).reshape(
                *shape[:axis], out_size, *shape[axis + 1:])
    return x


def interpolate(x: torch.Tensor, scale_factor=None, size=None,
                mode: str = "nearest") -> torch.Tensor:
    """Resize an (N, C, *spatial) tensor."""
    if mode not in _MODES:
        raise ValueError(f"Unsupported mode {mode!r}")
    spatial = x.shape[2:]
    if size is None:
        if scale_factor is None:
            raise ValueError("one of size or scale_factor required")
        size = tuple(int(math.floor(s * scale_factor)) for s in spatial)
    elif isinstance(size, int):
        size = (size,) * len(spatial)
    if tuple(size) == tuple(spatial):
        return x
    if mode == "nearest":
        return F.interpolate(x, size=size, mode="nearest")
    return _resize_linear(x, tuple(size))
