"""Resizing with the conventions of ``latentfusion_tpu/ops/interpolate.py``.

The output size is ``floor(in * scale_factor)`` per axis and is handed to
``F.interpolate`` as a size, so the source coordinate scale is ``in / out``
exactly as in the JAX version: legacy ``floor`` nearest, and
``align_corners=False`` for (bi/tri)linear.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_MODES = ("nearest", "linear", "bilinear", "trilinear")


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
    linear = {1: "linear", 2: "bilinear", 3: "trilinear"}[len(spatial)]
    return F.interpolate(x, size=size, mode=linear, align_corners=False)
