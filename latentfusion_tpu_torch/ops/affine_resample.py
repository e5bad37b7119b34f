"""Separable (axis-aligned) 2D resampling as two per-axis interpolation
products (counterpart of ``latentfusion_tpu/ops/affine_resample.py``).

``Camera.zoom`` and ``Camera.uncrop`` sample along per-camera affine grids
that are separable, so each is ``Wy @ image @ Wx^T`` with small per-axis
weight matrices. The semantics are those of ``grid_sample_2d``: corner taps,
zeros or border padding, round-half-even nearest.
"""
from __future__ import annotations

import torch


def axis_weights(src: torch.Tensor, in_size: int, mode: str = "bilinear",
                 padding_mode: str = "zeros") -> torch.Tensor:
    """(N, Out) fractional source coords -> (N, Out, In) weights W with
    ``out[o] = sum_j W[o, j] * in[j]``."""
    if padding_mode == "border":
        src = src.clamp(0.0, in_size - 1)
    j = torch.arange(in_size, dtype=torch.float32, device=src.device)[None, None]
    if mode == "nearest":
        # Out-of-range indices match no column: zeros padding for free.
        return (j == torch.round(src)[..., None]).float()
    x0 = torch.floor(src)
    w1 = (src - x0)[..., None]
    x0 = x0[..., None]
    return (j == x0) * (1.0 - w1) + (j == x0 + 1) * w1


def separable_resample_2d(image: torch.Tensor, src_y: torch.Tensor,
                          src_x: torch.Tensor, mode: str = "bilinear",
                          padding_mode: str = "zeros") -> torch.Tensor:
    """Resample (N, C, H, W) at the outer product of per-axis source coords
    src_y (N, H_out) and src_x (N, W_out), in input pixel units."""
    image = image.float()
    wy = axis_weights(src_y, image.shape[-2], mode, padding_mode)
    wx = axis_weights(src_x, image.shape[-1], mode, padding_mode)
    out = torch.einsum("noh,nchw->ncow", wy, image)
    return torch.einsum("nkw,ncow->ncok", wx, out)


def bbox_source_coords(boxes: torch.Tensor, out_size: int,
                       truncate_corners: bool = True):
    """Per-axis source pixel coords for (N, 4) (xmin, ymin, xmax, ymax)
    boxes. ``truncate_corners`` truncates the corners toward zero, as the
    original TorchScript ``bbox_to_grid`` did when it coerced them to
    integers; trained checkpoints saw those crops. Returns (src_y, src_x),
    each (N, out_size)."""
    if truncate_corners:
        boxes = torch.trunc(boxes)
    k = torch.arange(out_size, dtype=torch.float32, device=boxes.device)[None]
    denom = max(out_size - 1, 1)
    src_x = boxes[:, 0:1] + k * (boxes[:, 2:3] - boxes[:, 0:1]) / denom - 0.5
    src_y = boxes[:, 1:2] + k * (boxes[:, 3:4] - boxes[:, 1:2]) / denom - 0.5
    return src_y, src_x
