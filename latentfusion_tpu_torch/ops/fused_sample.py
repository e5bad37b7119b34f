"""K1 forward: trilinear 3D volume sampler (counterpart of
``latentfusion_tpu/ops/pallas_fused_sample.py:grid_sample_3d_fused``).

``grid_sample_3d_fused`` computes ``F.grid_sample(volume, grid,
mode="bilinear", align_corners=False)`` with zeros or border padding, for a
volume batch NV that divides the grid batch N: sample batch n reads volume
``n // (N // NV)``, so a latent shared by many hypothesis cameras is read in
place and never copied N times.

On a CUDA tensor it launches the kernel of ``csrc/fused_sample.cu`` (see the
note there) or raises; on a CPU tensor it runs ``grid_sample_3d_plain``, the
same function as an explicit 8-corner gather in PyTorch. ``LAUNCHES`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .grid_sample import _unnormalize

LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PADDING = ("zeros", "border")


def _check_args(volume, grid, padding_mode, out_dtype):
    if volume.dim() != 5 or grid.dim() != 5 or grid.shape[-1] != 3:
        raise ValueError(f"expected volume (NV, C, D, H, W) and grid "
                         f"(N, Do, Ho, Wo, 3), got {tuple(volume.shape)} and "
                         f"{tuple(grid.shape)}")
    if grid.shape[0] % volume.shape[0] != 0:
        raise ValueError(f"volume batch {volume.shape[0]} must divide grid "
                         f"batch {grid.shape[0]}")
    if padding_mode not in _PADDING:
        raise ValueError(f"padding_mode must be one of {_PADDING}")
    if volume.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError("volume and output must be float32 or bfloat16")
    if grid.dtype != torch.float32:
        raise TypeError("grid must be float32")
    if volume.device != grid.device:
        raise ValueError("volume and grid must be on one device")


def grid_sample_3d_plain(volume: torch.Tensor, grid: torch.Tensor,
                         padding_mode: str = "zeros",
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's function in plain PyTorch: an explicit 8-corner gather,
    fp32 weights and accumulation, rounded once to ``out_dtype``."""
    _check_args(volume, grid, padding_mode, out_dtype)
    nv, c, d, h, w = volume.shape
    n = grid.shape[0]
    j = d * h * w
    g = grid.reshape(n, -1, 3)
    k = g.shape[1]

    def taps(coord, size):
        x = _unnormalize(coord, size)
        if padding_mode == "border":
            x = x.clamp(0.0, size - 1)
        x0 = torch.floor(x)
        w1 = x - x0
        out = []
        for offset, weight in ((0, 1.0 - w1), (1, w1)):
            i = x0 + offset
            valid = (i >= 0) & (i <= size - 1)
            out.append((i.clamp(0, size - 1).long(), weight * valid))
        return out

    tx, ty, tz = taps(g[..., 0], w), taps(g[..., 1], h), taps(g[..., 2], d)
    # Sample batch n reads volume n // group; offsets index the (C, NV*J)
    # view of the volume, so no per-hypothesis copy of it is made.
    base = (torch.arange(n, device=grid.device) // (n // nv) * j)[:, None]
    vol_cj = volume.float().transpose(0, 1).reshape(c, nv * j)
    acc = torch.zeros(c, n * k, dtype=torch.float32, device=volume.device)
    for iz, wz in tz:
        for iy, wy in ty:
            for ix, wx in tx:
                idx = base + (iz * h + iy) * w + ix
                acc.addcmul_(vol_cj[:, idx.reshape(-1)],
                             (wz * wy * wx).reshape(1, -1))
    out = acc.reshape(c, n, k).transpose(0, 1).to(out_dtype)
    return out.reshape(n, c, *grid.shape[1:4])


def grid_sample_3d_fused(volume: torch.Tensor, grid: torch.Tensor,
                         padding_mode: str = "zeros",
                         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sample ``volume`` (NV, C, D, H, W) at ``grid`` (N, Do, Ho, Wo, 3),
    NV | N. Returns (N, C, Do, Ho, Wo) in ``out_dtype``."""
    global LAUNCHES
    if volume.device.type == "cpu":
        return grid_sample_3d_plain(volume, grid, padding_mode, out_dtype)
    if volume.device.type != "cuda":
        raise ValueError(f"unsupported device {volume.device}")
    _check_args(volume, grid, padding_mode, out_dtype)
    if not (volume.is_contiguous() and grid.is_contiguous()):
        raise ValueError("volume and grid must be contiguous")
    if torch.is_grad_enabled() and (volume.requires_grad or grid.requires_grad):
        raise RuntimeError("the K1 kernel has no backward pass yet; run under "
                           "torch.no_grad() or on the plain version")
    nv, c, d, h, w = volume.shape
    n = grid.shape[0]
    k = grid[0, ..., 0].numel()
    out = torch.empty((n, c, *grid.shape[1:4]), dtype=out_dtype,
                      device=volume.device)
    lib = _build.load("fused_sample")
    fn = lib.lf_fused_sample_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 7
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(volume.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(volume.data_ptr(), grid.data_ptr(), out.data_ptr(),
                    nv, n, c, d, h, w, k, int(padding_mode == "border"),
                    _DTYPE_CODES[volume.dtype], _DTYPE_CODES[out_dtype],
                    stream)
    _build.check(lib, status, "fused_sample_fwd")
    LAUNCHES += 1
    return out
