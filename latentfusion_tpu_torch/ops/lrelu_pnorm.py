"""K2 forward: fused leaky-ReLU + PixelNorm (counterpart of
``latentfusion_tpu/ops/pallas_lrelu_pnorm.py:lrelu_pixel_norm_pallas``).

``lrelu_pixel_norm_fwd(x, slope, eps)`` computes, over the channel dim 1 of
an NC(D)HW tensor, ``u = leaky_relu(x, slope)``, ``inv = 1 / sqrt(mean(u²)
+ eps)`` and ``y = u * inv`` in fp32, and returns ``y`` in the dtype of
``x`` with ``inv`` (B, *spatial) in fp32 for a later backward pass.

On a CUDA tensor it launches the kernel of ``csrc/lrelu_pnorm.cu`` (see the
note there) or raises; on a CPU tensor it runs ``lrelu_pixel_norm_plain``.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(x):
    if x.dim() < 2:
        raise ValueError(f"expected (B, C, *spatial), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError("x must be float32 or bfloat16")


def lrelu_pixel_norm_plain(x: torch.Tensor, slope: float, eps: float):
    """The kernel's function in plain PyTorch; returns (y, inv)."""
    _check_args(x)
    xf = x.float()
    u = torch.where(xf >= 0, xf, slope * xf)
    inv = 1.0 / torch.sqrt((u * u).mean(dim=1) + eps)
    return (u * inv[:, None]).to(x.dtype), inv


def lrelu_pixel_norm_fwd(x: torch.Tensor, slope: float, eps: float):
    """Returns (y, inv); see the module docstring."""
    global LAUNCHES
    if x.device.type == "cpu":
        return lrelu_pixel_norm_plain(x, slope, eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_args(x)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if torch.is_grad_enabled() and x.requires_grad:
        raise RuntimeError("the K2 kernel has no backward pass yet; run under "
                           "torch.no_grad() or on the plain version")
    b, c = x.shape[:2]
    s = x[0, 0].numel()
    y = torch.empty_like(x)
    inv = torch.empty((b, *x.shape[2:]), dtype=torch.float32, device=x.device)
    lib = _build.load("lrelu_pnorm")
    fn = lib.lf_lrelu_pnorm_fwd
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3
                   + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), y.data_ptr(), inv.data_ptr(), b, c, s,
                    slope, eps, _DTYPE_CODES[x.dtype], stream)
    _build.check(lib, status, "lrelu_pnorm_fwd")
    LAUNCHES += 1
    return y, inv
