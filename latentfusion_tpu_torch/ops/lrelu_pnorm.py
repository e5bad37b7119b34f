"""K2: fused leaky-ReLU + PixelNorm, forward and backward (counterpart of
``latentfusion_tpu/ops/pallas_lrelu_pnorm.py:lrelu_pixel_norm_pallas``).

``lrelu_pixel_norm_fwd(x, slope, eps)`` computes, over the channel dim 1 of
an NC(D)HW tensor, ``u = leaky_relu(x, slope)``, ``inv = 1 / sqrt(mean(u²)
+ eps)`` and ``y = u * inv`` in fp32, and returns ``y`` in the dtype of
``x`` with ``inv`` (B, *spatial) in fp32 for the backward pass.

``lrelu_pixel_norm_bwd(x, inv, g, slope)`` is that backward: with
``t = mean(g * u, C)``, ``du = g * inv - u * inv³ * t`` and
``dx = lrelu'(x) * du``, in the dtype of ``x``.

``lrelu_pixel_norm(x, slope, eps)`` is the differentiable function: an
``autograd.Function`` whose forward is the first and whose backward is the
second.

On a CUDA tensor each wrapper launches its kernel of ``csrc/lrelu_pnorm.cu``
(see the note there) or raises; on a CPU tensor it runs its plain PyTorch
version. ``LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

LAUNCHES = 0
BWD_LAUNCHES = 0

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
        raise RuntimeError("lrelu_pixel_norm_fwd is not differentiable; use "
                           "lrelu_pixel_norm, whose backward is K2-bwd")
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


def lrelu_pixel_norm_bwd_plain(x: torch.Tensor, inv: torch.Tensor,
                               g: torch.Tensor, slope: float) -> torch.Tensor:
    """The backward kernel's function in plain PyTorch: dx from x, the
    forward's ``inv`` and the upstream gradient ``g``."""
    _check_args(x)
    xf, gf = x.float(), g.float()
    u = torch.where(xf >= 0, xf, slope * xf)
    inv = inv.float()[:, None]
    t = (gf * u).mean(dim=1, keepdim=True)
    du = gf * inv - u * (inv * inv * inv) * t
    return torch.where(xf >= 0, du, slope * du).to(x.dtype)


def lrelu_pixel_norm_bwd(x: torch.Tensor, inv: torch.Tensor, g: torch.Tensor,
                         slope: float) -> torch.Tensor:
    """dx of ``y = lrelu_pixel_norm(x)`` given dL/dy ``g``; see the module
    docstring."""
    global BWD_LAUNCHES
    if x.device.type == "cpu":
        return lrelu_pixel_norm_bwd_plain(x, inv, g, slope)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_args(x)
    if g.shape != x.shape or inv.shape != (x.shape[0], *x.shape[2:]):
        raise ValueError(f"g {tuple(g.shape)} and inv {tuple(inv.shape)} do "
                         f"not match x {tuple(x.shape)}")
    if g.dtype not in _DTYPE_CODES or inv.dtype != torch.float32:
        raise TypeError("g must be float32 or bfloat16 and inv float32")
    if not (x.is_contiguous() and g.is_contiguous() and inv.is_contiguous()):
        raise ValueError("x, g and inv must be contiguous")
    if not (g.device == inv.device == x.device):
        raise ValueError("x, g and inv must be on one device")
    b, c = x.shape[:2]
    s = x[0, 0].numel()
    dx = torch.empty_like(x)
    lib = _build.load("lrelu_pnorm")
    fn = lib.lf_lrelu_pnorm_bwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3
                   + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(x.data_ptr(), inv.data_ptr(), g.data_ptr(), dx.data_ptr(),
                    b, c, s, slope, _DTYPE_CODES[x.dtype],
                    _DTYPE_CODES[g.dtype], stream)
    _build.check(lib, status, "lrelu_pnorm_bwd")
    BWD_LAUNCHES += 1
    return dx


class LReluPixelNorm(torch.autograd.Function):
    """Forward K2-fwd, backward K2-bwd; saves x and ``inv``."""

    @staticmethod
    def forward(ctx, x, slope, eps):
        y, inv = lrelu_pixel_norm_fwd(x, slope, eps)
        ctx.save_for_backward(x, inv)
        ctx.slope = slope
        return y

    @staticmethod
    def backward(ctx, g):
        x, inv = ctx.saved_tensors
        return lrelu_pixel_norm_bwd(x, inv, g.contiguous(), ctx.slope), None, None


def lrelu_pixel_norm(x: torch.Tensor, slope: float, eps: float) -> torch.Tensor:
    """Differentiable ``pixel_norm(leaky_relu(x, slope))`` over dim 1."""
    return LReluPixelNorm.apply(x.contiguous(), slope, eps)
