"""NN building blocks (counterpart of ``latentfusion_tpu/modules``).

``lrelu_pixel_norm`` and ``pixel_norm`` compute PixelNorm over the channel
dim 1. Their backend is ``"hopper"`` (the default: kernels K2-fwd and
K2-bwd, ``ops/lrelu_pnorm.py``, on CUDA tensors; their plain versions on
CPU tensors) or ``"torch"`` (K2's plain PyTorch forward everywhere, under
autograd).
"""
import contextlib

import torch

from ..ops.lrelu_pnorm import lrelu_pixel_norm as _lrelu_pixel_norm_k2
from ..ops.lrelu_pnorm import lrelu_pixel_norm_plain

_BACKENDS = ("hopper", "torch")
_LRELU_PNORM_BACKEND = "hopper"


def set_lrelu_pnorm_backend(name: str) -> None:
    """Select the lrelu + PixelNorm implementation: ``"hopper"`` or ``"torch"``."""
    global _LRELU_PNORM_BACKEND
    if name not in _BACKENDS:
        raise ValueError(name)
    _LRELU_PNORM_BACKEND = name


@contextlib.contextmanager
def lrelu_pnorm_backend(name: str):
    prev = _LRELU_PNORM_BACKEND
    set_lrelu_pnorm_backend(name)
    try:
        yield
    finally:
        set_lrelu_pnorm_backend(prev)


def lrelu_pixel_norm(x: torch.Tensor, slope: float, eps: float = 1e-8) -> torch.Tensor:
    """``pixel_norm(leaky_relu(x, slope))`` over dim 1."""
    if _LRELU_PNORM_BACKEND == "torch":
        return lrelu_pixel_norm_plain(x, slope, eps)[0]
    return _lrelu_pixel_norm_k2(x, slope, eps)


def pixel_norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """PixelNorm over dim 1: K2 with slope 1, where leaky-ReLU is the identity."""
    return lrelu_pixel_norm(x, 1.0, eps)


from .equalized import EqualizedConv  # noqa: E402,F401
from .blocks import Block, InputBlock, OutputBlock, create_block_defs  # noqa: E402,F401
from .unet import BaseUNet, UNet2d  # noqa: E402,F401
from .gru import ConvGRUCell  # noqa: E402,F401
