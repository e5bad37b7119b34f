"""PyTorch/CUDA port of LatentFusion-TPU for NVIDIA Hopper (H100).

The JAX package ``latentfusion_tpu`` is the reference; this package mirrors
its module layout. It imports torch and numpy only. Entry points take an
explicit ``device`` (default ``"cuda"``) and raise when no GPU is present
unless the caller passes ``device="cpu"``.

The Pallas kernels on the ported paths (build + render, pose estimation,
training) are CUDA C++ kernels here (``csrc/``), built with ``nvcc`` at
first use and bound with ctypes:

- ``ops.fused_sample``: trilinear volume sampler (K1 forward, d/dgrid and
  d/dvolume);
- ``ops.lrelu_pnorm``: fused leaky-ReLU + PixelNorm (K2 forward and
  backward).

The host data path's C++ (the rasterizer, ``csrc/jpeg.cpp``) is built with
g++ at first use.
"""
from .device import resolve_device  # noqa: F401
