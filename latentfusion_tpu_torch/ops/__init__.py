"""Resampling ops and the port's hand-written CUDA kernels.

``fused_sample`` (K1) and ``lrelu_pnorm`` (K2) launch their kernels on CUDA
tensors and take their plain PyTorch versions only on CPU tensors.
"""
