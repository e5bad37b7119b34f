"""(B, V, ...) <-> (B*V, ...) reshapes (counterpart of
``latentfusion_tpu/three/batchview.py``)."""
from __future__ import annotations

import torch


def bv2b(x: torch.Tensor) -> torch.Tensor:
    """Fold the view dim into the batch dim."""
    return x.reshape(-1, *x.shape[2:])


def b2bv(x: torch.Tensor, num_view: int = -1, batch_size: int = -1) -> torch.Tensor:
    """Unfold the batch dim into (batch, view)."""
    if num_view == -1 and batch_size == -1:
        raise ValueError("One of num_view or batch_size must be non-negative.")
    return x.reshape(batch_size, num_view, *x.shape[1:])
