"""Core 3D tensor math (counterpart of ``latentfusion_tpu/three/core.py``)."""
from __future__ import annotations

import torch


def acos_safe(t: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    return torch.acos(t.clamp(-1.0 + eps, 1.0 - eps))


def ensure_batch_dim(tensor: torch.Tensor, num_dims: int):
    """Adds a leading batch dim if the tensor has ``num_dims`` dims."""
    if tensor.dim() == num_dims:
        return tensor[None], True
    return tensor, False
