"""(B, V, ...) <-> (B*V, ...) reshapes (counterpart of
``latentfusion_tpu/three/batchview.py``)."""
from __future__ import annotations

import torch


def bvmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul of (B, V, i, j) by (B, V, j, k)."""
    if a.shape[0] != b.shape[0]:
        raise ValueError("batch dimension must match")
    if a.shape[1] != b.shape[1]:
        raise ValueError("view dimension must match")
    return torch.einsum("bvij,bvjk->bvik", a, b)


def bv2b(x: torch.Tensor) -> torch.Tensor:
    """Fold the view dim into the batch dim."""
    return x.reshape(-1, *x.shape[2:])


def b2bv(x: torch.Tensor, num_view: int = -1, batch_size: int = -1) -> torch.Tensor:
    """Unfold the batch dim into (batch, view)."""
    if num_view == -1 and batch_size == -1:
        raise ValueError("One of num_view or batch_size must be non-negative.")
    return x.reshape(batch_size, num_view, *x.shape[1:])


def vcat(tensors, batch_size: int) -> torch.Tensor:
    """Concatenate batch-folded tensors along their view dim."""
    return bv2b(torch.cat([b2bv(t, batch_size=batch_size) for t in tensors], dim=1))


def vsplit(tensor: torch.Tensor, sections) -> tuple:
    """Split a batch-folded tensor along its view dim into ``sections``
    (a list of view counts), each folded again."""
    tensor = b2bv(tensor, num_view=sum(sections))
    return tuple(bv2b(t) for t in torch.split(tensor, list(sections), dim=1))
