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


def normalize(vector: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2-normalize along ``dim`` (no eps clamp, as in the JAX version)."""
    return vector / torch.linalg.norm(vector, dim=dim, keepdim=True)


def uniform_unit_vector(n: int, generator: torch.Generator) -> torch.Tensor:
    """``n`` uniform random unit 3-vectors, drawn on the generator's device."""
    return normalize(torch.randn(n, 3, generator=generator,
                                 device=generator.device), dim=1)


def inner_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1)


def homogenize(coords: torch.Tensor) -> torch.Tensor:
    """Append a homogeneous 1 coordinate."""
    return torch.cat((coords, torch.ones_like(coords[..., :1])), dim=-1)


def dehomogenize(coords: torch.Tensor) -> torch.Tensor:
    """Divide by (and drop) the last coordinate."""
    return coords[..., :-1] / coords[..., -1:]


def transform_coords(coords: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Apply homogeneous transform(s) (B, M, M) to point sets (B, P, M-1)
    or (P, M-1)."""
    coords, unsqueezed = ensure_batch_dim(coords, 2)
    coords = homogenize(coords)
    coords = dehomogenize((transform @ coords.transpose(-1, -2)).transpose(-1, -2))
    return coords[0] if unsqueezed else coords
