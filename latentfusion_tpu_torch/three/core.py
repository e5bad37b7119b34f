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


def uniform(n: int, min_val: float, max_val: float,
            generator: torch.Generator) -> torch.Tensor:
    """``n`` uniform samples in [min_val, max_val), drawn on the generator's
    device."""
    rand = torch.rand(n, generator=generator, device=generator.device)
    return (max_val - min_val) * rand + min_val


def uniform_unit_vector(n: int, generator: torch.Generator) -> torch.Tensor:
    """``n`` uniform random unit 3-vectors, drawn on the generator's device."""
    return normalize(torch.randn(n, 3, generator=generator,
                                 device=generator.device), dim=1)


def linspace(start, stop, num: int, device=None) -> torch.Tensor:
    """``num`` evenly spaced fp32 values computed as the JAX package's
    ``jnp.linspace`` does: ``start (1 - k / d) + stop k / d`` for k < d =
    num - 1, then ``stop`` (``torch.linspace`` rounds differently). Tensor
    end points may carry gradients."""
    start = torch.as_tensor(start, dtype=torch.float32, device=device)
    stop = torch.as_tensor(stop, dtype=torch.float32, device=start.device)
    if num <= 1:
        return start.reshape(1)[:num]
    step = torch.arange(num - 1, dtype=torch.float32, device=start.device) / (num - 1)
    return torch.cat((start * (1 - step) + stop * step, stop.reshape(1)))


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


def transform_coord_grid(grid: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """Apply (B, M, N) transforms to a (B, *spatial, N-1) coordinate grid."""
    if transform.shape[0] != grid.shape[0]:
        raise ValueError("Batch dimensions must match.")
    out_shape = (*grid.shape[:-1], transform.shape[1])
    coords = grid_to_coords(homogenize(grid))
    coords = (transform @ coords.transpose(1, 2)).transpose(1, 2)
    return dehomogenize(coords.reshape(out_shape))


def grid_to_coords(grid: torch.Tensor) -> torch.Tensor:
    """Flatten a (B, *spatial, C) grid to (B, prod(spatial), C)."""
    return grid.reshape(grid.shape[0], -1, grid.shape[-1])


def spherical_to_cartesian(theta, phi, r=1.0) -> torch.Tensor:
    """The original's convention, kept: z is ``r cos(theta)``."""
    theta, phi = torch.as_tensor(theta), torch.as_tensor(phi)
    return torch.stack((r * torch.cos(theta) * torch.sin(phi),
                        r * torch.sin(theta) * torch.sin(phi),
                        r * torch.cos(theta)), dim=-1)


def points_bound(points: torch.Tensor) -> torch.Tensor:
    """(N, 3) points -> (3, 2) per-axis (min, max)."""
    return torch.stack((points.amin(dim=0), points.amax(dim=0)), dim=1)


def points_radius(points: torch.Tensor) -> torch.Tensor:
    """Largest distance of a point from the bounding box's centre."""
    centroid = points_bound(points).mean(dim=1)[None]
    return torch.linalg.norm(points - centroid, dim=1).max()


def points_diameter(points: torch.Tensor) -> torch.Tensor:
    return 2 * points_radius(points)


def points_centroid(points: torch.Tensor) -> torch.Tensor:
    return points_bound(points).mean(dim=1)


def points_bounding_size(points: torch.Tensor) -> torch.Tensor:
    bounds = points_bound(points)
    return torch.linalg.norm(bounds[:, 1] - bounds[:, 0])
