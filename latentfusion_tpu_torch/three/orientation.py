"""Rotation sampling for pose hypotheses (counterpart of the parts of
``latentfusion_tpu/three/orientation.py`` that seed the estimators):
sunflower-even points on the sphere and the quaternions that look along
them. Random draws take a ``torch.Generator`` and happen on its device."""
from __future__ import annotations

import math

import torch

from . import core
from . import quaternion as q


UP = (0.0, 0.0, 1.0)


def evenly_distributed_points(n: int, hemisphere: bool = False,
                              device=None) -> torch.Tensor:
    """``n`` sunflower-even unit vectors (n, 3) on the sphere, or on the
    hemisphere around +z."""
    indices = torch.arange(n, dtype=torch.float32, device=device) + 0.5
    if hemisphere:
        phi = torch.arccos(1 - 2 * indices / n / 2)
    else:
        phi = torch.arccos(1 - 2 * indices / n)
    theta = math.pi * (1 + 5 ** 0.5) * indices
    return torch.stack((torch.cos(theta) * torch.sin(phi),
                        torch.sin(theta) * torch.sin(phi),
                        torch.cos(phi)), dim=1)


def quat_from_rays(forward: torch.Tensor, down: torch.Tensor) -> torch.Tensor:
    """Quaternions of cameras looking along ``forward`` (n, 3) with ``down``
    (n, 3) as the image's down direction before orthogonalisation."""
    right = core.normalize(torch.linalg.cross(down, forward))
    down = core.normalize(torch.linalg.cross(forward, right))
    return q.mat_to_quat(torch.stack((right, down, forward), dim=1))


def random_quat_from_ray(forward: torch.Tensor, up=None,
                         generator: torch.Generator = None) -> torch.Tensor:
    """Quaternions looking along ``forward``: rolled about it at random
    (a uniform ``down`` from ``generator``) or kept upright to ``up``."""
    n = forward.shape[0]
    if up is None:
        if generator is None:
            raise ValueError("generator required when up is None")
        down = core.uniform_unit_vector(n, generator).to(forward.device)
    else:
        up = torch.as_tensor(up, dtype=torch.float32, device=forward.device)
        down = -(up.expand(n, 3) + forward)
    return quat_from_rays(forward, down)


def evenly_distributed_quats(n: int, hemisphere: bool = False,
                             upright: bool = False,
                             generator: torch.Generator = None,
                             device=None) -> torch.Tensor:
    """Cameras looking at the origin from ``n`` sunflower-even directions,
    upright to +z or rolled at random."""
    rays = evenly_distributed_points(n, hemisphere, device)
    return random_quat_from_ray(-rays, UP if upright else None, generator=generator)
