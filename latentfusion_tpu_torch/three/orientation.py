"""Rotation sampling (counterpart of ``latentfusion_tpu/three/orientation.py``):
spiral orbits, rays in a segment or hemisphere around an up vector,
sunflower-even points on the sphere and the quaternions that look along
them, disk-sampled quaternions. Random draws take a ``torch.Generator`` and
happen on its device; the rejection loops keep the JAX package's bounds."""
from __future__ import annotations

import math

import torch

from . import core
from . import quaternion as q


UP = (0.0, 0.0, 1.0)


def spiral_orbit(n: int, c: int = 16, device=None) -> torch.Tensor:
    """``n`` pure quaternions along a spiral from pole to pole."""
    phi = core.linspace(0, math.pi, n, device=device)
    return q.from_spherical(phi, c * phi)


def _check_up(up, n: int, device) -> torch.Tensor:
    up = torch.as_tensor(up, dtype=torch.float32, device=device)
    if up.dim() == 1:
        up = up.expand(n, up.shape[0])
    return core.normalize(up)


def _ray_angles(rays: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return torch.arccos(core.inner_product(up, rays).clamp(-1.0, 1.0))


def _random_rays(n: int, generator: torch.Generator) -> torch.Tensor:
    return core.normalize(torch.randn(n, 3, generator=generator,
                                      device=generator.device))


def sample_segment_rays(n: int, up, min_angle, max_angle,
                        generator: torch.Generator,
                        max_iters: int = 256) -> torch.Tensor:
    """``n`` unit rays whose angle to ``up`` lies in [min_angle, max_angle]:
    rays outside are redrawn, at most ``max_iters`` times."""
    rays = _random_rays(n, generator)
    up = _check_up(up, n, rays.device)
    for _ in range(max_iters):
        angles = _ray_angles(rays, up)
        valid = (min_angle <= angles) & (angles <= max_angle)
        if bool(valid.all()):
            break
        rays = torch.where(valid[:, None], rays, _random_rays(n, generator))
    return core.normalize(rays)


def sample_hemisphere_rays(n: int, up, generator: torch.Generator) -> torch.Tensor:
    """``n`` uniform unit rays, those below ``up``'s plane reflected into
    its hemisphere."""
    rays = _random_rays(n, generator)
    up = _check_up(up, n, rays.device)
    dot = (up * rays).sum(dim=-1)
    reflected = rays - 2 * dot[:, None] * up
    return torch.where((dot < 0)[:, None], reflected, rays)


def sample_segment_quats(n: int, up, min_angle, max_angle,
                         generator: torch.Generator) -> torch.Tensor:
    """Rotations that tilt ``up`` onto a segment ray, after a uniform yaw
    about ``up`` (the yaw drawn first)."""
    up = _check_up(up, n, generator.device)
    yaw_angle = torch.rand(n, generator=generator, device=generator.device) * math.pi * 2.0
    yaw_quat = q.from_axis_angle(up, yaw_angle)
    rays = sample_segment_rays(n, up, min_angle, max_angle, generator)
    pivot = torch.linalg.cross(up, rays)
    quat = q.from_axis_angle(pivot, _ray_angles(rays, up))
    return q.qmul(quat, yaw_quat)


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


def disk_sample_quats(n: int, min_angle: float, generator: torch.Generator,
                      max_tries: int = 64) -> torch.Tensor:
    """Greedy Poisson-disk sampling: uniform random quaternions, each kept
    if it is at least ``min_angle`` from every one kept before, or after
    ``max_tries`` rejections in a row."""
    quats = torch.zeros(n, 4, device=generator.device)
    quats[0] = q.random(1, generator)[0]
    count, num_tries = 1, 0
    while count < n:
        new_quat = q.random(1, generator)
        angles = q.angular_distance(quats[:count], new_quat)[:, 0]
        if bool((angles >= min_angle).all()) or num_tries > max_tries:
            quats[count] = new_quat[0]
            count, num_tries = count + 1, 0
        else:
            num_tries += 1
    return quats
