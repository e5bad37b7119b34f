"""Quaternion algebra in (w, x, y, z) convention (counterpart of
``latentfusion_tpu/three/quaternion.py``). Samplers take a
``torch.Generator`` and draw on its device."""
from __future__ import annotations

import math

import torch

from . import core


def identity(n: int, device=None) -> torch.Tensor:
    """``n`` identity quaternions (1, 0, 0, 0)."""
    q = torch.tensor((1.0, 0.0, 0.0, 0.0), device=device)
    return q.repeat(n, 1)


def normalize(quaternion: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.linalg.norm(quaternion, dim=-1, keepdim=True)
    return quaternion / norm.clamp_min(eps)


def quat_to_mat(quaternion: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion -> (..., 3, 3) rotation matrix."""
    quaternion, unsqueezed = core.ensure_batch_dim(quaternion, 1)
    q = normalize(quaternion)
    w, x, y, z = q.unbind(-1)
    tx, ty, tz = 2.0 * x, 2.0 * y, 2.0 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz = ty * y, tz * y
    tzz = tz * z
    matrix = torch.stack(
        [
            1.0 - (tyy + tzz), txy - twz, txz + twy,
            txy + twz, 1.0 - (txx + tzz), tyz - twx,
            txz - twy, tyz + twx, 1.0 - (txx + tyy),
        ],
        dim=-1,
    ).reshape(*q.shape[:-1], 3, 3)
    return matrix[0] if unsqueezed else matrix


def mat_to_quat(rotation_matrix: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Rotation matrix -> (w, x, y, z), selecting among the same four cases
    as the JAX version (so the sign convention matches)."""
    m, unsqueezed = core.ensure_batch_dim(rotation_matrix, 2)
    mv = m.reshape(*m.shape[:-2], 9)
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = mv.unbind(-1)
    tiny = torch.finfo(mv.dtype).tiny

    def safe_div(num, den):
        return num / den.clamp_min(tiny)

    trace = m00 + m11 + m22
    sq_t = torch.sqrt((trace + 1.0).clamp_min(tiny)) * 2.0
    q_t = torch.stack([0.25 * sq_t, safe_div(m21 - m12, sq_t),
                       safe_div(m02 - m20, sq_t), safe_div(m10 - m01, sq_t)], -1)
    sq_1 = torch.sqrt((1.0 + m00 - m11 - m22 + eps).clamp_min(tiny)) * 2.0
    q_1 = torch.stack([safe_div(m21 - m12, sq_1), 0.25 * sq_1,
                       safe_div(m01 + m10, sq_1), safe_div(m02 + m20, sq_1)], -1)
    sq_2 = torch.sqrt((1.0 + m11 - m00 - m22 + eps).clamp_min(tiny)) * 2.0
    q_2 = torch.stack([safe_div(m02 - m20, sq_2), safe_div(m01 + m10, sq_2),
                       0.25 * sq_2, safe_div(m12 + m21, sq_2)], -1)
    sq_3 = torch.sqrt((1.0 + m22 - m00 - m11 + eps).clamp_min(tiny)) * 2.0
    q_3 = torch.stack([safe_div(m10 - m01, sq_3), safe_div(m02 + m20, sq_3),
                       safe_div(m12 + m21, sq_3), 0.25 * sq_3], -1)

    where_2 = torch.where((m11 > m22)[..., None], q_2, q_3)
    where_1 = torch.where(((m00 > m11) & (m00 > m22))[..., None], q_1, where_2)
    quaternion = torch.where((trace > 0.0)[..., None], q_t, where_1)
    return quaternion[0] if unsqueezed else quaternion


def random(n: int, generator: torch.Generator) -> torch.Tensor:
    """``n`` uniform random unit quaternions, drawn on the generator's
    device (the JAX version's formula, torch's random stream)."""
    rand = torch.rand(n, 3, generator=generator, device=generator.device)
    r1 = torch.sqrt(1.0 - rand[:, 0])
    r2 = torch.sqrt(rand[:, 0])
    t1 = 2.0 * math.pi * rand[:, 1]
    t2 = 2.0 * math.pi * rand[:, 2]
    return torch.stack([torch.cos(t2) * r2, torch.sin(t1) * r1,
                        torch.cos(t1) * r1, torch.sin(t2) * r2], dim=1)


def qmul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    w = w2 * w1 - x2 * x1 - y2 * y1 - z2 * z1
    x = w2 * x1 + x2 * w1 - y2 * z1 + z2 * y1
    y = w2 * y1 + x2 * z1 + y2 * w1 - z2 * x1
    z = w2 * z1 - x2 * y1 + y2 * x1 + z2 * w1
    return torch.stack((w, x, y, z), dim=-1)


def rotate_vector(quat: torch.Tensor, vector: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vectors (..., 3) by unit quaternions (..., 4)."""
    shape = vector.shape
    quat = quat.reshape(-1, 4)
    vector = vector.reshape(-1, 3)
    pure, vector = torch.broadcast_tensors(quat[:, 1:], vector)
    uv = torch.linalg.cross(pure, vector)
    uuv = torch.linalg.cross(pure, uv)
    return (vector + 2 * (quat[:, :1] * uv + uuv)).reshape(shape)


def from_spherical(theta, phi, r=1.0) -> torch.Tensor:
    """Pure quaternions (0, x, y, z) of spherical directions; as in the
    original, only z is scaled by ``r``."""
    theta, phi = torch.as_tensor(theta), torch.as_tensor(phi)
    x = torch.cos(theta) * torch.sin(phi)
    y = torch.sin(theta) * torch.sin(phi)
    z = r * torch.cos(phi)
    return torch.stack((torch.zeros_like(x), x, y, z), dim=-1)


def qexp(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Quaternion exponential of (*, 4) or pure-imaginary (*, 3) input."""
    if q.shape[-1] == 4:
        s, v = q[..., :1], q[..., 1:]
    else:
        s, v = torch.zeros_like(q[..., :1]), q
    theta = torch.linalg.norm(v, dim=-1, keepdim=True)
    xyz = 1.0 / theta.clamp_min(eps) * torch.sin(theta) * v
    return torch.exp(s) * torch.cat((torch.cos(theta), xyz), dim=-1)


def qlog(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Quaternion logarithm."""
    mag = torch.linalg.norm(q, dim=-1, keepdim=True)
    s, v = q[..., :1], q[..., 1:]
    xyz = (v / torch.linalg.norm(v, dim=-1, keepdim=True).clamp_min(eps)
           * core.acos_safe(s / mag.clamp_min(eps)))
    return torch.cat((torch.log(mag), xyz), dim=-1)


def from_axis_angle(axis: torch.Tensor, angle) -> torch.Tensor:
    """Unit quaternions for rotations by ``angle`` about ``axis`` (..., 3)."""
    if not torch.is_tensor(angle):
        angle = torch.full(axis.shape[:-1], float(angle), dtype=axis.dtype,
                           device=axis.device)
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    c = torch.cos(angle / 2.0)
    s = torch.sin(angle / 2.0)
    return torch.stack((c, s * axis[..., 0], s * axis[..., 1], s * axis[..., 2]),
                       dim=-1)


def qdelta(n: int, std, generator: torch.Generator) -> torch.Tensor:
    """``n`` random small rotations: the exponential of N(0, std / 2)
    rotation vectors, drawn on the generator's device."""
    noise = torch.randn(n, 3, generator=generator, device=generator.device)
    omega = torch.cat((torch.zeros_like(noise[:, :1]), noise), dim=-1)
    return qexp(std / 2.0 * omega)


def perturb(q: torch.Tensor, std, generator: torch.Generator) -> torch.Tensor:
    """Unit quaternions ``q`` (n, 4) or (4,) turned by random rotations of
    ``std`` radians (``qdelta``, applied on the left)."""
    q, unsqueezed = core.ensure_batch_dim(q, 1)
    q_out = qmul(qdelta(q.shape[0], std, generator).to(q.device), q)
    return q_out[0] if unsqueezed else q_out


def angular_distance(q1: torch.Tensor, q2: torch.Tensor,
                     eps: float = 1e-7) -> torch.Tensor:
    """Pairwise angular distances (N1, N2) between two quaternion sets."""
    dot = normalize(q1) @ normalize(q2).T
    return 2 * core.acos_safe(dot.abs(), eps=eps)
