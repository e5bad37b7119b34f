"""Rigid 4x4 transform helpers (counterpart of
``latentfusion_tpu/three/rigid.py``)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import quaternion
from .core import dehomogenize, ensure_batch_dim, uniform


def intrinsic_to_3x4(matrix: torch.Tensor) -> torch.Tensor:
    """Pad a (.., 3, 3) intrinsic to (.., 3, 4)."""
    return F.pad(matrix, (0, 1))


def matrix_3x3_to_4x4(matrix: torch.Tensor) -> torch.Tensor:
    """(.., 3, 3) -> (.., 4, 4) homogeneous."""
    out = F.pad(matrix, (0, 1, 0, 1))
    out[..., 3, 3] = 1.0
    return out


def rotation_to_4x4(matrix: torch.Tensor) -> torch.Tensor:
    return matrix_3x3_to_4x4(matrix)


def translation_to_4x4(translation: torch.Tensor) -> torch.Tensor:
    """(.., 3) translation -> (.., 4, 4) homogeneous."""
    eye = torch.eye(4, dtype=translation.dtype, device=translation.device)
    out = eye.expand(*translation.shape[:-1], 4, 4).clone()
    out[..., :3, 3] = translation
    return out


def decompose(matrix: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split (B, 3|4, 4) extrinsics (or one) into their rotation and
    translation 4x4s."""
    matrix, unsqueezed = ensure_batch_dim(matrix, 2)
    b, rows = matrix.shape[:2]
    origin = torch.zeros(b, rows, 1, dtype=matrix.dtype, device=matrix.device)
    origin[:, 3:] = 1.0
    R = torch.cat((matrix[:, :, :3], origin), dim=-1)
    eye = torch.eye(4, 3, dtype=matrix.dtype, device=matrix.device)[:rows]
    T = torch.cat((eye.expand(b, rows, 3), matrix[:, :, 3:4]), dim=-1)
    return (R[0], T[0]) if unsqueezed else (R, T)


def inverse_transform(matrix: torch.Tensor) -> torch.Tensor:
    """Inverse of rigid 4x4s (B, 4, 4) or one."""
    matrix, unsqueezed = ensure_batch_dim(matrix, 2)
    R, T = decompose(matrix)
    R_inv = R.transpose(1, 2)
    t_inv = (R_inv @ T[:, :4, 3:4])[:, :3, 0]
    out = torch.zeros_like(matrix)
    out[:, :3, :3] = R_inv[:, :3, :3]
    out[:, :3, 3] = -t_inv
    out[:, 3, 3] = 1.0
    return out[0] if unsqueezed else out


def translate_matrix(matrix: torch.Tensor, offset) -> torch.Tensor:
    """Move the frame's origin by ``offset`` in the frame's own space."""
    matrix, unsqueezed = ensure_batch_dim(matrix, 2)
    out = inverse_transform(matrix)
    out[:, :3, 3] += torch.as_tensor(offset, dtype=out.dtype, device=out.device)
    out = inverse_transform(out)
    return out[0] if unsqueezed else out


def scale_matrix(matrix: torch.Tensor, scale) -> torch.Tensor:
    """Scale the frame's origin by ``scale`` in the frame's own space."""
    matrix, unsqueezed = ensure_batch_dim(matrix, 2)
    out = inverse_transform(matrix)
    out[:, :3, 3] *= torch.as_tensor(scale, dtype=out.dtype, device=out.device)
    out = inverse_transform(out)
    return out[0] if unsqueezed else out


def extrinsic_to_position(extrinsic: torch.Tensor) -> torch.Tensor:
    """Camera centres C = -R^T t of (B, 4, 4) extrinsics, or of one."""
    extrinsic, unsqueezed = ensure_batch_dim(extrinsic, 2)
    rot_mat, trans_mat = decompose(extrinsic)
    position = dehomogenize((rot_mat.transpose(-1, -2) @ trans_mat[:, :, 3:4])[..., 0])
    return position[0] if unsqueezed else position


def random_translation(n: int, x_bound, y_bound, z_bound,
                       generator: torch.Generator) -> torch.Tensor:
    """(n, 3) translations uniform in the bounds, drawn x, then y, then z."""
    return torch.stack([uniform(n, *bound, generator)
                        for bound in (x_bound, y_bound, z_bound)], dim=-1)


def to_extrinsic_matrix(translation: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Compose extrinsic = T @ R."""
    rot = rotation_to_4x4(quaternion.quat_to_mat(quat))
    return translation_to_4x4(translation) @ rot


def extrinsic_to_quat(extrinsic: torch.Tensor) -> torch.Tensor:
    """The rotation of extrinsics as (w, x, y, z)."""
    rot_mat, _ = decompose(extrinsic)
    return quaternion.mat_to_quat(rot_mat[..., :3, :3])
