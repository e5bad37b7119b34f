"""Rigid 4x4 transform helpers (counterpart of
``latentfusion_tpu/three/rigid.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import quaternion


def intrinsic_to_3x4(matrix: torch.Tensor) -> torch.Tensor:
    """Pad a (.., 3, 3) intrinsic to (.., 3, 4)."""
    return F.pad(matrix, (0, 1))


def rotation_to_4x4(matrix: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) rotation -> (B, 4, 4) homogeneous."""
    out = F.pad(matrix, (0, 1, 0, 1))
    out[..., 3, 3] = 1.0
    return out


def translation_to_4x4(translation: torch.Tensor) -> torch.Tensor:
    """(B, 3) translation -> (B, 4, 4) homogeneous."""
    eye = torch.eye(4, dtype=translation.dtype, device=translation.device)
    out = eye.expand(*translation.shape[:-1], 4, 4).clone()
    out[..., :3, 3] = translation
    return out


def to_extrinsic_matrix(translation: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Compose extrinsic = T @ R."""
    rot = rotation_to_4x4(quaternion.quat_to_mat(quat))
    return translation_to_4x4(translation) @ rot
