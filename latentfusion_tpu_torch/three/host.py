"""Numpy twins of ``quaternion.quat_to_mat``, ``quaternion.qmul`` and
``rigid.to_extrinsic_matrix`` for host code (counterpart of
``latentfusion_tpu/three/host.py``): per-view pose math in data workers
costs microseconds in numpy against a device round trip per op. Same
float32 formulas, normalisation eps and (w, x, y, z) layout."""
from __future__ import annotations

import numpy as np


def normalize(q: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    q = np.asarray(q, dtype=np.float32)
    norm = np.linalg.norm(q, axis=-1, keepdims=True)
    return q / np.maximum(norm, eps)


def quat_to_mat(quaternion: np.ndarray) -> np.ndarray:
    """(..., 4) (w, x, y, z) -> (..., 3, 3)."""
    q = normalize(quaternion)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    tx, ty, tz = 2.0 * x, 2.0 * y, 2.0 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz = ty * y, tz * y
    tzz = tz * z
    matrix = np.stack(
        [
            1.0 - (tyy + tzz), txy - twz, txz + twy,
            txy + twz, 1.0 - (txx + tzz), tyz - twx,
            txz - twy, tyz + twx, 1.0 - (txx + tyy),
        ],
        axis=-1,
    ).reshape(*q.shape[:-1], 3, 3)
    return matrix.astype(np.float32)


def qmul(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Hamilton product in (w, x, y, z) layout."""
    q1 = np.asarray(q1, dtype=np.float32)
    q2 = np.asarray(q2, dtype=np.float32)
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return np.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    ).astype(np.float32)


def to_extrinsic_matrix(translation: np.ndarray,
                        quaternion: np.ndarray) -> np.ndarray:
    """extrinsic = T @ R, batched over leading dims."""
    translation = np.asarray(translation, dtype=np.float32)
    rot = quat_to_mat(quaternion)
    out = np.zeros((*rot.shape[:-2], 4, 4), dtype=np.float32)
    out[..., :3, :3] = rot
    out[..., :3, 3] = translation
    out[..., 3, 3] = 1.0
    return out
