"""Pose accuracy metrics: ADD, ADD-S, z-symmetric ADD, 2D projection error,
rotation and translation distance (counterpart of
``latentfusion_tpu/pose/metrics.py``)."""
from __future__ import annotations

import math
from typing import Dict

import torch

from .. import three
from ..three import quaternion


def camera_rotation_dist(camera1, camera2):
    return quaternion.angular_distance(camera1.quaternion, camera2.quaternion)


def camera_translation_dist(camera1, camera2):
    return torch.linalg.norm(camera1.translation - camera2.translation, dim=-1)


def compute_point_add(extrinsic_gt, extrinsic_eval, points):
    """Mean distance between the points under the two transforms."""
    points_gt = three.transform_coords(points, extrinsic_gt)
    points_eval = three.transform_coords(points, extrinsic_eval)
    return torch.linalg.norm(points_gt - points_eval, dim=-1).mean()


def best_distance(x1, x2, batch_size: int = 1000):
    """Distance from each point of x1 to its nearest point of x2, in chunks
    of x1 (direct differences: the |a|² + |b|² - 2ab expansion cancels for
    near-identical point sets)."""
    return torch.cat([
        torch.linalg.norm(x1[i:i + batch_size, None] - x2[None], dim=-1).amin(dim=1)
        for i in range(0, x1.shape[0], batch_size)])


def compute_point_add_s(extrinsic_gt, extrinsic_eval, points):
    """Mean nearest-point distance between the points under the two
    transforms (symmetric objects)."""
    points_gt = three.transform_coords(points, extrinsic_gt)
    points_eval = three.transform_coords(points, extrinsic_eval)
    return best_distance(points_gt, points_eval).mean()


def compute_point_add_sym(extrinsic_gt, extrinsic_eval, points):
    """ADD, also against the ground truth turned 180 degrees about z."""
    z_axis = torch.tensor([[0.0, 0.0, 1.0]], device=points.device)
    rot_z180 = three.rotation_to_4x4(quaternion.quat_to_mat(
        quaternion.from_axis_angle(z_axis, math.pi)))
    add_ident = compute_point_add(extrinsic_gt, extrinsic_eval, points)
    add_zsym = compute_point_add(extrinsic_gt @ rot_z180, extrinsic_eval, points)
    return torch.minimum(add_ident, add_zsym)


def compute_point_proj2d(proj_gt, proj_eval, points):
    """Mean distance between the points' projections."""
    points_gt = three.transform_coords(points, proj_gt)
    points_eval = three.transform_coords(points, proj_eval)
    return torch.linalg.norm(points_gt - points_eval, dim=-1).mean()


def camera_metrics(camera_gt, camera_eval, points, scale_to_meters) -> Dict:
    """Metrics of one estimated camera against the ground truth, as floats
    (the point metrics only with ``points``); a list of such dicts for
    cameras of length > 1."""
    if len(camera_gt) > 1:
        return [camera_metrics(camera_gt[i], camera_eval[i], points,
                               scale_to_meters)
                for i in range(len(camera_gt))]
    metrics = {
        "rotation_dist": float(camera_rotation_dist(camera_gt, camera_eval).reshape(())),
        "translation_dist": float(camera_translation_dist(camera_gt, camera_eval).reshape(())
                                  * scale_to_meters),
    }
    if points is not None:
        gt, ev = camera_gt.obj_to_cam, camera_eval.obj_to_cam
        metrics["add"] = float(compute_point_add(gt, ev, points) * scale_to_meters)
        metrics["add_s"] = float(compute_point_add_s(gt, ev, points) * scale_to_meters)
        metrics["add_sym"] = float(compute_point_add_sym(gt, ev, points) * scale_to_meters)
        metrics["proj2d"] = float(compute_point_proj2d(
            camera_gt.obj_to_image, camera_eval.obj_to_image, points))
    return metrics


def concat_camera_metrics(metrics_list) -> dict:
    """Metric dicts with the same keys -> {key: [value of each dict]}."""
    return {key: [metrics[key] for metrics in metrics_list] for key in metrics_list[0]}
