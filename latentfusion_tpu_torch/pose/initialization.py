"""Initial pose from a target's depth and mask: the translation only, with
the identity rotation (counterpart of
``latentfusion_tpu/pose/initialization.py``)."""
from __future__ import annotations

import torch

from .. import imutils, three
from ..camera import Camera
from ..three import quaternion, stats


def masks_to_viewports(masks: torch.Tensor, pad: float = 10.0) -> torch.Tensor:
    """(B, 4) mask bounding boxes (xmin, ymin, xmax, ymax), padded."""
    m = masks.reshape(masks.shape[0], *masks.shape[-2:]) > 0
    height, width = m.shape[-2:]
    yy, xx = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=masks.device),
        torch.arange(width, dtype=torch.float32, device=masks.device),
        indexing="ij")
    big = 1e9
    xmin = torch.where(m, xx, big).amin(dim=(-2, -1))
    ymin = torch.where(m, yy, big).amin(dim=(-2, -1))
    xmax = torch.where(m, xx, -big).amax(dim=(-2, -1))
    ymax = torch.where(m, yy, -big).amax(dim=(-2, -1))
    padding = torch.tensor((-pad, -pad, pad, pad), device=masks.device)
    return torch.stack((xmin, ymin, xmax, ymax), dim=-1) + padding


def masks_to_centroids(masks: torch.Tensor) -> torch.Tensor:
    """(B, 2) centres (u, v) of the mask bounding boxes."""
    viewports = masks_to_viewports(masks, 0.0)
    return torch.stack(((viewports[:, 2] + viewports[:, 0]) / 2.0,
                        (viewports[:, 3] + viewports[:, 1]) / 2.0), dim=-1)


def _reject_outliers_mad_bounds(values: torch.Tensor, m: float = 3.0):
    """Min and max of the values within ``m`` median absolute deviations of
    the median."""
    median = stats.median(values)
    mad = stats.median((values - median).abs())
    inliers = values[(values - median).abs() / mad.clamp_min(1e-12) < m]
    return inliers.min(), inliers.max()


def estimate_camera_dist(depth: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B,) object depth: the midpoint of the robust depth range inside the
    mask eroded by a disk of radius 3 (the raw mask where erosion leaves
    fewer than 10 pixels)."""
    num_batch = depth.shape[0]
    m = mask.reshape(num_batch, *mask.shape[-2:]) > 0
    d = depth.reshape(num_batch, *depth.shape[-2:])
    eroded = imutils.erode_disk(m.float(), 3) > 0.5
    enough = eroded.sum(dim=(-2, -1), keepdim=True) >= 10
    valid = torch.where(enough, eroded, m) & (d > 0.0)
    zs = []
    for i in range(num_batch):
        lo, hi = _reject_outliers_mad_bounds(d[i][valid[i]])
        zs.append((lo + hi) / 2.0)
    return torch.stack(zs)


def estimate_translation(depth, mask, intrinsic):
    """Camera-frame (x, y, z) of the object: z from the depth, x and y from
    the mask's box centre back-projected at z."""
    z_cam = estimate_camera_dist(depth, mask)
    centroid_uv = masks_to_centroids(mask)
    u0, v0 = intrinsic[..., 0, 2], intrinsic[..., 1, 2]
    fu, fv = intrinsic[..., 0, 0], intrinsic[..., 1, 1]
    x_cam = (centroid_uv[:, 0] - u0) / fu * z_cam
    y_cam = (centroid_uv[:, 1] - v0) / fv * z_cam
    return x_cam, y_cam, z_cam


def estimate_initial_pose(depth, mask, intrinsic, width, height) -> Camera:
    """A camera at the estimated translation with the identity rotation."""
    translation = torch.stack(estimate_translation(depth, mask, intrinsic), dim=-1)
    rotation = quaternion.identity(intrinsic.shape[0], device=intrinsic.device)
    return Camera(intrinsic, three.to_extrinsic_matrix(translation, rotation),
                  height=height, width=width, device=intrinsic.device)
