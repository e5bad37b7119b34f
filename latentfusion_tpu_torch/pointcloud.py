"""Point clouds (counterpart of ``latentfusion_tpu/pointcloud.py``): PLY
input and output, projection into cameras, the points inside masks, and a
RANSAC plane segmentation. ``filter_outliers`` (scikit-learn's estimators)
is not ported."""
from __future__ import annotations

import numpy as np
import torch

from . import three


def load_ply(path) -> torch.Tensor:
    from .meshutils import load_ply as _load

    return torch.from_numpy(_load(path)["vertices"])


def save_ply(path, points, colors=None):
    """An ASCII PLY of (N, 3) points, with (N, 3) colors in [0, 1] if given."""
    points = np.asarray(torch.as_tensor(points).detach().cpu())
    lines = ["ply", "format ascii 1.0", f"element vertex {len(points)}",
             "property float x", "property float y", "property float z"]
    if colors is not None:
        colors = (np.asarray(torch.as_tensor(colors).detach().cpu()) * 255.0).astype(np.uint8)
        lines += ["property uchar red", "property uchar green", "property uchar blue"]
    lines.append("end_header")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
        for i, p in enumerate(points):
            row = f"{p[0]} {p[1]} {p[2]}"
            if colors is not None:
                row += f" {colors[i, 0]} {colors[i, 1]} {colors[i, 2]}"
            f.write(row + "\n")


def project_pointcloud(camera, points: torch.Tensor) -> torch.Tensor:
    """Object-space points (B, N, 3) to integer pixel coordinates (B, N, 2)
    (truncated toward zero)."""
    image_points = (camera.obj_to_image @ three.homogenize(points).transpose(1, 2)).transpose(1, 2)
    return three.dehomogenize(image_points).to(torch.int32)


def compute_point_mask(camera, mask, points: torch.Tensor) -> torch.Tensor:
    """(B, N) whether each point projects inside the image and onto the
    foreground of ``mask`` (B, ..., H, W)."""
    height, width = camera.height, camera.width
    mask = torch.as_tensor(mask).reshape(len(camera), height, width) > 0.5
    image_points = project_pointcloud(camera, points).long()
    x, y = image_points[..., 0], image_points[..., 1]
    in_bounds = (x >= 0) & (x < width) & (y >= 0) & (y < height)
    index = y.clamp(0, height - 1) * width + x.clamp(0, width - 1)
    return in_bounds & torch.gather(mask.reshape(len(camera), -1), 1, index)


def segment_plane(points, distance_threshold=0.01, num_iterations=256, seed=0):
    """RANSAC plane fit (numpy ``RandomState(seed)``). Returns (a torch bool
    mask of the plane's inliers and of everything below the plane, the
    plane (a, b, c, d) as numpy)."""
    pts = np.asarray(torch.as_tensor(points).detach().cpu(), dtype=np.float64)
    rng = np.random.RandomState(seed)
    n = len(pts)
    best_inliers = 0
    best_plane = None
    for _ in range(num_iterations):
        idx = rng.choice(n, 3, replace=False)
        p0, p1, p2 = pts[idx]
        normal = np.cross(p1 - p0, p2 - p0)
        norm = np.linalg.norm(normal)
        if norm < 1e-12:
            continue
        normal = normal / norm
        d = -normal.dot(p0)
        count = int((np.abs(pts @ normal + d) < distance_threshold).sum())
        if count > best_inliers:
            best_inliers = count
            best_plane = (*normal, d)
    if best_plane is None:
        raise RuntimeError("plane segmentation failed")

    a, b, c, d = best_plane
    normal = np.asarray((a, b, c))
    normal /= np.linalg.norm(normal)
    point_on_plane = np.asarray((0.0, 0.0, -d / c)) if abs(c) > 1e-9 else -d * normal
    sign = np.sign(point_on_plane.dot(normal))
    below_plane = sign * (pts @ normal) <= 0
    inlier = np.abs(pts @ normal + d) < distance_threshold
    return torch.from_numpy(inlier | below_plane), np.asarray(best_plane)
