"""Point clouds (counterpart of ``latentfusion_tpu/pointcloud.py``): PLY
input and output, projection into cameras, the points inside masks, and a
RANSAC plane segmentation, and ``filter_outliers``: scikit-learn's isolation
forest rebuilt in numpy (its elliptic envelope is not ported: ROADMAP.md,
Queue 1)."""
from __future__ import annotations

import logging
import math

import numpy as np
import torch

from . import three

logger = logging.getLogger(__name__)


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


def average_path_length(n) -> np.ndarray:
    """The mean path length of an unsuccessful search in a binary search
    tree of ``n`` keys: isolation depth added for a leaf holding ``n``
    samples (0 for n <= 1, 1 for n = 2)."""
    n = np.asarray(n, dtype=np.float64)
    out = np.where(n == 2, 1.0, 0.0)
    big = n > 2
    out[big] = 2.0 * (np.log(n[big] - 1.0) + np.euler_gamma) - 2.0 * (n[big] - 1.0) / n[big]
    return out


def _isolation_tree(x: np.ndarray, rng: np.random.Generator, max_depth: int):
    """One isolation tree of the rows of ``x``: each node splits on a
    feature drawn among those not constant in it, at a threshold uniform
    between their least and greatest value (x <= threshold goes left), until
    one sample is left or ``max_depth``. Arrays by node: feature (-1 at a
    leaf), threshold, left, right, and at leaves depth + average path length
    of the samples held."""
    feature, threshold, left, right, value = [], [], [], [], []
    stack = [(np.arange(len(x)), 0, None, None)]
    while stack:
        idx, depth, parent, side = stack.pop()
        node = len(feature)
        if parent is not None:
            (left if side == 0 else right)[parent] = node
        feature.append(-1)
        threshold.append(0.0)
        left.append(-1)
        right.append(-1)
        value.append(0.0)
        sub = x[idx]
        lo, hi = sub.min(axis=0), sub.max(axis=0)
        candidates = np.flatnonzero(hi > lo)
        if len(idx) <= 1 or depth >= max_depth or len(candidates) == 0:
            value[node] = depth + float(average_path_length(len(idx)))
            continue
        f = int(rng.choice(candidates))
        t = float(rng.uniform(lo[f], hi[f]))
        feature[node], threshold[node] = f, t
        go_left = sub[:, f] <= t
        stack.append((idx[~go_left], depth + 1, node, 1))
        stack.append((idx[go_left], depth + 1, node, 0))
    return (np.asarray(feature), np.asarray(threshold), np.asarray(left), np.asarray(right),
            np.asarray(value))


def _path_lengths(tree, x: np.ndarray) -> np.ndarray:
    feature, threshold, left, right, value = tree
    node = np.zeros(len(x), np.int64)
    while True:
        inner = feature[node] >= 0
        if not inner.any():
            return value[node]
        n = node[inner]
        go_left = x[inner, feature[n]] <= threshold[n]
        node[inner] = np.where(go_left, left[n], right[n])


def isolation_forest_scores(points, rng: np.random.Generator, n_estimators: int = 100,
                            max_samples: int = 256) -> np.ndarray:
    """scikit-learn's ``IsolationForest(...).score_samples``: each of
    ``n_estimators`` trees grown on ``min(max_samples, N)`` points drawn
    without replacement to depth ceil(log2 of that); a point's score is
    -2^(-mean path length / average path length of the subsample size),
    lower the more isolated."""
    x = np.asarray(points, dtype=np.float32)
    n_sub = min(max_samples, len(x))
    max_depth = int(math.ceil(math.log2(max(n_sub, 2))))
    depths = np.zeros(len(x))
    for _ in range(n_estimators):
        tree = _isolation_tree(x[rng.choice(len(x), n_sub, replace=False)], rng, max_depth)
        depths += _path_lengths(tree, x)
    norm = float(average_path_length(n_sub))
    return -np.power(2.0, -depths / n_estimators / norm)


def filter_outliers(points, n_estimators=100, contamination=0.05,
                    type="isolation_forest", *, rng: np.random.Generator):
    """The inlier mask (N,) bool of ``IsolationForest(n_estimators,
    contamination).fit_predict(points) > 0``: points whose score is below
    the ``contamination`` quantile of all scores are outliers. The trees
    draw from ``rng``."""
    if type == "elliptic":
        raise NotImplementedError(
            "filter_outliers(type='elliptic') is not ported (ROADMAP.md, Queue 1)")
    if type != "isolation_forest":
        raise ValueError("Unknown outlier filter type")
    pts = points.detach().cpu().numpy() if torch.is_tensor(points) else np.asarray(points)
    scores = isolation_forest_scores(pts, rng, n_estimators)
    keep = scores >= np.percentile(scores, 100.0 * contamination)
    logger.info("filtered points: %d filtered, %d valid", int((~keep).sum()), int(keep.sum()))
    return torch.from_numpy(keep)
