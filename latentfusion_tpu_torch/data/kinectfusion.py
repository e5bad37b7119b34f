"""KinectFusion captures (counterpart of
``latentfusion_tpu/data/kinectfusion.py``): relative pose chains anchored
at the point cloud's centroid, frames rescaled so that the camera stands at
a distance of 3. Images are PNG, read by ``png.py``."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .. import png


def load_points_file(path):
    with open(path) as f:
        lines = [s.strip() for s in f.read().split("\n") if s.strip()]
    return np.asarray([[float(v) for v in line.split(" ")] for line in lines],
                      dtype=np.float32)


def load_poses_file(poses_path):
    with open(poses_path) as f:
        lines = f.read().split("\n")
    num_cameras = len(lines) // 4
    poses = []
    for i in range(num_cameras):
        cam_lines = lines[i * 4 + 1:i * 4 + 4]
        pose = np.asarray([[float(v) for v in line.split(" ")] for line in cam_lines],
                          dtype=np.float32)
        bottom = np.asarray([[0.0, 0.0, 0.0, 1.0]], dtype=np.float32)
        poses.append(np.concatenate([pose, bottom]))
    return np.stack(poses)


def load_poses(poses_path, points_path):
    """The relative chain of ``poses_path`` anchored at the centre of the
    bounds of ``points_path``'s cloud."""
    points = load_points_file(points_path)
    centroid = np.stack([points.min(axis=0), points.max(axis=0)], axis=1).mean(axis=1)
    rel_poses = load_poses_file(poses_path)
    rel_poses[0][:3, 3] = centroid
    canon = rel_poses[0]
    abs_poses = [rel_poses[0]]
    for rel in rel_poses[1:]:
        abs_poses.append(rel @ canon)
    return np.stack(abs_poses)


def load_depth(path):
    depth = png.read_png(path)
    if depth.ndim > 2:
        depth = depth[:, :, 0]
    return depth.astype(np.float32) / 1000.0


def load_intrinsics(path):
    with open(path) as f:
        k = np.asarray(json.load(f), dtype=np.float32).reshape(3, 3)
    return np.concatenate([k, np.zeros((3, 1), np.float32)], axis=1)


class KinectFusionDataset:
    def __init__(self, path, stride=1):
        self.path = Path(path)
        self.image_dir = self.path / "images"
        self.extrinsics = load_poses(self.path / "poses.txt", self.path / "points.xyz")
        intrinsic = load_intrinsics(self.path / "intrinsics.json")
        self.intrinsics = np.tile(intrinsic[None], (self.extrinsics.shape[0], 1, 1))
        self.color_paths = [*sorted(self.image_dir.glob("*-color.png")),
                            *sorted(self.image_dir.glob("*-rgb.png"))]
        self.depth_paths = sorted(self.image_dir.glob("*-depth.png"))
        if stride > 1:
            self.color_paths = self.color_paths[::stride]
            self.depth_paths = self.depth_paths[::stride]
            self.extrinsics = self.extrinsics[::stride]
            self.intrinsics = self.intrinsics[::stride]

    def __len__(self):
        return min(len(self.color_paths), self.extrinsics.shape[0])

    def __getitem__(self, idx):
        extrinsic = self.extrinsics[idx].copy()
        intrinsic = self.intrinsics[idx]
        color = png.read_png(self.color_paths[idx])[..., :3]
        color = color.astype(np.float32).transpose(2, 0, 1) / 255.0
        depth = load_depth(self.depth_paths[idx])
        # Rescale to a camera distance of 3.
        scale = 3.0 / np.linalg.norm(extrinsic[:3, 3])
        extrinsic[:3, 3] *= scale
        return {"color": color, "depth": depth * scale, "extrinsic": extrinsic,
                "intrinsic": intrinsic}
