"""MOPED / Realsense captures (counterpart of
``latentfusion_tpu/data/realsense.py``): open3d or KinectFusion
trajectories, the optional manual registration, the integrated point cloud
filtered by an isolation forest, the object scale from its bounds, and
RGB-D frames resized by ``image_scale`` in the normalised object frame.

Images are read as imageio reads them, by their bytes and not their name:
JPEG by ``jpeg.py``, PNG by ``png.py``. Resizing is OpenCV's
INTER_NEAREST (``cv_compat.resize_nearest``). Items are numpy.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path

import numpy as np
import torch

from .. import jpeg, png, three
from ..augment.cv_compat import resize_nearest
from ..meshutils import load_ply as _load_ply_mesh
from ..pointcloud import filter_outliers

logger = logging.getLogger(__name__)
JPEG_MAGIC = b"\xff\xd8\xff"


def read_image(path) -> np.ndarray:
    """A JPEG or PNG file by its magic bytes, uint8 or uint16 (H, W[, C]).
    A progressive JPEG raises ``jpeg.NoDecoderError``."""
    path = Path(path)
    data = path.read_bytes()
    if data[:3] == JPEG_MAGIC:
        return jpeg.decode_jpeg(data, str(path))
    if data[:8] == png.SIGNATURE:
        return png.read_png(path)
    raise ValueError(f"{path}: neither a JPEG nor a PNG file")


def _invert_rigid(trans: np.ndarray) -> np.ndarray:
    rot = trans[:3, :3].T
    out = np.zeros((4, 4), dtype=np.float32)
    out[3, 3] = 1
    out[:3, :3] = rot
    out[:3, 3] = -rot @ trans[:3, 3]
    return out


def read_open3d_trajectory(filename) -> np.ndarray:
    """An Open3D ``.log`` trajectory (a metadata line, then the 4x4
    camera-to-world pose, per frame) as world-to-camera extrinsics (N, 4, 4)."""
    traj = []
    with open(filename, "r") as f:
        meta = f.readline()
        while meta:
            mat = np.stack([np.array(f.readline().split(), dtype=np.float64)
                            for _ in range(4)])
            traj.append(_invert_rigid(mat.astype(np.float32)))
            meta = f.readline()
    return np.stack(traj)


def _parse_kinectfusion_poses(poses_path) -> np.ndarray:
    """KinectFusion's ``poses.txt``: per frame a header line and the 3x4
    pose; (N, 4, 4)."""
    with open(poses_path, "r") as f:
        lines = f.read().split("\n")
    poses = []
    for i in range(len(lines) // 4):
        pose = np.asarray([[float(v) for v in line.split(" ")]
                           for line in lines[i * 4 + 1:i * 4 + 4]], dtype=np.float32)
        poses.append(np.concatenate([pose, np.asarray([[0.0, 0.0, 0.0, 1.0]], np.float32)]))
    return np.stack(poses)


def read_kinectfusion_trajectory(poses_path) -> np.ndarray:
    """The relative poses chained onto the first: (N, 4, 4)."""
    rel_poses = _parse_kinectfusion_poses(poses_path)
    canon = rel_poses[0]
    return np.stack([rel_poses[0]] + [rel @ canon for rel in rel_poses[1:]])


def _resize(image, scale):
    if scale == 1.0:
        return image
    h, w = image.shape[:2]
    return resize_nearest(image, (int(w * scale), int(h * scale)))


class RealsenseDataset:
    """Frames of one or more captures of one object. Items: color (3, H, W)
    float in [0, 1], mask (H, W) bool, depth (H, W) in metres times the
    object scale, extrinsic (4, 4) normalised, intrinsic (3, 4) scaled by
    ``image_scale``. The outlier filter's trees draw from ``rng`` (by
    default ``numpy.random.default_rng(0)``)."""

    def __init__(self, scene_paths, image_scale=0.2, object_scale="auto",
                 center_object=True, odometry_type="open3d",
                 use_registration=True, mask_type="default", ref_points=None,
                 rng: np.random.Generator = None):
        if isinstance(scene_paths, (str, Path)):
            scene_paths = [scene_paths]
        self.scene_paths = [Path(p) for p in scene_paths]
        self.odometry_type = odometry_type
        self.use_registration = use_registration
        self.center_object = center_object
        rng = np.random.default_rng(0) if rng is None else rng

        mask_folder = "mask-plane" if mask_type == "plane" else "mask"
        self.mask_paths, self.depth_paths, self.color_paths = [], [], []
        self.intrinsics, extrinsics_list, points_list = [], [], []
        for path in self.scene_paths:
            intrinsic = self.load_intrinsics(path)
            mask_dir = path / mask_folder
            if not mask_dir.exists():
                raise ValueError(f"Mask directory {mask_dir!s} does not exist.")
            mask_paths = sorted(mask_dir.glob("*.png"))
            valid_ids = [int(p.stem) for p in mask_paths]
            self.mask_paths.extend(mask_paths)
            self.depth_paths.extend(path / "depth" / p.name for p in mask_paths)
            self.color_paths.extend(path / "color" / p.with_suffix(".jpg").name
                                    for p in mask_paths)
            self.intrinsics.extend([intrinsic] * len(valid_ids))
            if odometry_type is not None:
                extrinsics_list.append(self.load_extrinsics(path)[valid_ids])
                points_list.append(self.load_points(path))
        self.intrinsics = np.stack(self.intrinsics)

        if odometry_type is not None:
            self.extrinsics = np.concatenate(extrinsics_list)
            self.quaternions = three.extrinsic_to_quat(torch.from_numpy(self.extrinsics))
            points = np.concatenate(points_list)
            keep = filter_outliers(points, contamination=0.1, rng=rng).numpy()
            self.points = points[keep]
            self.centroid = three.points_centroid(torch.from_numpy(self.points)).numpy()
        elif object_scale == "auto":
            raise ValueError("object_scale cannot be auto if odometry is not given.")

        if ref_points is not None:
            self.points = np.asarray(ref_points)
            self.centroid = three.points_centroid(torch.from_numpy(self.points)).numpy()

        if object_scale == "auto":
            object_scale = 1.2 / float(three.points_bounding_size(torch.from_numpy(self.points)))
        self.image_scale = image_scale
        self.object_scale = object_scale

    # ------------------------------------------------------------------- io
    def load_intrinsics(self, path) -> np.ndarray:
        """Open3D's intrinsics JSON, whose matrix is column-major: (3, 4)."""
        with open(path / "intrinsics.json") as f:
            data = json.load(f)
        k = np.asarray(data["intrinsic_matrix"], dtype=np.float32).reshape(3, 3).T
        return np.concatenate([k, np.zeros((3, 1), np.float32)], axis=1)

    def load_extrinsics(self, path) -> np.ndarray:
        if self.odometry_type == "open3d":
            extrinsics = read_open3d_trajectory(path / "scene" / "trajectory.log")
        elif self.odometry_type == "kinectfusion":
            extrinsics = read_kinectfusion_trajectory(path / "scene_kf" / "poses.txt")
        else:
            raise ValueError(f"Unknown odometry_type {self.odometry_type!r}")
        if self.use_registration:
            inv = three.inverse_transform(torch.from_numpy(self.load_registration(path)))
            extrinsics = extrinsics @ inv.numpy()[None]
        return extrinsics

    def load_points(self, path) -> np.ndarray:
        folder = "scene" if self.odometry_type == "open3d" else "scene_kf"
        points = _load_ply_mesh(path / folder / "integrated_cropped.ply")["vertices"]
        if self.use_registration:
            transform = torch.from_numpy(self.load_registration(path))
            points = three.transform_coords(torch.from_numpy(points)[None],
                                            transform[None])[0].numpy()
        return points

    def load_registration(self, path) -> np.ndarray:
        """``registration/manual.json``'s transform, else
        ``registration.json``'s, else the identity."""
        if not self.use_registration:
            return np.eye(4, dtype=np.float32)
        reg_path = path / "registration" / "manual.json"
        if not reg_path.exists():
            reg_path = path / "registration" / "registration.json"
        if not reg_path.exists():
            return np.eye(4, dtype=np.float32)
        with open(reg_path) as f:
            logger.info("using registration %s", reg_path)
            return np.asarray(json.load(f)["transform"], dtype=np.float32)

    # ------------------------------------------------------- normalization
    def normalize_points(self, points) -> torch.Tensor:
        return torch.as_tensor(points) * self.object_scale

    def normalize_extrinsic(self, extrinsic) -> torch.Tensor:
        extrinsic = torch.as_tensor(extrinsic)
        if self.center_object:
            extrinsic = three.translate_matrix(extrinsic, -torch.from_numpy(self.centroid))
        extrinsic = extrinsic.clone()
        extrinsic[..., :3, 3] *= self.object_scale
        return extrinsic

    def denormalize_extrinsic(self, extrinsic) -> torch.Tensor:
        extrinsic = torch.as_tensor(extrinsic).clone()
        extrinsic[..., :3, 3] /= self.object_scale
        if self.center_object:
            extrinsic = three.translate_matrix(extrinsic, torch.from_numpy(self.centroid))
        return extrinsic

    def normalize_intrinsic(self, intrinsic) -> torch.Tensor:
        intrinsic = torch.as_tensor(intrinsic).clone()
        intrinsic[..., :2, :] *= self.image_scale
        return intrinsic

    def denormalize_intrinsic(self, intrinsic) -> torch.Tensor:
        intrinsic = torch.as_tensor(intrinsic).clone()
        intrinsic[..., :2, :] /= self.image_scale
        return intrinsic

    def sample_evenly(self, n) -> torch.Tensor:
        """Indices of ``n`` frames whose camera positions are spread out
        (farthest-point sampling)."""
        positions = three.extrinsic_to_position(torch.from_numpy(self.extrinsics))
        _, inds = three.utils.farthest_points(
            positions, n_clusters=n, dist_func=lambda a, b: torch.linalg.norm(a - b, dim=-1),
            return_center_indexes=True)
        return inds

    # ------------------------------------------------------------- item API
    def __len__(self):
        return len(self.color_paths)

    def get_ids(self):
        return [p.stem for p in self.mask_paths]

    def __getitem__(self, idx):
        color = _resize(read_image(self.color_paths[idx]), self.image_scale)
        color = color.astype(np.float32).transpose(2, 0, 1) / 255.0
        mask = _resize(read_image(self.mask_paths[idx]), self.image_scale)
        if mask.ndim > 2:
            mask = mask[..., 0]
        depth = _resize(read_image(self.depth_paths[idx]), self.image_scale)
        depth = depth.astype(np.float32) / 1000.0 * self.object_scale
        intrinsic = self.normalize_intrinsic(self.intrinsics[idx]).numpy()
        if self.odometry_type is not None:
            extrinsic = self.normalize_extrinsic(self.extrinsics[idx]).numpy()
        else:
            extrinsic = np.eye(4, dtype=np.float32)
        return {"color": color, "mask": mask.astype(bool), "depth": depth,
                "extrinsic": extrinsic, "intrinsic": intrinsic}
