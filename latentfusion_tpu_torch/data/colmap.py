"""COLMAP reconstructions (counterpart of ``latentfusion_tpu/data/colmap.py``):
COLMAP's text export (``images.txt``, ``cameras.txt``, ``points3D.txt``),
the sparse cloud filtered by an isolation forest and scaled from its
bounds, and masked RGB frames with normalised extrinsics. Images are read
by their bytes (``realsense.read_image``) and resized with OpenCV's
INTER_NEAREST (``cv_compat.resize_nearest``). Items are numpy.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import three
from ..augment.cv_compat import resize_nearest
from ..pointcloud import filter_outliers
from .realsense import read_image


def _lines(path):
    with open(path) as f:
        return [line.strip() for line in f if not line.startswith("#")]


def parse_image_meta(path):
    """``images.txt``: per image its id, name, camera id, rotation (w, x,
    y, z) and translation (every second line; the others are 2D points)."""
    out = []
    for line in _lines(path)[::2]:
        (image_id, qw, qx, qy, qz, tx, ty, tz, camera_id, name) = line.split(" ")
        out.append({
            "id": int(image_id),
            "name": name,
            "camera_id": int(camera_id),
            "rotation": np.asarray([qw, qx, qy, qz], dtype=np.float32),
            "translation": np.asarray([tx, ty, tz], dtype=np.float32),
        })
    return out


def parse_points(path, max_error=2.0) -> np.ndarray:
    """``points3D.txt``'s points whose reprojection error is at most
    ``max_error``: (N, 3) float32."""
    points = []
    for line in _lines(path):
        vals = line.split(" ")[:8]
        if float(vals[7]) <= max_error:
            points.append([float(v) for v in vals[1:4]])
    return np.asarray(points, dtype=np.float32)


def parse_cameras(path) -> dict:
    """``cameras.txt``'s PINHOLE cameras by id: size and (3, 4) intrinsic."""
    cameras = {}
    for line in _lines(path):
        parts = line.split(" ")
        camera_id, model, width, height = parts[:4]
        if model != "PINHOLE":
            raise ValueError(f"Camera model {model!r} is not supported yet.")
        fx, fy, cx, cy = (float(v) for v in parts[4:8])
        cameras[int(camera_id)] = {
            "id": int(camera_id),
            "width": int(width),
            "height": int(height),
            "model": model,
            "intrinsic": np.asarray([[fx, 0.0, cx, 0.0], [0.0, fy, cy, 0.0],
                                     [0.0, 0.0, 1.0, 0.0]], dtype=np.float32),
        }
    return cameras


class ColmapDataset:
    """Frames of one COLMAP reconstruction. Items: color (3, H, W) float in
    [0, 1], mask (H, W) bool, extrinsic (4, 4) normalised, intrinsic (3, 4)
    scaled by ``image_scale``. The outlier filter's trees draw from ``rng``
    (by default ``numpy.random.default_rng(0)``)."""

    def __init__(self, path, image_scale=0.2, object_scale="auto", mask_mode="grabcut",
                 rng: np.random.Generator = None):
        self.path = Path(path)
        self.image_dir = self.path / "color"
        self.mask_dir = self.path / "mask"
        rng = np.random.default_rng(0) if rng is None else rng

        points = parse_points(self.path / "points3D.txt")
        keep = filter_outliers(points, contamination=0.1, rng=rng).numpy()
        self.points = points[keep]
        self.image_dicts = parse_image_meta(self.path / "images.txt")
        self.cameras = parse_cameras(self.path / "cameras.txt")
        self.centroid = three.points_centroid(torch.from_numpy(self.points)).numpy()
        if object_scale == "auto":
            object_scale = 1.0 / float(three.points_bounding_size(torch.from_numpy(self.points)))
        self.image_scale = image_scale
        self.object_scale = object_scale
        self.mask_mode = mask_mode

    def __len__(self):
        return len(self.image_dicts)

    def _load(self, path, as_bool=False):
        image = read_image(path)
        h, w = image.shape[:2]
        image = resize_nearest(image, (int(w * self.image_scale), int(h * self.image_scale)))
        return image.astype(bool) if as_bool else image

    def __getitem__(self, idx):
        meta = self.image_dicts[idx]
        image = self._load(self.image_dir / meta["name"])
        mask = self._load(self.mask_dir / f"{meta['name']}.png", as_bool=True)
        if mask.ndim > 2:
            mask = mask[..., 0]
        camera = self.cameras[meta["camera_id"]]
        extrinsic = three.to_extrinsic_matrix(torch.from_numpy(meta["translation"])[None],
                                              torch.from_numpy(meta["rotation"])[None])[0]
        extrinsic = three.translate_matrix(extrinsic, -torch.from_numpy(self.centroid))
        extrinsic = extrinsic.numpy().copy()
        extrinsic[:3, 3] *= self.object_scale
        intrinsic = camera["intrinsic"].copy()
        intrinsic[:2, :] *= self.image_scale
        return {
            "color": image.astype(np.float32).transpose(2, 0, 1) / 255.0,
            "mask": mask,
            "extrinsic": extrinsic,
            "intrinsic": intrinsic,
        }
