"""BOP-format datasets: LINEMOD, LM-O, T-LESS (counterpart of
``latentfusion_tpu/data/bop.py``).

Per-frame intrinsics and ground-truth extrinsics from BOP's JSON, visible
masks, depth with its per-frame scale, all rescaled by the object scale that
gives the object a unit (base) diameter. Images are PNG, read by
``png.py``. Items are numpy; cameras convert at the device boundary.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .. import meshutils, png, three
from ..three import quaternion as quat

LINEMOD_ID_TO_NAME = {
    "000001": "ape", "000002": "benchvise", "000003": "bowl",
    "000004": "camera", "000005": "can", "000006": "cat",
    "000007": "mug", "000008": "driller", "000009": "duck",
    "000010": "eggbox", "000011": "glue", "000012": "holepuncher",
    "000013": "iron", "000014": "lamp", "000015": "phone",
}
LINEMOD_NAME_TO_ID = {v: k for k, v in LINEMOD_ID_TO_NAME.items()}


class BOPDataset:
    """Frames of one object in one scene. Items: color (3, H, W) float in
    [0, 1], mask (H, W) bool, depth (H, W) in metres times the object scale,
    extrinsic (4, 4) normalised, intrinsic (3, 4)."""

    def __init__(self, dataset_path, scene_path, object_id,
                 center_object: bool = False, object_scale=None):
        self.dataset_path = Path(dataset_path)
        self.scene_path = Path(scene_path)
        self.object_id = object_id

        name = self.dataset_path.name
        if name in ("lm", "lmo"):
            base_obj_scale = 1.0
            self.models_path = self.dataset_path / "models"
        elif name == "tless":
            base_obj_scale = 0.60
            self.models_path = self.dataset_path / "models_reconst"
        else:
            raise ValueError(f"Unknown dataset type {name}")

        self.model_path = self.models_path / f"obj_{object_id:06d}.ply"
        self.pointcloud_path = self.dataset_path / "models_eval" / f"obj_{object_id:06d}.ply"

        with open(self.dataset_path / "models_eval" / "models_info.json") as f:
            self.model_info = json.load(f)[str(object_id)]

        self.center_object = center_object
        if object_scale is None:
            self.object_scale = base_obj_scale / self.model_info["diameter"]
        else:
            self.object_scale = object_scale

        self.image_scale = 1.0
        mi = self.model_info
        self.bounds = np.asarray([
            (mi["min_x"], mi["min_x"] + mi["size_x"]),
            (mi["min_y"], mi["min_y"] + mi["size_y"]),
            (mi["min_z"], mi["min_z"] + mi["size_z"]),
        ], dtype=np.float32)
        self.centroid = self.bounds.mean(axis=1)

        self.depth_dir = self.scene_path / "depth"
        self.mask_dir = self.scene_path / "mask_visib"
        self.color_dir = self.scene_path / "rgb"

        self.intrinsics, self.depth_scales = self._load_intrinsics(
            self.scene_path / "scene_camera.json")
        self.extrinsics, self.scene_object_inds = self._load_extrinsics(
            self.scene_path / "scene_gt.json")
        self.extrinsics = np.stack(self.extrinsics)

        rotation, _ = three.decompose(torch.from_numpy(self.extrinsics))
        self.quaternions = quat.mat_to_quat(rotation[:, :3, :3])

        self.depth_paths = sorted(self.depth_dir / f"{i:06d}.png"
                                  for i in self.scene_object_inds)
        self.mask_paths = [self.mask_dir / f"{i:06d}_{o:06d}.png"
                           for i, o in self.scene_object_inds.items()]
        self.color_paths = sorted(self.color_dir / f"{i:06d}.png"
                                  for i in self.scene_object_inds)
        assert len(self.depth_paths) == len(self.mask_paths)
        assert len(self.depth_paths) == len(self.color_paths)

    # ------------------------------------------------------------------- io
    @classmethod
    def _load_intrinsics(cls, path):
        intrinsics, depth_scales = [], []
        with open(path) as f:
            data = json.load(f)
        for key in sorted(int(k) for k in data):
            value = data[str(key)]
            k33 = np.asarray(value["cam_K"], dtype=np.float32).reshape(3, 3)
            intrinsics.append(np.concatenate([k33, np.zeros((3, 1), np.float32)], axis=1))
            depth_scales.append(value["depth_scale"])
        return intrinsics, depth_scales

    def _load_extrinsics(self, path):
        extrinsics = []
        scene_object_inds = {}
        with open(path) as f:
            data = json.load(f)
        for frame_ind in sorted(int(k) for k in data):
            for obj_ind, cam_d in enumerate(data[str(frame_ind)]):
                if cam_d["obj_id"] == self.object_id:
                    E = np.eye(4, dtype=np.float32)
                    E[:3, :3] = np.asarray(cam_d["cam_R_m2c"], dtype=np.float32).reshape(3, 3)
                    E[:3, 3] = np.asarray(cam_d["cam_t_m2c"], dtype=np.float32)
                    extrinsics.append(E)
                    scene_object_inds[frame_ind] = obj_ind
        return extrinsics, scene_object_inds

    def load_pointcloud(self) -> torch.Tensor:
        obj = meshutils.Object3D(self.pointcloud_path)
        return torch.from_numpy(obj.vertices * self.object_scale)

    # -------------------------------------------------------- normalization
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

    # -------------------------------------------------------------- sampling
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
        return [p.stem for p in self.color_paths]

    def __getitem__(self, idx):
        color = png.read_png(self.color_paths[idx]).astype(np.float32) / 255.0
        mask = png.read_png(self.mask_paths[idx]).astype(bool)
        if mask.ndim > 2:
            mask = mask[..., 0]
        depth = (png.read_png(self.depth_paths[idx]).astype(np.float32)
                 * self.object_scale * self.depth_scales[idx])
        return {
            "color": color.transpose(2, 0, 1),
            "mask": mask,
            "depth": depth,
            "extrinsic": self.normalize_extrinsic(self.extrinsics[idx]).numpy(),
            "intrinsic": self.normalize_intrinsic(self.intrinsics[idx]).numpy(),
        }
