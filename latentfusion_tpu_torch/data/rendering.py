"""Scene and renderer over the host rasterizer (counterpart of
``latentfusion_tpu/data/rendering.py``).

The rasterizer takes the OpenCV-convention extrinsic as it is; the
Realsense canonical frame is kept. Everything here is numpy on the host:
data workers call it once per view.
"""
from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np
import torch

from .. import meshutils, three
from ..three import host
from ..three import quaternion as quat
from . import rasterizer

CANON_POSE_REALSENSE = np.asarray(
    ((1.0, 0.0, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, -1.0)), dtype=np.float32)

_CANON_QUAT_REALSENSE = None


def _canon_quat_realsense() -> np.ndarray:
    """``mat_to_quat(CANON_POSE_REALSENSE)``, computed once."""
    global _CANON_QUAT_REALSENSE
    if _CANON_QUAT_REALSENSE is None:
        _CANON_QUAT_REALSENSE = quat.mat_to_quat(
            torch.from_numpy(CANON_POSE_REALSENSE)).numpy().astype(np.float32)
    return _CANON_QUAT_REALSENSE


def load_object(path, scale=1.0, size=1.0, recenter=True, resize=True,
                bound_type="diameter", load_materials=False):
    """Load a mesh, centre it on its bounds and scale it to ``size``
    (``bound_type`` "diameter" or "extents"). Returns (object, the scale
    applied by the resize)."""
    obj = meshutils.Object3D(path, load_materials=load_materials)
    if recenter:
        obj.recenter("bounds")
    if resize:
        if bound_type == "diameter":
            object_scale = size / obj.bounding_diameter
        elif bound_type == "extents":
            object_scale = size / obj.bounding_size
        else:
            raise ValueError(f"Unknown size_type {bound_type!r}")
        obj.rescale(object_scale)
    else:
        object_scale = 1.0
    if scale != 1.0:
        obj.rescale(scale)
    return obj, object_scale


def get_zbound(distance, scale, eps=0.01):
    znear = max(eps, distance - scale / 2.0 - eps)
    zfar = distance + scale / 2.0 + eps
    return znear, zfar


class SceneContext:
    """An object, its intrinsic and pose, point lights and a Blinn-Phong
    material (``specular`` strength, ``roughness`` in (0, 1])."""

    def __init__(self, obj: meshutils.Object3D, intrinsic):
        self.intrinsic = np.asarray(intrinsic, dtype=np.float32)[:3, :3]
        self.obj = obj
        self.extrinsic: Optional[np.ndarray] = None
        # lights: list of (position (3,), color (3,), intensity)
        self.lights = []
        self.ambient = 0.1
        self.specular = 0.0
        self.roughness = 1.0
        # The object's meshes merged into one buffer, built at the first
        # render and kept for the views of an item; invalidate_cache() after
        # changing the geometry or the materials after a render.
        self._geom_cache = None

    def invalidate_cache(self) -> None:
        self._geom_cache = None

    def merged_geometry(self):
        """(vertices, faces, colors, normals, uvs, texture, uv_scale) over
        the object's meshes, cached."""
        if self._geom_cache is not None:
            return self._geom_cache
        meshes = self.obj.meshes
        vertices = np.concatenate([m.vertices for m in meshes])
        faces, colors, normals, uvs = [], [], [], []
        offset = 0
        has_colors = all(m.vertex_colors is not None for m in meshes)
        has_uvs = all(m.uvs is not None for m in meshes)
        for m in meshes:
            faces.append(m.faces + offset)
            normals.append(m.vertex_normals)
            if has_colors:
                colors.append(m.vertex_colors)
            if has_uvs:
                uvs.append(m.uvs)
            offset += len(m.vertices)
        self._geom_cache = (
            np.ascontiguousarray(vertices, dtype=np.float32),
            np.ascontiguousarray(np.concatenate(faces), dtype=np.int32),
            (np.ascontiguousarray(np.concatenate(colors), dtype=np.float32)
             if has_colors else None),
            np.ascontiguousarray(np.concatenate(normals), dtype=np.float32),
            (np.ascontiguousarray(np.concatenate(uvs), dtype=np.float32)
             if has_uvs else None),
            meshes[0].texture if has_uvs else None,
            meshes[0].uv_scale,
        )
        return self._geom_cache

    @property
    def shininess(self) -> float:
        """Roughness -> Blinn-Phong exponent (2 / r^4 - 2, clamped)."""
        r = max(float(self.roughness), 0.05)
        return float(np.clip(2.0 / r ** 4 - 2.0, 1.0, 4096.0))

    @property
    def object_quaternion(self) -> torch.Tensor:
        return three.extrinsic_to_quat(torch.from_numpy(self.extrinsic))

    @property
    def object_translation(self) -> torch.Tensor:
        return torch.from_numpy(self.extrinsic[:3, 3].copy())

    def randomize_lights(self, min_lights, max_lights, min_dist=1.5,
                         max_dist=3.0, min_intensity=1.2, max_intensity=20.0,
                         random_color=True):
        """Between ``min_lights`` and ``max_lights`` point lights at random
        directions and distances (``random`` and ``np.random`` draws, in the
        JAX package's order)."""
        num_lights = random.randint(min_lights, max_lights)
        self.lights = []
        for _ in range(num_lights):
            intensity = random.uniform(min_intensity, max_intensity)
            color = (np.random.uniform(0.2, 1.0, 3) if random_color
                     else np.ones(3))
            position = np.random.randn(3)
            position = (random.uniform(min_dist, max_dist)
                        * position / np.linalg.norm(position))
            self.lights.append((position.astype(np.float32),
                                color.astype(np.float32), float(intensity)))

    def set_pose(self, translation, quaternion, frame="default"):
        translation = np.asarray(translation, dtype=np.float32).reshape(-1)
        quaternion = np.asarray(quaternion, dtype=np.float32).reshape(-1)
        if frame == "realsense":
            quaternion = host.qmul(quaternion, _canon_quat_realsense())
        self.set_pose_from_extrinsic(host.to_extrinsic_matrix(translation, quaternion))

    def set_pose_from_extrinsic(self, extrinsic, frame="default"):
        extrinsic = np.asarray(extrinsic, dtype=np.float32)
        if frame == "realsense":
            canon = np.eye(4, dtype=np.float32)
            canon[:3, :3] = CANON_POSE_REALSENSE
            extrinsic = extrinsic @ canon
        self.extrinsic = extrinsic

    def set_intrinsic(self, intrinsic):
        self.intrinsic = np.asarray(intrinsic, dtype=np.float32)[:3, :3]


class Renderer:
    """Renders a ``SceneContext`` at ``width`` x ``height``; ``plain`` uses
    the numpy rasterizer."""

    def __init__(self, width, height, plain: bool = False):
        self.width = width
        self.height = height
        self.plain = plain

    def render(self, context: SceneContext) -> Tuple:
        """(color (H, W, 3), depth (H, W), mask (H, W)) float32 numpy of the
        object at the context's pose; the first mesh's material serves all."""
        (vertices, faces, colors, normals, uvs, texture,
         uv_scale) = context.merged_geometry()
        lights = context.lights
        return rasterizer.rasterize(
            vertices, faces, context.extrinsic, context.intrinsic,
            self.width, self.height,
            vertex_colors=colors, vertex_normals=normals,
            uvs=uvs, texture=texture, uv_scale=uv_scale,
            light_pos=np.stack([l[0] for l in lights]) if lights else None,
            light_color=np.stack([l[1] for l in lights]) if lights else None,
            light_intensity=np.asarray([l[2] for l in lights],
                                       dtype=np.float32) if lights else None,
            ambient=context.ambient, specular=context.specular,
            shininess=context.shininess, plain=self.plain)
