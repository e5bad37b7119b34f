"""Batched pinhole camera as a tensor class (counterpart of
``latentfusion_tpu/camera.py``).

Pose is stored as the reference parameterization: ``log_quaternion`` (the
imaginary part of the log of a unit quaternion) plus ``translation``.
Methods return new cameras; none mutates its inputs.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import three
from .device import resolve_device
from .ops.affine_resample import bbox_source_coords, separable_resample_2d
from .three import quaternion as quat


def _as_tensor(value, device) -> torch.Tensor:
    """fp32 tensor on ``device``. A tensor that already is one is returned
    as it is, so a pose leaf that requires a gradient stays in the graph."""
    return torch.as_tensor(value, dtype=torch.float32, device=device)


class Camera:
    """Batched pinhole camera.

    Tensors: ``intrinsic`` (B, 3, 4), ``viewport`` (B, 4) as
    (xmin, ymin, xmax, ymax), ``log_quaternion`` (B, 3), ``translation``
    (B, 3). Scalars: ``z_span``, ``width``, ``height``.
    """

    def __init__(self, intrinsic, extrinsic=None, z_span=0.5, viewport=None,
                 width=640, height=480, log_quaternion=None,
                 translation=None, device="cuda"):
        device = resolve_device(device)
        intrinsic = _as_tensor(intrinsic, device)
        if intrinsic.dim() == 2:
            intrinsic = intrinsic[None]
        if intrinsic.shape[1:] == (3, 3):
            intrinsic = three.intrinsic_to_3x4(intrinsic)

        if viewport is None:
            viewport = torch.tensor((0.0, 0.0, width, height), device=device)
            viewport = viewport.expand(intrinsic.shape[0], 4)
        else:
            viewport = _as_tensor(viewport, device)
            if viewport.dim() == 1:
                viewport = viewport[None]

        if extrinsic is not None:
            extrinsic = _as_tensor(extrinsic, device)
            if extrinsic.dim() == 2:
                extrinsic = extrinsic[None]
            translation = extrinsic[:, :3, 3]
            # The real part of the log of a unit quaternion is always 0.
            log_quaternion = quat.qlog(quat.mat_to_quat(extrinsic[:, :3, :3]))[:, 1:]
        if translation is None:
            raise ValueError("translation must be given through extrinsic or explicitly.")
        if log_quaternion is None:
            raise ValueError("log_quaternion must be given through extrinsic or explicitly.")
        translation = _as_tensor(translation, device)
        log_quaternion = _as_tensor(log_quaternion, device)
        if translation.dim() == 1:
            translation = translation[None]
        if log_quaternion.dim() == 1:
            log_quaternion = log_quaternion[None]

        self.intrinsic = intrinsic
        self.viewport = viewport
        self.log_quaternion = log_quaternion
        self.translation = translation
        self.z_span = float(z_span)
        self.width = width
        self.height = height

    def _new(self, intrinsic=None, viewport=None, log_quaternion=None,
             translation=None) -> "Camera":
        return Camera(
            self.intrinsic if intrinsic is None else intrinsic, None,
            self.z_span, self.viewport if viewport is None else viewport,
            width=self.width, height=self.height,
            log_quaternion=(self.log_quaternion if log_quaternion is None
                            else log_quaternion),
            translation=self.translation if translation is None else translation,
            device=self.device)

    _REPLACE_FIELDS = ("intrinsic", "viewport", "log_quaternion",
                       "translation", "z_span", "width", "height")

    def replace(self, **params) -> "Camera":
        """A camera with the given fields swapped in, as they are: nothing
        is converted, so tensors that require a gradient stay in the graph."""
        unknown = set(params) - set(self._REPLACE_FIELDS)
        if unknown:
            # e.g. replace(extrinsic=...): pose lives in log_quaternion and
            # translation.
            raise TypeError(f"Camera.replace: unknown fields {sorted(unknown)}")
        out = object.__new__(Camera)
        for name in self._REPLACE_FIELDS:
            setattr(out, name, params.get(name, getattr(self, name)))
        return out

    # -------------------------------------------------------------- properties
    @property
    def device(self) -> torch.device:
        return self.intrinsic.device

    @property
    def length(self) -> int:
        return self.intrinsic.shape[0]

    def __len__(self):
        return self.length

    @property
    def quaternion(self):
        return quat.qexp(self.log_quaternion)

    @property
    def rotation_matrix(self):
        return three.rotation_to_4x4(quat.quat_to_mat(quat.normalize(self.quaternion)))

    @property
    def translation_matrix(self):
        return three.translation_to_4x4(self.translation)

    @property
    def extrinsic(self):
        return self.translation_matrix @ self.rotation_matrix

    @property
    def obj_to_cam(self):
        return self.extrinsic

    @property
    def cam_to_obj(self):
        return (self.rotation_matrix.transpose(2, 1)
                @ three.translation_to_4x4(-self.translation))

    @property
    def obj_to_image(self):
        return self.intrinsic @ self.obj_to_cam

    @property
    def position(self):
        """Camera center C = -R^T t."""
        R = self.rotation_matrix[:, :3, :3]
        return (-R.transpose(2, 1) @ self.translation[..., None])[..., 0]

    @property
    def viewport_height(self):
        return self.viewport[:, 3] - self.viewport[:, 1]

    @property
    def viewport_width(self):
        return self.viewport[:, 2] - self.viewport[:, 0]

    @property
    def u0(self):
        return self.intrinsic[:, 0, 2]

    @property
    def v0(self):
        return self.intrinsic[:, 1, 2]

    @property
    def fu(self):
        return self.intrinsic[:, 0, 0]

    @property
    def fv(self):
        return self.intrinsic[:, 1, 1]

    @property
    def znear(self):
        return self.translation[:, 2] - self.z_span

    @property
    def zfar(self):
        return self.translation[:, 2] + self.z_span

    # ------------------------------------------------------------- pose edits
    def with_quaternion(self, q) -> "Camera":
        return self.replace(log_quaternion=quat.qlog(q)[:, 1:])

    def rotate(self, q) -> "Camera":
        """Right-multiply the rotation by the quaternions ``q`` (B, 4)."""
        return self.with_quaternion(quat.qmul(self.quaternion, q))

    def translate(self, offset) -> "Camera":
        """Move the camera *center* by ``offset`` in object space.

        The original implementation negates the homogeneous vector before
        dehomogenizing, which cancels the sign; like the JAX package, this
        implements the consistent version: the new center is
        ``position + offset``."""
        offset = _as_tensor(offset, self.device)
        offset, _ = three.ensure_batch_dim(offset, 1)
        position = (self.position + offset.expand_as(self.position))[..., None]
        translation = -(self.rotation_matrix[:, :3, :3] @ position)[..., 0]
        return self._new(translation=translation)

    # -------------------------------------------------------------- crops/zoom
    def uncrop(self, image=None, scale_mode: str = "nearest", scale: float = 1.0):
        """Paste a viewport-cropped image back into the full frame."""
        new_cam = self._new(viewport=torch.tensor(
            (0.0, 0.0, self.width, self.height),
            device=self.device).expand(self.length, 4))
        if image is None:
            return new_cam
        width = int(self.width * scale)
        height = int(self.height * scale)
        viewport = self.viewport * scale
        rows = torch.arange(height, dtype=torch.float32, device=self.device)[None]
        cols = torch.arange(width, dtype=torch.float32, device=self.device)[None]
        h_img, w_img = image.shape[-2], image.shape[-1]
        src_y = ((rows - viewport[:, 1:2])
                 / (self.viewport_height * scale)[:, None] * h_img - 0.5)
        src_x = ((cols - viewport[:, 0:1])
                 / (self.viewport_width * scale)[:, None] * w_img - 0.5)
        return (separable_resample_2d(image, src_y, src_x, mode=scale_mode,
                                      padding_mode="border"), new_cam)

    def zoom(self, image, target_size: int, target_dist, target_fu=None,
             target_fv=None, image_scale: float = 1.0, zs=None,
             centroid_uvs=None, scale_mode: str = "bilinear"):
        """Re-image as if viewed from ``target_dist`` into a
        ``target_size``² frame. Returns ``(image_new, camera_new)``, or just
        ``camera_new`` when ``image`` is None."""
        K = self.intrinsic
        if zs is None:
            zs = self.translation[:, 2]
        fu, fv = K[:, 0, 0], K[:, 1, 1]
        target_fu = fu if target_fu is None else target_fu
        target_fv = fv if target_fv is None else target_fv

        bbox_u = (target_dist * (1.0 / zs) / fu * target_fu * target_size
                  / self.width * image_scale)
        bbox_v = (target_dist * (1.0 / zs) / fv * target_fv * target_size
                  / self.height * image_scale)
        if centroid_uvs is None:
            origin = torch.tensor((0.0, 0.0, 0.0, 1.0), device=self.device)
            uvs = K @ self.obj_to_cam @ origin.reshape(1, 4, 1).expand(self.length, 4, 1)
            centroid_uvs = uvs[:, :2, 0] / uvs[:, 2:, 0]
        center_u = centroid_uvs[:, 0] / self.width
        center_v = centroid_uvs[:, 1] / self.height
        boxes = torch.stack([
            (center_u - bbox_u / 2) * float(self.width),
            (center_v - bbox_v / 2) * float(self.height),
            (center_u + bbox_u / 2) * float(self.width),
            (center_v + bbox_v / 2) * float(self.height),
        ], dim=-1)
        camera_new = self._new(viewport=boxes)
        if image is None:
            return camera_new
        src_y, src_x = bbox_source_coords(boxes, target_size)
        return separable_resample_2d(image, src_y, src_x, mode=scale_mode), camera_new

    # ---------------------------------------------------------------- coords
    def pixel_coords_uv(self, out_size):
        """Viewport meshgrid (u, v) in pixel space, each (B, h, w)."""
        if isinstance(out_size, int):
            out_size = (out_size, out_size)
        v_pixel, u_pixel = torch.meshgrid(
            torch.linspace(0.0, 1.0, out_size[0], device=self.device),
            torch.linspace(0.0, 1.0, out_size[1], device=self.device),
            indexing="ij")
        u_pixel = (u_pixel[None] * self.viewport_width.reshape(-1, 1, 1)
                   + self.viewport[:, 0].reshape(-1, 1, 1))
        v_pixel = (v_pixel[None] * self.viewport_height.reshape(-1, 1, 1)
                   + self.viewport[:, 1].reshape(-1, 1, 1))
        return u_pixel, v_pixel

    def pixel_coords_uvz(self, out_size):
        """Viewport-frustum meshgrid in pixel space. The z axis covers
        ``[znear, znear + z_span]``, half of the depth window, as trained
        checkpoints expect."""
        if isinstance(out_size, int):
            out_size = (out_size,) * 3
        lin = [torch.linspace(0.0, 1.0, s, device=self.device) for s in out_size]
        z_pixel, v_pixel, u_pixel = torch.meshgrid(*lin, indexing="ij")
        vp = self.viewport.reshape(-1, 4, 1, 1, 1)
        u_pixel = u_pixel[None] * self.viewport_width.reshape(-1, 1, 1, 1) + vp[:, 0]
        v_pixel = v_pixel[None] * self.viewport_height.reshape(-1, 1, 1, 1) + vp[:, 1]
        z_pixel = z_pixel[None] * self.z_span + self.znear.reshape(-1, 1, 1, 1)
        return u_pixel, v_pixel, z_pixel

    def camera_coords(self, out_size):
        """Frustum voxel centers in camera space."""
        u_pixel, v_pixel, z_cam = self.pixel_coords_uvz(out_size)
        y_cam = (v_pixel - self.v0.reshape(-1, 1, 1, 1)) / self.fv.reshape(-1, 1, 1, 1) * z_cam
        x_cam = (u_pixel - self.u0.reshape(-1, 1, 1, 1)) / self.fu.reshape(-1, 1, 1, 1) * z_cam
        return x_cam, y_cam, z_cam

    # ----------------------------------------------------------- depth window
    def denormalize_depth(self, depth, eps: float = 0.01):
        """[-1, 1] window depth -> metric depth."""
        lead = depth.shape[:-3]
        znear = (self.znear - eps).reshape(*lead, 1, 1, 1)
        zfar = (self.zfar + eps).reshape(*lead, 1, 1, 1)
        return (depth / 2.0 + 0.5) * (zfar - znear) + znear

    def normalize_depth(self, depth, eps: float = 0.01):
        """Metric depth -> clamped [-1, 1] window depth."""
        znear = (self.znear - eps).reshape(-1, 1, 1, 1)
        zfar = (self.zfar + eps).reshape(-1, 1, 1, 1)
        return ((depth - znear) / (zfar - znear)).clamp(0, 1) * 2.0 - 1.0

    # ------------------------------------------------------------- containers
    @classmethod
    def cat(cls, cameras: Sequence["Camera"]) -> "Camera":
        first = cameras[0]
        return cls(torch.cat([c.intrinsic for c in cameras]), None, first.z_span,
                   torch.cat([c.viewport for c in cameras]),
                   width=first.width, height=first.height,
                   log_quaternion=torch.cat([c.log_quaternion for c in cameras]),
                   translation=torch.cat([c.translation for c in cameras]),
                   device=first.device)

    def __getitem__(self, item) -> "Camera":
        if isinstance(item, int):
            item = slice(item, item + 1) if item != -1 else slice(-1, None)
        return Camera(self.intrinsic[item], None, self.z_span,
                      self.viewport[item], width=self.width,
                      height=self.height,
                      log_quaternion=self.log_quaternion[item],
                      translation=self.translation[item], device=self.device)

    def repeat(self, n: int) -> "Camera":
        return self._new(intrinsic=self.intrinsic.repeat(n, 1, 1),
                         viewport=self.viewport.repeat(n, 1),
                         log_quaternion=self.log_quaternion.repeat(n, 1),
                         translation=self.translation.repeat(n, 1))

    def repeat_interleave(self, n: int) -> "Camera":
        """Each camera ``n`` times in a row: (c0, c0, ..., c1, c1, ...)."""
        return self._new(intrinsic=self.intrinsic.repeat_interleave(n, dim=0),
                         viewport=self.viewport.repeat_interleave(n, dim=0),
                         log_quaternion=self.log_quaternion.repeat_interleave(n, dim=0),
                         translation=self.translation.repeat_interleave(n, dim=0))

    def __repr__(self):
        return f"Camera(count={self.length}, device={self.device})"
