"""Volume <-> camera-frustum resampling (counterpart of
``latentfusion_tpu/transforms.py``).

Conventions kept from the reference, which trained checkpoints depend on:

- the object cube spans ``[-cube_size/2, cube_size/2]``, meshgrid order
  (z, y, x) stacked as (x, y, z);
- camera -> object: the grid z coordinate is ``(z - znear) / (zfar - znear)``,
  in [0, 1] rather than [-1, 1];
- object -> camera: frustum voxel z spans ``[znear, znear + z_span]``, half
  the window (``Camera.camera_coords``).

Both transforms sample through ``_volume_sample``. Its backend is
``"hopper"`` (the default: kernels K1-fwd and K1-bwd-grid,
``ops/fused_sample.py``, for every shape on a CUDA tensor) or ``"torch"``
(K1's plain PyTorch forward, under autograd).
"""
from __future__ import annotations

import contextlib

import torch

from .camera import Camera
from .dtypes import get_compute_dtype
from .ops.fused_sample import grid_sample_3d, grid_sample_3d_plain

_BACKENDS = ("hopper", "torch")
_VOLUME_SAMPLE_BACKEND = "hopper"


def set_volume_sample_backend(name: str) -> None:
    """Select the 3D sampler: ``"hopper"`` or ``"torch"``."""
    global _VOLUME_SAMPLE_BACKEND
    if name not in _BACKENDS:
        raise ValueError(name)
    _VOLUME_SAMPLE_BACKEND = name


@contextlib.contextmanager
def volume_sample_backend(name: str):
    prev = _VOLUME_SAMPLE_BACKEND
    set_volume_sample_backend(name)
    try:
        yield
    finally:
        set_volume_sample_backend(prev)


def _volume_sample(volume: torch.Tensor, grid: torch.Tensor,
                   padding_mode: str) -> torch.Tensor:
    """volume (NV, C, D, H, W) with NV | len(grid); grid (N, D, H, W, 3)."""
    if _VOLUME_SAMPLE_BACKEND == "torch":
        dtype = get_compute_dtype()
        return grid_sample_3d_plain(volume.to(dtype), grid, padding_mode, dtype)
    return grid_sample_3d(volume, grid, padding_mode)


def get_obj_coords(cube_size: float, size: int, device) -> torch.Tensor:
    """Homogeneous object-cube voxel coordinates, (size^3, 4)."""
    lin = torch.linspace(-cube_size / 2, cube_size / 2, size, device=device)
    z, y, x = torch.meshgrid(lin, lin, lin, indexing="ij")
    return torch.stack((x, y, z, torch.ones_like(x)), dim=-1).reshape(-1, 4)


def camera_to_object_grid(camera: Camera, size: int,
                          cube_size: float = 1.0) -> torch.Tensor:
    """(B, S, S, S, 3) grid that samples a camera-frustum volume at the
    object cube's voxels: x, y in the viewport's [-1, 1], z in [0, 1]."""
    obj_coords = get_obj_coords(cube_size, size, camera.device)
    cam_coords = camera.obj_to_cam @ obj_coords.T[None]
    # x, y become pixel coords (perspective divided); z stays camera depth.
    pixel_coords = camera.intrinsic @ cam_coords
    xy = pixel_coords[:, :2] / pixel_coords[:, 2:3]
    z = pixel_coords[:, 2]
    znear = camera.znear[:, None]
    zfar = camera.zfar[:, None]
    grid = torch.stack((
        (xy[:, 0] - camera.viewport[:, 0, None]) / camera.viewport_width[:, None] * 2 - 1,
        (xy[:, 1] - camera.viewport[:, 1, None]) / camera.viewport_height[:, None] * 2 - 1,
        (z - znear) / (zfar - znear),
    ), dim=-1)
    return grid.reshape(-1, size, size, size, 3).contiguous()


def object_to_camera_grid(camera: Camera, size: int,
                          cube_size: float = 1.0) -> torch.Tensor:
    """(N, S, S, S, 3) grid that samples the object cube at the frustum
    voxel centers of each camera."""
    x_cam, y_cam, z_cam = camera.camera_coords(size)
    cam_coords = torch.stack((x_cam, y_cam, z_cam, torch.ones_like(x_cam)),
                             dim=-1).reshape(camera.length, -1, 4)
    obj_coords = camera.cam_to_obj @ cam_coords.transpose(2, 1)
    grid = obj_coords[:, :3].transpose(1, 2) / (cube_size / 2)
    return grid.reshape(-1, size, size, size, 3).contiguous()


def camera_to_object(cam_volume: torch.Tensor, camera: Camera,
                     cube_size: float = 1.0,
                     padding_mode: str = "border") -> torch.Tensor:
    """Unproject (B, C, S, S, S) camera-frustum features onto the object
    cube; returns (B, C, S, S, S)."""
    grid = camera_to_object_grid(camera, cam_volume.shape[-1], cube_size)
    return _volume_sample(cam_volume, grid, padding_mode)


def object_to_camera(obj_volume: torch.Tensor, camera: Camera,
                     cube_size: float = 1.0,
                     padding_mode: str = "border") -> torch.Tensor:
    """Sample the (NV, C, S, S, S) object cube at the frustum voxel centers
    of ``camera`` (NV | len(camera)); returns (len(camera), C, S, S, S).
    A shared latent (NV = 1) is read in place for every camera."""
    grid = object_to_camera_grid(camera, obj_volume.shape[-1], cube_size)
    return _volume_sample(obj_volume, grid, padding_mode)
