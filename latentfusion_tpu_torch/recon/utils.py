"""Reconstruction helpers (counterpart of ``latentfusion_tpu/recon/utils.py``):
voxel and pixel coordinate grids, the depth mask, and ``process_batch``,
which turns a raw training batch into the zoomed, normalized views the
networks take.

The JAX package's channels-last layout policy is not ported:
``get_normalized_voxel_depth`` takes NCDHW only.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional

import torch

from ..augment import gan_normalize
from ..camera import Camera
from ..three import quaternion
from ..three.batchview import b2bv, bv2b


def optimal_camera_dist(focal_length: float, size: float, radius: float,
                        slack: float = 1.5) -> float:
    """The camera distance at which a sphere of ``radius`` fills a
    ``size``-pixel frame of focal length ``focal_length``, plus ``slack``."""
    theta = math.atan2(size / 2.0, focal_length)
    h = radius * math.cos(theta)
    x = h / math.sin(theta)
    d = math.sqrt(x ** 2 + radius ** 2
                  - 2 * x * radius * math.cos(math.pi / 2.0 - theta))
    return d + slack


def _linspaces(sizes, device):
    return [torch.linspace(-1.0, 1.0, s, device=device) for s in sizes]


def get_normalized_voxel_coords(tensor: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) -> (B, 3, D, H, W) coords in [-1, 1], stacked (z, y, x)."""
    lin = _linspaces(tensor.shape[-3:], tensor.device)
    coords = torch.stack(torch.meshgrid(*lin, indexing="ij"), dim=0)
    return coords[None].expand(tensor.shape[0], -1, -1, -1, -1)


def get_normalized_pixel_coords(tensor: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 2, H, W) coords in [-1, 1], stacked (y, x)."""
    lin = _linspaces(tensor.shape[-2:], tensor.device)
    coords = torch.stack(torch.meshgrid(*lin, indexing="ij"), dim=0)
    return coords[None].expand(tensor.shape[0], -1, -1, -1)


def get_normalized_voxel_depth(tensor: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) -> (B, 1, D, H, W): the z coordinate in [-1, 1]."""
    b, _, d, h, w = tensor.shape
    z = torch.linspace(-1.0, 1.0, d, device=tensor.device).reshape(1, 1, d, 1, 1)
    return z.expand(b, 1, d, h, w)


def mask_normalized_depth(depth: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Normalized depth in [-1, 1] with the background (mask 0) set to -1."""
    return ((depth / 2.0 + 0.5) * mask) * 2.0 - 1.0


def _process_group(group: Mapping[str, torch.Tensor],
                   rotation: Optional[torch.Tensor], cube_size: float,
                   camera_dist: float, input_size: int, is_gt: bool) -> dict:
    """One group of (B, V) full-frame views -> zoomed ``image`` (B, V, 3, s,
    s) in [-1, 1], ``mask``, ``depth`` (normalized to the zoomed camera's
    window) and ``camera`` (length B*V), each camera first rotated by
    ``rotation``. Ground-truth groups also mask the image and the depth."""
    batch_size = group["mask"].shape[0]
    extrinsic = bv2b(group["extrinsic"])
    intrinsic = bv2b(group["intrinsic"])
    mask = bv2b(group["mask"][:, :, None].float())
    image = bv2b(gan_normalize(group["render"]))
    depth = bv2b(group["depth"][:, :, None]) if "depth" in group else None

    camera = Camera(intrinsic, extrinsic, z_span=cube_size / 2.0,
                    height=image.shape[2], width=image.shape[3],
                    device=image.device)
    if rotation is not None:
        camera = camera.rotate(rotation.expand(camera.length, 4))

    out = {}
    out["image"], zoom_camera = camera.zoom(image, input_size, camera_dist,
                                            scale_mode="bilinear")
    out["camera"] = zoom_camera
    out["mask"] = camera.zoom(mask, input_size, camera_dist, scale_mode="nearest")[0]
    if depth is not None:
        d = camera.zoom(depth, input_size, camera_dist, scale_mode="nearest")[0]
        out["depth"] = zoom_camera.normalize_depth(d)

    if is_gt:
        out["image"] = out["image"] * out["mask"]
        out["depth"] = mask_normalized_depth(out["depth"], out["mask"])

    for k in ("image", "depth", "mask"):
        if k in out:
            out[k] = b2bv(out[k], batch_size=batch_size)
    return out


def process_batch(batch: Mapping[str, Mapping[str, torch.Tensor]],
                  cube_size: float, camera_dist: float, input_size: int,
                  random_orientation: bool = True,
                  generator: Optional[torch.Generator] = None,
                  rotation: Optional[torch.Tensor] = None) -> dict:
    """Zoom every group of a raw training batch (``{name: {render (B, V, 3,
    H, W) in [0, 1], mask (B, V, H, W), depth (B, V, H, W) metric,
    extrinsic (B, V, 4, 4), intrinsic (B, V, 3, 4)}}``) to the canonical
    camera. With ``random_orientation`` every camera of the batch is first
    rotated by one random quaternion: ``rotation`` (1, 4) if given, else a
    draw from ``generator``. Groups whose name contains ``gt`` are ground
    truth."""
    if not random_orientation:
        rotation = None
    elif rotation is None:
        if generator is None:
            raise ValueError("a generator or a rotation is required for "
                             "random_orientation")
        rotation = quaternion.random(1, generator)
    if rotation is not None:
        rotation = rotation.to(next(iter(batch.values()))["mask"].device)
    return {k: _process_group(v, rotation, cube_size, camera_dist, input_size,
                              is_gt="gt" in k)
            for k, v in batch.items()}
