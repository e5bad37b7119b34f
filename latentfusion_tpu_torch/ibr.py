"""Image-based rendering: input views warped into output views through
predicted depth, then blended (counterpart of ``latentfusion_tpu/ibr.py``).

Image tensors are (B, V, C, H, W) per object batch and cameras are
object-major (B*V). As in the original, ``reproject_views`` back-projects
the input views' *normalised* depth as if it were metric to make the
reprojected-depth feature; only the warp field uses metric depth.
"""
from __future__ import annotations

import math

import torch

from . import three
from .camera import Camera
from .distances import outer_distance
from .ops.grid_sample import grid_sample_2d
from .three.batchview import b2bv, bv2b


def depth_to_warp_field(source_cam: Camera, target_cam: Camera,
                        target_depth: torch.Tensor) -> torch.Tensor:
    """Sampling grids (V_o, V_i, H, W, 2) that take each source view to each
    target view through the target's normalised depth (V_o, 1, H, W); grid
    coordinates are relative to each source viewport."""
    height, width = target_depth.shape[-2:]
    xx, yy, zz = target_cam.depth_camera_coords(target_cam.denormalize_depth(target_depth))
    cam_coords = three.grid_to_coords(torch.stack((xx, yy, zz), dim=-1))
    obj_coords = three.transform_coords(cam_coords, target_cam.cam_to_obj)
    n_out, n_in = target_cam.length, source_cam.length
    obj_coords = bv2b(obj_coords[:, None].expand(n_out, n_in, *obj_coords.shape[1:]))
    obj_to_pix = bv2b(source_cam.obj_to_image[None].expand(n_out, n_in, 3, 4))
    pix = three.transform_coords(obj_coords, obj_to_pix)
    viewport = source_cam.viewport.repeat(n_out, 1)
    vp_width = viewport[:, 2] - viewport[:, 0]
    vp_height = viewport[:, 3] - viewport[:, 1]
    grid = torch.stack(
        (((pix[..., 0] - viewport[:, 0, None]) / vp_width[:, None]) * 2 - 1,
         ((pix[..., 1] - viewport[:, 1, None]) / vp_height[:, None]) * 2 - 1), dim=-1)
    return grid.reshape(n_out, n_in, height, width, 2)


def reproject_views(image_in: torch.Tensor, depth_in: torch.Tensor,
                    depth_out: torch.Tensor, camera_in: Camera, camera_out: Camera):
    """Input views (V_i, C, H, W) with normalised depth (V_i, 1, H, W) into
    the output views of normalised depth (V_o, 1, H, W). Returns the image
    (V_o, V_i, C, H, W) and the input depth seen from each output camera,
    normalised to its window (V_o, V_i, 1, H, W)."""
    n_out, n_in = camera_out.length, camera_in.length
    grid = bv2b(depth_to_warp_field(camera_in, camera_out, depth_out))
    image_in_b = bv2b(image_in[None].expand(n_out, *image_in.shape))
    obj_coords_in = torch.stack(camera_in.depth_object_coords(depth_in), dim=-1)
    obj_coords_in = bv2b(obj_coords_in[None].expand(n_out, *obj_coords_in.shape))
    camera_out_rep = camera_out.repeat_interleave(n_in)
    cam_coords = three.transform_coord_grid(obj_coords_in, camera_out_rep.obj_to_cam)
    depth_in_tf = camera_out_rep.normalize_depth(cam_coords[..., 2][:, None])
    image_reproj = grid_sample_2d(image_in_b, grid, mode="bilinear")
    depth_reproj = grid_sample_2d(depth_in_tf, grid, mode="bilinear")
    return b2bv(image_reproj, n_in), b2bv(depth_reproj, n_in)


def _split_cameras(camera: Camera, num_objects: int, i: int) -> Camera:
    n = camera.length // num_objects
    return camera[i * n:(i + 1) * n]


def reproject_views_batch(image_in, depth_in, depth_out, camera_in: Camera,
                          camera_out: Camera):
    """``reproject_views`` for each object of (B, V_i, C, H, W). Returns the
    stacked images and depths and the (B, V_o, V_i) rotation distances
    (angle over pi, eps 1e-2) and position distances (cosine over 2)."""
    images, depths, dists_r, dists_t = [], [], [], []
    for i in range(image_in.shape[0]):
        cam_in = _split_cameras(camera_in, image_in.shape[0], i)
        cam_out = _split_cameras(camera_out, image_in.shape[0], i)
        dists_r.append(three.quaternion.angular_distance(
            cam_out.quaternion, cam_in.quaternion, eps=1e-2) / math.pi)
        dists_t.append(outer_distance(cam_out.position, cam_in.position,
                                      metric="cosine") / 2.0)
        image, depth = reproject_views(image_in[i], depth_in[i], depth_out[i],
                                       cam_in, cam_out)
        images.append(image)
        depths.append(depth)
    return (torch.stack(images), torch.stack(depths), torch.stack(dists_r),
            torch.stack(dists_t))


def _inverse_distance_weights(cam_dists: torch.Tensor, p, eps) -> torch.Tensor:
    w = 1.0 / (cam_dists[..., None, None] ** p).clamp_min(eps)
    return torch.softmax(w, dim=1)


def render_ibr(camera_in: Camera, camera_out: Camera, image_in, depth_fake_in,
               depth_fake_out, p=0.5, weight_type: str = "cam_dist",
               eps: float = 1e-2):
    """Blend each object's reprojected input views (B, V_i, C, H, W) by
    softmax weights of inverse camera distances (``cam_dist``: positions'
    cosine, ``cam_angle``: rotations, ``cam_hybrid``: both) or of inverse
    reprojected-depth error (``depth``, scaled by its largest value).
    Depths are normalised. Returns the blend (B, V_o, C, H, W) and the
    reprojections (B, V_o, V_i, C, H, W)."""
    blends, reprojs = [], []
    num_b = image_in.shape[0]
    for i in range(num_b):
        cam_in = _split_cameras(camera_in, num_b, i)
        cam_out = _split_cameras(camera_out, num_b, i)
        image_reproj, depth_reproj = reproject_views(
            image_in[i], depth_fake_in[i], depth_fake_out[i], cam_in, cam_out)
        reprojs.append(image_reproj)
        if weight_type == "cam_dist":
            cam_dists = outer_distance(cam_out.position, cam_in.position,
                                       metric="cosine", eps=eps) / 2.0
            weights = _inverse_distance_weights(cam_dists, p, eps)
        elif weight_type == "cam_angle":
            cam_dists = three.quaternion.angular_distance(
                cam_out.quaternion, cam_in.quaternion) / math.pi
            weights = _inverse_distance_weights(cam_dists, p, eps)
        elif weight_type == "cam_hybrid":
            dists_t = outer_distance(cam_out.position, cam_in.position,
                                     metric="cosine") / 2.0
            dists_r = three.quaternion.angular_distance(
                cam_out.quaternion, cam_in.quaternion)
            dists_r = (dists_r / (math.pi / 8)).clamp(0.0, 1.0)
            cam_dists = 1.0 - (1.0 - dists_t) * (1.0 - dists_r)
            weights = _inverse_distance_weights(cam_dists, p, eps)
        elif weight_type == "depth":
            depth_diff = (depth_reproj - depth_fake_out[i][:, None]).abs()
            weights = torch.softmax(
                1.0 / ((depth_diff / depth_diff.max()) ** p + eps), dim=1).squeeze(2)
        else:
            raise ValueError(f"Unknown weight_type {weight_type}")
        blends.append((weights[:, :, None] * image_reproj).sum(dim=1))
    return torch.stack(blends), torch.stack(reprojs)


def render_latent_ibr(photographer, z_obj, camera_in: Camera, camera_out: Camera,
                      image_in, p=0.5, weight_type: str = "cam_dist",
                      eps: float = 1e-4):
    """Decode the latent at the input and output cameras and blend the
    input images by ``render_ibr``. Returns (color, depth, mask,
    reprojections) of the output views."""
    from .recon.models import decode

    fake_in = decode(photographer, z_obj, camera_in)[0]
    fake_out = decode(photographer, z_obj, camera_out)[0]
    image_ibr, image_reproj = render_ibr(camera_in, camera_out, image_in,
                                         fake_in["depth"], fake_out["depth"],
                                         p, weight_type, eps)
    return image_ibr, fake_out["depth"], fake_out["mask"], image_reproj


def render_latent_ibr2(photographer, z_obj, camera_in: Camera, camera_out: Camera,
                       image_in, p=0.5, weight_type: str = "cam_dist",
                       return_latent: bool = True, eps: float = 1e-4,
                       apply_mask: bool = False):
    """The decoder's output at ``camera_out`` with its color replaced by
    the ``render_ibr`` blend of ``image_in`` (masked at 0.5 with
    ``apply_mask``). Returns (y, z_2d | None)."""
    from .recon.models import decode

    y_in = decode(photographer, z_obj, camera_in, apply_mask=apply_mask)[0]
    y_out, z_out, _ = decode(photographer, z_obj, camera_out,
                             return_latent=return_latent, apply_mask=apply_mask)
    image_ibr, _ = render_ibr(camera_in, camera_out, image_in, y_in["depth"],
                              y_out["depth"], p, weight_type, eps)
    y_out["color"] = image_ibr * (y_out["mask"] > 0.5) if apply_mask else image_ibr
    return y_out, z_out


def blend_logits(logits: torch.Tensor, image_reproj: torch.Tensor):
    """Softmax blend over views of (N, V, C, H, W) by logits (N, V, H, W)."""
    weights = torch.softmax(logits, dim=1)[:, :, None]
    return (weights * image_reproj).sum(dim=1), weights


def warp_blend_logits(logits: torch.Tensor, image_reproj: torch.Tensor, flow_size):
    """Learned blend with a flow correction of at most ``flow_size`` pixels:
    logits (N, 3V, H, W) are the blend's, then x and y flow's. Returns the
    image (N, C, H, W), the weights and the flows."""
    num_views = image_reproj.shape[1]
    height, width = image_reproj.shape[-2:]
    blend, flow_x_logits, flow_y_logits = torch.split(logits, num_views, dim=1)
    weights = torch.softmax(blend, dim=1)[:, :, None]
    flow_dx = flow_size / width * torch.tanh(flow_x_logits)
    flow_dy = flow_size / height * torch.tanh(flow_y_logits)
    base_y, base_x = torch.meshgrid(
        torch.linspace(-1, 1, height, device=logits.device),
        torch.linspace(-1, 1, width, device=logits.device), indexing="ij")
    flow_grid = torch.stack((base_x[None, None] + flow_dx,
                             base_y[None, None] + flow_dy), dim=-1).clamp(-1, 1)
    image = grid_sample_2d(bv2b(image_reproj), bv2b(flow_grid), mode="bilinear")
    image = (weights * b2bv(image, num_views)).sum(dim=1)
    return image, weights, flow_dx, flow_dy
