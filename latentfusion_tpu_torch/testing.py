"""An analytic ellipsoid renderer that stands in for ``LatentFusionModel``
in the estimators' tests and accuracy rigs (counterpart of the ellipsoid
half of ``latentfusion_tpu/testing.py``). Closed-form ray casting, so the
renders are exact and differentiable with respect to the camera.

``render_training_batch`` renders raw training batches of random
ellipsoids, in the layout ``recon.utils.process_batch`` takes, for training
without a mesh dataset. ``convs_perturbed`` measures a gradient's noise
floor."""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from . import three
from .camera import Camera
from .device import resolve_device
from .modules.equalized import EqualizedConv
from .observation import Observation
from .three import quaternion as quat

MASK_SHARPNESS = 400.0  # soft-mask logits per unit of the ray's discriminant
# Training batches: the mesh dataset's camera bounds (x_bound and z_bound of
# SyntheticDataset, latentfusion_tpu/data/synthetic.py:188), and semi-axes
# near half of its object sizes (size_jitter (0.5, 1.0), :189).
X_BOUND = (-0.5, 0.5)
Z_BOUND = (1.5, 3.0)
AXES_RANGE = (0.2, 0.45)


def _rays(camera: Camera, out_size):
    """Per-pixel rays in object space: origins (N, 1, 1, 3) and directions
    (N, h, w, 3) whose camera-frame z is 1, so the ray parameter is the
    camera-frame depth."""
    u, v = camera.pixel_coords_uv(out_size)
    dx = (u - camera.u0.reshape(-1, 1, 1)) / camera.fu.reshape(-1, 1, 1)
    dy = (v - camera.v0.reshape(-1, 1, 1)) / camera.fv.reshape(-1, 1, 1)
    d_cam = torch.stack((dx, dy, torch.ones_like(dx)), dim=-1)
    R = camera.rotation_matrix[:, :3, :3]
    d_obj = torch.einsum("nji,nhwj->nhwi", R, d_cam)  # R^T d
    return camera.position[:, None, None, :], d_obj


def _intersect(camera: Camera, out_size, axes):
    """Discriminant and nearest ray parameter of each pixel's ray against
    the ellipsoid with semi-axes ``axes`` centred at the object origin."""
    o_obj, d_obj = _rays(camera, out_size)
    inv_axes = 1.0 / torch.tensor(axes, dtype=torch.float32, device=camera.device)
    ds = d_obj * inv_axes
    os_ = o_obj * inv_axes
    a = (ds ** 2).sum(-1)
    b = 2.0 * (os_ * ds).sum(-1)
    c = (os_ ** 2).sum(-1) - 1.0
    disc = b ** 2 - 4 * a * c
    t = (-b - torch.sqrt(disc.clamp_min(1e-12))) / (2 * a)
    return disc, t


def render_ellipsoid(camera: Camera, size: int, axes=(0.15, 0.25, 0.35)):
    """Render ``size``² views of the camera viewports. Returns (metric
    depth (N, 1, h, w), 0 at misses; a soft mask; its logits)."""
    disc, t = _intersect(camera, size, axes)
    depth = torch.where(disc > 0, t, 0.0)[:, None]
    mask_logits = (disc * MASK_SHARPNESS)[:, None]
    return depth, torch.sigmoid(mask_logits), mask_logits


def render_ellipsoid_full(camera: Camera, axes=(0.15, 0.25, 0.35)):
    """Full-frame (height, width) render. Returns (metric depth, a hard
    mask)."""
    disc, t = _intersect(camera, (camera.height, camera.width), axes)
    hit = disc > 0
    return torch.where(hit, t, 0.0)[:, None], hit.float()[:, None]


def render_ellipsoid_color(camera: Camera, depth, mask, axes=(0.15, 0.25, 0.35)):
    """Procedurally textured, headlight-lit color (N, 3, h, w) of a full-frame
    render: the texture is a function of the object-frame hit point, so the
    color tells orientations apart."""
    u, v = camera.pixel_coords_uv((camera.height, camera.width))
    z = depth[:, 0]
    p_cam = torch.stack(((u - camera.u0.reshape(-1, 1, 1)) / camera.fu.reshape(-1, 1, 1) * z,
                         (v - camera.v0.reshape(-1, 1, 1)) / camera.fv.reshape(-1, 1, 1) * z,
                         z), dim=-1)
    R = camera.rotation_matrix[:, :3, :3]
    position = camera.position[:, None, None, :]
    p_obj = torch.einsum("nji,nhwj->nhwi", R, p_cam) + position
    axes_t = torch.tensor(axes, dtype=torch.float32, device=camera.device)
    n_obj = p_obj / axes_t ** 2
    n_obj = n_obj / torch.linalg.norm(n_obj, dim=-1, keepdim=True).clamp_min(1e-6)
    view = position - p_obj
    view = view / torch.linalg.norm(view, dim=-1, keepdim=True).clamp_min(1e-6)
    lambert = (n_obj * view).sum(-1).clamp(0.0, 1.0)
    phases = torch.tensor((0.0, 2.1, 4.2), device=camera.device)
    tex = 0.55 + 0.45 * torch.sin(9.0 * p_obj.sum(-1)[..., None] + phases)
    shade = (0.25 + 0.75 * lambert)[..., None] * tex
    return shade.permute(0, 3, 1, 2) * mask


class EllipsoidOracleModel:
    """The model interface the estimators use (``input_size``,
    ``camera_dist``, ``device``, ``decode_latent``, ``compute_latent_code``),
    rendering the analytic ellipsoid; the latent is ignored."""

    def __init__(self, input_size: int = 64, camera_dist: float = 3.90625,
                 axes=(0.15, 0.25, 0.35), device="cuda"):
        self.input_size = input_size
        self.camera_dist = camera_dist
        self.axes = axes
        self.device = resolve_device(device)

    def decode_latent(self, z_obj, camera: Camera, return_latent: bool = True,
                      apply_mask: bool = False):
        """Renders at the (zoomed) cameras in ``LatentFusionModel.decode_latent``'s
        contract: normalized depth, -1 off the object."""
        depth_metric, mask, mask_logits = render_ellipsoid(
            camera, self.input_size, self.axes)
        depth = torch.where(mask > 0.5, camera.normalize_depth(depth_metric), -1.0)
        y = {"depth": depth[None], "mask": mask[None], "mask_logits": mask_logits[None]}
        z_lat = (torch.zeros(1, camera.length, 1, device=camera.device)
                 if return_latent else None)
        return y, z_lat

    def compute_latent_code(self, observation: Observation, camera: Camera) -> torch.Tensor:
        """The oracle has no latent: zeros (N, 1), like ``decode_latent``'s."""
        return torch.zeros(camera.length, 1, device=camera.device)

    def make_observation(self, camera: Camera, shaded: bool = False) -> Observation:
        """The ground-truth full-frame observation: shaded color, or the
        silhouette in all three channels."""
        depth, mask = render_ellipsoid_full(camera, self.axes)
        if shaded:
            color = render_ellipsoid_color(camera, depth, mask, self.axes)
        else:
            color = mask.expand(camera.length, 3, camera.height, camera.width)
        return Observation(color, depth, (mask > 0.5).float(), camera)


def make_camera(n: int = 1, z: float = 3.90625, f: float = 250.0,
                width: int = 320, height: int = 240,
                quats: Optional[torch.Tensor] = None, device="cuda") -> Camera:
    """Cameras at (0, 0, z) with focal length ``f``: with ``f = 250`` and the
    oracle's ``input_size = 64``, ``camera_dist = f / input_size`` makes the
    zoom box cover one object unit. Identity rotations unless ``quats``."""
    device = resolve_device(device)
    intrinsic = torch.tensor([[f, 0.0, width / 2], [0.0, f, height / 2],
                              [0.0, 0.0, 1.0]], device=device).repeat(n, 1, 1)
    if quats is None:
        quats = quat.identity(n, device=device)
    trans = torch.tensor([[0.0, 0.0, z]], device=device).repeat(n, 1)
    return Camera(intrinsic, three.to_extrinsic_matrix(trans, quats.to(device)),
                  width=width, height=height, device=device)


def render_training_batch(generator: torch.Generator, batch_size: int,
                          num_input_views: int, num_output_views: int,
                          width: int = 640, height: int = 480,
                          device="cuda") -> dict:
    """A raw training batch of ``batch_size`` ellipsoids, each with semi-axes
    drawn uniformly from ``AXES_RANGE``, seen by ``num_input_views +
    num_output_views`` full-frame cameras (f = 615 at 640 pixels wide):
    uniform random rotations, the object at x in ``X_BOUND``, y in its
    share of the frame's height, and depth in ``Z_BOUND``, as the mesh
    dataset draws its cameras. Returns groups ``in`` and ``in_gt`` (the same input views)
    and ``out_gt``, each ``{render (B, V, 3, H, W) shaded in [0, 1], mask
    (B, V, H, W), depth (B, V, H, W) metric with 0 off the object,
    extrinsic (B, V, 4, 4), intrinsic (B, V, 3, 4)}``. Every draw comes from
    ``generator``; the renders are made on ``device``."""
    device = resolve_device(device)
    gdev = generator.device
    views = num_input_views + num_output_views
    n = batch_size * views

    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=gdev)
        return (lo + u * (hi - lo)).to(device)

    axes = uniform((batch_size, 3), *AXES_RANGE)
    quats = quat.random(n, generator).to(device)
    y_bound = (X_BOUND[0] * height / width, X_BOUND[1] * height / width)
    trans = torch.stack((uniform(n, *X_BOUND), uniform(n, *y_bound),
                         uniform(n, *Z_BOUND)), dim=-1)
    f = 615.0 * width / 640.0
    intrinsic = torch.tensor([[f, 0.0, width / 2, 0.0], [0.0, f, height / 2, 0.0],
                              [0.0, 0.0, 1.0, 0.0]], device=device).expand(n, 3, 4)
    camera = Camera(intrinsic, three.to_extrinsic_matrix(trans, quats),
                    width=width, height=height, device=device)
    renders, depths, masks = [], [], []
    for b, obj_axes in enumerate(axes.tolist()):
        cam = camera[b * views:(b + 1) * views]
        depth, mask = render_ellipsoid_full(cam, obj_axes)
        renders.append(render_ellipsoid_color(cam, depth, mask, obj_axes))
        depths.append(depth[:, 0])
        masks.append(mask[:, 0])
    full = {"render": torch.stack(renders), "depth": torch.stack(depths),
            "mask": torch.stack(masks),
            "extrinsic": camera.extrinsic.reshape(batch_size, views, 4, 4),
            "intrinsic": intrinsic.reshape(batch_size, views, 3, 4)}
    inputs = {k: v[:, :num_input_views] for k, v in full.items()}
    return {"in": inputs, "in_gt": dict(inputs),
            "out_gt": {k: v[:, num_input_views:] for k, v in full.items()}}


@contextlib.contextmanager
def convs_perturbed(network: nn.Module, eps: float, seed: int):
    """Inside, every convolution of ``network`` multiplies its output by
    (1 + eps N(0, 1)) (forward hooks; one generator per device, seeded with
    ``seed``). Each K2 takes a convolution's output and normalizes it, so
    its output moves by about eps relative too."""
    gens = {}

    def hook(_module, _inputs, y):
        g = gens.setdefault(y.device, torch.Generator(device=y.device).manual_seed(seed))
        return y * (1 + eps * torch.randn(y.shape, generator=g, device=y.device))

    handles = [m.register_forward_hook(hook) for m in network.modules()
               if isinstance(m, EqualizedConv)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()
