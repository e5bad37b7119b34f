"""Analytic objects that stand in for ``LatentFusionModel`` in the
estimators' tests and accuracy rigs (counterpart of
``latentfusion_tpu/testing.py``): the ellipsoid oracle, and the multi-lobe
objects of the unseen-object rig (``sample_lobe_shapes``,
``render_lobe_shape``, ``lobe_shape_color``, ``MultiLobeOracleModel``) and
their meshes for the mesh data path (``lobe_shape_meshes``).
Closed-form ray casting, so the renders are exact and differentiable with
respect to the camera.

``render_training_batch`` renders raw training batches of random
ellipsoids, in the layout ``recon.utils.process_batch`` takes, for training
without a mesh dataset. ``convs_perturbed`` measures a gradient's noise
floor."""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
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

    def build_latent_object(self, observation: Observation) -> torch.Tensor:
        """The oracle has no latent: a (1, 1, 1, 1, 1, 1) zero placeholder."""
        return torch.zeros(1, 1, 1, 1, 1, 1, device=self.device)

    def make_observation(self, camera: Camera, shaded: bool = False) -> Observation:
        """The ground-truth full-frame observation: shaded color, or the
        silhouette in all three channels."""
        depth, mask = render_ellipsoid_full(camera, self.axes)
        if shaded:
            color = render_ellipsoid_color(camera, depth, mask, self.axes)
        else:
            color = mask.expand(camera.length, 3, camera.height, camera.width)
        return Observation(color, depth, (mask > 0.5).float(), camera)


# ---------------------------------------------------------------------------
# Multi-lobe objects: a union of L rotated ellipsoid lobes, one parameter
# dict per object (centers (L, 3), axes (L, 3), rots (L, 3, 3) mapping the
# object frame into each lobe's, tex_phase (3,), tex_freq (), tints (L, 3));
# a pool stacks them along a leading axis.
# ---------------------------------------------------------------------------

def _lobe_ray_hits(o_obj, d_obj, centers, axes, rots):
    """Intersect rays (origins ``o_obj`` (N, 1, 1, 3), directions ``d_obj``
    (N, h, w, 3) with camera-frame z 1, so the ray parameter is the depth)
    with the lobes. Returns (depth (N, h, w), inf at misses; the largest
    lobe discriminant over the ray's quadratic scale, the soft mask's
    signal; the one-hot (N, h, w, L) of the lobe hit first)."""
    o_rel = o_obj[..., None, :] - centers
    o_l = torch.einsum("lij,nhwlj->nhwli", rots, o_rel) / axes
    d_l = torch.einsum("lij,nhwj->nhwli", rots, d_obj) / axes
    a = (d_l ** 2).sum(-1)
    b = 2.0 * (o_l * d_l).sum(-1)
    c = (o_l ** 2).sum(-1) - 1.0
    disc = b ** 2 - 4 * a * c
    t_l = (-b - torch.sqrt(disc.clamp_min(1e-12))) / (2 * a)
    t_l = torch.where((disc > 0) & (t_l > 1e-3), t_l, torch.inf)
    t = t_l.amin(-1)
    lobe_onehot = (t_l == t[..., None]).float()
    disc_max = (disc / a.clamp_min(1e-8)).amax(-1)
    return t, disc_max, lobe_onehot


def render_lobe_shape(camera: Camera, shape: dict, size=None,
                      mask_sharpness: float = MASK_SHARPNESS):
    """Render a multi-lobe object at ``size`` (an int or (h, w); None for
    the full frame). Returns (metric depth (N, 1, h, w), 0 at misses; the
    hard mask; the soft mask's logits; the lobe one-hot (N, h, w, L))."""
    if size is None:
        size = (camera.height, camera.width)
    o_obj, d_obj = _rays(camera, size)
    t, disc_max, lobe_onehot = _lobe_ray_hits(o_obj, d_obj, shape["centers"],
                                              shape["axes"], shape["rots"])
    hit = torch.isfinite(t)
    depth = torch.where(hit, t, 0.0)[:, None]
    return depth, hit.float()[:, None], (disc_max * mask_sharpness)[:, None], lobe_onehot


def lobe_shape_color(camera: Camera, depth, mask, lobe_onehot, shape: dict):
    """Headlight-lit color (N, 3, h, w) of a render: the object's sinusoidal
    texture (``tex_freq``, ``tex_phase``) of the object-frame hit point
    times the hit lobe's tint, so both the object and its orientation show
    in color."""
    o_obj, d_obj = _rays(camera, tuple(depth.shape[-2:]))
    p_obj = o_obj + d_obj * depth[:, 0][..., None]
    # The hit lobe's implicit-surface normal: R^T ((R (p - c)) / a^2).
    p_l = torch.einsum("lij,nhwlj->nhwli", shape["rots"], p_obj[..., None, :] - shape["centers"])
    n_l = torch.einsum("lji,nhwlj->nhwli", shape["rots"], p_l / shape["axes"] ** 2)
    n_obj = (n_l * lobe_onehot[..., None]).sum(-2)
    n_obj = n_obj / torch.linalg.norm(n_obj, dim=-1, keepdim=True).clamp_min(1e-6)
    view = -d_obj / torch.linalg.norm(d_obj, dim=-1, keepdim=True).clamp_min(1e-6)
    lambert = (n_obj * view).sum(-1).clamp(0.0, 1.0)
    tex = 0.55 + 0.45 * torch.sin(shape["tex_freq"] * p_obj.sum(-1)[..., None]
                                  + shape["tex_phase"])
    tint = (shape["tints"] * lobe_onehot[..., None]).sum(-2)
    shade = (0.25 + 0.75 * lambert)[..., None] * tex * tint
    return shade.permute(0, 3, 1, 2) * mask


def _np_quat_to_mat(q):
    """A (w, x, y, z) quaternion's rotation matrix (numpy)."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _fibonacci_sphere(n: int):
    """``n`` evenly distributed unit directions (numpy)."""
    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    return np.stack([np.cos(theta) * np.sin(phi),
                     np.sin(theta) * np.sin(phi), np.cos(phi)], axis=-1)


def sample_lobe_shapes(seed: int, n_shapes: int, max_lobes: int = 4,
                       n_points: int = 512, diameter: float = 1.0, device="cuda"):
    """A pool of ``n_shapes`` multi-lobe objects drawn on the host by
    ``np.random.default_rng(seed)``, the draws in the JAX package's order, so
    a seed gives its pool. Each object has 2 to ``max_lobes`` active lobes
    (inactive ones are lobe 0 shrunk inside it, so every object has
    ``max_lobes``), is recentred at its surface centroid and scaled to
    ``diameter``. Shape i of a seed does not depend on ``n_shapes``.
    Returns (the stacked parameter dict of float32 tensors (K, ...) on
    ``device``; a list of (P, 3) float32 surface point clouds for ADD-S)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    pool = {k: [] for k in ("centers", "axes", "rots", "tex_phase", "tex_freq", "tints")}
    clouds = []
    sphere_dirs = np.asarray(_fibonacci_sphere(max(n_points, 256)), dtype=np.float64)

    for _ in range(n_shapes):
        n_active = int(rng.integers(2, max_lobes + 1))
        centers = np.zeros((max_lobes, 3))
        axes = np.zeros((max_lobes, 3))
        rots = np.zeros((max_lobes, 3, 3))
        axes[0] = rng.uniform(0.16, 0.30, 3)
        rots[0] = _np_quat_to_mat(rng.normal(size=4))
        for li in range(1, n_active):
            axes[li] = rng.uniform(0.07, 0.20, 3)
            direction = rng.normal(size=3)
            direction /= np.linalg.norm(direction)
            # Near lobe 0's surface, so the union is connected.
            reach = rng.uniform(0.55, 0.95) * axes[0].mean()
            centers[li] = direction * reach
            rots[li] = _np_quat_to_mat(rng.normal(size=4))
        for li in range(n_active, max_lobes):
            axes[li] = axes[0] * 0.5
            rots[li] = rots[0]

        # Surface points of the active lobes that lie on the union's boundary.
        pts = []
        for li in range(n_active):
            p = centers[li] + (sphere_dirs * axes[li]) @ rots[li]
            inside_other = np.zeros(len(p), dtype=bool)
            for lj in range(n_active):
                if lj == li:
                    continue
                q = ((p - centers[lj]) @ rots[lj].T) / axes[lj]
                inside_other |= (q ** 2).sum(-1) < 0.98
            pts.append(p[~inside_other])
        pts = np.concatenate(pts, axis=0)

        centroid = pts.mean(0)
        pts -= centroid
        centers -= centroid
        d = np.sqrt(((pts[None] - pts[:, None]) ** 2).sum(-1)).max()
        s = diameter / d
        pts *= s
        centers *= s
        axes *= s

        if len(pts) > n_points:
            pts = pts[rng.choice(len(pts), n_points, replace=False)]
        pool["centers"].append(centers)
        pool["axes"].append(axes)
        pool["rots"].append(rots)
        pool["tex_phase"].append(rng.uniform(0, 2 * np.pi, 3))
        pool["tex_freq"].append(rng.uniform(6.0, 12.0))
        pool["tints"].append(rng.uniform(0.45, 1.0, (max_lobes, 3)))
        clouds.append(pts.astype(np.float32))

    stacked = {k: torch.from_numpy(np.stack(v).astype(np.float32)).to(device)
               for k, v in pool.items()}
    return stacked, clouds


def index_lobe_shape(pool: dict, k) -> dict:
    """Object ``k`` of a stacked pool."""
    return {name: arr[k] for name, arr in pool.items()}


def _uv_sphere(lat: int, lon: int):
    """A unit UV sphere (numpy): vertices (V, 3), faces (F, 3), uvs (V, 2),
    on a (lat + 1) x (lon + 1) grid whose seam column is duplicated so that
    each vertex has one UV; outward winding, degenerate pole faces left out."""
    th = np.linspace(0.0, np.pi, lat + 1)
    ph = np.linspace(0.0, 2 * np.pi, lon + 1)
    T, P = np.meshgrid(th, ph, indexing="ij")
    verts = np.stack([np.sin(T) * np.cos(P), np.sin(T) * np.sin(P), np.cos(T)],
                     axis=-1).reshape(-1, 3)
    uvs = np.stack([P / (2 * np.pi), 1.0 - T / np.pi], axis=-1).reshape(-1, 2)
    idx = np.arange((lat + 1) * (lon + 1)).reshape(lat + 1, lon + 1)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[1:, 1:].ravel()
    d = idx[:-1, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, c], -1), np.stack([a, c, d], -1)], axis=0)
    tri = verts[faces]
    area = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    return verts, faces[area > 1e-12], uvs


def lobe_shape_meshes(pool: dict, out_dir, lat: int = 32, lon: int = 64):
    """Write every object of a lobe pool as a textured OBJ mesh
    ``lobes_NNNN.obj`` (the same text as the JAX package writes) and return
    the paths. Each active lobe is a UV sphere mapped as
    ``sample_lobe_shapes`` maps its surface, with its own horizontal strip of
    the texture; the z-buffer render of the closed lobes is the union's
    visible surface. Inactive lobes (lobe 0 shrunk inside itself) are left
    out."""
    from pathlib import Path

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sph_v, sph_f, sph_uv = _uv_sphere(lat, lon)
    centers, axes, rots = (pool[k].cpu().numpy() for k in ("centers", "axes", "rots"))
    n_shapes, n_lobes = centers.shape[:2]
    paths = []
    for k in range(n_shapes):
        path = out_dir / f"lobes_{k:04d}.obj"
        with open(path, "w") as f:
            f.write(f"# multi-lobe shape {k} ({n_lobes} lobes)\n")
            offset = 0
            for li in range(n_lobes):
                if li > 0 and (np.allclose(centers[k, li], centers[k, 0])
                               and np.allclose(axes[k, li], axes[k, 0] * 0.5)):
                    continue
                v = centers[k, li] + (sph_v * axes[k, li]) @ rots[k, li]
                uv = sph_uv * np.asarray([1.0 / n_lobes, 1.0])
                uv[:, 0] += li / n_lobes
                for vv, tt in zip(v, uv):
                    f.write(f"v {vv[0]:.6f} {vv[1]:.6f} {vv[2]:.6f}\n")
                    f.write(f"vt {tt[0]:.6f} {tt[1]:.6f}\n")
                for tri in sph_f + offset + 1:
                    f.write(f"f {tri[0]}/{tri[0]} {tri[1]}/{tri[1]} {tri[2]}/{tri[2]}\n")
                offset += len(v)
        paths.append(path)
    return paths


class MultiLobeOracleModel:
    """``EllipsoidOracleModel`` for a multi-lobe object ``shape`` (one
    object's parameter dict): stands in for ``LatentFusionModel`` in the
    estimators; the latent is ignored."""

    def __init__(self, shape: dict, input_size: int = 128, camera_dist: float = 5.78,
                 device="cuda"):
        self.device = resolve_device(device)
        self.shape = {k: v.to(self.device) for k, v in shape.items()}
        self.input_size = input_size
        self.camera_dist = camera_dist

    def decode_latent(self, z_obj, camera: Camera, return_latent: bool = True,
                      apply_mask: bool = False):
        """Renders at the (zoomed) cameras in ``LatentFusionModel.decode_latent``'s
        contract: normalized depth, -1 off the object."""
        depth_metric, mask_hard, mask_logits, _ = render_lobe_shape(
            camera, self.shape, self.input_size)
        depth = torch.where(mask_hard > 0.5, camera.normalize_depth(depth_metric), -1.0)
        y = {"depth": depth[None], "mask": torch.sigmoid(mask_logits)[None],
             "mask_logits": mask_logits[None]}
        z_lat = (torch.zeros(1, camera.length, 1, device=camera.device)
                 if return_latent else None)
        return y, z_lat

    def compute_latent_code(self, observation: Observation, camera: Camera) -> torch.Tensor:
        return torch.zeros(camera.length, 1, device=camera.device)

    def build_latent_object(self, observation: Observation) -> torch.Tensor:
        return torch.zeros(1, 1, 1, 1, 1, 1, device=self.device)

    def make_observation(self, camera: Camera, shaded: bool = True) -> Observation:
        """The full-frame observation: shaded color, or the silhouette in
        all three channels; the hard mask."""
        return lobe_observation(self.shape, camera, shaded)


def lobe_observation(shape: dict, camera: Camera, shaded: bool = True) -> Observation:
    """The full-frame observation of a multi-lobe object at ``camera``."""
    depth, mask, _, lobe_onehot = render_lobe_shape(camera, shape)
    if shaded:
        color = lobe_shape_color(camera, depth, mask, lobe_onehot, shape)
    else:
        color = mask.expand(camera.length, 3, camera.height, camera.width)
    return Observation(color, depth, mask, camera)


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
