"""The synthetic multi-view training stream (counterpart of
``latentfusion_tpu/data/synthetic.py``).

Per item: input and output camera poses (random, segment-constrained,
sunflower-even or a spiral orbit), a mesh at a jittered size, a random
material (UV-mapped texture or planar projection into vertex colors, a
Blinn-Phong lobe with a MERL roughness), a random color or depth background,
per-view random lights, color jitter, noise, mask corruption and camera
jitter, all rendered by the host rasterizer. Items are dicts of numpy
groups ``in``, ``out_gt`` (and ``in_gt``) of render, mask, depth, extrinsic
and intrinsic stacks.

Poses come from a ``torch.Generator`` seeded from ``seed`` and the worker
id (the JAX package draws them from ``jax.random``); ``random`` and
``np.random`` are drawn exactly as the JAX package draws them. Images are
PNG (``png.py``) or JPEG (``jpeg.py``): the procedural textures and
backgrounds are written as 8-bit RGB PNG and the depth backgrounds as 16-bit
grey PNG; the JPEG banks of the training recipe read as imageio reads them.
"""
from __future__ import annotations

import logging
import math
import random
from pathlib import Path

import numpy as np
import torch

from .. import augment, jpeg, png, three
from ..jpeg import NoDecoderError  # noqa: F401  (raised by read_image)
from ..three import host
from ..three import quaternion as quat
from . import rendering

logger = logging.getLogger(__name__)

# The canonical Realsense intrinsic of a 640x480 frame.
INTRINSIC = [
    [615.1436, 0.0000, 315.3623, 0.0000],
    [0.0000, 615.4991, 251.5415, 0.0000],
    [0.0000, 0.0000, 1.0000, 0.0000],
]

# ShapeNet uses +Y as up; YCB uses +Z up. Pre-rotate to the canonical frame.
OBJ_DEFAULT_POSE = np.asarray(
    ((1.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0)), dtype=np.float32)

IMAGE_EXT = ".png"


def read_image(path) -> np.ndarray:
    """An image file as a numpy array: JPEG through ``jpeg.py`` (a JPEG it
    cannot decode raises ``NoDecoderError``), anything else as PNG."""
    path = Path(path)
    if path.suffix.lower() in (".jpg", ".jpeg"):
        return jpeg.read_jpeg(path)
    return png.read_png(path)


def make_procedural_blobs(out_dir, n_objs: int = 4, n_verts: int = 2000):
    """Write ``n_objs`` procedural convex-blob OBJ meshes and return their
    paths (stand-ins for ShapeNet or ModelNet meshes)."""
    from scipy.spatial import ConvexHull

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(n_objs):
        rng = np.random.RandomState(i)
        v = rng.randn(n_verts, 3).astype(np.float64)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        v *= 0.8 + 0.4 * rng.rand(n_verts, 1)
        hull = ConvexHull(v)
        # Keep only the hull's vertices and orient every face outward (hull
        # simplices carry no consistent winding).
        hv = v[hull.vertices]
        remap = np.full(len(v), -1, dtype=np.int64)
        remap[hull.vertices] = np.arange(len(hull.vertices))
        centroid = hv.mean(axis=0)
        p = out_dir / f"blob{i}.obj"
        with open(p, "w") as f:
            for vv in hv:
                f.write(f"v {vv[0]:.5f} {vv[1]:.5f} {vv[2]:.5f}\n")
            for s in hull.simplices:
                a, b, c = v[s[0]], v[s[1]], v[s[2]]
                n = np.cross(b - a, c - a)
                if np.dot(n, a - centroid) < 0:
                    s = (s[0], s[2], s[1])
                r = remap[list(s)] + 1
                f.write(f"f {r[0]} {r[1]} {r[2]}\n")
        paths.append(p)
    return paths


def _multi_octave_noise(rng, h, w, channels=3, octaves=(4, 8, 16, 32)):
    """Value noise: random low-resolution fields bilinearly upsampled and
    summed, normalised to [0, 1]."""
    from scipy.ndimage import zoom as ndzoom

    img = np.zeros((h, w, channels), np.float32)
    amp = 1.0
    for cells in octaves:
        low = rng.rand(cells, cells, channels).astype(np.float32)
        img += amp * ndzoom(low, (h / cells, w / cells, 1), order=1)[:h, :w]
        amp *= 0.55
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return img


def procedural_texture(i: int, size: int = 256, seed: int = 0) -> np.ndarray:
    """Texture ``i`` of the procedural bank: (size, size, 3) uint8 of noise,
    stripes or a checker (by ``i % 3``) in random colors."""
    rng = np.random.RandomState(seed * 100003 + i)
    kind = i % 3
    if kind == 0:
        img = _multi_octave_noise(rng, size, size)
    elif kind == 1:
        period = rng.randint(8, 64)
        angle = rng.rand() * np.pi
        yy, xx = np.mgrid[0:size, 0:size]
        phase = xx * np.cos(angle) + yy * np.sin(angle)
        a, b = rng.rand(3), rng.rand(3)
        w = (0.5 + 0.5 * np.sin(2 * np.pi * phase / period))[..., None]
        img = (a * w + b * (1 - w)).astype(np.float32)
    else:
        cells = rng.randint(4, 16)
        yy, xx = np.mgrid[0:size, 0:size]
        chk = (((xx * cells // size) + (yy * cells // size)) % 2)
        a, b = rng.rand(3), rng.rand(3)
        img = (a * chk[..., None] + b * (1 - chk[..., None]))
        img = img.astype(np.float32)
        img += 0.15 * _multi_octave_noise(rng, size, size)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def make_procedural_textures(out_dir, n: int = 48, size: int = 256, seed: int = 0):
    """Write ``n`` procedural textures ``tex_NNN.png`` (8-bit RGB) and return
    the directory (stand-ins for the COCO texture bank)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        png.write_png(out_dir / f"tex_{i:03d}.png", procedural_texture(i, size, seed))
    return out_dir


def procedural_background(i: int, width: int = 640, height: int = 480,
                          seed: int = 1) -> np.ndarray:
    """Color background ``i``: (height, width, 3) uint8 noise, half of them
    with random rectangles."""
    rng = np.random.RandomState(seed * 7919 + i)
    img = _multi_octave_noise(rng, height, width)
    if i % 2:
        for _ in range(rng.randint(3, 10)):
            x0, y0 = rng.randint(0, width - 8), rng.randint(0, height - 8)
            x1 = min(width, x0 + rng.randint(8, width // 2))
            y1 = min(height, y0 + rng.randint(8, height // 2))
            img[y0:y1, x0:x1] = 0.7 * img[y0:y1, x0:x1] + 0.3 * rng.rand(3)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def procedural_depth(i: int, width: int = 640, height: int = 480, seed: int = 1) -> np.ndarray:
    """Depth background ``i``: (height, width) uint16 millimetres, a ramp plus
    noise."""
    rng = np.random.RandomState(seed * 104729 + i)
    d = _multi_octave_noise(rng, height, width, channels=1)[..., 0]
    yy = np.linspace(0, 1, height)[:, None]
    d = 800.0 + 2500.0 * (0.6 * d + 0.4 * yy)
    return d.astype(np.uint16)


def make_procedural_backgrounds(out_dir, n_color: int = 24, n_depth: int = 12,
                                width: int = 640, height: int = 480, seed: int = 1):
    """Write color backgrounds ``bg_NNN.png`` (8-bit RGB) and depth
    backgrounds ``depth_NNN.png`` (16-bit grey, millimetres) and return the
    directory (stand-ins for the COCO color and depth banks)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i in range(n_color):
        png.write_png(out_dir / f"bg_{i:03d}.png",
                      procedural_background(i, width, height, seed))
    for i in range(n_depth):
        png.write_png(out_dir / f"depth_{i:03d}.png",
                      procedural_depth(i, width, height, seed))
    return out_dir


def index_images(image_dir: Path, index_name: str = "paths.txt"):
    """A color bank's images: the paths listed in ``index_name`` if present,
    else every JPEG (the JAX package's banks) and PNG file, sorted."""
    image_dir = Path(image_dir)
    if (image_dir / index_name).exists():
        return index_paths(image_dir, IMAGE_EXT, index_name)
    return sorted(p for ext in (".jpg", ".jpeg", IMAGE_EXT) for p in image_dir.glob(f"**/*{ext}"))


def index_paths(dataset_dir: Path, ext: str, index_name: str = "paths.txt"):
    """The paths listed in ``index_name`` if present, else every ``*ext``
    file under ``dataset_dir``, sorted."""
    dataset_dir = Path(dataset_dir)
    index_path = dataset_dir / index_name
    if index_path.exists():
        with open(index_path) as f:
            return [Path(dataset_dir, p.strip()) for p in f.readlines()]
    return sorted(dataset_dir.glob(f"**/*{ext}"))


class SyntheticDataset(torch.utils.data.IterableDataset):
    """The infinite synthetic stream; ``worker_init_fn`` runs in each loader
    worker (``loader.make_loader`` calls it)."""

    MAX_MESH_BYTES = 2e7

    def __init__(self, shape_paths, num_input_views, num_output_views,
                 x_bound=(-0.5, 0.5), y_bound=None, z_bound=(1.5, 3),
                 size_jitter=(0.5, 1.0), color_noise_level=0.0,
                 depth_noise_level=0.0, mask_noise_p=0.0,
                 min_lights=3, max_lights=8, width=640, height=480,
                 camera_angle_min=0.0, camera_angle_max=math.pi / 2.0,
                 camera_angle_spread=math.pi / 12.0,
                 camera_translation_noise=0.0, camera_rotation_noise=0.0,
                 color_background_dir=None, depth_background_dir=None,
                 textures_dir=None, use_textures=False,
                 random_materials=False, color_random_background=False,
                 depth_random_background=False, use_spiral_outputs=False,
                 use_constrained_cameras=False, disk_sample_cameras=False,
                 use_model_materials=False, obj_default_pose=OBJ_DEFAULT_POSE,
                 device_id=0, seed=None, emit_in_gt=True):
        super().__init__()
        self.width = width
        self.height = height
        if not y_bound:
            y_bound = (x_bound[0] / width * height, x_bound[1] / width * height)
        self.x_bound = x_bound
        self.y_bound = y_bound
        self.z_bound = z_bound
        self.size_jitter = size_jitter
        self.min_lights = min_lights
        self.max_lights = max_lights
        self.color_noise_level = color_noise_level
        self.depth_noise_level = depth_noise_level
        self.mask_noise_p = mask_noise_p
        self.color_random_background = color_random_background
        self.depth_random_background = depth_random_background
        self.random_materials = random_materials

        self.num_inputs = num_input_views
        self.num_outputs = num_output_views
        # emit_in_gt=False leaves the clean input views out of items: the
        # reconstruction step reads them only with reconstruct_input.
        self.emit_in_gt = emit_in_gt
        self.use_spiral_outputs = use_spiral_outputs
        self.use_constrained_cameras = use_constrained_cameras
        self.disk_sample_cameras = disk_sample_cameras
        self.camera_angle_min = camera_angle_min
        self.camera_angle_max = camera_angle_max
        self.camera_angle_spread = camera_angle_spread
        self.camera_translation_noise = camera_translation_noise
        self.camera_rotation_noise = camera_rotation_noise
        self.obj_default_pose = obj_default_pose
        self.shape_paths = list(shape_paths)

        self.texture_paths = (index_images(textures_dir)
                              if use_textures and textures_dir else [])
        self.color_background_paths = (
            index_images(color_background_dir)
            if color_random_background and color_background_dir else [])
        self.depth_background_paths = (
            index_paths(depth_background_dir, IMAGE_EXT, "depth_paths.txt")
            if depth_random_background and depth_background_dir else [])
        if color_background_dir and color_background_dir == depth_background_dir:
            # One directory holds both banks: tell them apart by name.
            self.color_background_paths = [p for p in self.color_background_paths
                                           if not p.name.startswith("depth_")]
            self.depth_background_paths = [p for p in self.depth_background_paths
                                           if p.name.startswith("depth_")]

        logger.info("dataset indexed: %d shapes, %d textures, %d color bgs, %d depth bgs",
                    len(self.shape_paths), len(self.texture_paths),
                    len(self.color_background_paths), len(self.depth_background_paths))

        self._mask_corrupt = augment.masks.default_mask_corruption()
        self._renderer = None
        self._worker_id = None
        self._seed = int(seed if seed is not None else 0)
        self._generator = None

    # -------------------------------------------------------------- workers
    def worker_init_fn(self, worker_id):
        """Give this worker its renderer, its ``random`` and ``np.random``
        seeds (as the JAX package seeds them) and its pose generator."""
        self._worker_id = worker_id
        self._renderer = rendering.Renderer(width=self.width, height=self.height)
        random.seed((worker_id + 1) * 7919 + random.randrange(1 << 20))
        np.random.seed((worker_id + 1) * 104729 % (1 << 31))
        self._generator = torch.Generator().manual_seed(self._seed + worker_id)

    def _pose_generator(self) -> torch.Generator:
        if self._generator is None:
            self._generator = torch.Generator().manual_seed(self._seed)
        return self._generator

    # ---------------------------------------------------------------- poses
    def _canonical(self, rot_quats: torch.Tensor) -> np.ndarray:
        canon = quat.mat_to_quat(torch.from_numpy(np.asarray(self.obj_default_pose)))
        return quat.qmul(rot_quats, canon.expand(len(rot_quats), 4)).numpy()

    def random_poses(self, n, constrained=False, disk_sample=False):
        """(n, 3) translations in the bounds and (n, 4) rotations, numpy."""
        g = self._pose_generator()
        translation = three.random_translation(n, self.x_bound, self.y_bound,
                                               self.z_bound, generator=g)
        if constrained:
            angle = random.uniform(self.camera_angle_min + self.camera_angle_spread,
                                   self.camera_angle_max - self.camera_angle_spread)
            rot_quats = three.orientation.sample_segment_quats(
                n, (0.0, 0.0, 1.0), angle - self.camera_angle_spread,
                angle + self.camera_angle_spread, generator=g)
        elif disk_sample:
            rot_quats = three.orientation.evenly_distributed_quats(n, generator=g)
        else:
            rot_quats = quat.random(n, g)
        return translation.numpy(), self._canonical(rot_quats)

    def orbit_poses(self, n):
        translation = np.tile(np.asarray([[0.0, 0.0, self.z_bound[0]]], dtype=np.float32),
                              (n, 1))
        return translation, self._canonical(three.orientation.spiral_orbit(n, c=8))

    # --------------------------------------------------------------- assets
    def load_random_image(self, paths):
        """A random RGB image of ``paths`` (uint8 (H, W, 3))."""
        for _ in range(32):
            path = random.choice(paths)
            try:
                image = read_image(path)
                if image.ndim != 3 or image.shape[2] < 3:
                    continue
                return image[:, :, :3]
            except Exception:
                logger.warning("failed to read image %s", path)
        raise RuntimeError("could not load a background image")

    def load_random_depth(self, paths):
        """A random depth image of ``paths`` (millimetres), rescaled to
        [0, far] with far random in [z_bound[1], 6]."""
        far = random.uniform(self.z_bound[1], 6.0)
        for _ in range(32):
            path = random.choice(paths)
            try:
                depth = read_image(path)
                if depth.ndim > 2:
                    depth = depth[:, :, 0]
                depth = depth.astype(np.float32) / 1000.0
                rng = depth.max() - depth.min()
                if rng <= 0:
                    continue
                return (depth - depth.min()) / rng * far
            except Exception:
                logger.warning("failed to read depth image %s", path)
        raise RuntimeError("could not load a background depth")

    # The roughness of the 100 MERL materials, (2 / (g + 2))^(1/4) of each
    # material's Blinn-Phong glossiness g, sorted.
    MERL_ROUGHNESS = (
        0.0638, 0.0647, 0.0658, 0.0662, 0.0662, 0.0681, 0.0704, 0.0738,
        0.0756, 0.0781, 0.0789, 0.0791, 0.0813, 0.0817, 0.0826, 0.0837,
        0.0866, 0.0881, 0.0888, 0.0891, 0.0892, 0.0892, 0.0904, 0.0904,
        0.0916, 0.0952, 0.0999, 0.1, 0.1, 0.1028, 0.1035, 0.1069, 0.1099,
        0.1246, 0.1414, 0.1416, 0.1418, 0.1461, 0.1529, 0.1838, 0.1984,
        0.1999, 0.2093, 0.2093, 0.2478, 0.2514, 0.2704, 0.2862, 0.2988,
        0.3003, 0.3098, 0.3098, 0.3186, 0.3203, 0.3338, 0.3495, 0.3502,
        0.3624, 0.3715, 0.3766, 0.381, 0.3847, 0.3874, 0.3893, 0.3912,
        0.3915, 0.3917, 0.3927, 0.3939, 0.3962, 0.4015, 0.4055, 0.407,
        0.4187, 0.4193, 0.4204, 0.4535, 0.4566, 0.4576, 0.462, 0.4666,
        0.4674, 0.4691, 0.472, 0.4765, 0.4842, 0.4852, 0.4886, 0.495,
        0.4973, 0.5094, 0.5207, 0.5256, 0.5329, 0.5491, 0.6043, 0.6363,
        0.6527, 0.8726, 0.9029,
    )

    def sample_roughness(self) -> float:
        return float(random.choice(self.MERL_ROUGHNESS))

    def _apply_random_material(self, obj):
        """Objects whose meshes all have UVs get one texture, UV-mapped at a
        random tile scale (nine times in ten); otherwise each mesh gets a
        texture projected on a random plane into its vertex colors, or a
        random flat color."""
        use_uv_texture = (self.texture_paths
                          and all(m.uvs is not None for m in obj.meshes)
                          and random.random() < 0.9)
        if use_uv_texture:
            tex = self.load_random_image(self.texture_paths)
            base = np.random.uniform(0.5, 1.0, 3)
            texture = np.clip(tex.astype(np.float32) / 255.0 * base, 0, 1)
            uv_scale = random.uniform(1.0, 8.0)
            for mesh in obj.meshes:
                mesh.texture = texture
                mesh.uv_scale = uv_scale
                mesh.vertex_colors = None
            return
        for mesh in obj.meshes:
            mesh.texture = None
            mesh.uv_scale = 1.0
            if self.texture_paths and random.random() < 0.9:
                tex = self.load_random_image(self.texture_paths)
                base = np.random.uniform(0.5, 1.0, 3)
                th, tw = tex.shape[:2]
                v = mesh.vertices
                axes = np.random.permutation(3)[:2]
                uv = v[:, axes]
                span = uv.max(axis=0) - uv.min(axis=0) + 1e-6
                uv = (uv - uv.min(axis=0)) / span
                scale = random.uniform(1.0, 8.0)
                ui = (uv[:, 0] * (tw - 1) * scale % (tw - 1)).astype(int)
                vi = (uv[:, 1] * (th - 1) * scale % (th - 1)).astype(int)
                mesh.vertex_colors = np.clip(tex[vi, ui].astype(np.float32) / 255.0 * base, 0, 1)
            else:
                color = np.random.uniform(0.2, 1.0, 3).astype(np.float32)
                mesh.vertex_colors = np.tile(color[None], (len(mesh.vertices), 1))

    def _load_object(self):
        """A random mesh at a jittered size, skipping oversized or broken
        files."""
        size_jitter = random.uniform(*self.size_jitter)
        for _ in range(64):
            model_path = Path(random.choice(self.shape_paths))
            try:
                if model_path.stat().st_size > self.MAX_MESH_BYTES:
                    logger.warning("skipping large model %s", model_path)
                    continue
                obj, obj_scale = rendering.load_object(model_path, size=size_jitter)
                if len(obj.vertices) < 3:
                    continue
                return obj, obj_scale
            except Exception as e:
                logger.error("exception while loading mesh %s: %s", model_path, e)
        raise RuntimeError("could not load any mesh")

    # ----------------------------------------------------------------- items
    def __iter__(self):
        if self._renderer is None:
            self.worker_init_fn(0)
        while True:
            yield self._get_item()

    def _get_item(self):
        intrinsic = np.asarray(INTRINSIC, dtype=np.float32).copy()
        intrinsic[0] *= self.width / 640.0
        intrinsic[1] *= self.height / 480.0

        in_t, in_q = self.random_poses(self.num_inputs,
                                       constrained=self.use_constrained_cameras,
                                       disk_sample=self.disk_sample_cameras)
        if self.use_spiral_outputs:
            out_t, out_q = self.orbit_poses(self.num_outputs)
        else:
            out_t, out_q = self.random_poses(self.num_outputs,
                                             disk_sample=self.disk_sample_cameras)

        obj, _ = self._load_object()
        context = rendering.SceneContext(obj, intrinsic)
        if self.random_materials:
            self._apply_random_material(obj)
            context.roughness = self.sample_roughness()
            context.specular = random.uniform(0.05, 0.6)

        color_bg_base = (self.load_random_image(self.color_background_paths)
                         if self.color_background_paths else None)
        depth_bg_base = (self.load_random_depth(self.depth_background_paths)
                         if self.depth_background_paths else None)

        bg_crop = augment.tensors.TensorRandomCrop((self.height, self.width),
                                                   pad_if_needed=True)
        bg_flip_h = augment.tensors.TensorRandomHorizontalFlip()
        bg_flip_v = augment.tensors.TensorRandomVerticalFlip()

        groups = {k: {"render": [], "mask": [], "depth": []}
                  for k in ("in", "in_gt", "out_gt")}

        for t, q in zip(in_t, in_q):
            context.randomize_lights(self.min_lights, self.max_lights)
            context.set_pose(t, q)
            color, depth, mask = self._renderer.render(context)
            groups["in_gt"]["render"].append(color)
            groups["in_gt"]["depth"].append(depth)
            groups["in_gt"]["mask"].append(mask)

            color = augment.color_jitter(color)
            if color_bg_base is not None:
                bg = bg_crop(bg_flip_v(bg_flip_h(
                    color_bg_base.transpose(2, 0, 1)))).transpose(1, 2, 0)
                bg = bg.astype(np.float32) / 255.0
                color = mask[:, :, None] * color + (1 - mask[:, :, None]) * bg
            if depth_bg_base is not None:
                bg_d = bg_crop(depth_bg_base[None])[0]
                depth = mask * depth + (1 - mask) * bg_d
            if self.color_noise_level > 0:
                color = augment.add_noise(color, self.color_noise_level)
            if self.depth_noise_level > 0:
                depth = augment.add_depth_noise(depth, self.depth_noise_level)
            noisy_mask = np.round(mask)
            if random.random() < self.mask_noise_p:
                noisy_mask = self._mask_corrupt(noisy_mask.astype(bool)).astype(np.float32)
            groups["in"]["render"].append(color)
            groups["in"]["depth"].append(depth)
            groups["in"]["mask"].append(noisy_mask)

        for t, q in zip(out_t, out_q):
            context.set_pose(t, q)
            color, depth, mask = self._renderer.render(context)
            groups["out_gt"]["render"].append(color)
            groups["out_gt"]["depth"].append(depth)
            groups["out_gt"]["mask"].append(mask)

        in_intrinsic = np.tile(intrinsic[None, :3, :3], (self.num_inputs, 1, 1))
        out_intrinsic = np.tile(intrinsic[None, :3, :3], (self.num_outputs, 1, 1))
        in_extrinsic_gt = host.to_extrinsic_matrix(in_t, in_q)

        # Camera jitter for training on noisy extrinsics.
        t_noisy, q_noisy = in_t, in_q
        if self.camera_translation_noise > 0:
            t_noisy = in_t + (np.random.randn(*in_t.shape).astype(np.float32)
                              * self.camera_translation_noise)
        if self.camera_rotation_noise > 0:
            q_noisy = quat.perturb(torch.from_numpy(in_q), self.camera_rotation_noise,
                                   self._pose_generator()).numpy()
        in_extrinsic = host.to_extrinsic_matrix(t_noisy, q_noisy)
        out_extrinsic = host.to_extrinsic_matrix(out_t, out_q)

        def pack(g, extrinsic, intrinsic_):
            return {"render": np.stack(g["render"]).transpose(0, 3, 1, 2),
                    "mask": np.stack(g["mask"]),
                    "depth": np.stack(g["depth"]),
                    "extrinsic": extrinsic,
                    "intrinsic": intrinsic_}

        item = {"in": pack(groups["in"], in_extrinsic, in_intrinsic),
                "out_gt": pack(groups["out_gt"], out_extrinsic, out_intrinsic)}
        if self.emit_in_gt:
            item["in_gt"] = pack(groups["in_gt"], in_extrinsic_gt, in_intrinsic)
        return item


class ShapeNetDataset(SyntheticDataset):
    """ShapeNet's OBJ meshes, some synsets left out."""

    DEFAULT_BLACKLIST = (
        "02858304",  # boats
        "02876657",  # bottles (often thin/transparent)
        "04401088",  # phones
    )

    def __init__(self, dataset_path, blacklist_synsets=None, **kwargs):
        dataset_path = Path(dataset_path)
        blacklist = set(blacklist_synsets or self.DEFAULT_BLACKLIST)
        paths = []
        for p in index_paths(dataset_path, ".obj"):
            synset = next((part for part in p.parts if part.isdigit() and len(part) == 8),
                          None)
            if synset not in blacklist:
                paths.append(p)
        super().__init__(paths, **kwargs)


class ModelNetDataset(SyntheticDataset):
    def __init__(self, dataset_path, split="train", **kwargs):
        dataset_path = Path(dataset_path)
        paths = sorted(dataset_path.glob(f"**/{split}/*.off"))
        if not paths:
            paths = index_paths(dataset_path, ".off")
        super().__init__(paths, **kwargs)


class YCBDataset(SyntheticDataset):
    def __init__(self, dataset_path, **kwargs):
        dataset_path = Path(dataset_path)
        paths = sorted(dataset_path.glob("*/google_16k/textured.obj"))
        if not paths:
            paths = index_paths(dataset_path, ".obj")
        super().__init__(paths, **kwargs)


class BOPTrainDataset(SyntheticDataset):
    """Synthetic training on a BOP dataset's models."""

    def __init__(self, dataset_path, models_dirname="models", **kwargs):
        dataset_path = Path(dataset_path)
        paths = sorted((dataset_path / models_dirname).glob("obj_*.ply"))
        super().__init__(paths, **kwargs)
