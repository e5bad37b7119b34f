"""RGB-D observation container (counterpart of
``latentfusion_tpu/observation.py``).

An Observation bundles color (B, 3, H, W), depth (B, 1, H, W), mask
(B, 1, H, W), a Camera, and the ``is_zoomed / is_prepared / is_normalized``
flags that gate preprocessing. ``save`` and ``load`` keep the JAX package's
directory layout (``cameras.json`` and ``NNNN.{color,depth,mask}.png``)
through the port's own PNG codec (``png.py``).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from . import imutils, png
from .augment import gan_denormalize, gan_normalize
from .camera import Camera


def render_observation(renderer, scene, device="cuda") -> "Observation":
    """Render ``scene`` (``data.rendering.SceneContext``) at its pose into a
    one-frame Observation on ``device``."""
    color, depth, mask = renderer.render(scene)
    camera = Camera(scene.intrinsic, scene.extrinsic, width=renderer.width,
                    height=renderer.height, device=device)
    return Observation(np.moveaxis(color, -1, 0)[None], depth[None, None], mask[None, None],
                       camera, object_scale=scene.obj.scale)


def render_random_observations(renderer, scene, n, x_bound=(0.0, 0.0), y_bound=(0.0, 0.0),
                               z_bound=(0.5, 0.5), disk_sample_quats=True, frame="default",
                               generator=None, device="cuda") -> "Observation":
    """``n`` renders of ``scene`` at random translations in the bounds and
    sunflower-even (or uniform random) rotations drawn from ``generator``
    (a CPU generator seeded 0 if None)."""
    from . import three
    from .three import quaternion as quat

    g = generator if generator is not None else torch.Generator().manual_seed(0)
    translations = three.random_translation(n, x_bound, y_bound, z_bound, generator=g)
    if disk_sample_quats:
        quaternions = three.orientation.evenly_distributed_quats(n, generator=g)
    else:
        quaternions = quat.random(n, g)
    observations = []
    for trans, q in zip(translations.cpu().numpy(), quaternions.cpu().numpy()):
        scene.set_pose(trans, q, frame=frame)
        observations.append(render_observation(renderer, scene, device))
    return Observation.collate(observations)


def sample_eval_observations(renderer, scene, x_bound=(0, 0), y_bound=(0, 0),
                             z_bound=(0.5, 0.5), rot_std_rad=None,
                             trans_std_m=(0.01, 0.01, 0.05), generator=None, device="cuda"):
    """A reference and a target render of ``scene``: the reference at a
    random pose, the target turned from it by a random rotation of
    ``rot_std_rad`` (redrawn while it exceeds 45 degrees, 16 times at most)
    and moved by N(0, ``trans_std_m``). Draws from ``generator`` in that
    order (a CPU generator seeded 0 if None)."""
    import math

    from . import three
    from .three import quaternion as quat

    if rot_std_rad is None:
        rot_std_rad = math.pi / 12
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    ref_trans = three.random_translation(1, x_bound, y_bound, z_bound, generator=g)[0]
    ref_quat = quat.random(1, g)[0]
    scene.set_pose(ref_trans.cpu().numpy(), ref_quat.cpu().numpy())
    ref_obs = render_observation(renderer, scene, device)

    tar_quat = quat.perturb(ref_quat, rot_std_rad, g)
    for _ in range(16):
        if float(quat.angular_distance(tar_quat[None], ref_quat[None])[0, 0]) < math.pi / 4:
            break
        tar_quat = quat.perturb(ref_quat, rot_std_rad, g)
    noise = torch.randn(3, generator=g, device=g.device)
    tar_trans = ref_trans + noise * torch.tensor(trans_std_m, device=g.device)
    scene.set_pose(tar_trans.cpu().numpy(), tar_quat.cpu().numpy())
    return ref_obs, render_observation(renderer, scene, device)


class Observation:
    def __init__(self, color, depth, mask, camera: Camera,
                 object_scale: float = 1.0, is_zoomed: bool = False,
                 is_normalized: bool = False, is_prepared: bool = False):
        device = camera.device
        tensors = []
        for t in (color, depth, mask):
            t = torch.as_tensor(t, dtype=torch.float32, device=device)
            tensors.append(t[None] if t.dim() == 3 else t)
        self.color, self.depth, self.mask = tensors
        self.camera = camera
        self.meta = {"object_scale": object_scale, "is_zoomed": is_zoomed,
                     "is_normalized": is_normalized, "is_prepared": is_prepared}

    def _with(self, color=None, depth=None, mask=None, camera=None, **flags):
        meta = {**self.meta, **flags}
        return Observation(self.color if color is None else color,
                           self.depth if depth is None else depth,
                           self.mask if mask is None else mask,
                           self.camera if camera is None else camera, **meta)

    @classmethod
    def from_dataset(cls, dataset, inds=None, device="cuda") -> "Observation":
        """Items ``inds`` (all if None) of a map-style dataset (``color``,
        ``depth``, ``mask``, ``intrinsic``, ``extrinsic``), collated."""
        from .data.loader import collate

        if inds is None:
            inds = range(len(dataset))
        return cls.from_dict(collate([dataset[int(i)] for i in inds]), device=device)

    @classmethod
    def from_dict(cls, d, device="cuda") -> "Observation":
        """From arrays: ``color`` (B, 3, H, W), ``depth`` and ``mask``
        (B, H, W), ``intrinsic`` and ``extrinsic``."""
        height, width = d["color"].shape[-2:]
        camera = Camera(d["intrinsic"], d["extrinsic"], width=width,
                        height=height, device=device)
        depth = torch.as_tensor(d["depth"], dtype=torch.float32)
        mask = torch.as_tensor(d["mask"], dtype=torch.float32)
        return cls(d["color"], depth[..., None, :, :], mask[..., None, :, :],
                   camera)

    @classmethod
    def collate(cls, observations) -> "Observation":
        first = observations[0]
        return cls(torch.cat([o.color for o in observations]),
                   torch.cat([o.depth for o in observations]),
                   torch.cat([o.mask for o in observations]),
                   Camera.cat([o.camera for o in observations]), **first.meta)

    def __len__(self):
        return len(self.camera)

    def __getitem__(self, item) -> "Observation":
        """Frames ``item`` (an int keeps its batch dim of 1)."""
        if isinstance(item, int):
            item = slice(item, item + 1) if item != -1 else slice(-1, None)
        return self._with(self.color[item], self.depth[item], self.mask[item],
                          self.camera[item])

    def clone(self) -> "Observation":
        return self._with(self.color.clone(), self.depth.clone(),
                          self.mask.clone(), self.camera.clone())

    def to_list(self) -> list:
        return [self[i] for i in range(len(self))]

    def expand(self, n: int) -> "Observation":
        """A single frame repeated ``n`` times."""
        if len(self) > 1:
            raise ValueError(f"Must be single but has batch size {len(self)}.")
        return self._with(self.color.expand(n, *self.color.shape[1:]),
                          self.depth.expand(n, *self.depth.shape[1:]),
                          self.mask.expand(n, *self.mask.shape[1:]),
                          self.camera.repeat(n))

    # --------------------------------------------------------------- disk I/O
    def save(self, path) -> None:
        """``cameras.json`` (the camera's ``to_kwargs`` and the flags) and
        per frame an 8-bit RGB color PNG (``255 c`` truncated), a 16-bit
        depth PNG in millimetres (truncated) and an 8-bit mask PNG (255
        where the mask exceeds 0.5)."""
        path = Path(path)
        path.mkdir(exist_ok=True, parents=True)
        camera_json = {k: (v.tolist() if torch.is_tensor(v) else v)
                       for k, v in self.camera.to_kwargs().items()}
        camera_json["meta"] = self.meta
        with open(path / "cameras.json", "w") as f:
            json.dump(camera_json, f, indent=2)
        color = self.color.detach().cpu().numpy()
        depth = self.depth.detach().cpu().numpy()
        mask = self.mask.detach().cpu().numpy()
        for i in range(len(self)):
            png.write_png(path / f"{i:04d}.color.png",
                          (255.0 * color[i].transpose(1, 2, 0)).astype(np.uint8))
            png.write_png(path / f"{i:04d}.depth.png",
                          (1000.0 * depth[i][0]).astype(np.uint16))
            png.write_png(path / f"{i:04d}.mask.png",
                          (mask[i][0] > 0.5).astype(np.uint8) * 255)

    @classmethod
    def load(cls, path, frames=None, device="cuda") -> "Observation":
        """What ``save`` (of this package or the JAX package) wrote: all
        frames, one (an int) or a list of them."""
        path = Path(path)
        with open(path / "cameras.json") as f:
            camera_json = json.load(f)
        meta = camera_json.pop("meta", {})
        cameras = Camera.from_kwargs(camera_json, device=device)
        if frames is None:
            inds = list(range(len(cameras)))
        elif isinstance(frames, int):
            inds = [frames]
        else:
            inds = list(frames)
        cameras = Camera.cat([cameras[i] for i in inds])
        color = np.stack([png.read_png(path / f"{i:04d}.color.png")
                          for i in inds]).astype(np.float32) / 255.0
        depth = np.stack([png.read_png(path / f"{i:04d}.depth.png")
                          for i in inds]).astype(np.float32) / 1000.0
        mask = np.stack([png.read_png(path / f"{i:04d}.mask.png") > 0
                         for i in inds]).astype(np.float32)
        return cls(torch.from_numpy(color.transpose(0, 3, 1, 2)),
                   torch.from_numpy(depth)[:, None],
                   torch.from_numpy(mask)[:, None], cameras, **meta)

    # ----------------------------------------------------------- preprocessing
    def zoom(self, target_dist, target_size, camera: Camera = None) -> "Observation":
        """Crop and rescale around the object as seen from ``target_dist``."""
        camera = self.camera if camera is None else camera
        color, new_camera = camera.zoom(self.color, target_size, target_dist,
                                        scale_mode="bilinear")
        depth, _ = camera.zoom(self.depth, target_size, target_dist,
                               scale_mode="nearest")
        mask, _ = camera.zoom(self.mask, target_size, target_dist,
                              scale_mode="nearest")
        return self._with(color, depth, mask, new_camera, is_zoomed=True)

    def uncrop(self, camera: Camera = None) -> "Observation":
        """Paste zoomed frames back into the full frame (color bilinear,
        depth and mask nearest)."""
        camera = self.camera if camera is None else camera
        color, new_camera = camera.uncrop(self.color, scale_mode="bilinear")
        depth, _ = camera.uncrop(self.depth, scale_mode="nearest")
        mask, _ = camera.uncrop(self.mask, scale_mode="nearest")
        return self._with(color, depth, mask, new_camera, is_zoomed=False)

    def prepare(self, crop_color: bool = True, crop_depth: bool = True) -> "Observation":
        """Mask out the background."""
        color = (gan_denormalize(gan_normalize(self.color) * self.mask)
                 if crop_color else self.color)
        depth = self.depth * self.mask if crop_depth else self.depth
        return self._with(color, depth, is_prepared=True)

    def normalize(self) -> "Observation":
        """Color to [-1, 1], depth to the camera's [-1, 1] window."""
        return self._with(gan_normalize(self.color),
                          self.camera.normalize_depth(self.depth),
                          is_normalized=True)

    def denormalize(self) -> "Observation":
        """Undo ``normalize``."""
        return self._with(gan_denormalize(self.color),
                          self.camera.denormalize_depth(self.depth),
                          is_normalized=False)

    # ------------------------------------------------------------- geometry
    def estimate_camera(self) -> Camera:
        """The translation-only initial camera from depth and mask."""
        from .pose.initialization import estimate_initial_pose

        return estimate_initial_pose(self.depth, self.mask, self.camera.intrinsic,
                                     self.camera.width, self.camera.height)

    def zoom_estimate(self, target_dist, target_size) -> "Observation":
        """``zoom`` about the estimated camera."""
        return self.zoom(target_dist, target_size, camera=self.estimate_camera())

    def pointcloud(self, frame: str = "object", return_colors: bool = False,
                   segment: bool = True):
        """Back-projected points (B, H*W, 3) in the object or camera frame,
        with (B, H*W) colors if asked, and with ``segment`` the (B, H*W)
        mask of the valid points (mask over 0.5 and depth over 0): fixed
        shapes, where the original returns ragged arrays."""
        coords = (self.camera.depth_object_coords(self.depth) if frame == "object"
                  else self.camera.depth_camera_coords(self.depth))
        points = torch.stack(coords, dim=-1).reshape(len(self), -1, 3)
        valid = ((self.mask > 0.5).reshape(len(self), -1)
                 & (self.depth.reshape(len(self), -1) > 0))
        out = (points,)
        if return_colors:
            out += (self.color.permute(0, 2, 3, 1).reshape(len(self), -1, 3),)
        if segment:
            out += (valid,)
        return out[0] if len(out) == 1 else out

    def dilate(self, kernel_size: int = 5) -> "Observation":
        """Dilate the mask by a square ``kernel_size`` window and paint the
        new ring with the mean foreground color."""
        pad_color = imutils.mean_color(self.color, self.mask).mean(dim=0)
        pad_color = pad_color.reshape(1, 3, 1, 1).expand_as(self.color)
        dilated = imutils.dilate(self.mask, 1, kernel_size)
        pad_mask = dilated - self.mask
        bg_mask = (1.0 - dilated).clamp_min(0)
        color = self.mask * self.color + bg_mask * self.color + pad_mask * pad_color
        return self._with(color, mask=dilated)
