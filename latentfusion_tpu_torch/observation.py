"""RGB-D observation container (counterpart of
``latentfusion_tpu/observation.py``).

An Observation bundles color (B, 3, H, W), depth (B, 1, H, W), mask
(B, 1, H, W), a Camera, and the ``is_zoomed / is_prepared / is_normalized``
flags that gate preprocessing.
"""
from __future__ import annotations

import torch

from .augment import gan_denormalize, gan_normalize
from .camera import Camera


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
