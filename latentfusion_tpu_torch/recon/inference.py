"""LatentFusionModel, the public inference API (counterpart of
``latentfusion_tpu/recon/inference.py``): build a latent object from posed
reference views, then render it from a batch of cameras, in the zoomed
frame (``render_latent_object``) or the full frame (``render_full``), with
color by image-based rendering from the reference views (``render_ibr_basic``,
or ``render_ibr`` with a learned IBR generator)."""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Mapping, Optional

import torch
from torch import nn

from .. import ibr
from ..camera import Camera
from ..device import resolve_device
from ..modules.unet import UNet2d
from ..observation import Observation
from ..three.batchview import b2bv, bv2b
from . import checkpoint as ckpt
from . import models

logger = logging.getLogger(__name__)


class LatentFusionModel:
    def __init__(self, sculptor: models.Sculptor,
                 sculptor_state: Optional[Mapping],
                 fuser: nn.Module, fuser_state: Optional[Mapping],
                 photographer: models.Photographer,
                 photographer_state: Optional[Mapping],
                 camera_dist: float, device="cuda",
                 generator: Optional[UNet2d] = None,
                 generator_state: Optional[Mapping] = None):
        """Modules with their state dicts (None keeps a module's own
        weights); ``generator`` is the optional IBR generator that
        ``render_ibr`` needs. The modules are moved to ``device``, set to
        eval and frozen: gradients flow to the inputs (cameras), never the
        weights."""
        self.device = resolve_device(device)
        for module, state in ((sculptor, sculptor_state), (fuser, fuser_state),
                              (photographer, photographer_state),
                              (generator, generator_state)):
            if module is None:
                continue
            if state is not None:
                module.load_state_dict(state)
            module.to(self.device).eval().requires_grad_(False)
        self.sculptor = sculptor
        self.fuser = fuser
        self.photographer = photographer
        self.generator = generator
        self.camera_dist = camera_dist
        self.input_size = sculptor.in_size

    @classmethod
    def from_checkpoint(cls, checkpoint, device="cuda") -> "LatentFusionModel":
        """Load a reference ``.pth`` checkpoint (path or loaded dict)."""
        device = resolve_device(device)
        if isinstance(checkpoint, (str, Path)):
            checkpoint = torch.load(checkpoint, map_location="cpu",
                                    weights_only=False)
        sculptor, fuser, photographer = ckpt.modules_from_checkpoint(checkpoint)
        logger.info("loaded model name=%s epoch=%s",
                    checkpoint.get("name", "<unnamed>"),
                    checkpoint.get("epoch", -1) + 1)
        return cls(sculptor, None, fuser, None, photographer, None,
                   camera_dist=checkpoint["args"]["camera_dist"], device=device,
                   generator=ckpt.generator_from_checkpoint(checkpoint))

    def zoom_observation(self, observation: Observation) -> Observation:
        """The observation zoomed to the model's camera distance and input
        size, unless it is already."""
        if not observation.meta["is_zoomed"]:
            return observation.zoom(self.camera_dist, self.input_size)
        return observation

    def preprocess_observation(self, observation: Observation) -> Observation:
        """Zoom to the model's camera distance and input size, mask out the
        background, normalize; each step only once."""
        if not observation.meta["is_zoomed"]:
            observation = observation.zoom(self.camera_dist, self.input_size)
        if not observation.meta["is_prepared"]:
            observation = observation.prepare()
        if not observation.meta["is_normalized"]:
            observation = observation.normalize()
        return observation

    @torch.no_grad()
    def build_latent_object(self, observation: Observation) -> torch.Tensor:
        """Encode and fuse all views of ``observation`` into one latent
        object (1, 1, C, S, S, S)."""
        obs = self.preprocess_observation(observation)
        return models.encode(self.sculptor, self.fuser, obs.camera,
                             obs.color[None], obs.depth[None], obs.mask[None])

    def compute_latent_code(self, observation: Observation,
                            camera: Camera) -> torch.Tensor:
        """The target's 2D latent at every camera of ``camera`` (already
        zoomed): the observation is preprocessed once, repeated to
        ``len(camera)`` if it is a single frame, and each frame is encoded
        and decoded at its camera. Autograd stays on, so a loss of it
        reaches the camera. Returns (N, C, H, W)."""
        obs = self.preprocess_observation(observation)
        if len(obs) == 1:
            obs = obs.expand(len(camera))
        _, z = models.autoencode(self.sculptor, self.fuser, self.photographer,
                                 camera, obs.color[:, None], obs.depth[:, None],
                                 obs.mask[:, None])
        return z

    def decode_latent(self, z_obj: torch.Tensor, camera: Camera,
                      return_latent: bool = True, apply_mask: bool = False):
        """Decode one latent object at every camera of ``camera`` (already
        zoomed) with autograd on: the pose estimators' render. Returns
        (y, z_2d | None) with ``y`` entries (1, N, ...)."""
        y, z, _ = models.decode(self.photographer, z_obj, camera,
                                return_latent=return_latent, apply_mask=apply_mask)
        return y, z

    @torch.no_grad()
    def render_latent_object(self, z_obj: torch.Tensor, camera: Camera,
                             return_latent: bool = True,
                             apply_mask: bool = True):
        """Render one latent object from every camera of ``camera`` (already
        zoomed). Returns (y, z_2d) with ``y`` entries (1, N, ...)."""
        y, z, _ = models.decode(self.photographer, z_obj, camera,
                                return_latent=return_latent, apply_mask=apply_mask)
        return y, (z.squeeze(0) if return_latent else None)

    @torch.no_grad()
    def render_full(self, z_obj: torch.Tensor, camera: Camera,
                    input_obs: Optional[Observation] = None, p=0.5) -> dict:
        """Render one latent object at full-frame cameras: zoom, decode with
        the mask applied, metric depth times the mask, then each output
        pasted back into the frame (nearest). With ``input_obs`` the color
        is ``render_ibr_basic``'s blend of its views. Returns ``depth`` and
        ``mask`` (N, 1, H, W) and, where there is color, ``color`` (N, 3, H,
        W) in [0, 1].

        The color of ``render_ibr_basic`` is (N, 3, h, w) already; the JAX
        package squeezes it a second time, which fails for every N
        (ROADMAP Queue 3), and the original's second squeeze is a no-op for
        N > 1: the port takes the (N, 3, h, w) color as it is."""
        camera_zoom = camera.zoom(None, self.input_size, self.camera_dist)
        if input_obs is None:
            pred_y, _ = self.render_latent_object(z_obj, camera_zoom, apply_mask=True,
                                                  return_latent=False)
        else:
            pred_y, _ = self.render_ibr_basic(z_obj, input_obs, camera_zoom,
                                              apply_mask=True, return_latent=False,
                                              p=p)
        mask = pred_y["mask"].squeeze(0)
        depth = camera_zoom.denormalize_depth(pred_y["depth"].squeeze(0)) * mask
        out = {"depth": camera_zoom.uncrop(depth)[0], "mask": camera_zoom.uncrop(mask)[0]}
        if "color" in pred_y:
            color = pred_y["color"].reshape(-1, *pred_y["color"].shape[-3:])
            out["color"] = camera_zoom.uncrop(color / 2 + 0.5)[0]
        return out

    @torch.no_grad()
    def render_ibr_basic(self, z_obj: torch.Tensor, input_obs: Observation,
                         camera_out: Camera, return_latent: bool = True,
                         apply_mask: bool = True, p=0.5):
        """Decode at ``camera_out`` (zoomed), with color blended from the
        preprocessed views of ``input_obs`` by inverse camera distance
        (``ibr.render_latent_ibr2``, ``cam_dist``). Returns (y, z_2d): ``y``
        entries (1, N, ...) but ``color`` (N, 3, h, w)."""
        input_obs = self.preprocess_observation(input_obs)
        y_ibr, z_ibr = ibr.render_latent_ibr2(
            self.photographer, z_obj, input_obs.camera, camera_out,
            b2bv(input_obs.color, batch_size=1), p=p, weight_type="cam_dist",
            return_latent=return_latent, apply_mask=apply_mask)
        if return_latent:
            z_ibr = z_ibr.squeeze(0)
        y_ibr["color"] = y_ibr["color"].squeeze(0)
        return y_ibr, z_ibr

    @torch.no_grad()
    def render_ibr(self, z_obj: torch.Tensor, input_obs: Observation,
                   camera_out: Camera, return_latent: bool = True):
        """Decode at ``camera_out`` (zoomed), with color from the learned
        IBR generator: it reads the output depth and, per input view, the
        masked reprojected color and depth and the cameras' position
        similarity (1 + 5 V_i channels), and its logits blend and warp the
        reprojections (``ibr.warp_blend_logits``, flow 5 pixels). Returns
        (y, z_2d) with a leading dim of 1 squeezed from each entry."""
        if self.generator is None:
            raise ValueError("no IBR generator in this model")
        input_obs = self.preprocess_observation(input_obs)
        (y_out, z_out, image_reproj, depth_reproj, _mask_out, depth_out, _cam_dist_r,
         cam_dist_t) = self._render_reprojections(z_obj, input_obs.color,
                                                  input_obs.camera, camera_out)
        if return_latent:
            z_out = z_out.squeeze(0)
        cam_sims = 1.0 - cam_dist_t * 2
        x = torch.cat((image_reproj, depth_reproj,
                       cam_sims[:, :, None, None, None].expand(
                           *cam_sims.shape, 1, *image_reproj.shape[-2:])), dim=2)
        x = torch.cat((depth_out, x.reshape(x.shape[0], -1, *x.shape[-2:])), dim=1)
        color, _, _, _ = ibr.warp_blend_logits(self.generator(x), image_reproj, 5)
        y_out["color"] = color
        y_out = {k: (v.squeeze(0) if v.shape[0] == 1 else v) for k, v in y_out.items()}
        return y_out, z_out

    def _render_reprojections(self, z_obj, color_in, camera_in: Camera,
                              camera_out: Camera, return_latent: bool = True):
        """Decode at the input and output cameras and reproject the input
        colors into the output views, masked by the output mask (the
        reprojected depth's background at -1). Returns the output decode and
        latent, then view-folded: reprojected color and depth, output mask
        and depth, rotation and position distances."""
        y_in, _, _ = models.decode(self.photographer, z_obj, camera_in)
        y_out, z_out, _ = models.decode(self.photographer, z_obj, camera_out,
                                        return_latent=return_latent)
        mask_out = y_out["mask"]
        image_reproj, depth_reproj, cam_dist_r, cam_dist_t = ibr.reproject_views_batch(
            color_in[None], y_in["depth"], y_out["depth"], camera_in, camera_out)
        image_reproj = image_reproj * mask_out[:, :, None]
        depth_reproj = (depth_reproj + 1.0) * mask_out[:, :, None] - 1.0
        return (y_out, z_out, bv2b(image_reproj), bv2b(depth_reproj), bv2b(mask_out),
                bv2b(y_out["depth"]), bv2b(cam_dist_r), bv2b(cam_dist_t))
