"""LatentFusionModel, the public inference API (counterpart of
``latentfusion_tpu/recon/inference.py``): build a latent object from posed
reference views, then render it from a batch of cameras."""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Mapping, Optional

import torch
from torch import nn

from ..camera import Camera
from ..device import resolve_device
from ..observation import Observation
from . import checkpoint as ckpt
from . import models

logger = logging.getLogger(__name__)


class LatentFusionModel:
    def __init__(self, sculptor: models.Sculptor,
                 sculptor_state: Optional[Mapping],
                 fuser: nn.Module, fuser_state: Optional[Mapping],
                 photographer: models.Photographer,
                 photographer_state: Optional[Mapping],
                 camera_dist: float, device="cuda"):
        """Modules with their state dicts (None keeps a module's own
        weights). The modules are moved to ``device``, set to eval and
        frozen: gradients flow to the inputs (cameras), never the weights."""
        self.device = resolve_device(device)
        for module, state in ((sculptor, sculptor_state), (fuser, fuser_state),
                              (photographer, photographer_state)):
            if state is not None:
                module.load_state_dict(state)
            module.to(self.device).eval().requires_grad_(False)
        self.sculptor = sculptor
        self.fuser = fuser
        self.photographer = photographer
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
                   camera_dist=checkpoint["args"]["camera_dist"], device=device)

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

    def decode_latent(self, z_obj: torch.Tensor, camera: Camera,
                      return_latent: bool = True, apply_mask: bool = False):
        """Decode one latent object at every camera of ``camera`` (already
        zoomed) with autograd on: the pose estimators' render. Returns
        (y, z_2d | None) with ``y`` entries (1, N, ...)."""
        return models.decode(self.photographer, z_obj, camera,
                             return_latent=return_latent, apply_mask=apply_mask)

    @torch.no_grad()
    def render_latent_object(self, z_obj: torch.Tensor, camera: Camera,
                             return_latent: bool = True,
                             apply_mask: bool = True):
        """Render one latent object from every camera of ``camera`` (already
        zoomed). Returns (y, z_2d) with ``y`` entries (1, N, ...)."""
        y, z = models.decode(self.photographer, z_obj, camera,
                             return_latent=return_latent, apply_mask=apply_mask)
        return y, (z.squeeze(0) if return_latent else None)
