"""The IBR generator's training step (counterpart of
``latentfusion_tpu/train/ibr_step.py``): the reconstruction model (frozen,
or trained with ``train_recon``) predicts depth and mask at the input and
output cameras; the input colors are reprojected into the output views by
the predicted depths; a ``UNet2d`` generator reads [the predicted output
depth, per input view (reprojected color, reprojected depth, rotation and
position camera distances)], 1 + 6V channels, and regresses the output
color (``regress``), blends the reprojections (``blend``) or blends them
after a learned flow (``blend_flow``); color loss [and the multi-scale
LSGAN discriminator on the output colors].

Each step runs on cuDNN's deterministic algorithms (``train.step._accumulate``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import ibr
from .. import losses as L
from ..camera import Camera
from ..recon import models
from ..recon.utils import mask_normalized_depth, process_batch
from ..three.batchview import b2bv, bv2b
from . import step as base_step


def generator_in_channels(num_input_views: int) -> int:
    """1 output-depth channel + per input view (3 color + 1 depth + 2 camera
    distance channels)."""
    return 1 + (2 + 1 + 3) * num_input_views


def generator_out_channels(ibr_type: str, num_input_views: int):
    if ibr_type == "regress":
        return (3,)
    elif ibr_type == "blend":
        return (num_input_views,)
    elif ibr_type == "blend_flow":
        return (num_input_views,) * 3
    raise ValueError("Unknown ibr_type")


def make_ibr_train_step(sculptor, fuser, photographer, generator,
                        discriminator=None, config: Optional[Dict] = None):
    """Returns ``step(state, raw_batch, rng=None, input_noise_weight=0.0) ->
    (state, scalars)``, ``state`` a ``train.step.TrainState`` over the
    generator (and the reconstruction modules with ``train_recon``) and the
    discriminator. ``rng`` (a ``torch.Generator``) draws, in this order, the
    input depth's noise (``generator_input_depth``), the real images' and
    the fake images' instance noise. ``scalars``:
    ``loss/generator/recon/<term>``, ``loss/generator/total`` [,
    ``loss/discriminator/total``]."""
    config = dict(config or {})
    cube_size = config.get("cube_size", 1.0)
    camera_dist = config.get("camera_dist", 1.5)
    input_size = sculptor.in_size
    num_input_views = config["num_input_views"]
    num_output_views = config["num_output_views"]
    batch_size = config.get("batch_size", 1)
    ibr_type = config.get("ibr_type", "blend_flow")
    flow_size = config.get("flow_size", 5)
    train_recon = config.get("train_recon", False)
    no_apply_mask = config.get("no_apply_mask", False)
    gan_weight = config.get("g_gan_loss_weight", 1.0)
    color_weight = config.get("g_color_recon_loss_weight", 50.0)
    color_loss_type = config.get("g_color_recon_loss_type", "l1")
    color_k = config.get("g_color_recon_loss_k", 2000)
    noise_std = config.get("input_noise_std", 0.2)

    def render_reprojections(proc, rng):
        recon_camera = Camera.vcat((proc["in_gt"]["camera"], proc["out_gt"]["camera"]),
                                   batch_size=batch_size)
        depth_in = None
        if config.get("generator_input_depth", False):
            depth = proc["in"]["depth"]
            noise = base_step._normal(depth.shape, rng, depth.device)
            depth_in = (depth + noise * config.get("depth_noise_std", 0.25)).clamp(-1, 1)

        with torch.set_grad_enabled(train_recon and torch.is_grad_enabled()):
            z_obj = models.encode(sculptor, fuser, proc["in"]["camera"], proc["in"]["image"],
                                  depth_in, proc["in"]["mask"])
            fake = models.decode(photographer, z_obj, recon_camera)[0]

        v = num_input_views
        depth_fake_in = fake["depth"][:, :v].float()
        depth_fake_out = fake["depth"][:, v:].float()
        mask_fake_out = fake["mask"][:, v:].float()
        image_reproj, depth_reproj, cam_dists_r, cam_dists_t = ibr.reproject_views_batch(
            proc["in"]["image"], depth_fake_in, depth_fake_out, proc["in"]["camera"],
            proc["out_gt"]["camera"])
        image_reproj = image_reproj * mask_fake_out[:, :, None]
        depth_reproj = (depth_reproj + 1.0) * mask_fake_out[:, :, None] - 1.0
        return (image_reproj, depth_reproj, mask_fake_out, depth_fake_out,
                cam_dists_r, cam_dists_t)

    def g_losses(batch, rng, input_noise_weight):
        proc = process_batch(batch, cube_size, camera_dist, input_size,
                             random_orientation=False)
        proc["in"]["image"] = proc["in"]["image"] * proc["in"]["mask"]
        if "depth" in proc["in"]:
            proc["in"]["depth"] = mask_normalized_depth(proc["in"]["depth"],
                                                        proc["in"]["mask"])
        (image_reproj, depth_reproj, mask_ibr_out, depth_ibr_out, cam_r,
         cam_t) = render_reprojections(proc, rng)

        hw = image_reproj.shape[-2:]
        x = torch.cat((
            image_reproj,
            depth_reproj,
            cam_r[..., None, None, None].expand(*cam_r.shape, 1, *hw),
            cam_t[..., None, None, None].expand(*cam_t.shape, 1, *hw),
        ), dim=3)
        x = x.reshape(x.shape[0] * x.shape[1], x.shape[2] * x.shape[3], *hw)
        x = torch.cat((bv2b(depth_ibr_out), x), dim=1)

        logits = generator(x)
        if ibr_type == "regress":
            image_ibr_out = torch.tanh(logits)
        elif ibr_type == "blend":
            image_ibr_out, _ = ibr.blend_logits(logits, bv2b(image_reproj))
        else:
            image_ibr_out = ibr.warp_blend_logits(logits, bv2b(image_reproj), flow_size)[0]
        image_ibr_out = b2bv(image_ibr_out.float(), num_output_views)
        if not no_apply_mask:
            image_ibr_out = image_ibr_out * mask_ibr_out

        gt_image = proc["out_gt"]["image"] * proc["out_gt"]["mask"]
        loss_dict = {"color": color_weight * base_step._recon_loss(
            color_loss_type, image_ibr_out, gt_image, color_k)}

        d_pack = None
        if discriminator is not None:
            real = bv2b(proc["out_gt"]["image"])
            fake_img = bv2b(image_ibr_out)
            scale = input_noise_weight * noise_std
            real_noise = scale * base_step._normal(real.shape, rng, real.device)
            fake_noise = scale * base_step._normal(fake_img.shape, rng, fake_img.device)
            with torch.profiler.record_function(base_step.DISCRIMINATOR_RANGE):
                loss_dict["gan"] = gan_weight * L.multiscale_lsgan_loss(
                    discriminator(fake_img + fake_noise, bv2b(mask_ibr_out)), 1)
            d_pack = (fake_img.detach(), real, bv2b(proc["out_gt"]["mask"]),
                      bv2b(mask_ibr_out).detach(), real_noise, fake_noise)
        return loss_dict, d_pack

    def d_losses(d_pack):
        fake_img, real, real_mask, fake_mask, real_noise, fake_noise = d_pack
        with torch.profiler.record_function(base_step.DISCRIMINATOR_RANGE):
            loss_real = L.multiscale_lsgan_loss(discriminator(real + real_noise, real_mask), 1)
            loss_fake = L.multiscale_lsgan_loss(discriminator(fake_img + fake_noise, fake_mask),
                                                0)
        return {"total": loss_real + loss_fake}

    def step(state: base_step.TrainState, batch, rng: Optional[torch.Generator] = None,
             input_noise_weight: float = 0.0):
        summed, _ = base_step._accumulate(
            1, lambda i: g_losses(batch, rng, input_noise_weight), state,
            discriminator, d_losses)
        scalars = {f"loss/generator/recon/{k.split('/', 1)[1]}": v
                   for k, v in summed.items()
                   if k.startswith("generator/") and k != "generator/total"}
        scalars["loss/generator/total"] = summed["generator/total"]
        if discriminator is not None:
            scalars["loss/discriminator/total"] = summed["discriminator/total"]
        return state, scalars

    return step
