"""Pose estimation utilities (counterpart of ``latentfusion_tpu/pose/utils.py``):
hypothesis sampling around an estimate, the optimizable camera leaves, axis
flips, the mask losses (IoU, masked mean, centroid shape and contour) and
the perceptual loss."""
from __future__ import annotations

import math

import torch

from .. import three
from ..camera import Camera
from ..three import orientation
from ..three import quaternion as quat


def perturb_camera(camera: Camera, translation_std, quaternion_std,
                   generator: torch.Generator) -> Camera:
    """Gaussian perturbation of translation and log-quaternion."""
    noise_t = torch.randn(camera.translation.shape, generator=generator,
                          device=generator.device).to(camera.device)
    noise_q = torch.randn(camera.log_quaternion.shape, generator=generator,
                          device=generator.device).to(camera.device)
    return camera.replace(
        translation=camera.translation + noise_t * translation_std,
        log_quaternion=camera.log_quaternion + noise_q * quaternion_std)


def cameras_with_estimate(camera_est: Camera, quaternion: torch.Tensor,
                          translation: torch.Tensor) -> Camera:
    """Cameras with ``camera_est``'s intrinsic, viewport and frame, at the
    given rotations (n, 4) and translations (n, 3)."""
    n = quaternion.shape[0]
    return Camera(camera_est.intrinsic.expand(n, *camera_est.intrinsic.shape[1:]),
                  three.to_extrinsic_matrix(translation, quaternion),
                  camera_est.z_span, viewport=camera_est.viewport.expand(n, 4),
                  width=camera_est.width, height=camera_est.height,
                  device=camera_est.device)


def sample_cameras_with_estimate(n: int, camera_est: Camera,
                                 generator: torch.Generator,
                                 translation_std: float = 0.0,
                                 hemisphere: bool = False,
                                 upright: bool = False) -> Camera:
    """``n`` sunflower-even rotation hypotheses (each rolled at random about
    its viewing ray unless ``upright``) around ``camera_est``'s translation."""
    device = camera_est.device
    noise = torch.randn(n, 3, generator=generator, device=generator.device)
    translation = camera_est.translation.expand(n, 3) + noise.to(device) * translation_std
    quaternion = orientation.evenly_distributed_quats(
        n, hemisphere=hemisphere, upright=upright, generator=generator,
        device=generator.device).to(device)
    return cameras_with_estimate(camera_est, quaternion, translation)


def camera_params(camera: Camera) -> dict:
    """The leaves that refinement optimizes, by ``Camera.replace`` name:
    rotation, translation and the zoom viewport."""
    return {"log_quaternion": camera.log_quaternion,
            "translation": camera.translation, "viewport": camera.viewport}


def flip_camera(camera: Camera, axis=(0.0, 0.0, 1.0)) -> Camera:
    """Rotate each camera 180 degrees about an object axis."""
    ax = torch.tensor([axis], dtype=torch.float32, device=camera.device)
    return camera.rotate(quat.from_axis_angle(ax.expand(len(camera), 3), math.pi))


def zero_invalid_pixels(tensor: torch.Tensor, invalid_mask: torch.Tensor) -> torch.Tensor:
    """Zero the loss where the target has no depth inside its mask."""
    return tensor * (~invalid_mask).to(tensor.dtype)


def iou_loss(input_mask, target_mask, eps: float = 1e-4):
    """log(union) - log(intersection) per batch item."""
    intersection = (input_mask * target_mask).sum(dim=(1, 2, 3))
    union = (input_mask.sum(dim=(1, 2, 3)) + target_mask.sum(dim=(1, 2, 3))
             - intersection)
    return torch.log(union.clamp_min(eps)) - torch.log(intersection.clamp_min(eps))


def reduce_loss_mask(loss, mask, eps: float = 1e-4):
    """Masked mean over the spatial dims."""
    if loss.dim() == 4:
        loss = loss.squeeze(1)
    if mask.dim() == 4:
        mask = mask.squeeze(1)
    num = (loss * mask).sum(dim=(-2, -1)).clamp_min(eps / 10)
    den = mask.sum(dim=(-2, -1)).clamp_min(eps)
    return num / den


def _pixel_grid(height: int, width: int, device):
    return torch.meshgrid(torch.arange(height, dtype=torch.float32, device=device),
                          torch.arange(width, dtype=torch.float32, device=device),
                          indexing="ij")


def mask_centroid(mask):
    """The (y, x) pixel centroid of each mask (..., h, w) -> (..., 2)."""
    yy, xx = _pixel_grid(*mask.shape[-2:], mask.device)
    den = mask.sum(dim=(-2, -1))
    return torch.stack(((mask * yy).sum(dim=(-2, -1)) / den,
                        (mask * xx).sum(dim=(-2, -1)) / den), dim=-1)


def mask_contour(mask):
    """Where the mask, thresholded at 0.5, changes between neighbouring
    pixels: a boolean (..., h - 2, w - 2)."""
    mask = (mask > 0.5).float()
    yg = (mask[..., 1:, :] - mask[..., :-1, :]).abs()
    xg = (mask[..., :, 1:] - mask[..., :, :-1]).abs()
    return (yg[..., 1:, :-2] + xg[..., :-2, 1:]).abs() > 0


def shape_loss(input_mask, target_mask):
    """Per-pixel difference of the distance to each mask's centroid, both
    over the target's largest distance, inside the input mask (N, h, w)."""
    if input_mask.dim() == 4:
        input_mask = input_mask.squeeze(1)
    if target_mask.dim() == 4:
        target_mask = target_mask.squeeze(1)
    if target_mask.shape[0] == 1:
        target_mask = target_mask.expand_as(input_mask)
    n = input_mask.shape[0]
    yx_coords = torch.stack(_pixel_grid(*input_mask.shape[-2:], input_mask.device))[None]
    input_dtc = torch.linalg.norm(
        yx_coords - mask_centroid(input_mask)[:, :, None, None], dim=1)
    target_dtc = torch.linalg.norm(
        yx_coords - mask_centroid(target_mask)[:, :, None, None], dim=1) * target_mask
    target_maxdist = target_dtc.reshape(n, -1).amax(dim=1)[:, None, None]
    return (input_dtc / target_maxdist - target_dtc / target_maxdist).abs() * input_mask


def contour_loss(input_mask, target_mask):
    """|contour length of the target - of the input| per item, masks
    (N, 1, h, w)."""
    input_contour = mask_contour(input_mask).float()
    target_contour = mask_contour(target_mask).float()
    return (target_contour.sum(dim=(1, 2, 3)) - input_contour.sum(dim=(1, 2, 3))).abs()


def get_perceptual_loss(vgg=None, torch_state_dict=None, device="cuda"):
    """The VGG16 perceptual loss: of a ``modules.vgg.VGG16Features``, or of
    one on ``device`` loaded from a torchvision VGG16 ``state_dict``."""
    from ..modules.vgg import VGG16Features, build_perceptual_loss

    if vgg is None:
        if torch_state_dict is None:
            raise ValueError("provide vgg or torch_state_dict (torchvision VGG16)")
        vgg = VGG16Features(device=device)
        vgg.load_torchvision_state_dict(torch_state_dict)
    return build_perceptual_loss(vgg)
