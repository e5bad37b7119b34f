"""Decompose the pose-refinement step's time: the decode's forward, the
object-to-camera warp alone, the decode with the pose loss, and that loss's
gradient with respect to the camera (counterpart of
``tools/profile_decode.py``).

    python -m latentfusion_tpu_torch.profile_decode [--device cpu]

On ``profile_refinement``'s inputs (the flagship Photographer with random
weights at input 256, bfloat16, the ellipsoid oracle's target, 8 hypothesis
cameras zoomed to the input), each function is timed by
``utils.profiling.timeit`` (one warm-up call, then 20 calls each waited
for) and printed as the JAX tool prints it. The caller's compute dtype is
restored on return. Runs on the GPU unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

import torch

from . import dtypes, transforms
from .device import resolve_device
from .pose import estimation
from .pose import utils as pu
from .profile_refinement import DIST, INPUT, LATENT, N, flagship_model, target_setup
from .recon import models
from .utils import profiling

REPS = 20


def zoom_setup(model, n: int = N, latent=LATENT) -> dict:
    """``profile_refinement.target_setup`` with ``zoom_cam``: the
    hypotheses zoomed to the model's input size at its camera distance."""
    inputs = target_setup(model, n, latent)
    inputs["zoom_cam"] = inputs["init_cam"].zoom(None, model.input_size, model.camera_dist)
    return inputs


@torch.no_grad()
def decode_fwd(photographer, z_obj, camera):
    y, _, _ = models.decode(photographer, z_obj, camera)
    return y["depth"]


@torch.no_grad()
def o2c_only(z_obj, camera):
    """The object-to-camera warp of the latent, shared by every camera."""
    return transforms.object_to_camera(z_obj[0], camera)


def _pose_loss(photographer, z_obj, camera, obs, reduce):
    y, _, _ = models.decode(photographer, z_obj, camera, return_latent=True)
    z_depth = camera.denormalize_depth(y["depth"].squeeze(0))
    losses = estimation.default_pose_loss(obs, z_depth, y["mask_logits"].squeeze(0), camera)
    return sum(reduce(v) for v in losses.values())


@torch.no_grad()
def decode_loss(photographer, z_obj, camera, obs):
    """The decode and the pose losses, each summed over the hypotheses."""
    return _pose_loss(photographer, z_obj, camera, obs, torch.sum)


def decode_loss_grad(photographer, z_obj, params_cam, obs, zoom_cam):
    """The gradient of the mean pose losses with respect to the camera
    leaves ``params_cam`` (``pose.utils.camera_params``) of ``zoom_cam``."""
    leaves = {k: v.detach().requires_grad_() for k, v in params_cam.items()}
    with torch.enable_grad():
        loss = _pose_loss(photographer, z_obj, zoom_cam.replace(**leaves), obs, torch.mean)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads))


def report(name, fn, *args) -> float:
    """Seconds per call of ``fn(*args)`` by ``profiling.timeit``, printed
    as the JAX tool prints it."""
    dt = profiling.timeit(fn, *args, reps=REPS, warmup=1)
    print(f"{name:40s} {dt * 1e3:9.2f} ms", flush=True)
    return dt


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the host)")
    return p.parse_args(argv)


@dtypes.compute_dtype()
def main(argv=None) -> dict:
    """Prints the four timings; returns them in seconds by name."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    dtypes.set_compute_dtype("bfloat16")
    model = flagship_model(INPUT, DIST, device)
    ph = model.photographer
    inputs = zoom_setup(model)
    z_obj, zoom_cam, obs = inputs["z_obj"], inputs["zoom_cam"], inputs["target_obs"]
    cam_params = pu.camera_params(zoom_cam, optimize_viewport=True)
    return {
        "decode_fwd": report("decode fwd (8 hyp)", decode_fwd, ph, z_obj, zoom_cam),
        "o2c_only": report("object_to_camera warp only", o2c_only, z_obj, zoom_cam),
        "decode_loss": report("decode + pose loss", decode_loss, ph, z_obj, zoom_cam, obs),
        "decode_loss_grad": report("decode + loss + grad (full step core)", decode_loss_grad,
                                   ph, z_obj, cam_params, obs, zoom_cam)}


if __name__ == "__main__":
    main()
