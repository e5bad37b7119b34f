"""Pose refinement through a freshly trained decoder, no oracle (counterpart
of ``tools/trained_pose_experiment.py``).

Trains the small stack (32² input, a 16-channel latent of 16³) on a pool of
12 synthetic renders of a cube for 1200 Adam steps at 2e-3, builds the
latent object from 8 reference views through ``LatentFusionModel``, and
refines 8 hypotheses perturbed from the true pose (0.3 rad, 0.1 in
translation) for 80 steps, printing the ADD-S of each before (``init
errs``) and after (``ranked finals``).

    python -m latentfusion_tpu_torch.trained_pose_experiment [--device cpu]

The JAX tool runs on import, at its fixed budget; here ``run(device,
steps)`` does the work and ``main`` runs it at 1200 steps. It writes
nothing but the cube mesh, to a temporary directory. The JAX tool's
reference views, target and perturbations come from ``jax.random``:
``experiment_cameras.json`` holds them. The weights start from a
``torch.Generator`` seeded with 0, the steps' orientations from one seeded
with 1.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

W, H, F = 96, 72, 72.0
CAMERA_DIST = 1.5
INTRINSIC = np.asarray([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]], np.float32)
STEPS = 1200
POOL = 12
LOG_EVERY = 300
STEP_CONFIG = {"camera_dist": CAMERA_DIST, "random_orientation": True,
               "g_depth_recon_loss_type": "l1", "g_depth_recon_loss_weight": 25.0,
               "g_mask_recon_loss_weight": 25.0}
NUM_HYPOTHESES = 8
FINE = {"ranking_size": 8, "loss_weights": {"depth": 1.0, "ov_depth": 0.3, "mask": 1.0},
        "learning_rate": 0.01, "num_samples": NUM_HYPOTHESES, "num_iters": 80,
        "converge_threshold": 1e-6, "converge_patience": 80, "optimizer": "adam"}


def make_models(device, generator=None):
    """(sculptor, fuser, photographer): the small stack, 32² input and a
    16-channel latent of 16³."""
    from .recon.fusion import GRUFuser
    from .recon.models import Photographer, Sculptor
    from .zoo import _place

    sculptor = Sculptor(in_size=32, image_config=((8, "D", 16), (16,)), camera_config=(16, 16),
                        object_config=(16, 16), projection_type="factor", cube_size=1.0)
    photographer = Photographer(in_size=16, image_config=((8, "D", 16), (16, "U", 16, "U", 8)),
                                camera_config=(16, 16), object_config=None,
                                projection_type="factor", predict_depth=True,
                                predict_mask=True, cube_size=1.0)
    return tuple(_place(m, device, generator)
                 for m in (sculptor, GRUFuser(in_channels=16), photographer))


def train(step, state, pool, steps: int, generator):
    """``steps`` steps over the pool in turn, printing the loss every 300.
    Returns (state, each step's loss as a device tensor)."""
    losses = []
    t0 = time.time()
    for i in range(steps):
        state, aux = step(state, pool[i % len(pool)], generator)
        losses.append(aux["loss/generator/total"])
        if i % LOG_EVERY == 0:
            print(i, float(losses[-1]), f"{time.time() - t0:.0f}s", flush=True)
    print("final train loss:", float(losses[-1]))
    return state, losses


def perturbed_hypotheses(gt_cam, draws, device):
    """``NUM_HYPOTHESES`` copies of ``gt_cam`` turned by the drawn
    perturbations and moved by the drawn translation noise."""
    from .camera import Camera

    n = NUM_HYPOTHESES
    base = Camera(gt_cam.intrinsic.expand(n, -1, -1), None, gt_cam.z_span,
                  log_quaternion=gt_cam.log_quaternion.expand(n, -1),
                  translation=gt_cam.translation.expand(n, -1), width=W, height=H,
                  device=device)
    noise = torch.as_tensor(draws["trained_pose_translation_noise"], device=device)
    return base.rotate(torch.as_tensor(draws["trained_pose_perturb_quats"], device=device)
                       ).replace(translation=base.translation + noise)


def refine(model, mesh_path: Path, device):
    """The latent from 8 reference views, then 80 refinement steps from the
    perturbed hypotheses. Returns (the hypotheses' initial ADD-S, the ranked
    refined cameras' ADD-S)."""
    from .data import rendering
    from .observation import Observation
    from .pose import estimation, metrics
    from .train_cube_demo import load_draws, pose, render_obs

    draws = load_draws()
    obj, _ = rendering.load_object(mesh_path, size=1.0)
    ref_obs = Observation.collate([render_obs(obj, INTRINSIC, pose(q), W, H, device)
                                   for q in draws["reference_quats"]])
    z_obj = model.build_latent_object(ref_obs)
    target = render_obs(obj, INTRINSIC, pose(draws["trained_pose_gt_quat"]), W, H, device)
    gt_cam = target.camera
    points = torch.as_tensor(obj.vertices, dtype=torch.float32, device=device)

    def add_s(c):
        return metrics.camera_metrics(gt_cam, c, points, scale_to_meters=1.0)["add_s"]

    init_cams = perturbed_hypotheses(gt_cam, draws, device)
    init_errs = [add_s(init_cams[i]) for i in range(NUM_HYPOTHESES)]
    est = estimation.GradientPoseEstimator(model=model, **FINE)
    best = est.estimate(z_obj, target, camera=init_cams)
    final_errs = [add_s(best[i]) for i in range(len(best))]
    print("init errs:", np.round(init_errs, 3))
    print("ranked finals:", np.round(final_errs, 3))
    return init_errs, final_errs


def run(device, steps: int = STEPS) -> dict:
    """Train ``steps`` steps, then refine. Returns {losses (device tensors),
    init_errs, final_errs}."""
    from .device import resolve_device
    from .recon.inference import LatentFusionModel
    from .train.step import init_gan_train_state, make_optimizer, make_recon_train_step
    from .train_cube_demo import make_cube_obj, render_pool

    device = resolve_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        mesh_path = make_cube_obj(Path(tmp))
        pool = render_pool(mesh_path, POOL, 1, 2, 2, W, H, device)
        sculptor, fuser, photographer = make_models(device,
                                                    torch.Generator(device).manual_seed(0))
        state = init_gan_train_state({"sculptor": sculptor, "fuser": fuser,
                                      "photographer": photographer},
                                     make_optimizer("adam", 2e-3), device=device)
        step = make_recon_train_step(sculptor, fuser, photographer, config=STEP_CONFIG)
        state, losses = train(step, state, pool, steps, torch.Generator(device).manual_seed(1))
        model = LatentFusionModel(sculptor, None, fuser, None, photographer, None,
                                  camera_dist=CAMERA_DIST, device=device)
        init_errs, final_errs = refine(model, mesh_path, device)
    return {"losses": losses, "init_errs": init_errs, "final_errs": final_errs}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="default the card")
    args = parser.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
