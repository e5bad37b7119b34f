"""Trace the pose-refinement loop and print the top device ops (counterpart
of ``tools/profile_refinement.py``).

    python -m latentfusion_tpu_torch.profile_refinement [--trace-dir DIR]
        [--iters 20] [--parse-only] [--device cpu]

The flagship family at input 256 with random weights (N(0, 1) from seed 0),
in bfloat16, refines 8 hypotheses (``sample_cameras_with_estimate`` around
the target's camera) of the ellipsoid oracle's target (the canonical camera
at distance 1.5, rotated by a uniform random quaternion) with Adam for
``--iters`` steps. One ``estimate`` warms up; the next is traced by
``utils.profiling.profile`` into ``--trace-dir``, whose newest trace
``utils.profiling.top_ops`` then reads: device time and launches by kernel.
``--parse-only`` reads the directory's newest trace without running
anything. The caller's compute dtype is restored on return. Runs on the GPU
unless ``--device cpu`` (there the table is of host ops).

``target_setup`` and ``flagship_model`` are shared with ``profile_cem`` and
``profile_decode``; each draw comes from a ``torch.Generator`` seeded as the
JAX tools seed their keys.
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import torch

from . import dtypes, testing, three, zoo
from .camera import Camera
from .device import resolve_device
from .pose import estimation
from .pose import utils as pu
from .recon.inference import LatentFusionModel
from .utils import profiling

INPUT, DIST, N = zoo.FLAGSHIP_INPUT_SIZE, 1.5, 8
LATENT = (256, 16)  # the flagship latent's channels and side
TARGET_SEED, LATENT_SEED, HYPOTHESIS_SEED = 3, 0, 1


def flagship_model(input_size: int = INPUT, camera_dist: float = DIST, device="cuda",
                   seed: int = 0) -> LatentFusionModel:
    """The flagship family with N(0, 1) weights drawn from ``seed``."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return LatentFusionModel(
        zoo.flagship_sculptor(input_size, device=device, generator=gen), None,
        zoo.flagship_fuser(device=device, generator=gen), None,
        zoo.flagship_photographer(input_size, device=device, generator=gen), None,
        camera_dist=camera_dist, device=device)


def target_camera(camera_dist: float, generator: torch.Generator, device) -> Camera:
    """``zoo.canonical_camera(1, camera_dist)`` rotated by a uniform random
    quaternion."""
    cam = zoo.canonical_camera(1, camera_dist, device=device)
    quats = three.quaternion.random(1, generator).to(cam.device)
    return Camera(cam.intrinsic, three.to_extrinsic_matrix(cam.translation, quats),
                  z_span=cam.z_span, width=cam.width, height=cam.height, device=cam.device)


def target_setup(model, n: int = N, latent=LATENT) -> dict:
    """The JAX tools' inputs on the model's device: ``cam0`` (seed 3),
    ``z_obj`` (1, 1, C, S, S, S) = N(0, 1) * 0.1 (seed 0), ``target_obs``
    (the ellipsoid oracle's full frame at ``cam0``) and, for ``n`` > 0,
    ``init_cam``: ``n`` hypotheses around ``cam0`` (seed 1)."""
    device = model.device
    cam0 = target_camera(model.camera_dist, torch.Generator().manual_seed(TARGET_SEED), device)
    channels, side = latent
    z_obj = torch.randn((1, 1, channels, side, side, side),
                        generator=torch.Generator().manual_seed(LATENT_SEED)).to(device) * 0.1
    oracle = testing.EllipsoidOracleModel(input_size=model.input_size,
                                          camera_dist=model.camera_dist, device=device)
    out = {"cam0": cam0, "z_obj": z_obj, "target_obs": oracle.make_observation(cam0)}
    if n > 0:
        out["init_cam"] = pu.sample_cameras_with_estimate(
            n, cam0, torch.Generator().manual_seed(HYPOTHESIS_SEED))
    return out


def estimator_kwargs(n: int = N, iters: int = 20) -> dict:
    """``GradientPoseEstimator``'s arguments in the JAX tool."""
    return dict(ranking_size=n, loss_weights={"depth": 1.0, "ov_depth": 0.3},
                learning_rate=0.01, num_samples=n, num_iters=iters,
                converge_threshold=-1.0, converge_patience=iters + 1, optimizer="adam")


def trace_call(fn, warm, trace_dir, device):
    """Run ``warm()``, then trace ``fn()`` into ``trace_dir``; returns the
    profiler."""
    warm()
    with profiling.profile(trace_dir, device) as prof:
        fn()
    return prof


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trace-dir", type=Path,
                   default=Path(tempfile.gettempdir()) / "lf_refine_trace")
    p.add_argument("--parse-only", action="store_true")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the host)")
    return p.parse_args(argv)


@dtypes.compute_dtype()
def main(argv=None):
    """Prints the top ops of the traced estimate; returns their ms by name."""
    args = parse_args(argv)
    if not args.parse_only:
        device = resolve_device(args.device)
        dtypes.set_compute_dtype("bfloat16")
        model = flagship_model(device=device)
        inputs = target_setup(model)
        est = estimation.GradientPoseEstimator(model=model, **estimator_kwargs(N, args.iters))

        def run():
            est.estimate(inputs["z_obj"], inputs["target_obs"], camera=inputs["init_cam"])

        trace_call(run, run, args.trace_dir, device)
    return profiling.top_ops(args.trace_dir, device=args.device)


if __name__ == "__main__":
    main()
