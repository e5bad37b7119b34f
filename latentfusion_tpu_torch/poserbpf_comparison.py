"""MOPED tracking (the PoseRBPF comparison protocol; counterpart of
``tools/poserbpf_comparison.py``).

    python -m latentfusion_tpu_torch.poserbpf_comparison --checkpoint model.pth \\
        --reference-scene moped/obj/reference --eval-scene moped/obj/evaluation \\
        --out moped_eval [--max-frames N] [--device cpu]

The latent object is built from ``--num-ref-views`` frames of the
reference capture (farthest-point sampling of the camera positions); frame
0 of the evaluation capture gets the coarse search and refinement of the
fine estimator's hypotheses; every later frame is refined from the previous
frame's pose repeated and perturbed (N(0, 0.005) on the translation,
N(0, 0.02) on the log-quaternion, a ``torch.Generator`` seeded with the
frame's index). Writes ``results.json``: per frame the rotation and
translation distances to the capture's pose, the frame and its seconds.
``--video`` also writes each frame with the estimate's rendered mask
overlaid on its red channel as ``tracking/000000.png``, ... (``videos.py``:
the JAX tool's frames where it has no ffmpeg). Runs on the GPU unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import time
from pathlib import Path

import torch

from . import videos
from .data.loader import collate
from .data.realsense import RealsenseDataset
from .device import resolve_device, synchronize
from .observation import Observation
from .pose import estimation, metrics
from .pose.plotting import overlay_mask
from .pose.utils import perturb_camera
from .recon.inference import LatentFusionModel

logger = logging.getLogger("poserbpf_comparison")
CONFIGS = Path(__file__).resolve().parents[1] / "configs"
WARM_TRANSLATION_STD, WARM_QUATERNION_STD = 0.005, 0.02


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkpoint", type=Path, required=True)
    parser.add_argument("--reference-scene", type=Path, required=True,
                        help="MOPED reference capture dir")
    parser.add_argument("--eval-scene", type=Path, required=True,
                        help="MOPED evaluation capture dir")
    parser.add_argument("--num-ref-views", type=int, default=16)
    parser.add_argument("--coarse-config", type=Path,
                        default=CONFIGS / "cross_entropy_quick.toml")
    parser.add_argument("--fine-config", type=Path, default=CONFIGS / "adam_quick.toml")
    parser.add_argument("--out", type=Path, default=Path("moped_eval"))
    parser.add_argument("--video", action="store_true")
    parser.add_argument("--max-frames", type=int, default=-1)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def track(model, coarse, fine, z_obj, eval_ds, n_frames: int, first_draws=None,
          writer=None):
    """Frame 0 coarse then fine, every later frame refined from the last
    pose. ``first_draws`` (tests) gives frame 0's coarse search another
    implementation's random stream. With a ``videos.VideoWriter`` each
    frame's color is written with the best estimate's rendered mask
    overlaid. Returns the rows and, per frame, (the capture's camera, the
    estimate's best camera)."""
    device = model.device
    rows, cameras, prev_camera = [], [], None
    for frame_idx in range(n_frames):
        target = Observation.from_dict(collate([eval_ds[frame_idx]]), device=device)
        t0 = time.time()
        if prev_camera is None:
            kwargs = {} if first_draws is None else {"draws": first_draws}
            coarse_cams = coarse.estimate(z_obj, target, **kwargs)
            best = fine.estimate(z_obj, target, camera=coarse_cams[:fine.num_samples])
        else:
            generator = torch.Generator(device=device).manual_seed(frame_idx)
            warm = perturb_camera(prev_camera.repeat(fine.num_samples),
                                  WARM_TRANSLATION_STD, WARM_QUATERNION_STD, generator)
            best = fine.estimate(z_obj, target, camera=warm)
        synchronize(device)
        elapsed = time.time() - t0
        prev_camera = best[0]
        m = metrics.camera_metrics(target.camera, best[0], None, 1.0)
        m["frame"] = frame_idx
        m["seconds"] = elapsed
        rows.append(m)
        cameras.append((target.camera, best[0]))
        logger.info("frame %d: rot=%.3f trans=%.4f (%.2fs)", frame_idx,
                    m["rotation_dist"], m["translation_dist"], elapsed)
        if writer is not None:
            with torch.no_grad():
                mask = model.render_full(z_obj, best[0])["mask"][0, 0]
            writer.write(overlay_mask(target.color[0].cpu().numpy(), mask.cpu().numpy()))
    return rows, cameras


def main(argv=None, first_draws=None):
    """Returns the rows of ``results.json`` and, per frame, (the capture's
    camera, the best estimate)."""
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    device = resolve_device(args.device)
    model = LatentFusionModel.from_checkpoint(args.checkpoint, device=device)

    ref_ds = RealsenseDataset(args.reference_scene)
    inds = [int(i) for i in ref_ds.sample_evenly(args.num_ref_views)]
    ref_obs = Observation.from_dict(collate([ref_ds[i] for i in inds]), device=device)
    logger.info("building latent object from %d reference views", len(inds))
    z_obj = model.build_latent_object(ref_obs)

    eval_ds = RealsenseDataset(args.eval_scene, ref_points=ref_ds.points)
    coarse = estimation.load_from_config(args.coarse_config, model)
    fine = estimation.load_from_config(args.fine_config, model)
    n_frames = len(eval_ds)
    if args.max_frames > 0:
        n_frames = min(n_frames, args.max_frames)
    writer = None
    if args.video:
        args.out.mkdir(parents=True, exist_ok=True)
        writer = videos.VideoWriter(args.out / "tracking.mp4", fps=15)
    with writer or contextlib.nullcontext():
        results, cameras = track(model, coarse, fine, z_obj, eval_ds, n_frames, first_draws,
                                 writer)

    args.out.mkdir(parents=True, exist_ok=True)
    with open(args.out / "results.json", "w") as f:
        json.dump(results, f, indent=2)
    mean = {k: sum(r[k] for r in results) / len(results)
            for k in ("rotation_dist", "translation_dist", "seconds")}
    logger.info("tracking done: mean rot=%.4f rad, trans=%.4f, %.3fs/frame",
                mean["rotation_dist"], mean["translation_dist"], mean["seconds"])
    return results, cameras


if __name__ == "__main__":
    main()
