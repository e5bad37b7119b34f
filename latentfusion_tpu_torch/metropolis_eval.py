"""Accuracy of the Metropolis estimator as the coarse stage, beside the
cross-entropy (CEM) control, on the learned encoder-distill checkpoint
(counterpart of ``tools/metropolis_eval.py``).

    python -m latentfusion_tpu_torch.metropolis_eval --out DIR \\
        [--checkpoint artifacts/encoder_distill/encoder_distill.npz] \\
        [--targets 8] [--chains 128] [--mh-iters 300] \\
        [--refine-samples 16] [--refine-iters 150] [--tiny] [--device cpu]

The object is the encoder-distill ellipsoid (axes 0.21, 0.36, 0.5), seen
by the oracle at 16 shaded reference views, from which the model builds
its latent. For each target (the oracle's silhouette at a target camera)
the coarse stage (``--chains`` Metropolis-Hastings chains of ``--mh-iters``
steps; the control: CEM of 128 x 10, 48 elites) is followed by gradient
refinement of its best ``--refine-samples`` for ``--refine-iters`` steps,
and ADD-S against 512 surface points is gated at a tenth of the diameter.
Runs in bfloat16, as the JAX tool does (``dtypes``); the caller's compute
dtype is restored on return. Writes ``pose_eval.json`` in the JAX record's
layout (``artifacts/metropolis/pose_eval.json``).

The cameras are JAX's (reference views from ``PRNGKey(7)``, targets from
``PRNGKey(55)`` split in three per target), which this package cannot
redraw: ``eval_cameras.json`` holds them. The estimators' draws come from
``torch.Generator``s seeded with ``--seed``. ``--tiny`` runs the tiny
family with random weights (a smoke of the rig). Runs on the GPU unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from . import dtypes, testing, zoo
from .camera import Camera
from .device import resolve_device, synchronize
from .pose import estimation, metrics
from .recon.inference import LatentFusionModel
from .three import orientation

EVAL_CAMERAS = Path(__file__).with_name("eval_cameras.json")
OBJECT_AXES = (0.21, 0.36, 0.5)  # the encoder-distill training object
CEM_BUDGET = {"cem_samples": 128, "cem_iters": 10, "cem_elites": 48}


def load_eval_cameras(device="cuda") -> dict:
    """``eval_cameras.json``'s cameras on ``device``: ``reference`` (one
    Camera of 16), ``metropolis_targets`` (a list of one-camera Cameras)
    and ``serving_targets`` (rounds of lists of one-camera Cameras, one per
    object)."""
    device = resolve_device(device)
    rec = json.loads(EVAL_CAMERAS.read_text())

    def cameras(extrinsics):
        extrinsic = torch.tensor(extrinsics, dtype=torch.float32)
        n = extrinsic.shape[0]
        intrinsic = torch.tensor(rec["intrinsic"], dtype=torch.float32).expand(n, 3, 4)
        return Camera(intrinsic, extrinsic, z_span=rec["z_span"], width=rec["width"],
                      height=rec["height"], device=device)

    def singles(extrinsics):
        cams = cameras(extrinsics)
        return [cams[i] for i in range(len(cams))]

    return {"reference": cameras(rec["reference"]),
            "metropolis_targets": singles(rec["metropolis_targets"]),
            "serving_targets": [singles(row) for row in rec["serving_targets"]]}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, required=True,
                        help="directory for pose_eval.json (not artifacts/metropolis: "
                             "the JAX package's record is there)")
    parser.add_argument("--checkpoint", type=Path,
                        default=Path("artifacts/encoder_distill/encoder_distill.npz"))
    parser.add_argument("--targets", type=int, default=8)
    parser.add_argument("--chains", type=int, default=128)
    parser.add_argument("--mh-iters", type=int, default=300)
    parser.add_argument("--refine-samples", type=int, default=16)
    parser.add_argument("--refine-iters", type=int, default=150)
    parser.add_argument("--tiny", action="store_true",
                        help="random tiny model (a smoke of the rig)")
    parser.add_argument("--seed", type=int, default=0, help="seeds the estimators' draws")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def build_model(args, device) -> LatentFusionModel:
    """The demo family with the checkpoint's weights, or with ``--tiny``
    the tiny family with weights drawn from seed 0."""
    if args.tiny:
        gen = torch.Generator().manual_seed(0)
        return LatentFusionModel(zoo.tiny_sculptor(device=device, generator=gen), None,
                                 zoo.tiny_fuser(device=device, generator=gen), None,
                                 zoo.tiny_photographer(device=device, generator=gen), None,
                                 camera_dist=zoo.DEMO_CAMERA_DIST, device=device)
    from .unseen_eval import build_model as build_family

    return build_family("demo", args.checkpoint, device)


@dtypes.compute_dtype()
def main(argv=None) -> dict:
    """Writes ``pose_eval.json`` and returns its content."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    dtypes.set_compute_dtype("bfloat16")
    args.out.mkdir(parents=True, exist_ok=True)
    model = build_model(args, device)
    diameter = 2 * max(OBJECT_AXES)
    oracle = testing.EllipsoidOracleModel(model.input_size, model.camera_dist, OBJECT_AXES,
                                          device=device)
    points = (orientation.evenly_distributed_points(512, device=device)
              * torch.tensor(OBJECT_AXES, device=device))
    cams = load_eval_cameras(device)
    if args.targets > len(cams["metropolis_targets"]):
        raise ValueError(f"{EVAL_CAMERAS.name} holds {len(cams['metropolis_targets'])} targets")
    z_obj = model.build_latent_object(oracle.make_observation(cams["reference"], shaded=True))

    metro = estimation.MetropolisPoseEstimator(
        model=model, num_samples=args.chains, num_iters=args.mh_iters,
        loss_weights={"depth": 1.0}, ranking_size=args.refine_samples)
    cem = estimation.CrossEntropyPoseEstimator(
        model=model, num_gmm_components=6, sample_flipped=True,
        num_samples=CEM_BUDGET["cem_samples"], num_iters=CEM_BUDGET["cem_iters"],
        num_elites=CEM_BUDGET["cem_elites"], learning_rate=0.75,
        loss_weights={"depth": 1.0}, ranking_size=16)
    fine = estimation.GradientPoseEstimator(
        model=model, ranking_size=min(8, args.refine_samples),
        loss_weights={"depth": 1.0, "ov_depth": 0.3}, learning_rate=0.01,
        num_samples=args.refine_samples, num_iters=args.refine_iters,
        converge_threshold=1e-6, converge_patience=25, optimizer="adam")

    def m_of(gt_cam, cam):
        m = metrics.camera_metrics(gt_cam, cam, points, scale_to_meters=1.0)
        return {k: float(m[k]) for k in ("add_s", "rotation_dist", "translation_dist")}

    def run(coarse, tag):
        generator = torch.Generator(device=device).manual_seed(args.seed)
        rows = []
        for t, gt_cam in enumerate(cams["metropolis_targets"][:args.targets]):
            target = oracle.make_observation(gt_cam)
            t0 = time.time()
            coarse_cams = coarse.estimate(z_obj, target, generator=generator)
            best = fine.estimate(z_obj, target, camera=coarse_cams[:args.refine_samples])
            synchronize(device)
            dt = time.time() - t0
            refined = m_of(gt_cam, best[0])
            row = {"target": t, "coarse": m_of(gt_cam, coarse_cams[0]), "refined": refined,
                   "seconds": round(dt, 3), "add_s_01d": bool(refined["add_s"] < 0.1 * diameter)}
            rows.append(row)
            print(f"[{tag}] target {t}: coarse={row['coarse']['add_s']:.4f} "
                  f"refined={refined['add_s']:.4f} {dt:.1f}s 0.1d={row['add_s_01d']}",
                  flush=True)
        warm = (float(np.mean([r["seconds"] for r in rows[1:]])) if len(rows) > 1
                else rows[0]["seconds"])
        return {"targets": rows, "add_s_0.1d": float(np.mean([r["add_s_01d"] for r in rows])),
                "warm_seconds_per_object": round(warm, 3)}

    refine_budget = {"refine_samples": args.refine_samples, "refine_iters": args.refine_iters}
    summary = {
        "checkpoint": str(args.checkpoint),
        "object": "encoder-distill ellipsoid", "diameter": diameter,
        "threshold": 0.1 * diameter,
        "metropolis": {
            "budget": {"chains": args.chains, "mh_iters": args.mh_iters, **refine_budget},
            **run(metro, "metropolis")},
        "cem_control": {
            "budget": {**CEM_BUDGET, **refine_budget},
            **run(cem, "cem")},
    }
    (args.out / "pose_eval.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps({"metropolis_add_s_0.1d": summary["metropolis"]["add_s_0.1d"],
                      "cem_add_s_0.1d": summary["cem_control"]["add_s_0.1d"]}))
    return summary


if __name__ == "__main__":
    main()
