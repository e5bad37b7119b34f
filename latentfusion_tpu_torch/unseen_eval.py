"""Pose of held-out unseen objects (counterpart of ``tools/unseen_eval.py``
and of the ``--skip-train`` evaluation half of
``tools/train_unseen_objects.py``).

    python -m latentfusion_tpu_torch.unseen_eval \\
        --checkpoint artifacts/unseen_objects_pool128/unseen_objects.npz \\
        --heldout-objects 4 --out /tmp/unseen [--batch] [--device cpu]

For each held-out object (object h of the lobe pool of seed ``--pool-seed``
+ 7919, never rendered in training) and for object 0 of the training pool
(the in-distribution control): the latent from the object's reference views
(``build_latent_object``), then for each target pose CEM, gradient
refinement and ADD-S against the object's surface points, gated at a tenth
of its diameter. Writes ``pose_eval.json`` in the JAX rig's schema.

The cameras are JAX's: the rig draws them from ``jax.random`` (the
reference views from ``PRNGKey(7)``, each target from ``PRNGKey(55)`` split
per target), which this package cannot redraw, so ``unseen_cameras.json``
holds them. Its 16 reference cameras are those the committed JAX renders
``artifacts/serving/frames/refs_o*.npz`` were made at; ``--eval-views N``
takes the first N (JAX draws another set for each N). Its targets are the
first 6 of the rig's stream, drawn by JAX in fp32. The CEM's draws come from
a ``torch.Generator`` seeded with ``--seed``.

``--batch`` estimates the held-out objects' target t together, one
``estimate_batch`` of CEM and one of refinement per target index (the
in-process half of ``tools/serving_accuracy.py``).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from . import testing, zoo
from .camera import Camera
from .device import resolve_device
from .pose import estimation, metrics
from .recon.checkpoint import from_jax_params, load_params_npz, split_state_dict
from .recon.inference import LatentFusionModel

CAMERAS = Path(__file__).with_name("unseen_cameras.json")
CAMERA_DIST = 5.78  # the demo rigs' canonical distance (zoo.DEMO_CAMERA_DIST)
DIAMETER = 1.0
HELDOUT_SEED_OFFSET = 7919  # held-out pool seed = training pool seed + this
FAMILIES = ("demo", "mid", "tiny")


def search_budget_record(args) -> dict:
    """The ``search_budget`` block of ``pose_eval.json``."""
    return {"cem_samples": args.cem_samples, "cem_iters": args.cem_iters,
            "cem_elites": args.cem_elites, "refine_samples": args.refine_samples,
            "refine_iters": args.refine_iters,
            "rank_latent_weight": args.rank_latent_weight,
            "rank_mask_weight": args.rank_mask_weight,
            "rank_iou_weight": args.rank_iou_weight}


def extra_weights_from_args(args) -> dict:
    """The ranking terms added to both estimators' depth loss."""
    return {k: w for k, w in (("latent", args.rank_latent_weight),
                              ("mask", args.rank_mask_weight),
                              ("iou", args.rank_iou_weight)) if w > 0.0}


# The reference's cross_entropy_{quick,slow}.toml budgets and semantics, as
# the JAX rigs spell them (tools/train_encoder_distill.py:289-297).
COARSE_CONFIGS = {
    "quick": {"num_samples": 128, "num_iters": 10, "num_elites": 48, "learning_rate": 0.75,
              "loss_weights": {"depth": 1.0}, "ranking_size": 16},
    "slow": {"num_samples": 200, "num_iters": 30, "num_elites": 64, "learning_rate": 0.3,
             "loss_weights": {"depth": 1.0, "ov_depth": 0.2}, "ranking_size": 64},
}


def build_estimators(model, budget: dict, extra_weights=None, coarse_config: str = "quick"):
    """The rig's coarse and fine stack: CEM at ``COARSE_CONFIGS[coarse_config]``'s
    learning rate, loss weights and ranking and gradient refinement at
    ``adam_slow``'s, sized by ``budget``."""
    extra_weights = dict(extra_weights or {})
    preset = COARSE_CONFIGS[coarse_config]
    coarse = estimation.CrossEntropyPoseEstimator(
        model=model, num_gmm_components=6, sample_flipped=True,
        num_samples=budget["cem_samples"], num_iters=budget["cem_iters"],
        num_elites=budget["cem_elites"], learning_rate=preset["learning_rate"],
        loss_weights={**preset["loss_weights"], **extra_weights},
        ranking_size=min(preset["ranking_size"], budget["cem_samples"]))
    fine = estimation.GradientPoseEstimator(
        model=model, ranking_size=min(8, budget["refine_samples"]),
        loss_weights={"depth": 1.0, "ov_depth": 0.3, **extra_weights},
        learning_rate=0.01, num_samples=budget["refine_samples"],
        num_iters=budget["refine_iters"], converge_threshold=1e-6,
        converge_patience=25, optimizer="adam")
    return coarse, fine


def load_cameras(num_views: int = 16, num_targets: int = 6, device="cuda"):
    """The rig's first ``num_views`` reference cameras (one Camera) and
    first ``num_targets`` target cameras (a list of one-camera Cameras)."""
    device = resolve_device(device)
    rec = json.loads(CAMERAS.read_text())
    refs, targets = rec["reference"], rec["targets"]
    if num_views > len(refs["extrinsic"]) or num_targets > len(targets["extrinsic"]):
        raise ValueError(f"{CAMERAS.name} holds {len(refs['extrinsic'])} reference and "
                         f"{len(targets['extrinsic'])} target cameras")

    def cameras(part, n):
        extrinsic = torch.tensor(part["extrinsic"][:n], dtype=torch.float32)
        intrinsic = torch.tensor(part["intrinsic"], dtype=torch.float32).expand(n, 3, 4)
        return Camera(intrinsic, extrinsic, z_span=0.5, width=640, height=480, device=device)

    target = cameras(targets, num_targets)
    return cameras(refs, num_views), [target[i] for i in range(num_targets)]


def _metrics(gt_cam, cam, points) -> dict:
    m = metrics.camera_metrics(gt_cam, cam, points, 1.0)
    return {k: m[k] for k in ("add_s", "rotation_dist", "translation_dist")}


def _row(t, gt_cam, coarse_cam, best_cam, points, diameter) -> dict:
    refined = _metrics(gt_cam, best_cam, points)
    return {"target": t, "coarse": _metrics(gt_cam, coarse_cam, points),
            "refined": refined, "add_s_01d": bool(refined["add_s"] < 0.1 * diameter)}


def _say_row(tag, row) -> None:
    r = row["refined"]
    print(f"{tag}target {row['target']}: coarse add_s={row['coarse']['add_s']:.4f} "
          f"refined={r['add_s']:.4f} rot={r['rotation_dist']:.3f} "
          f"trans={r['translation_dist']:.4f} 0.1d={row['add_s_01d']}", flush=True)


def evaluate_object(model, ref_obs, targets, points, budget, extra_weights=None,
                    diameter: float = DIAMETER, tag: str = "", generator=None, draws=None,
                    coarse_config: str = "quick"):
    """Estimate each target of one object and gate it at ADD-S < 0.1
    ``diameter``. ``targets``: a list of (ground-truth camera, target
    Observation); ``points``: the object's surface points (P, 3). The CEM
    draws from ``generator``; ``draws(t)``, for tests, gives target t's
    CEM another implementation's random stream (the estimator's
    ``draws=``). Returns (one row per target, the share within 0.1d)."""
    z_obj = model.build_latent_object(ref_obs)
    coarse, fine = build_estimators(model, budget, extra_weights, coarse_config)
    points = torch.as_tensor(points, device=model.device)
    rows = []
    for t, (gt_cam, target) in enumerate(targets):
        kwargs = {} if draws is None else {"draws": draws(t)}
        coarse_cams = coarse.estimate(z_obj, target, generator=generator, **kwargs)
        best = fine.estimate(z_obj, target,
                             camera=coarse_cams[:min(budget["refine_samples"], len(coarse_cams))])
        rows.append(_row(t, gt_cam, coarse_cams[0], best[0], points, diameter))
        _say_row(tag, rows[-1])
    return rows, float(np.mean([r["add_s_01d"] for r in rows]))


def evaluate_batch(model, ref_obs, targets, points, budget, extra_weights=None,
                   diameter: float = DIAMETER, tag: str = "", generator=None):
    """``evaluate_object`` for B objects at once: ``ref_obs``, ``targets``
    and ``points`` hold one entry per object, and each target index t is one
    ``estimate_batch`` of CEM and one of refinement over the B objects.
    Returns (B lists of rows, the seconds of each target index's batch)."""
    z_objs = torch.cat([model.build_latent_object(obs) for obs in ref_obs])
    coarse, fine = build_estimators(model, budget, extra_weights)
    points = [torch.as_tensor(p, device=model.device) for p in points]
    rows = [[] for _ in ref_obs]
    seconds = []
    for t in range(len(targets[0])):
        t0 = time.perf_counter()
        frames = [obj_targets[t][1] for obj_targets in targets]
        coarse_out = coarse.estimate_batch(z_objs, frames, generator=generator)
        n = min(budget["refine_samples"], len(coarse_out[0]))
        best = fine.estimate_batch(z_objs, frames,
                                   cameras=Camera.cat([c[:n] for c in coarse_out]))
        for b, obj_targets in enumerate(targets):
            rows[b].append(_row(t, obj_targets[t][0], coarse_out[b][0], best[b][0],
                                points[b], diameter))
            _say_row(f"{tag}[heldout {b}] ", rows[b][-1])
        seconds.append(time.perf_counter() - t0)
    return rows, seconds


def build_model(family: str, checkpoint, device="cuda", keys=None) -> LatentFusionModel:
    """The ``family``'s modules with the weights of an enumerated-leaf
    checkpoint (``<stem>.npz``, its leaves named by ``keys``, by default
    ``<stem>_keys.json`` beside it)."""
    device = resolve_device(device)
    if family not in FAMILIES:
        raise ValueError(f"family {family!r} is not one of {FAMILIES}")
    checkpoint = Path(checkpoint)
    keys = checkpoint.with_name(f"{checkpoint.stem}_keys.json") if keys is None else keys
    state = split_state_dict(from_jax_params(load_params_npz(checkpoint, keys)))
    modules = {"demo": (zoo.demo_sculptor, zoo.demo_fuser, zoo.demo_photographer),
               "mid": (zoo.mid_sculptor, zoo.mid_fuser, zoo.mid_photographer),
               "tiny": (zoo.tiny_sculptor, zoo.tiny_fuser, zoo.tiny_photographer)}[family]
    sculptor, fuser, photographer = (make(device=device) for make in modules)
    return LatentFusionModel(sculptor, state["sculptor"], fuser, state["fuser"],
                             photographer, state["photographer"], camera_dist=CAMERA_DIST,
                             device=device)


def object_views(pool, k: int, ref_cams: Camera, target_cams):
    """Object ``k`` of ``pool`` at the reference cameras (one Observation)
    and at each target camera (a list of (camera, Observation))."""
    shape = testing.index_lobe_shape(pool, k)
    return (testing.lobe_observation(shape, ref_cams),
            [(cam, testing.lobe_observation(shape, cam)) for cam in target_cams])


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkpoint", type=Path, required=True,
                        help="enumerated-leaf npz with <stem>_keys.json beside it")
    parser.add_argument("--family", choices=FAMILIES, default="demo")
    parser.add_argument("--train-objects", type=int, default=10,
                        help="the training pool's size, for the split record")
    parser.add_argument("--heldout-objects", type=int, default=2)
    parser.add_argument("--pool-seed", type=int, default=0)
    parser.add_argument("--eval-targets", type=int, default=6)
    parser.add_argument("--eval-views", type=int, default=16)
    parser.add_argument("--cem-samples", type=int, default=128)
    parser.add_argument("--cem-iters", type=int, default=10)
    parser.add_argument("--cem-elites", type=int, default=48)
    parser.add_argument("--refine-samples", type=int, default=16)
    parser.add_argument("--refine-iters", type=int, default=150)
    parser.add_argument("--rank-latent-weight", type=float, default=0.0)
    parser.add_argument("--rank-mask-weight", type=float, default=0.0)
    parser.add_argument("--rank-iou-weight", type=float, default=0.0)
    parser.add_argument("--batch", action="store_true",
                        help="estimate the held-out objects' target t in one estimate_batch")
    parser.add_argument("--seed", type=int, default=0, help="seeds the CEM's generator")
    parser.add_argument("--out", type=Path, required=True,
                        help="directory for pose_eval.json")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    model = build_model(args.family, args.checkpoint, device)
    budget = {k: getattr(args, k) for k in ("cem_samples", "cem_iters", "cem_elites",
                                            "refine_samples", "refine_iters")}
    extra = extra_weights_from_args(args)
    ref_cams, target_cams = load_cameras(args.eval_views, args.eval_targets, device)
    heldout_seed = args.pool_seed + HELDOUT_SEED_OFFSET
    heldout_pool, heldout_clouds = testing.sample_lobe_shapes(
        heldout_seed, args.heldout_objects, diameter=DIAMETER, device=device)
    train_pool, train_clouds = testing.sample_lobe_shapes(args.pool_seed, 1,
                                                          diameter=DIAMETER, device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    views = [object_views(heldout_pool, h, ref_cams, target_cams)
             for h in range(args.heldout_objects)]
    summary = {"heldout": []}
    if args.batch:
        rows, seconds = evaluate_batch(model, [v[0] for v in views], [v[1] for v in views],
                                       heldout_clouds, budget, extra, generator=generator)
        summary["seconds_per_batch"] = seconds
    else:
        rows = [evaluate_object(model, ref_obs, targets, heldout_clouds[h], budget, extra,
                                tag=f"[heldout {h}] ", generator=generator)[0]
                for h, (ref_obs, targets) in enumerate(views)]
    for h, obj_rows in enumerate(rows):
        summary["heldout"].append({"object": h, "add_s_0.1d": float(np.mean(
            [r["add_s_01d"] for r in obj_rows])), "targets": obj_rows})
    ref_obs, targets = object_views(train_pool, 0, ref_cams, target_cams)
    control_rows, control = evaluate_object(model, ref_obs, targets, train_clouds[0], budget,
                                            extra, tag="[train 0] ", generator=generator)
    held = [r for obj_rows in rows for r in obj_rows]
    summary.update({
        "train_control": [{"object": 0, "add_s_0.1d": control, "targets": control_rows}],
        "heldout_add_s_0.1d": float(np.mean([r["add_s_01d"] for r in held])),
        "train_add_s_0.1d": control,
        "diameter": DIAMETER, "threshold": 0.1 * DIAMETER,
        "split": {"train_objects": args.train_objects, "train_pool_seed": args.pool_seed,
                  "heldout_objects": args.heldout_objects, "heldout_pool_seed": heldout_seed,
                  "note": "held-out shapes come from a disjoint RNG stream: novel lobe "
                          "geometry AND novel texture, never rendered during training"},
        "family": args.family, "checkpoint": str(args.checkpoint),
        "eval_views": args.eval_views, "batch": args.batch, "seed": args.seed,
        "device": str(device), "search_budget": search_budget_record(args)})
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "pose_eval.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps({"heldout_add_s_0.1d": summary["heldout_add_s_0.1d"],
                      "train_add_s_0.1d": control}))
    return summary


if __name__ == "__main__":
    main()
