"""Oracle distillation on the card (counterpart of
``tools/train_oracle_distill.py``): the mid-size Photographer and a free
learnable latent trained to regress the analytic ellipsoid's depth and mask
renders at fresh random cameras, in bf16, then the CEM + gradient pose
pipeline through the distilled decoder alone, gated at ADD-S 0.1d.

Per step: ``--views`` random full-frame cameras (a uniform rotation, the
translation jittered by N(0, (0.1, 0.1, 0.25)) around (0, 0, 5.78)) and
their zoomed crops; the latent (1, 1, 128, 8, 8, 8) broadcast to one volume
a view and decoded; 25 x depth L1 + 25 x mask BCE against the oracle's
zoomed render, plus ``--frame-loss-weight`` x (the full-frame depth loss +
0.3 x its overlap term) through ``Camera.uncrop``. Adam (0.9, 0.99) on a
cosine decay to 1 % over ``--steps``.

    python -m latentfusion_tpu_torch.train_oracle_distill --steps 30000 --out DIR \\
        [--skip-train] [--sharpness-probe] [--coarse-config slow] [--device cpu]

Writes ``distilled.npz`` and ``distilled_keys.json`` in the JAX tool's
flattened schema (the photographer's leaves, then ``z_obj``: either
package's ``--skip-train`` reads the other's), ``history.json`` and
``pose_eval.json`` (the JAX tool's keys). ``--skip-train`` reads the npz
and its keys from ``--out``. The training cameras come from
``torch.Generator``s with fixed seeds (the photographer's initial weights
from seed 0, the cameras from 1, the latent from 2); the evaluation's
targets are the JAX tool's draws, from ``eval_cameras.json``
(``metropolis_targets``: ``PRNGKey(55)`` split per target), and the CEM's
from a generator seeded with 55.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from . import dtypes

INPUT_SIZE = 128
CAMERA_DIST = 5.78
AXES = (0.21, 0.36, 0.5)  # unit bounding diameter
DIAMETER = 2 * max(AXES)
LATENT_CHANNELS = 128
LATENT_SIZE = INPUT_SIZE // 16
LOG_EVERY = 500
PROBE_ANGLES = np.linspace(0.0, 0.6, 13)
Z_KEY = "['z_obj']"
# adam_slow's shape; no mask term (the reference ships no mask-weighted config).
FINE = {"ranking_size": 8, "loss_weights": {"depth": 1.0, "ov_depth": 0.3},
        "learning_rate": 0.01, "num_samples": 16, "num_iters": 150,
        "converge_threshold": 1e-6, "converge_patience": 25, "optimizer": "adam"}


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=30000)
    parser.add_argument("--views", type=int, default=16, help="fresh random cameras per step")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--out", type=Path, required=True,
                        help="output directory (no default, so that a run cannot "
                             "overwrite the committed artifacts/oracle_distill)")
    parser.add_argument("--eval-targets", type=int, default=8)
    parser.add_argument("--skip-train", action="store_true",
                        help="load <out>/distilled.npz and only eval")
    parser.add_argument("--frame-loss-weight", type=float, default=2.0,
                        help="weight of the full-frame estimator-objective terms (0 disables)")
    parser.add_argument("--sharpness-probe", action="store_true",
                        help="also record the loss-vs-angle-offset curve")
    parser.add_argument("--coarse-samples", type=int, default=None,
                        help="override CEM hypotheses/iter (default: preset)")
    parser.add_argument("--coarse-iters", type=int, default=None,
                        help="override CEM iterations (default: preset)")
    parser.add_argument("--coarse-config", default="quick", choices=["quick", "slow"],
                        help="reference cross_entropy_{quick,slow}.toml coarse-search "
                             "budget/semantics")
    parser.add_argument("--device", default="cuda", help="default the card")
    return parser.parse_args(argv)


def distill_loss(photographer, z_obj, oracle, cam_full, frame_loss_weight: float):
    """The distillation loss of ``z_obj`` (1, 1, C, S, S, S), broadcast to a
    volume for each camera of ``cam_full`` (zoomed to the oracle's input
    size), against the oracle. Returns
    (loss, {depth_l1, mask_bce, frame_depth})."""
    from .train_encoder_distill import prediction_terms

    views = len(cam_full)
    with torch.no_grad():
        cam = cam_full.zoom(None, oracle.input_size, CAMERA_DIST)
        y_o, _ = oracle.decode_latent(None, cam)
        o_depth, o_mask = y_o["depth"][0], (y_o["mask"][0] > 0.5).float()
        target = oracle.make_observation(cam_full) if frame_loss_weight > 0.0 else None
    z = z_obj.expand(1, views, *z_obj.shape[2:]).reshape(views, *z_obj.shape[2:])
    logits, _, _ = photographer(z, cam)
    y = photographer.interpret_logits(logits)
    return prediction_terms(y["depth"], y["mask_logits"], cam, o_depth, o_mask, target,
                            frame_loss_weight)


def init_latent(device) -> torch.Tensor:
    """The free latent, N(0, 1) x 0.1 from seed 2, as a leaf with gradients."""
    g = torch.Generator(device).manual_seed(2)
    z = torch.randn((1, 1, LATENT_CHANNELS) + (LATENT_SIZE,) * 3, generator=g,
                    device=device) * 0.1
    return z.requires_grad_(True)


def save_distilled(out: Path, photographer, z_obj) -> None:
    """``distilled.npz`` (leaf i as "i") and ``distilled_keys.json`` in the
    JAX tool's leaf order: {photographer, z_obj} flattened, keys sorted."""
    from .recon import checkpoint as ckpt

    params = ckpt.to_jax_params({f"photographer.{k}": v
                                 for k, v in photographer.state_dict().items()})
    params[Z_KEY] = z_obj.detach().float().cpu().numpy()
    np.savez(out / "distilled.npz", **{str(i): v for i, v in enumerate(params.values())})
    (out / "distilled_keys.json").write_text(json.dumps(list(params)))


def load_distilled(out: Path, photographer, device) -> torch.Tensor:
    """Load ``<out>/distilled.npz`` (either package's) into ``photographer``;
    returns the latent."""
    from .recon import checkpoint as ckpt

    params = ckpt.load_params_npz(out / "distilled.npz", out / "distilled_keys.json")
    z_obj = torch.as_tensor(params.pop(Z_KEY), dtype=torch.float32, device=device)
    photographer.load_state_dict(ckpt.split_state_dict(ckpt.from_jax_params(params))
                                 ["photographer"])
    return z_obj


def train(args, photographer, oracle, device):
    """``--steps`` Adam steps on the photographer and the latent. Returns
    (the latent, the history rows, each step's loss as a device tensor)."""
    from . import zoo
    from .train_encoder_distill import history_row, log, train_step
    from .utils import cosine_decay_schedule

    z_obj = init_latent(device)
    params = list(photographer.parameters()) + [z_obj]
    log(f"# {sum(p.numel() for p in params) / 1e6:.1f}M trainable params")
    optimizer = torch.optim.Adam(params, lr=args.lr, betas=(0.9, 0.99), eps=1e-8)
    schedule = cosine_decay_schedule(args.lr, max(args.steps, 1), alpha=0.01)
    generator = torch.Generator(device).manual_seed(1)
    history, losses = [], []
    t0 = time.time()
    for i in range(args.steps):
        # Hypothesis-like full-frame cameras: a uniform rotation, the
        # translation jittered around (0, 0, CAMERA_DIST).
        cam_full = zoo.random_view_cameras(args.views, generator, CAMERA_DIST, device=device)
        loss, terms = train_step(optimizer, schedule, i, lambda: distill_loss(
            photographer, z_obj, oracle, cam_full, args.frame_loss_weight))
        losses.append(loss)
        if i and (i % LOG_EVERY == 0 or i == args.steps - 1):
            history.append(history_row(i, loss, terms))
            row = history[-1]
            log(f"step {i}: loss={row['loss']:.4f} d={row['depth_l1']:.4f} "
                f"m={row['mask_bce']:.4f} f={row['frame_depth']:.4f} "
                f"({i / (time.time() - t0):.1f} steps/s)")
    return z_obj.detach(), history, losses


def coarse_kwargs(args) -> dict:
    """The CEM's budget and semantics: ``--coarse-config``'s preset, with
    ``--coarse-samples`` (elites at least 3/8 of them) and ``--coarse-iters``."""
    from .unseen_eval import COARSE_CONFIGS

    kw = dict(COARSE_CONFIGS[args.coarse_config])
    if args.coarse_samples:
        kw["num_samples"] = args.coarse_samples
        kw["num_elites"] = max(kw["num_elites"], (3 * args.coarse_samples) // 8)
    if args.coarse_iters:
        kw["num_iters"] = args.coarse_iters
    return kw


def decoder_model(photographer, device):
    """The decoder-only ``LatentFusionModel`` the estimators render through."""
    from .recon.inference import LatentFusionModel

    model = LatentFusionModel(None, None, None, None, photographer, None,
                              camera_dist=CAMERA_DIST, device=device)
    model.input_size = INPUT_SIZE
    return model


def build_estimators(model, args):
    """CEM at ``coarse_kwargs(args)`` (6 components, flips) and the
    ``adam_slow``-shaped refinement of 16 for 150 steps without a mask term."""
    from .pose import estimation

    coarse = estimation.CrossEntropyPoseEstimator(model=model, num_gmm_components=6,
                                                  sample_flipped=True, **coarse_kwargs(args))
    fine = estimation.GradientPoseEstimator(model=model, **FINE)
    return coarse, fine


def score(fine, z_obj, target, camera) -> float:
    """The refinement's weighted loss, the least over ``camera``'s hypotheses."""
    with torch.no_grad():
        loss, _ = fine._score_hypotheses(z_obj, target, camera)
    return float(loss.min())


def evaluate_target(coarse, fine, z_obj, oracle, gt_cam, points, generator, t=0,
                    draws=None) -> dict:
    """CEM then refinement of the 16 best at one target; its row. ``draws``
    (for tests) gives the CEM another implementation's random stream."""
    from .unseen_eval import _metrics

    target = oracle.make_observation(gt_cam)
    kwargs = {} if draws is None else {"draws": draws}
    coarse_cams = coarse.estimate(z_obj, target, generator=generator, **kwargs)
    best = fine.estimate(z_obj, target, camera=coarse_cams[:fine.num_samples])
    refined = _metrics(gt_cam, best[0], points)
    return {"target": t, "coarse": _metrics(gt_cam, coarse_cams[0], points),
            "refined": refined, "loss_at_gt": score(fine, z_obj, target, gt_cam),
            "loss_refined": score(fine, z_obj, target, best[:1]),
            "add_s_01d": bool(refined["add_s"] < 0.1 * DIAMETER)}


def surface_points(device) -> torch.Tensor:
    """512 sunflower directions scaled by the ellipsoid's semi-axes."""
    from .three import orientation

    return orientation.evenly_distributed_points(512).to(device) * torch.tensor(AXES,
                                                                               device=device)


def evaluate(coarse, fine, z_obj, oracle, n_targets: int, device, generator):
    """CEM then refinement at the first ``n_targets`` of the JAX tool's
    targets; ADD-S against 512 surface points of the ellipsoid. Returns the
    rows."""
    from .metropolis_eval import load_eval_cameras

    targets = load_eval_cameras(device)["metropolis_targets"]
    if n_targets > len(targets):
        raise ValueError(f"eval_cameras.json holds {len(targets)} targets")
    points = surface_points(device)
    rows = []
    for t in range(n_targets):
        row = evaluate_target(coarse, fine, z_obj, oracle, targets[t], points, generator, t)
        rows.append(row)
        r = row["refined"]
        print(f"target {t}: coarse add_s={row['coarse']['add_s']:.4f} "
              f"refined={r['add_s']:.4f} rot={r['rotation_dist']:.3f} "
              f"trans={r['translation_dist']:.4f} loss_gt={row['loss_at_gt']:.4f} "
              f"loss_ref={row['loss_refined']:.4f} 0.1d={row['add_s_01d']}", flush=True)
    return rows


def sharpness_curve(fine, z_obj, oracle, device, angles=PROBE_ANGLES) -> list:
    """The loss at a rotation of each angle about y against the target at
    the identity: how sharp the distilled decoder's pose objective is."""
    from . import testing

    def camera(quats=None):
        return testing.make_camera(1, z=CAMERA_DIST, f=615.0, width=640, height=480,
                                   quats=quats, device=device)

    target = oracle.make_observation(camera())
    curve = []
    for ang in angles:
        q = np.concatenate([[np.cos(ang / 2)],
                            np.sin(ang / 2) * np.asarray([0.0, 1.0, 0.0])]).astype(np.float32)
        with torch.no_grad():
            loss, _ = fine._score_hypotheses(z_obj, target, camera(torch.from_numpy(q)[None]))
        curve.append({"angle_rad": float(ang), "loss": float(loss[0])})
        print(f"sharpness angle={ang:.3f} loss={float(loss[0]):.5f}", flush=True)
    return curve


@dtypes.compute_dtype()
def main(argv=None) -> dict:
    """Train (unless ``--skip-train``) and evaluate; returns the summary."""
    from . import testing, zoo
    from .device import resolve_device

    args = get_args(argv)
    device = resolve_device(args.device)
    dtypes.set_compute_dtype("bfloat16")
    args.out.mkdir(parents=True, exist_ok=True)
    # The JAX tool's mid-size Photographer (its PHOTOGRAPHER_*_CONFIG, factor
    # projection, nearest resizes, depth and mask) is the demo family's.
    photographer = zoo.demo_photographer(device=device,
                                         generator=torch.Generator(device).manual_seed(0))
    oracle = testing.EllipsoidOracleModel(input_size=INPUT_SIZE, camera_dist=CAMERA_DIST,
                                          axes=AXES, device=device)
    history = []
    if not args.skip_train:
        z_obj, history, _ = train(args, photographer.train(), oracle, device)
        (args.out / "history.json").write_text(json.dumps(history))
        save_distilled(args.out, photographer, z_obj)
    else:
        z_obj = load_distilled(args.out, photographer, device)

    coarse, fine = build_estimators(decoder_model(photographer, device), args)
    rows = evaluate(coarse, fine, z_obj, oracle, args.eval_targets, device,
                    torch.Generator(device).manual_seed(55))
    acc = float(np.mean([r["add_s_01d"] for r in rows]))
    mean_ref = float(np.mean([r["refined"]["add_s"] for r in rows]))
    summary = {"targets": rows, "add_s_0.1d": acc, "diameter": DIAMETER,
               "threshold": 0.1 * DIAMETER, "history": history[-5:],
               "trained_with": "oracle distillation (dense depth/mask regression from random "
                               "cameras; learned free latent; no encoder)"}
    if args.sharpness_probe:
        summary["sharpness_curve"] = sharpness_curve(fine, z_obj, oracle, device)
    (args.out / "pose_eval.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps({"add_s_0.1d": acc, "mean_refined_add_s": mean_ref}))
    return summary


if __name__ == "__main__":
    main()
