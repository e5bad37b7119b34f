"""Encoder-in-the-loop distillation on the card (counterpart of
``tools/train_encoder_distill.py``): the demo family (Sculptor, GRU fuser,
Photographer) trained on the analytic ellipsoid at fresh random cameras
every step, in bf16, then evaluated by pose estimation (ADD-S 0.1d).

Per step: render ``--views-in`` shaded full-frame views of the oracle at
random cameras; zoom, prepare, normalize, encode and fuse them (gradients
on); decode at ``--views-out`` fresh zoomed cameras; 25 x depth L1 + 25 x
mask BCE against the oracle, plus ``--frame-loss-weight`` x the estimator's
full-frame depth terms. Adam (0.9, 0.99) on a cosine decay to 1 % over
``--steps``.

    python -m latentfusion_tpu_torch.train_encoder_distill --steps 20000 \\
        --out DIR [--snapshot-steps 5000,10000] [--coarse-config slow] [--device cpu]

Writes ``encoder_distill.npz`` and ``encoder_distill_keys.json`` (the JAX
tool's leaf order and paths: its ``--skip-train`` and this package's
loaders read them), after training the reference-schema ``checkpoint.pth``
(a failed export raises, where the JAX tool prints and carries on),
``history.json``, ``pose_eval.json`` and, with
snapshots, ``scaling_curve.json``. The cameras come from a
``torch.Generator`` on the device (the JAX tool's from ``jax.random``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import dtypes

INPUT_SIZE = 128
CAMERA_DIST = 5.78
AXES = (0.21, 0.36, 0.5)
DIAMETER = 2 * max(AXES)
DEPTH_WEIGHT = MASK_WEIGHT = 25.0
OV_DEPTH_WEIGHT = 0.3
LOG_EVERY = 500


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=20000)
    parser.add_argument("--views-in", type=int, default=8,
                        help="reference views encoded per step")
    parser.add_argument("--views-out", type=int, default=8,
                        help="fresh supervision cameras per step")
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--out", type=Path, required=True,
                        help="output directory (no default, so that a run cannot "
                             "overwrite the committed artifacts/encoder_distill)")
    parser.add_argument("--eval-targets", type=int, default=8)
    parser.add_argument("--eval-views", type=int, default=16,
                        help="reference views for the eval latent build")
    parser.add_argument("--skip-train", action="store_true",
                        help="load <out>/encoder_distill.npz and only eval")
    parser.add_argument("--frame-loss-weight", type=float, default=2.0)
    parser.add_argument("--input-depth", action=argparse.BooleanOptionalAction, default=True,
                        help="feed normalized depth to the encoder")
    parser.add_argument("--snapshot-steps", default="",
                        help="comma-separated intermediate budgets to snapshot + "
                             "evaluate (scaling curve)")
    parser.add_argument("--curve-targets", type=int, default=6,
                        help="eval targets per snapshot on the curve")
    parser.add_argument("--coarse-config", default="quick", choices=["quick", "slow"],
                        help="reference cross_entropy_{quick,slow}.toml coarse-search "
                             "budget/semantics")
    parser.add_argument("--cem-samples", type=int, default=None,
                        help="CEM hypotheses an iteration (default: the coarse config's, "
                             "128 quick, 200 slow)")
    parser.add_argument("--cem-iters", type=int, default=None,
                        help="CEM iterations (default: the coarse config's, 10 or 30)")
    parser.add_argument("--cem-elites", type=int, default=None,
                        help="CEM elites (default: the coarse config's, 48 or 64)")
    parser.add_argument("--refine-samples", type=int, default=16)
    parser.add_argument("--refine-iters", type=int, default=150)
    parser.add_argument("--device", default="cuda", help="default the card")
    return parser.parse_args(argv)


def log(message: str) -> None:
    print(message, file=sys.stderr, flush=True)


def encode_views(sculptor, fuser, obs, input_size: int, camera_dist: float):
    """``LatentFusionModel.build_latent_object`` with gradients on: the
    full-frame views zoomed, prepared, normalized, encoded and fused."""
    from .recon import models

    obs = obs.zoom(camera_dist, input_size).prepare().normalize()
    return models.encode(sculptor, fuser, obs.camera, obs.color[None], obs.depth[None],
                         obs.mask[None])


def distill_terms(photographer, z_obj, cam, cam_full, o_depth, o_mask, target,
                  frame_loss_weight: float):
    """The rigs' loss on the decode of ``z_obj`` at the zoomed cameras
    ``cam`` of ``cam_full``: 25 x depth L1 + 25 x mask BCE against the
    oracle's (V, 1, S, S) depth and mask, plus ``frame_loss_weight`` x (the
    full-frame depth loss + 0.3 x its overlap term) against ``target``.
    Returns (loss, {depth_l1, mask_bce, frame_depth})."""
    from .recon import models

    y, _, _ = models.decode(photographer, z_obj, cam)
    return prediction_terms(y["depth"][0], y["mask_logits"][0], cam, o_depth, o_mask, target,
                            frame_loss_weight)


def prediction_terms(pred_depth, pred_mask_logits, cam, o_depth, o_mask, target,
                     frame_loss_weight: float):
    """``distill_terms`` of a decode's (V, 1, S, S) depth and mask logits."""
    from .pose import estimation

    pred_depth, pred_mask_logits = pred_depth.float(), pred_mask_logits.float()
    depth_l1 = (pred_depth - o_depth).abs().mean()
    mask_bce = estimation._bce_with_logits(pred_mask_logits, o_mask).mean()
    loss = DEPTH_WEIGHT * depth_l1 + MASK_WEIGHT * mask_bce
    frame_depth = torch.zeros((), device=loss.device)
    if frame_loss_weight > 0.0:
        frame = estimation.default_pose_loss(target, cam.denormalize_depth(pred_depth),
                                             pred_mask_logits, cam)
        frame_depth = frame["depth"].mean()
        loss = loss + frame_loss_weight * (frame_depth
                                           + OV_DEPTH_WEIGHT * frame["ov_depth"].mean())
    return loss, {"depth_l1": depth_l1, "mask_bce": mask_bce, "frame_depth": frame_depth}


def ellipsoid_loss(modules, oracle, cam_in, cam_full, frame_loss_weight: float):
    """The encoder-distill loss at input cameras ``cam_in`` and output
    cameras ``cam_full`` (full frame), at the oracle's input size."""
    size = oracle.input_size
    with torch.no_grad():
        obs = oracle.make_observation(cam_in, shaded=True)
        cam = cam_full.zoom(None, size, CAMERA_DIST)
        y_o, _ = oracle.decode_latent(None, cam)
        o_depth, o_mask = y_o["depth"][0], (y_o["mask"][0] > 0.5).float()
        target = oracle.make_observation(cam_full) if frame_loss_weight > 0 else None
    z_obj = encode_views(modules["sculptor"], modules["fuser"], obs, size, CAMERA_DIST)
    return distill_terms(modules["photographer"], z_obj, cam, cam_full, o_depth, o_mask,
                         target, frame_loss_weight)


def make_optimizer(modules, lr: float, steps: int):
    """Adam (0.9, 0.99) on ``optax.cosine_decay_schedule(lr, steps, 0.01)``:
    returns (optimizer, schedule)."""
    from .utils import cosine_decay_schedule

    params = [p for m in modules.values() for p in m.parameters()]
    return (torch.optim.Adam(params, lr=lr, betas=(0.9, 0.99), eps=1e-8),
            cosine_decay_schedule(lr, max(steps, 1), alpha=0.01))


def train_step(optimizer, schedule, step: int, loss_fn):
    """One update at ``schedule(step)``: returns (loss, terms), detached."""
    from .pose import estimation

    for group in optimizer.param_groups:
        group["lr"] = schedule(step)
    optimizer.zero_grad(set_to_none=True)
    with estimation.deterministic_cudnn():
        loss, terms = loss_fn()
        loss.backward()
    optimizer.step()
    return loss.detach(), {k: v.detach() for k, v in terms.items()}


def history_row(i: int, loss, terms) -> dict:
    return {"step": i, "loss": float(loss), **{k: float(v) for k, v in terms.items()}}


def save_params(modules, out: Path, stem: str, keys: bool = True) -> None:
    """The modules' parameters as the JAX rigs' npz (and keys json)."""
    from .recon import checkpoint as ckpt

    state = {f"{name}.{k}": v for name, m in modules.items()
             for k, v in m.state_dict().items()}
    ckpt.save_params_npz(out / f"{stem}.npz", state,
                         out / f"{stem}_keys.json" if keys else None)


def write_pth(modules, path: Path, input_depth: bool = True) -> None:
    """The reference-schema ``checkpoint.pth`` of the demo family, which both
    packages' ``LatentFusionModel.from_checkpoint`` read. A failed write
    raises."""
    from . import zoo
    from .recon import checkpoint as ckpt

    ckpt.save_reference_checkpoint(
        path, ckpt.reference_entries(zoo.demo_module_args(input_depth), modules["fuser"]),
        {name: m.state_dict() for name, m in modules.items()}, name="encoder_distill",
        args={"camera_dist": CAMERA_DIST})
    log(f"# wrote {path}")


def load_params(modules, path, keys_json) -> None:
    from .recon import checkpoint as ckpt

    state = ckpt.split_state_dict(ckpt.from_jax_params(ckpt.load_params_npz(path, keys_json)))
    for name, m in modules.items():
        m.load_state_dict(state[name])


def demo_modules(device, generator, input_depth: bool = True):
    from . import zoo

    return {"sculptor": zoo.demo_sculptor(input_depth=input_depth, device=device,
                                          generator=generator).train(),
            "fuser": zoo.demo_fuser(device=device, generator=generator).train(),
            "photographer": zoo.demo_photographer(device=device, generator=generator).train()}


def snapshot(modules) -> dict:
    return {name: {k: v.detach().clone() for k, v in m.state_dict().items()}
            for name, m in modules.items()}


def budget_of(args) -> dict:
    """The search budget: ``--cem-*`` where given, else ``--coarse-config``'s."""
    from .unseen_eval import COARSE_CONFIGS

    preset = COARSE_CONFIGS[args.coarse_config]
    pick = {"cem_samples": (args.cem_samples, preset["num_samples"]),
            "cem_iters": (args.cem_iters, preset["num_iters"]),
            "cem_elites": (args.cem_elites, preset["num_elites"])}
    return {**{k: preset_value if given is None else given
               for k, (given, preset_value) in pick.items()},
            "refine_samples": args.refine_samples, "refine_iters": args.refine_iters}


def evaluate(modules, state, oracle, args, n_targets, device, tag=""):
    """The latent from ``--eval-views`` held-out reference views through the
    trained encoder, then CEM and refinement at ``n_targets`` random 640x480
    targets; ADD-S against the ellipsoid's surface points."""
    from . import testing, unseen_eval, zoo
    from .recon.inference import LatentFusionModel
    from .three import orientation
    from .three import quaternion as quat

    model = LatentFusionModel(modules["sculptor"], state["sculptor"], modules["fuser"],
                              state["fuser"], modules["photographer"], state["photographer"],
                              camera_dist=CAMERA_DIST, device=device)
    g = torch.Generator(device).manual_seed(7)
    ref_obs = oracle.make_observation(zoo.random_view_cameras(args.eval_views, g, CAMERA_DIST,
                                                              device=device), shaded=True)
    targets = []
    for _ in range(n_targets):
        gt_cam = testing.make_camera(1, z=CAMERA_DIST, f=615.0, width=640, height=480,
                                     quats=quat.random(1, g), device=device)
        targets.append((gt_cam, oracle.make_observation(gt_cam)))
    points = orientation.evenly_distributed_points(512).to(device) * torch.tensor(
        AXES, device=device)
    return unseen_eval.evaluate_object(model, ref_obs, targets, points, budget_of(args),
                                       diameter=DIAMETER, tag=tag, generator=g,
                                       coarse_config=args.coarse_config)


def curve_row(step: int, rows, acc) -> dict:
    return {"step": step, "add_s_0.1d": acc,
            "mean_add_s": float(np.mean([r["refined"]["add_s"] for r in rows])),
            "mean_rotation_dist": float(np.mean([r["refined"]["rotation_dist"]
                                                 for r in rows])),
            "targets": rows}


@dtypes.compute_dtype()
def main(argv=None) -> dict:
    """Train (unless ``--skip-train``) and evaluate; returns the summary."""
    from . import testing, zoo
    from .device import resolve_device

    args = get_args(argv)
    device = resolve_device(args.device)
    dtypes.set_compute_dtype("bfloat16")
    args.out.mkdir(parents=True, exist_ok=True)
    snapshot_steps = sorted(int(s) for s in args.snapshot_steps.split(",") if s.strip())
    generator = torch.Generator(device).manual_seed(0)
    modules = demo_modules(device, generator, args.input_depth)
    oracle = testing.EllipsoidOracleModel(input_size=INPUT_SIZE, camera_dist=CAMERA_DIST,
                                          axes=AXES, device=device)

    def loss_fn():
        cam_in = zoo.random_view_cameras(args.views_in, generator, CAMERA_DIST, device=device)
        cam_full = zoo.random_view_cameras(args.views_out, generator, CAMERA_DIST,
                                           device=device)
        return ellipsoid_loss(modules, oracle, cam_in, cam_full, args.frame_loss_weight)

    history, snapshots = [], {}
    if not args.skip_train:
        n_params = sum(p.numel() for m in modules.values() for p in m.parameters())
        log(f"# {n_params / 1e6:.1f}M trainable params")
        optimizer, schedule = make_optimizer(modules, args.lr, args.steps)
        t0 = time.time()
        for i in range(args.steps):
            loss, terms = train_step(optimizer, schedule, i, loss_fn)
            if i in snapshot_steps:
                snapshots[i] = snapshot(modules)
                log(f"# snapshot at step {i}")
            if i and (i % LOG_EVERY == 0 or i == args.steps - 1):
                history.append(history_row(i, loss, terms))
                log(f"step {i}: loss={float(loss):.4f} ({i / (time.time() - t0):.1f} steps/s)")
        (args.out / "history.json").write_text(json.dumps(history))
        save_params(modules, args.out, "encoder_distill")
        write_pth(modules, args.out / "checkpoint.pth", args.input_depth)
    else:
        load_params(modules, args.out / "encoder_distill.npz",
                    args.out / "encoder_distill_keys.json")

    final, curve = snapshot(modules), []
    for s in sorted(snapshots):
        rows, acc = evaluate(modules, snapshots[s], oracle, args, args.curve_targets, device,
                             tag=f"[step {s}] ")
        curve.append(curve_row(s, rows, acc))
        print(json.dumps({"curve_step": s, "add_s_0.1d": acc}), flush=True)
    rows, acc = evaluate(modules, final, oracle, args, args.eval_targets, device)
    if snapshot_steps and not args.skip_train:
        curve.append(curve_row(args.steps, rows, acc))
        (args.out / "scaling_curve.json").write_text(json.dumps(curve, indent=2))
    summary = {"targets": rows, "add_s_0.1d": acc, "diameter": DIAMETER,
               "threshold": 0.1 * DIAMETER, "history": history[-5:],
               "eval_views": args.eval_views,
               "trained_with": "encoder-in-the-loop distillation (latent from Sculptor.encode "
                               "+ GRUFuser over rendered reference views; dense depth/mask "
                               "regression at fresh cameras; decoder from scratch)"}
    (args.out / "pose_eval.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps({"add_s_0.1d": acc, "mean_refined_add_s": float(np.mean(
        [r["refined"]["add_s"] for r in rows]))}))
    return summary


if __name__ == "__main__":
    main()
