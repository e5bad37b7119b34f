"""Several unseen objects estimated together, in process and through the
pose service, with ADD-S and warm latency (counterpart of
``tools/serving_accuracy.py``).

    python -m latentfusion_tpu_torch.serving_accuracy --out DIR \\
        [--checkpoint artifacts/unseen_objects_pool128/unseen_objects.npz] \\
        [--objects 2] [--rounds 3] [--rank-latent-weight 0.2] \\
        [--skip-daemon] [--device cpu]

The objects are held-out shapes of the pool-128 checkpoint's recorded split
(never rendered in its training), each seen at ``--eval-views`` reference
views; each round renders one target frame of every object (the lobe
oracle, full frame) into ``DIR/frames`` and estimates them all at once:
in process by ``estimate_batch`` (CEM 128 x 10 then refinement 16 x 150,
each object's best 16 refined, the latent ranking term at
``--rank-latent-weight``), in bfloat16 as the JAX tool sets it; then the
same frames through ``python -m latentfusion_tpu_torch.serve --stdio``
(one ``estimate`` request of all objects per round, in the service's
float32). ADD-S against each object's surface points is gated at 0.1 (the
objects' diameter is 1). Writes ``accuracy.json`` in the JAX record's
layout (``artifacts/serving/accuracy.json``).

The cameras are JAX's (``eval_cameras.json``: reference views from
``PRNGKey(7)``, its first ``--eval-views``; the targets from
``PRNGKey(55)`` split in two per object and round). Round r's coarse draws
come from a ``torch.Generator`` seeded with 100 + r in both halves. Runs on
the GPU unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import dtypes, testing
from .camera import Camera
from .device import resolve_device, synchronize
from .metropolis_eval import load_eval_cameras
from .pose import estimation, metrics
from .unseen_eval import build_model

ROOT = Path(__file__).resolve().parents[1]
# The record's budget: CEM 128 x 10 (48 elites), refinement 16 x 150.
CEM_SAMPLES, CEM_ITERS, REFINE_ITERS = 128, 10, 150
NOTE = ("objects are HELD-OUT shapes of the pool-128 checkpoint's recorded split; per-round "
        "joint latency covers N objects through ONE coarse loop + ONE refinement loop")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, required=True,
                        help="directory for accuracy.json and the target frames "
                             "(not artifacts/serving: the JAX package's record is there)")
    parser.add_argument("--checkpoint", type=Path,
                        default=Path("artifacts/unseen_objects_pool128/unseen_objects.npz"))
    parser.add_argument("--objects", type=int, default=2,
                        help="held-out objects estimated jointly")
    parser.add_argument("--rounds", type=int, default=3,
                        help="joint estimate rounds (one fresh target pose "
                             "per object per round; round 0 is cold)")
    parser.add_argument("--eval-views", type=int, default=16)
    parser.add_argument("--rank-latent-weight", type=float, default=0.2)
    parser.add_argument("--skip-daemon", action="store_true",
                        help="only the in-process estimate_batch half")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def estimator_configs(args) -> tuple:
    """The coarse and fine configurations (the service's JSON form)."""
    extra = {"latent": args.rank_latent_weight} if args.rank_latent_weight > 0 else {}
    coarse = {"type": "cross_entropy",
              "args": {"num_samples": CEM_SAMPLES, "num_iters": CEM_ITERS,
                       "num_elites": min(48, CEM_SAMPLES // 2), "learning_rate": 0.75,
                       "num_gmm_components": 6, "sample_flipped": True,
                       "ranking_size": min(16, CEM_SAMPLES)},
              "loss_weights": {"depth": 1.0, **extra}}
    fine = {"type": "gradient",
            "args": {"num_samples": 16, "num_iters": REFINE_ITERS, "learning_rate": 0.01,
                     "converge_threshold": 1e-6, "converge_patience": 25,
                     "optimizer": "adam", "ranking_size": 8},
            "loss_weights": {"depth": 1.0, "ov_depth": 0.3, **extra}}
    return coarse, fine


def save_obs_npz(obs, path) -> str:
    """An Observation in the service's npz layout."""
    np.savez(path, **{k: v.detach().float().cpu().numpy() for k, v in (
        ("color", obs.color), ("depth", obs.depth), ("mask", obs.mask),
        ("intrinsic", obs.camera.intrinsic), ("extrinsic", obs.camera.extrinsic))})
    return str(path)


def _hits_summary(rows) -> tuple:
    hits = [d["add_s_01d"] for row in rows for d in row["objects"]]
    warm = (round(float(np.mean([r["seconds_joint"] for r in rows[1:]])), 3)
            if len(rows) > 1 else None)
    return float(np.mean(hits)), warm


def in_process_rounds(model, coarse, fine, ref_obs, rounds, add_s_of) -> list:
    """Each round's frames in one ``estimate_batch`` of CEM and one of
    refinement."""
    z_objs = torch.cat([model.build_latent_object(o) for o in ref_obs], dim=0)
    out = []
    for r, row in enumerate(rounds):
        targets = [t for _, t, _ in row]
        generator = torch.Generator(device=model.device).manual_seed(100 + r)
        t0 = time.time()
        coarse_out = coarse.estimate_batch(z_objs, targets, generator=generator)
        best = fine.estimate_batch(z_objs, targets,
                                   cameras=Camera.cat([c[:16] for c in coarse_out]))
        synchronize(model.device)
        dt = time.time() - t0
        per_obj = [{"object": k, "add_s": round(add_s_of(row[k][0], best[k][:1], k), 5)}
                   for k in range(len(row))]
        for d in per_obj:
            d["add_s_01d"] = bool(d["add_s"] < 0.1)
        out.append({"round": r, "cold": r == 0, "seconds_joint": round(dt, 3),
                    "objects": per_obj})
        print(f"# round {r}: {dt:.2f}s {[d['add_s'] for d in per_obj]}", file=sys.stderr)
    return out


def served_rounds(rpc, ref_paths, rounds, add_s_of) -> list:
    """Register each object's reference npz, then per round one
    ``estimate`` of every object's frame, through ``rpc`` (request dict ->
    response dict)."""
    for k, path in enumerate(ref_paths):
        resp = rpc({"cmd": "register", "object": f"obj{k}", "npz": path})
        if not resp["ok"]:
            raise RuntimeError(f"register failed: {resp}")
    out = []
    for r, row in enumerate(rounds):
        t0 = time.time()
        resp = rpc({"cmd": "estimate", "object": [f"obj{k}" for k in range(len(row))],
                    "npz": [p for _, _, p in row], "seed": 100 + r, "top_k": 16})
        dt = time.time() - t0
        if not resp["ok"]:
            raise RuntimeError(f"estimate failed: {resp}")
        per_obj = []
        for k, pose in enumerate(resp["poses"]):
            gt_cam, target, _ = row[k]
            est = Camera(target.camera.intrinsic,
                         torch.tensor(pose["extrinsic"], dtype=torch.float32)[None],
                         z_span=target.camera.z_span, width=target.camera.width,
                         height=target.camera.height, device=target.camera.device)
            a = add_s_of(gt_cam, est, k)
            per_obj.append({"object": k, "add_s": round(a, 5), "add_s_01d": bool(a < 0.1)})
        out.append({"round": r, "cold": r == 0, "seconds_joint": round(dt, 3),
                    "server_seconds": resp["seconds"], "objects": per_obj})
        print(f"# served round {r}: {dt:.2f}s {[d['add_s'] for d in per_obj]}",
              file=sys.stderr)
    return out


@contextlib.contextmanager
def service_process(args):
    """``python -m latentfusion_tpu_torch.serve --stdio`` on the
    checkpoint and the estimators' configurations; yields its ``rpc``, and
    shuts it down on exit."""
    coarse, fine = estimator_configs(args)
    cmd = [sys.executable, "-m", "latentfusion_tpu_torch.serve", "--stdio",
           "--demo-npz", str(args.checkpoint), "--coarse-json", json.dumps(coarse),
           "--fine-json", json.dumps(fine), "--top-k", "16", "--device", args.device]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])}
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
                            bufsize=1, cwd=ROOT, env=env)

    def rpc(req):
        proc.stdin.write(json.dumps(req) + "\n")
        proc.stdin.flush()
        line = proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the service exited with code {proc.poll()}")
        return json.loads(line)

    try:
        yield rpc
        rpc({"cmd": "shutdown"})
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@dtypes.compute_dtype()
def main(argv=None, rpc=None) -> dict:
    """Writes ``accuracy.json`` and returns its content. ``rpc`` (tests)
    replaces the service process for the served half."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    args.out = Path(args.out)
    args.out.mkdir(parents=True, exist_ok=True)
    frames = args.out / "frames"
    frames.mkdir(exist_ok=True)

    split = json.loads((args.checkpoint.parent / "pose_eval.json").read_text())["split"]
    pool, clouds = testing.sample_lobe_shapes(split["heldout_pool_seed"], args.objects,
                                              device=device)
    shapes = [testing.index_lobe_shape(pool, k) for k in range(args.objects)]
    cams = load_eval_cameras(device)
    if args.rounds > len(cams["serving_targets"]) or args.objects > len(
            cams["serving_targets"][0]) or args.eval_views > len(cams["reference"]):
        raise ValueError("eval_cameras.json holds 3 rounds of 2 objects and 16 reference views")
    ref_obs = [testing.lobe_observation(s, cams["reference"][:args.eval_views]) for s in shapes]
    rounds = []
    for r in range(args.rounds):
        row = []
        for k, s in enumerate(shapes):
            gt_cam = cams["serving_targets"][r][k]
            target = testing.lobe_observation(s, gt_cam)
            row.append((gt_cam, target, save_obs_npz(target, frames / f"target_r{r}_o{k}.npz")))
        rounds.append(row)

    clouds = [torch.as_tensor(c, device=device) for c in clouds]

    def add_s_of(gt_cam, est_cam, k):
        return float(metrics.camera_metrics(gt_cam, est_cam, clouds[k],
                                            scale_to_meters=1.0)["add_s"])

    dtypes.set_compute_dtype("bfloat16")
    model = build_model("demo", args.checkpoint, device)
    coarse_cfg, fine_cfg = estimator_configs(args)
    coarse = estimation.load_from_config(coarse_cfg, model)
    fine = estimation.load_from_config(fine_cfg, model)
    print("# estimate_batch (in-process joint)...", file=sys.stderr)
    direct_rows = in_process_rounds(model, coarse, fine, ref_obs, rounds, add_s_of)
    acc, warm = _hits_summary(direct_rows)
    direct = {"rounds": direct_rows, "add_s_0.1d": acc, "warm_seconds_joint": warm,
              "objects_per_batch": args.objects}
    del model, coarse, fine
    dtypes.set_compute_dtype("float32")

    served = None
    if not args.skip_daemon:
        print("# starting the pose service...", file=sys.stderr)
        ref_paths = [save_obs_npz(o, frames / f"refs_o{k}.npz") for k, o in enumerate(ref_obs)]
        with (contextlib.nullcontext(rpc) if rpc is not None
              else service_process(args)) as call:
            served_rows = served_rounds(call, ref_paths, rounds, add_s_of)
        acc, warm = _hits_summary(served_rows)
        served = {"rounds": served_rows, "add_s_0.1d": acc, "warm_seconds_joint": warm}

    summary = {"checkpoint": str(args.checkpoint), "objects": args.objects,
               "rounds": args.rounds, "heldout_pool_seed": split["heldout_pool_seed"],
               "rank_latent_weight": args.rank_latent_weight, "estimate_batch": direct,
               "served": served, "note": NOTE}
    (args.out / "accuracy.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps({"estimate_batch_add_s_0.1d": direct["add_s_0.1d"],
                      "served_add_s_0.1d": served["add_s_0.1d"] if served else None}))
    return summary


if __name__ == "__main__":
    main()
