"""Pose of held-out unseen objects on the mesh data path (counterpart of the
evaluation half of ``tools/train_unseen_real.py``, its ``--skip-train``).

    python -m latentfusion_tpu_torch.unseen_real --out DIR \\
        [--checkpoint artifacts/unseen_real/unseen_real.npz] [--device cpu]

The lobe pools are triangulated into OBJ meshes as the JAX tool does (the
held-out pool, seed ``--pool-seed`` + 7919, at 48 x 96 per lobe; the
training pool, seed ``--pool-seed``, at 32 x 64 for the train control).
Each held-out mesh is rendered by the host rasterizer with its clean
default material (no lights: ambient only) at the rig's 16 reference
cameras and its target cameras (640x480, f 615), the cameras of
``unseen_cameras.json`` (the JAX rig's draws). Then, for each target index,
one ``estimate_batch`` of CEM and one of refinement over the held-out
objects (``unseen_eval.evaluate_batch``) at the JAX record's budget: CEM
128 x 10 with 48 elites, refinement 16 x 150, the latent ranking term at
0.2. ``pose_eval.json`` is written in the tool's schema, under
``rasterizer``; ``--oracle`` adds the analytic renderer's pass and
``--train-control`` object 0 of the training pool.

The checkpoint is the demo family's, its leaves in the order of
``artifacts/unseen_objects_pool128/unseen_objects_keys.json`` (the demo
family's leaf order; ``unseen_real.npz`` has no keys file of its own).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from . import testing, unseen_eval
from .camera import Camera
from .data import rendering
from .device import resolve_device
from .observation import Observation
from .three import quaternion as quat

ROOT = Path(__file__).resolve().parents[1]
CHECKPOINT = ROOT / "artifacts" / "unseen_real" / "unseen_real.npz"
KEYS = ROOT / "artifacts" / "unseen_objects_pool128" / "unseen_objects_keys.json"
EVAL_INTRINSIC = np.asarray([[615.0, 0, 320], [0, 615.0, 240], [0, 0, 1]], np.float32)
EVAL_WIDTH, EVAL_HEIGHT = 640, 480
TRAIN_MESH = (32, 64)  # lat, lon of a lobe of the training pool's meshes
HELDOUT_MESH = (48, 96)
BUDGET = {"cem_samples": 128, "cem_iters": 10, "cem_elites": 48,
          "refine_samples": 16, "refine_iters": 150}
RANK_LATENT_WEIGHT = 0.2


def pool_meshes(assets_dir, pool_seed: int, n: int, heldout: bool, device="cpu"):
    """The lobe pool of ``pool_seed`` (+ 7919 if ``heldout``) and its meshes
    under ``assets_dir``, written once (the tool's directory names). Returns
    (pool, surface clouds, OBJ paths)."""
    seed = pool_seed + unseen_eval.HELDOUT_SEED_OFFSET if heldout else pool_seed
    pool, clouds = testing.sample_lobe_shapes(seed, n, diameter=unseen_eval.DIAMETER,
                                              device=device)
    name = f"meshes_heldout_s{seed}_k{n}" if heldout else f"meshes_s{seed}_k{n}"
    mesh_dir = Path(assets_dir) / name
    lat, lon = HELDOUT_MESH if heldout else TRAIN_MESH
    if not (mesh_dir / f"lobes_{n - 1:04d}.obj").exists():
        testing.lobe_shape_meshes(pool, mesh_dir, lat=lat, lon=lon)
    return pool, clouds, sorted(mesh_dir.glob("lobes_*.obj"))[:n]


def mesh_scene(mesh_path) -> rendering.SceneContext:
    """The mesh as written (not recentred or resized) with its default
    material and no lights, at the evaluation's intrinsic."""
    obj, _ = rendering.load_object(mesh_path, recenter=False, resize=False)
    return rendering.SceneContext(obj, EVAL_INTRINSIC)


def rasterize_observation(mesh_path, camera: Camera, renderer=None, scene=None) -> Observation:
    """The mesh rendered by the host rasterizer at each of ``camera``'s
    poses (640x480, f 615), on the camera's device; ``scene`` (the mesh's
    ``mesh_scene``) saves reading the file again."""
    renderer = renderer or rendering.Renderer(EVAL_WIDTH, EVAL_HEIGHT)
    ctx = scene or mesh_scene(mesh_path)
    extrinsic = camera.extrinsic.detach().cpu()
    colors, depths, masks = [], [], []
    for i in range(len(camera)):
        q = quat.mat_to_quat(extrinsic[i, :3, :3]).numpy()
        ctx.set_pose(extrinsic[i, :3, 3].numpy(), q)
        c, d, m = renderer.render(ctx)
        colors.append(c.transpose(2, 0, 1))
        depths.append(d[None])
        masks.append(m[None])
    return Observation(np.stack(colors), np.stack(depths), np.stack(masks), camera)


def rasterized_views(mesh_paths, ref_cams: Camera, target_cams):
    """Each mesh at the reference cameras and at each target camera:
    [(reference Observation, [(camera, target Observation)])], and the
    seconds the renders took (reading the meshes included)."""
    renderer = rendering.Renderer(EVAL_WIDTH, EVAL_HEIGHT)
    t0 = time.perf_counter()
    views = []
    for path in mesh_paths:
        scene = mesh_scene(path)
        views.append((rasterize_observation(path, ref_cams, renderer, scene),
                      [(cam, rasterize_observation(path, cam, renderer, scene))
                       for cam in target_cams]))
    if ref_cams.device.type == "cuda":
        torch.cuda.synchronize()
    return views, time.perf_counter() - t0


def heldout_record(rows) -> list:
    return [{"object": h, "add_s_0.1d": float(np.mean([r["add_s_01d"] for r in obj_rows])),
             "targets": obj_rows} for h, obj_rows in enumerate(rows)]


def source_record(rows, control=None) -> dict:
    """A source's block of ``pose_eval.json`` (the tool's keys)."""
    held = [r for obj_rows in rows for r in obj_rows]
    out = {"heldout": heldout_record(rows),
           "heldout_add_s_0.1d": float(np.mean([r["add_s_01d"] for r in held]))}
    if control is not None:
        out["train_control"] = [{"object": 0, "add_s_0.1d": control[1], "targets": control[0]}]
        out["train_add_s_0.1d"] = control[1]
    return out


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkpoint", type=Path, default=CHECKPOINT)
    parser.add_argument("--keys", type=Path, default=KEYS,
                        help="the checkpoint's leaf names, one per leaf in order")
    parser.add_argument("--train-objects", type=int, default=128)
    parser.add_argument("--heldout-objects", type=int, default=4)
    parser.add_argument("--pool-seed", type=int, default=0)
    parser.add_argument("--eval-targets", type=int, default=6)
    parser.add_argument("--eval-views", type=int, default=16)
    for key, value in BUDGET.items():
        parser.add_argument(f"--{key.replace('_', '-')}", type=int, default=value)
    parser.add_argument("--rank-latent-weight", type=float, default=RANK_LATENT_WEIGHT)
    parser.add_argument("--rank-mask-weight", type=float, default=0.0)
    parser.add_argument("--rank-iou-weight", type=float, default=0.0)
    parser.add_argument("--oracle", action="store_true",
                        help="also evaluate on the analytic renderer's views")
    parser.add_argument("--train-control", action="store_true",
                        help="also evaluate object 0 of the training pool")
    parser.add_argument("--assets-dir", type=Path, default=None,
                        help="where the meshes are written (default: OUT/assets)")
    parser.add_argument("--seed", type=int, default=0, help="seeds the CEM's generator")
    parser.add_argument("--out", type=Path, required=True,
                        help="directory for pose_eval.json")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    assets = args.assets_dir or args.out / "assets"
    model = unseen_eval.build_model("demo", args.checkpoint, device, keys=args.keys)
    budget = {k: getattr(args, k) for k in BUDGET}
    extra = unseen_eval.extra_weights_from_args(args)
    ref_cams, target_cams = unseen_eval.load_cameras(args.eval_views, args.eval_targets, device)
    pool, clouds, paths = pool_meshes(assets, args.pool_seed, args.heldout_objects, True, device)
    views, render_s = rasterized_views(paths, ref_cams, target_cams)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    def run(source_views, tag):
        rows, seconds = unseen_eval.evaluate_batch(
            model, [v[0] for v in source_views], [v[1] for v in source_views], clouds,
            budget, extra, tag=tag, generator=generator)
        return rows, seconds

    rows, seconds = run(views, "[rasterizer] ")
    control = None
    if args.train_control:
        _, train_clouds, train_paths = pool_meshes(assets, args.pool_seed, args.train_objects,
                                                   False)
        ref_obs, targets = rasterized_views(train_paths[:1], ref_cams, target_cams)[0][0]
        control = unseen_eval.evaluate_object(model, ref_obs, targets, train_clouds[0], budget,
                                              extra, tag="[train 0] [rasterizer] ",
                                              generator=generator)
    summary = {
        "split": {"train_objects": args.train_objects, "train_pool_seed": args.pool_seed,
                  "heldout_objects": args.heldout_objects,
                  "heldout_pool_seed": args.pool_seed + unseen_eval.HELDOUT_SEED_OFFSET,
                  "note": "held-out meshes come from a disjoint RNG stream: novel lobe "
                          "geometry, never rendered during training"},
        "search_budget": unseen_eval.search_budget_record(args),
        "family": "demo", "checkpoint": str(args.checkpoint),
        "rasterizer": source_record(rows, control),
        "render_s": render_s, "seconds_per_batch": seconds,
        "seed": args.seed, "device": str(device)}
    if args.oracle:
        oracle = [unseen_eval.object_views(pool, h, ref_cams, target_cams)
                  for h in range(args.heldout_objects)]
        summary["oracle"] = source_record(run(oracle, "[oracle] ")[0])
    summary["heldout_add_s_0.1d"] = summary["rasterizer"]["heldout_add_s_0.1d"]
    if control is not None:
        summary["train_add_s_0.1d"] = control[1]
    summary["diameter"] = unseen_eval.DIAMETER
    summary["threshold"] = 0.1 * unseen_eval.DIAMETER
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "pose_eval.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps({"heldout_add_s_0.1d": summary["heldout_add_s_0.1d"],
                      "render_s": render_s}))
    return summary


if __name__ == "__main__":
    main()
