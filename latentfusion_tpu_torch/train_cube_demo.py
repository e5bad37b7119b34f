"""The cube demo on the card (counterpart of ``tools/train_cube_demo.py``):
train the mid-size LatentFusion stack on synthetic renders of one textured
cube, then run the whole pose pipeline (latent build, CEM, gradient
refinement, ADD-S) through the learned weights.

The model is the demo family at 128² (the Sculptor without a depth input,
the GRU fuser, the Photographer); the data is a pool of ``--pool`` batches
of the synthetic stream at 160x120, rendered once by the host rasterizer.
The step is the training tool's (random orientation, ``remat``, top-4096
hard smooth-L1 depth, weights 25/25) in bf16 under Adam (0, 0.99), or
``--lr-cosine`` (a cosine decay to 1 %).

    python -m latentfusion_tpu_torch.train_cube_demo --steps 8000 --out DIR \\
        [--skip-train] [--device cpu]

Writes ``<out>/cube.obj``, ``checkpoint.pth`` (the reference schema, which
both packages' ``LatentFusionModel.from_checkpoint`` read; ``--skip-train``
reads it), ``history.json`` and ``pose_eval.json`` (the JAX tool's keys).
The JAX tool's reference views and targets come from ``jax.random``, which
this package cannot redraw: ``experiment_cameras.json`` holds their
rotations. The weights start from a ``torch.Generator`` seeded with 0, the
steps' orientations from one seeded with 1, the CEM's from one seeded with
55.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from . import dtypes

W, H, F = 160, 120, 120.0
CAMERA_DIST = 1.5
INPUT_SIZE = 128
LOG_EVERY = 200
EXPERIMENT_CAMERAS = Path(__file__).with_name("experiment_cameras.json")
STEP_CONFIG = {"camera_dist": CAMERA_DIST, "random_orientation": True, "remat": True,
               "g_depth_recon_loss_type": "hard_smooth_l1", "g_depth_recon_loss_k": 4096,
               "g_depth_recon_loss_weight": 25.0, "g_mask_recon_loss_weight": 25.0}
COARSE = {"ranking_size": 8, "loss_weights": {"depth": 1.0}, "num_samples": 64,
          "num_iters": 10, "num_elites": 24, "num_gmm_components": 4, "learning_rate": 0.75,
          "sample_flipped": True}
# adam_quick's weights; no mask term (the reference ships no mask-weighted config).
FINE = {"ranking_size": 8, "loss_weights": {"depth": 1.0, "ov_depth": 0.3},
        "learning_rate": 0.01, "num_samples": 8, "num_iters": 100,
        "converge_threshold": 1e-6, "converge_patience": 20, "optimizer": "adam"}


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=8000)
    parser.add_argument("--pool", type=int, default=24, help="pre-rendered batch pool size")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--views-in", type=int, default=4)
    parser.add_argument("--views-out", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--lr-cosine", action="store_true",
                        help="cosine-decay the learning rate to lr/100 over --steps")
    parser.add_argument("--out", type=Path, required=True,
                        help="output directory (no default, so that a run cannot "
                             "overwrite the committed artifacts/cube_demo)")
    parser.add_argument("--eval-targets", type=int, default=4)
    parser.add_argument("--skip-train", action="store_true",
                        help="load <out>/checkpoint.pth and only eval")
    parser.add_argument("--device", default="cuda", help="default the card")
    return parser.parse_args(argv)


def make_models(device, generator=None):
    """(sculptor, fuser, photographer): the demo family, the Sculptor reading
    color and mask only."""
    from . import zoo

    return (zoo.demo_sculptor(input_depth=False, device=device, generator=generator),
            zoo.demo_fuser(device=device, generator=generator),
            zoo.demo_photographer(device=device, generator=generator))


def make_cube_obj(tmp_dir: Path, size=0.5) -> Path:
    """An axis-aligned cube of edge ``size`` as ``<tmp_dir>/cube.obj``."""
    s = size / 2
    verts = [(-s, -s, -s), (s, -s, -s), (s, s, -s), (-s, s, -s),
             (-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s)]
    faces = [(1, 2, 3), (1, 3, 4), (5, 7, 6), (5, 8, 7), (1, 5, 6),
             (1, 6, 2), (2, 6, 7), (2, 7, 3), (3, 7, 8), (3, 8, 4),
             (5, 1, 4), (5, 4, 8)]
    path = tmp_dir / "cube.obj"
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")
    return path


def load_draws() -> dict:
    """``experiment_cameras.json``: the JAX tools' rotation draws, float32."""
    rec = json.loads(EXPERIMENT_CAMERAS.read_text())
    return {k: np.asarray(v, np.float32) for k, v in rec.items() if k != "about"}


def render_pool(mesh_path: Path, n: int, batch: int, views_in: int, views_out: int,
                width: int = W, height: int = H, device="cuda") -> list:
    """``n`` collated batches of ``batch`` items of the synthetic stream of
    ``mesh_path`` (random materials, seed 0), on ``device``."""
    from .data import synthetic
    from .data.loader import collate, to_device, to_tensors

    ds = synthetic.SyntheticDataset([mesh_path], num_input_views=views_in,
                                    num_output_views=views_out, width=width, height=height,
                                    random_materials=True, seed=0)
    ds.worker_init_fn(0)
    it = iter(ds)
    return [to_device(to_tensors(collate([next(it) for _ in range(batch)])), device)
            for _ in range(n)]


def train(step, state, pool, steps: int, generator, schedule=None, log_every=LOG_EVERY):
    """``steps`` steps over the pool in turn, the learning rate
    ``schedule(i)`` when given. Returns (state, history rows, each step's
    loss as a device tensor)."""
    from .train_encoder_distill import log

    history, losses = [], []
    t0 = time.time()
    for i in range(steps):
        if schedule is not None:
            for group in state.optimizer.param_groups:
                group["lr"] = schedule(i)
        state, aux = step(state, pool[i % len(pool)], generator)
        losses.append(aux["loss/generator/total"])
        if i and (i % log_every == 0 or i == steps - 1):
            history.append({"step": i, "loss": float(losses[-1])})
            log(f"step {i}: loss={history[-1]['loss']:.4f} "
                f"({i / (time.time() - t0):.1f} steps/s)")
    return state, history, losses


def render_obs(obj, intrinsic: np.ndarray, extrinsic: np.ndarray, width: int, height: int,
               device):
    """The mesh rendered by the host rasterizer at ``extrinsic``, one light
    at (0, 0, -2)."""
    from .camera import Camera
    from .data import rendering
    from .observation import Observation

    ctx = rendering.SceneContext(obj, intrinsic)
    ctx.set_pose_from_extrinsic(np.asarray(extrinsic))
    ctx.lights = [(np.asarray([0.0, 0.0, -2.0], np.float32), np.ones(3, np.float32), 5.0)]
    color, depth, mask = rendering.Renderer(width, height).render(ctx)
    cam = Camera(intrinsic[None], np.asarray(extrinsic)[None], width=width, height=height,
                 device=device)
    return Observation(color.transpose(2, 0, 1)[None], depth[None, None], mask[None, None],
                       cam)


def pose(q: np.ndarray, camera_dist: float = CAMERA_DIST) -> np.ndarray:
    """The extrinsic at rotation ``q`` (4,) and (0, 0, ``camera_dist``)."""
    from . import three

    return three.to_extrinsic_matrix(torch.tensor([[0.0, 0.0, camera_dist]]),
                                     torch.from_numpy(np.asarray(q, np.float32))[None]
                                     ).numpy()[0]


def evaluate(model, mesh_path: Path, n_targets: int, device) -> list:
    """The latent from 8 reference views, then CEM 64 x 10 and Adam 8 x 100
    at each target; ADD-S against the cube's vertices. Returns the rows."""
    from .data import rendering
    from .observation import Observation
    from .pose import estimation, metrics

    draws = load_draws()
    if n_targets > len(draws["target_quats"]):
        raise ValueError(f"{EXPERIMENT_CAMERAS.name} holds {len(draws['target_quats'])} "
                         "targets")
    intrinsic = np.asarray([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1.0]], np.float32)
    obj, _ = rendering.load_object(mesh_path, size=1.0)
    ref_obs = Observation.collate([render_obs(obj, intrinsic, pose(q), W, H, device)
                                   for q in draws["reference_quats"]])
    z_obj = model.build_latent_object(ref_obs)
    coarse = estimation.CrossEntropyPoseEstimator(model=model, **COARSE)
    fine = estimation.GradientPoseEstimator(model=model, **FINE)
    points = torch.as_tensor(obj.vertices, dtype=torch.float32, device=device)
    generator = torch.Generator(device).manual_seed(55)

    def add_s(gt_cam, c):
        return metrics.camera_metrics(gt_cam, c, points, scale_to_meters=1.0)["add_s"]

    rows = []
    for t in range(n_targets):
        target = render_obs(obj, intrinsic, pose(draws["target_quats"][t]), W, H, device)
        gt_cam = target.camera
        coarse_cams = coarse.estimate(z_obj, target, generator=generator)
        best = fine.estimate(z_obj, target, camera=coarse_cams[:8])
        row = {"target": t, "coarse_add_s": add_s(gt_cam, coarse_cams[0]),
               "refined_add_s": add_s(gt_cam, best[0]),
               "add_s_01d": bool(add_s(gt_cam, best[0]) < 0.1)}
        rows.append(row)
        print(f"target {t}: coarse add_s={row['coarse_add_s']:.3f} "
              f"refined={row['refined_add_s']:.3f} 0.1d={row['add_s_01d']}", flush=True)
    return rows


@dtypes.compute_dtype()
def main(argv=None) -> dict:
    """Train (unless ``--skip-train``) and evaluate; returns the summary."""
    from . import zoo
    from .device import resolve_device
    from .recon import checkpoint as ckpt
    from .recon.inference import LatentFusionModel
    from .train.step import init_gan_train_state, make_optimizer, make_recon_train_step
    from .train_encoder_distill import log
    from .utils import cosine_decay_schedule

    args = get_args(argv)
    device = resolve_device(args.device)
    dtypes.set_compute_dtype("bfloat16")
    args.out.mkdir(parents=True, exist_ok=True)
    mesh_path = make_cube_obj(args.out)
    history = []
    if not args.skip_train:
        log("# rendering batch pool...")
        t0 = time.time()
        pool = render_pool(mesh_path, args.pool, args.batch, args.views_in, args.views_out,
                           device=device)
        log(f"# pool of {args.pool} batches in {time.time() - t0:.0f}s")
        sculptor, fuser, photographer = make_models(device,
                                                    torch.Generator(device).manual_seed(0))
        modules = {"sculptor": sculptor, "fuser": fuser, "photographer": photographer}
        n_params = sum(p.numel() for m in modules.values() for p in m.parameters())
        log(f"# {n_params / 1e6:.1f}M params")
        state = init_gan_train_state(modules, make_optimizer("adam", args.lr), device=device)
        step = make_recon_train_step(sculptor, fuser, photographer, config=STEP_CONFIG)
        schedule = (cosine_decay_schedule(args.lr, max(args.steps, 1), alpha=0.01)
                    if args.lr_cosine else None)
        state, history, _ = train(step, state, pool, args.steps,
                                  torch.Generator(device).manual_seed(1), schedule)
        (args.out / "history.json").write_text(json.dumps(history))
        ckpt.save_reference_checkpoint(
            args.out / "checkpoint.pth",
            ckpt.reference_entries(zoo.demo_module_args(input_depth=False), fuser),
            {name: m.state_dict() for name, m in modules.items()}, name="cube_demo",
            args={"camera_dist": CAMERA_DIST})
        log(f"# wrote {args.out / 'checkpoint.pth'}")
        model = LatentFusionModel(sculptor, None, fuser, None, photographer, None,
                                  camera_dist=CAMERA_DIST, device=device)
    else:
        model = LatentFusionModel.from_checkpoint(args.out / "checkpoint.pth", device=device)

    rows = evaluate(model, mesh_path, args.eval_targets, device)
    acc = float(np.mean([r["add_s_01d"] for r in rows]))
    summary = {"targets": rows, "add_s_0.1d": acc, "history": history[-5:]}
    (args.out / "pose_eval.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps({"add_s_0.1d": acc,
                      "mean_refined_add_s": float(np.mean([r["refined_add_s"] for r in rows]))}))
    return summary


if __name__ == "__main__":
    main()
