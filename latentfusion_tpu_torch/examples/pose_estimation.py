"""End-to-end pose estimation example (counterpart of
``examples/pose_estimation.py``): load a model, build a latent object from
reference views, run the coarse (cross-entropy) and fine (gradient) pose
estimation on a target view, and print the metric tables.

    python -m latentfusion_tpu_torch.examples.pose_estimation \\
        [--checkpoint model.pth] [--mesh obj.ply] [--device cpu]
    python -m latentfusion_tpu_torch.examples.pose_estimation --checkpoint model.pth \\
        --bop-path /data/bop/lm --scene-path /data/bop/lm/test/000001 --object-id 1

Two data modes:
- ``--bop-path/--scene-path/--object-id``: real LINEMOD/BOP data.
- default: fully synthetic: renders a mesh (``--mesh``, or a built-in cube)
  with the host rasterizer, so the pipeline runs with no external data.

With ``--checkpoint`` (a reference-schema ``.pth``) a trained model is
used; otherwise random tiny weights (pipeline demo only: expect garbage
accuracy, use the printed tables to see the machinery). The target's and
the references' rotations are drawn from a ``torch.Generator`` seeded with
``--seed``, which also seeds the lights' ``random``/``numpy.random`` draws.
Runs on the GPU unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import random
import time
from pathlib import Path

import numpy as np
import torch

CONFIGS = Path(__file__).resolve().parents[2] / "configs"
CUBE_HALF = 0.25


def build_model(args):
    from .. import zoo
    from ..device import resolve_device
    from ..recon.inference import LatentFusionModel

    device = resolve_device(args.device)
    if args.checkpoint:
        return LatentFusionModel.from_checkpoint(args.checkpoint, device=device)
    gen = torch.Generator().manual_seed(0)
    sculptor = zoo.tiny_sculptor(input_size=args.input_size, device=device, generator=gen)
    fuser = zoo.tiny_fuser(device=device, generator=gen)
    photographer = zoo.tiny_photographer(device=device, generator=gen)
    print("! no checkpoint given: using RANDOM weights (pipeline demo)")
    return LatentFusionModel(sculptor, None, fuser, None, photographer, None,
                             camera_dist=args.camera_dist, device=device)


def cube_object():
    """The built-in cube, unit diameter."""
    from ..meshutils import Mesh, Object3D

    s = CUBE_HALF
    verts = np.asarray(
        [(-s, -s, -s), (s, -s, -s), (s, s, -s), (-s, s, -s),
         (-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s)], np.float32)
    faces = np.asarray(
        [(0, 1, 2), (0, 2, 3), (4, 6, 5), (4, 7, 6), (0, 4, 5), (0, 5, 1),
         (1, 5, 6), (1, 6, 2), (2, 6, 7), (2, 7, 3), (4, 0, 3), (4, 3, 7)], np.int32)
    obj = Object3D(meshes=[Mesh(verts, faces)])
    obj.resize(1.0)
    return obj


def synthetic_observations(args, quats=None):
    """Reference views and a target view of a mesh rendered by the host
    rasterizer at 320x240: (reference Observation, target Observation,
    object). ``quats`` (num_views + 1, 4) replaces the drawn rotations."""
    from .. import three
    from ..camera import Camera
    from ..data import rendering
    from ..device import resolve_device
    from ..observation import Observation
    from ..three import quaternion as quat

    device = resolve_device(args.device)
    obj = rendering.load_object(args.mesh, size=1.0)[0] if args.mesh else cube_object()
    width, height = 320, 240
    intrinsic = np.asarray([[300.0, 0, width / 2, 0],
                            [0, 300.0, height / 2, 0],
                            [0, 0, 1, 0]], np.float32)
    context = rendering.SceneContext(obj, intrinsic)
    random.seed(args.seed)
    np.random.seed(args.seed)
    context.randomize_lights(2, 4)
    renderer = rendering.Renderer(width, height)

    if quats is None:
        quats = quat.random(args.num_views + 1, torch.Generator().manual_seed(args.seed))
    quats = torch.as_tensor(quats, dtype=torch.float32)
    trans = torch.tensor([0.0, 0.0, args.camera_dist])
    observations = []
    for i in range(args.num_views + 1):
        context.set_pose(trans.numpy(), quats[i].numpy())
        color, depth, mask = renderer.render(context)
        cam = Camera(intrinsic, three.to_extrinsic_matrix(trans[None], quats[i][None]),
                     width=width, height=height, device=device)
        observations.append(Observation(
            torch.from_numpy(np.ascontiguousarray(color.transpose(2, 0, 1)))[None],
            torch.from_numpy(depth)[None, None], torch.from_numpy(mask)[None, None], cam))
    return Observation.collate(observations[:-1]), observations[-1], obj


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--checkpoint", type=Path)
    parser.add_argument("--mesh", type=Path)
    parser.add_argument("--bop-path", type=Path)
    parser.add_argument("--scene-path", type=Path)
    parser.add_argument("--object-id", type=int, default=1)
    parser.add_argument("--num-views", type=int, default=8)
    parser.add_argument("--coarse-config", type=Path,
                        default=CONFIGS / "cross_entropy_quick.toml")
    parser.add_argument("--fine-config", type=Path, default=CONFIGS / "adam_quick.toml")
    parser.add_argument("--input-size", type=int, default=16)
    parser.add_argument("--camera-dist", type=float, default=1.5)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> str:
    """Prints and returns the metric table of the coarse and the fine
    estimate."""
    from ..observation import Observation
    from ..pose import estimation, metrics
    from ..pose import format as pf

    args = parse_args(argv)
    model = build_model(args)
    device = model.device
    if args.bop_path:
        from ..data.bop import BOPDataset
        from ..data.loader import collate

        ds = BOPDataset(args.bop_path, args.scene_path, args.object_id)
        inds = [int(i) for i in ds.sample_evenly(args.num_views + 1)]
        items = [ds[i] for i in inds]
        ref = Observation.from_dict(collate(items[:-1]), device=device)
        target = Observation.from_dict(collate(items[-1:]), device=device)
        points = ds.load_pointcloud().to(device)
    else:
        ref, target, obj = synthetic_observations(args)
        points = torch.as_tensor(obj.vertices, device=device)

    print(f"building latent object from {len(ref)} views...")
    t0 = time.time()
    z_obj = model.build_latent_object(ref)
    print(f"  done in {time.time() - t0:.2f}s, z_obj {tuple(z_obj.shape)}")

    coarse = estimation.load_from_config(args.coarse_config, model)
    fine = estimation.load_from_config(args.fine_config, model)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    print("coarse search (cross-entropy)...")
    t0 = time.time()
    coarse_cams = coarse.estimate(z_obj, target, generator=generator)
    print(f"  done in {time.time() - t0:.2f}s")

    print("fine refinement (gradient)...")
    t0 = time.time()
    best = fine.estimate(z_obj, target, camera=coarse_cams[:fine.num_samples])
    print(f"  done in {time.time() - t0:.2f}s")

    rows = [metrics.camera_metrics(target.camera, cam, points, 1.0)
            for cam in (coarse_cams[0], best[0])]
    table = pf.metrics_table_multiple(rows, names=["coarse", "fine"])
    print(table)
    return table


if __name__ == "__main__":
    main()
