"""6D pose of one object on a BOP-layout dataset (LINEMOD, T-LESS), scored
as the paper scores it (counterpart of ``tools/evaluate_bop.py``).

    python -m latentfusion_tpu_torch.evaluate_bop --checkpoint model.pth \\
        --dataset-path /data/bop/lm --scene-path /data/bop/lm/test/000001 \\
        --object-id 1 --num-input-views 16 --num-frames 50 --out results.json \\
        [--batch-frames 8] [--device cpu]

The latent object is built from ``--num-input-views`` reference frames
spread over the scene (farthest-point sampling of the camera positions).
Each evaluated frame (``--num-frames`` evenly spaced over the others, all
of them with 0) gets the coarse search (``--coarse-config``, cross-entropy)
and gradient refinement of its best ``--top-k`` (``--fine-config``), and the
best pose is scored against the ground truth with ADD, ADD-S, ADD-sym and
Proj2D in the model's units (BOP: millimetres), each gated at a tenth of
the object's diameter. ``--batch-frames N`` estimates N frames together
(``estimate_batch``: one latent, a hypothesis block per frame). ``--seed``
seeds a ``torch.Generator``; each group of frames draws from a generator
seeded from it, as the JAX tool splits its key per group. The checkpoint is
a reference-schema ``.pth`` (``LatentFusionModel.from_checkpoint``). Runs
on the GPU unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from .camera import Camera
from .data.bop import BOPDataset
from .device import resolve_device, synchronize
from .observation import Observation
from .pose import estimation, metrics
from .pose import format as pf
from .recon.inference import LatentFusionModel

logger = logging.getLogger("evaluate_bop")
CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", type=Path, required=True)
    parser.add_argument("--dataset-path", type=Path, required=True,
                        help="BOP dataset root (e.g. .../bop/lm)")
    parser.add_argument("--scene-path", type=Path, required=True,
                        help="scene directory (e.g. .../lm/test/000001)")
    parser.add_argument("--object-id", type=int, required=True)
    parser.add_argument("--num-input-views", type=int, default=16)
    parser.add_argument("--num-frames", type=int, default=0,
                        help="evaluate this many frames, evenly spaced over "
                             "the scene (0 = every non-reference frame)")
    parser.add_argument("--coarse-config", type=Path,
                        default=CONFIGS / "cross_entropy_quick.toml")
    parser.add_argument("--fine-config", type=Path, default=CONFIGS / "adam_quick.toml")
    parser.add_argument("--top-k", type=int, default=8,
                        help="coarse hypotheses refined by the fine stage")
    parser.add_argument("--batch-frames", type=int, default=1,
                        help="estimate this many eval frames jointly via "
                             "estimate_batch (same latent, per-frame "
                             "hypothesis blocks share the decoder batch)")
    parser.add_argument("--center-object", action="store_true")
    parser.add_argument("--out", type=Path, help="write per-frame metrics JSON here")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser.parse_args(argv)


def select_frames(dataset, ref_inds, num_frames):
    """Evaluation frames: evenly spaced over the scene, excluding the
    reference views used to build the latent object."""
    ref = set(int(i) for i in np.asarray(ref_inds))
    candidates = [i for i in range(len(dataset)) if i not in ref]
    if num_frames and num_frames < len(candidates):
        picks = np.linspace(0, len(candidates) - 1, num_frames)
        candidates = [candidates[int(round(p))] for p in picks]
    return candidates


def evaluate_frame(model, coarse, fine, z_obj, obs, top_k, generator):
    """Coarse search then gradient refinement; returns the ranked Camera."""
    coarse_cams = coarse.estimate(z_obj, obs, generator=generator)
    return fine.estimate(z_obj, obs, camera=coarse_cams[:top_k])


def evaluate_frames_batched(model, coarse, fine, z_obj, observations, top_k, generator):
    """Several frames of the same object together: the latent is shared,
    each frame owns a contiguous hypothesis block, and the coarse and the
    fine loops each run once over all frames. Returns one ranked Camera per
    frame."""
    z_objs = torch.cat([z_obj] * len(observations), dim=0)
    coarse_out = coarse.estimate_batch(z_objs, observations, generator=generator)
    return fine.estimate_batch(z_objs, observations,
                               cameras=Camera.cat([c[:top_k] for c in coarse_out]))


def group_generators(seed: int, n: int, device):
    """``n`` generators on ``device``, each seeded by a draw of a generator
    seeded with ``seed``: one stream per group of frames."""
    root = torch.Generator().manual_seed(seed)
    return [torch.Generator(device=device).manual_seed(
        int(torch.randint(2 ** 62, (1,), generator=root))) for _ in range(n)]


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = parse_args(argv)
    device = resolve_device(args.device)

    dataset = BOPDataset(args.dataset_path, args.scene_path, args.object_id,
                         center_object=args.center_object)
    points = dataset.load_pointcloud().to(device)
    # Normalized object units -> native model units (BOP: millimeters).
    scale_to_native = 1.0 / dataset.object_scale
    diameter = float(dataset.model_info["diameter"])

    model = LatentFusionModel.from_checkpoint(args.checkpoint, device=device)
    coarse = estimation.load_from_config(args.coarse_config, model)
    fine = estimation.load_from_config(args.fine_config, model)

    logger.info("building latent object from %d reference views...", args.num_input_views)
    ref_inds = dataset.sample_evenly(args.num_input_views)
    z_obj = model.build_latent_object(Observation.from_dataset(dataset, ref_inds, device=device))

    frame_inds = select_frames(dataset, ref_inds, args.num_frames)
    ids = dataset.get_ids()
    group_size = max(args.batch_frames, 1)
    groups = [frame_inds[i:i + group_size] for i in range(0, len(frame_inds), group_size)]
    rows = []
    for group, generator in zip(groups, group_generators(args.seed, len(groups), device)):
        t0 = time.time()
        observations = [Observation.from_dataset(dataset, [i], device=device) for i in group]
        if len(group) > 1:
            bests = evaluate_frames_batched(model, coarse, fine, z_obj, observations,
                                            args.top_k, generator)
        else:
            bests = [evaluate_frame(model, coarse, fine, z_obj, observations[0],
                                    args.top_k, generator)]
        synchronize(device)
        elapsed = (time.time() - t0) / len(group)
        for idx, obs, best in zip(group, observations, bests):
            m = metrics.camera_metrics(obs.camera, best[0], points,
                                       scale_to_meters=scale_to_native)
            m["frame"] = ids[idx]
            m["seconds"] = round(elapsed, 3)
            m["add_01d"] = bool(m["add"] < 0.1 * diameter)
            m["add_s_01d"] = bool(m["add_s"] < 0.1 * diameter)
            rows.append(m)
            logger.info("[%d/%d] frame %s: add=%.2f add_s=%.2f (0.1d=%.2f) "
                        "rot=%.3f rad %.1fs", len(rows), len(frame_inds), ids[idx],
                        m["add"], m["add_s"], 0.1 * diameter, m["rotation_dist"], elapsed)

    summary = metrics.concat_camera_metrics(
        [{k: v for k, v in r.items() if isinstance(v, float) and k != "seconds"}
         for r in rows])
    logger.info("\n%s", pf.metrics_table(
        {k: float(np.mean(v)) for k, v in summary.items()},
        name=f"obj_{args.object_id:06d} mean ({len(rows)} frames)"))
    acc = {"add_0.1d": float(np.mean([r["add_01d"] for r in rows])),
           "add_s_0.1d": float(np.mean([r["add_s_01d"] for r in rows]))}
    logger.info("%s", pf.metrics_table(acc, name="accuracy"))

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"object_id": args.object_id, "diameter": diameter,
                       "frames": rows, "accuracy": acc}, f, indent=2)
        logger.info("wrote %s", args.out)
    return rows, acc


if __name__ == "__main__":
    main()
