"""Run the JAX package's BOP and MOPED harnesses on the CPU on the inputs of
``chip_smoke.py`` phase 14: the demo family with the learned
encoder-distill weights as a reference ``.pth``, the oracle BOP scene at a
given camera and scene seed, and the committed ``tests/data/moped_synth``
capture at a given refinement config. It scores each leg as phase 14 does
(ADD-S within 0.1d; MOPED against the ellipsoid's points), so the port's
readings on the card have a reference on the same inputs.

    python tests/eval_witness.py --out DIR [--bop linemod:0 f615:0 ...]
        [--moped adam_quick adam_track] [--frames 8] [--batch-frames 1] [--part i/n]

A ``--bop`` case is ``<camera>:<scene seed>``, ``camera`` being ``linemod``
(LINEMOD's published cam_K) or ``f615`` (the checkpoint's own camera, the
gated scene); the evaluation seed equals the scene seed, as in
``chip_smoke.py``. The scene and the ``.pth`` are written by the port's
code (``chip_smoke.write_bop_scene``, ``write_demo_pth``) on the CPU. Each
case prints one line starting ``WITNESS`` and its JSON goes to DIR.
"""
import argparse
import contextlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def on_cpu():
    """``chip_smoke.py``'s writers, which build the port's oracle and read
    the ``.pth`` back on the card, on the CPU."""
    import functools

    import torch

    from latentfusion_tpu_torch import camera, testing
    from latentfusion_tpu_torch.recon.inference import LatentFusionModel

    read = LatentFusionModel.from_checkpoint
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(camera, "resolve_device",
                                          lambda device="cuda": torch.device("cpu")))
    stack.enter_context(mock.patch.object(
        testing, "EllipsoidOracleModel",
        functools.partial(testing.EllipsoidOracleModel, device="cpu")))
    stack.enter_context(mock.patch.object(
        LatentFusionModel, "from_checkpoint", lambda path: read(path, device="cpu")))
    return stack


def bop_case(pth, out, camera, seed, frames, batch_frames, part=(1, 1)):
    import chip_smoke

    k = {"linemod": chip_smoke.LINEMOD_K, "f615": chip_smoke.BOP_K}[camera]
    root = out / f"bop_{camera}_{seed}" / "lm"
    with on_cpu():
        scene = chip_smoke.write_bop_scene(root, seed, k=k)
    tool = _tool("evaluate_bop")
    select = tool.select_frames

    def part_of(dataset, ref_inds, num_frames):
        picks = select(dataset, ref_inds, num_frames)
        i, n = part
        return picks[(i - 1) * len(picks) // n:i * len(picks) // n]

    t0 = time.perf_counter()
    with mock.patch.object(tool, "select_frames", part_of):
        rows, _ = tool.main([
            "--checkpoint", str(pth), "--dataset-path", str(root), "--scene-path", str(scene),
            "--object-id", "1", "--num-input-views", "16", "--num-frames", str(frames),
            "--batch-frames", str(batch_frames), "--seed", str(seed),
            "--out", str(out / f"bop_{camera}_{seed}_{part[0]}of{part[1]}.json")])
    return {"leg": "bop", "camera": camera, "scene_seed": seed, "part": list(part),
            "frame_ids": [r["frame"] for r in rows],
            "hits": sum(r["add_s_01d"] for r in rows), "frames": len(rows),
            "add_s_mm": [round(r["add_s"], 2) for r in rows],
            "translation_mm": [round(r["translation_dist"], 1) for r in rows],
            "seconds": round(time.perf_counter() - t0, 1)}


def moped_case(pth, out, config, frames):
    import jax.numpy as jnp

    import chip_smoke
    from latentfusion_tpu.pose import metrics
    from latentfusion_tpu.three import orientation

    tool = _tool("poserbpf_comparison")
    pairs = []
    score = metrics.camera_metrics

    def recording(gt, est, points, scale):
        pairs.append((gt, est))
        return score(gt, est, points, scale)

    data = ROOT / "tests" / "data" / "moped_synth"
    argv = ["poserbpf_comparison", "--checkpoint", str(pth),
            "--reference-scene", str(data / "reference"), "--eval-scene", str(data / "evaluation"),
            "--fine-config", str(ROOT / "configs" / f"{config}.toml"),
            "--out", str(out / f"moped_{config}"), "--max-frames", str(frames)]
    t0 = time.perf_counter()
    with mock.patch.object(sys, "argv", argv), \
            mock.patch.object(metrics, "camera_metrics", recording):
        tool.main()
    points = (orientation.evenly_distributed_points(512)
              * jnp.asarray(chip_smoke.ORACLE_AXES))
    add_s = [float(score(gt, est, points, 1.0)["add_s"]) for gt, est in pairs]
    return {"leg": "moped", "config": config,
            "hits": sum(a < 0.1 * chip_smoke.ORACLE_DIAMETER for a in add_s),
            "frames": len(add_s), "add_s": [round(a, 4) for a in add_s],
            "seconds": round(time.perf_counter() - t0, 1)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--bop", nargs="*", default=[])
    parser.add_argument("--moped", nargs="*", default=[])
    parser.add_argument("--frames", type=int, default=8)
    parser.add_argument("--batch-frames", type=int, default=1)
    parser.add_argument("--part", default="1/1",
                        help="i/n: evaluate the i-th of n equal parts of the selected BOP "
                             "frames, so that n processes share a scene")
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    from latentfusion_tpu_torch.recon.checkpoint import (from_jax_params, load_params_npz,
                                                         split_state_dict)

    args.out.mkdir(parents=True, exist_ok=True)
    pth = args.out / "encoder_distill.pth"
    state = split_state_dict(from_jax_params(load_params_npz(
        chip_smoke.DISTILL / "encoder_distill.npz",
        chip_smoke.DISTILL / "encoder_distill_keys.json")))
    with on_cpu():
        chip_smoke.write_demo_pth(state, pth)
    results = []
    for case in args.bop:
        camera, seed = case.split(":")
        results.append(bop_case(pth, args.out, camera, int(seed), args.frames,
                                args.batch_frames, tuple(map(int, args.part.split("/")))))
        print("WITNESS", json.dumps(results[-1]), flush=True)
    for config in args.moped:
        results.append(moped_case(pth, args.out, config, args.frames))
        print("WITNESS", json.dumps(results[-1]), flush=True)
    (args.out / f"witness_{args.part.replace('/', 'of')}.json").write_text(
        json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    main()
