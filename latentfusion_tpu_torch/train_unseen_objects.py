"""Train the pipeline on a pool of procedural multi-lobe objects (the
training half of ``tools/train_unseen_objects.py``; its evaluation on
held-out objects is ``unseen_eval.py``).

Per step: a random object of the ``--train-objects`` pool (lobe seed
``--pool-seed``), ``--views-in`` shaded reference views of it at random
cameras encoded and fused (gradients on), decoded at ``--views-out`` fresh
zoomed cameras; 25 x depth L1 + 25 x mask BCE against the analytic render
plus ``--frame-loss-weight`` x the estimator's full-frame depth terms
(``train_encoder_distill.distill_terms``). Adam (0.9, 0.99) on a cosine
decay to 1 % over ``--steps``, in bf16.

    python -m latentfusion_tpu_torch.train_unseen_objects --steps 40000 \\
        --out DIR [--family demo|mid|tiny] [--device cpu]
    python -m latentfusion_tpu_torch.unseen_eval --checkpoint \\
        artifacts/unseen_objects/unseen_objects.npz --out DIR

Writes ``unseen_objects.npz`` with ``unseen_objects_keys.json`` (the JAX
tool's format) and ``history.json``. ``--max-seconds`` stops at the next
500-step boundary past the budget; ``--init-params`` warm-starts from a
same-family npz.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from . import dtypes
from . import train_encoder_distill as distill

CAMERA_DIST = 5.78
DIAMETER = 1.0


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=40000)
    parser.add_argument("--train-objects", type=int, default=10)
    parser.add_argument("--pool-seed", type=int, default=0,
                        help="train pool shapes = seeds [0, K)")
    parser.add_argument("--views-in", type=int, default=6)
    parser.add_argument("--views-out", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--out", type=Path, required=True,
                        help="output directory (no default, so that a run cannot "
                             "overwrite the committed artifacts/unseen_objects)")
    parser.add_argument("--init-params", type=Path, default=None,
                        help="warm-start all modules from a same-family npz")
    parser.add_argument("--frame-loss-weight", type=float, default=2.0)
    parser.add_argument("--snapshot-steps", default="",
                        help="comma-separated steps whose parameters are written as "
                             "unseen_objects_step<N>.npz")
    parser.add_argument("--max-seconds", type=float, default=0.0,
                        help="wall-clock budget: stop at the next 500-step boundary "
                             "past it (the schedule stays sized for --steps)")
    parser.add_argument("--family", choices=["demo", "mid", "tiny"], default="demo")
    parser.add_argument("--device", default="cuda", help="default the card")
    return parser.parse_args(argv)


def family_modules(family: str, device, generator):
    """(modules in train mode, input size) of a zoo family."""
    from . import zoo

    makers = {"demo": (zoo.demo_sculptor, zoo.demo_fuser, zoo.demo_photographer),
              "mid": (zoo.mid_sculptor, zoo.mid_fuser, zoo.mid_photographer),
              "tiny": (zoo.tiny_sculptor, zoo.tiny_fuser, zoo.tiny_photographer)}[family]
    size = {"demo": zoo.DEMO_INPUT_SIZE, "mid": zoo.MID_INPUT_SIZE, "tiny": 16}[family]
    mods = {name: make(device=device, generator=generator).train()
            for name, make in zip(("sculptor", "fuser", "photographer"), makers)}
    return mods, size


def load_leaves(modules, path) -> None:
    """Load an enumerated-leaf npz without keys (JAX's leaf order of these
    modules' tree) into ``modules``."""
    import numpy as np

    from .recon import checkpoint as ckpt

    template = ckpt.to_jax_params({f"{name}.{k}": v for name, m in modules.items()
                                   for k, v in m.state_dict().items()})
    with np.load(path) as data:
        if len(data.files) != len(template):
            raise ValueError(f"{path}: {len(data.files)} leaves, the modules have "
                             f"{len(template)}")
        leaves = {key: data[str(i)] for i, key in enumerate(template)}
    state = ckpt.split_state_dict(ckpt.from_jax_params(leaves))
    for name, m in modules.items():
        m.load_state_dict(state[name])


def lobe_loss(modules, shape, cam_in, cam_full, input_size: int, frame_loss_weight: float):
    """The rig's loss for one lobe object ``shape`` at input cameras
    ``cam_in`` and output cameras ``cam_full`` (full frame)."""
    from . import testing

    with torch.no_grad():
        obs = testing.lobe_observation(shape, cam_in)
        cam = cam_full.zoom(None, input_size, CAMERA_DIST)
        depth_m, o_mask, _, _ = testing.render_lobe_shape(cam, shape, input_size)
        o_depth = torch.where(o_mask > 0.5, cam.normalize_depth(depth_m), -1.0)
        target = testing.lobe_observation(shape, cam_full) if frame_loss_weight > 0 else None
    z_obj = distill.encode_views(modules["sculptor"], modules["fuser"], obs, input_size,
                                 CAMERA_DIST)
    return distill.distill_terms(modules["photographer"], z_obj, cam, cam_full, o_depth,
                                 o_mask, target, frame_loss_weight)


@dtypes.compute_dtype()
def main(argv=None) -> list:
    """Train; returns the history."""
    from . import testing, zoo
    from .device import resolve_device

    args = get_args(argv)
    device = resolve_device(args.device)
    dtypes.set_compute_dtype("bfloat16")
    args.out.mkdir(parents=True, exist_ok=True)
    snapshot_steps = {int(s) for s in args.snapshot_steps.split(",") if s.strip()}
    generator = torch.Generator(device).manual_seed(0)
    pool, _ = testing.sample_lobe_shapes(args.pool_seed, args.train_objects,
                                         diameter=DIAMETER, device=device)
    modules, input_size = family_modules(args.family, device, generator)
    if args.init_params is not None:
        load_leaves(modules, args.init_params)
        distill.log(f"# warm-started from {args.init_params}")

    def loss_fn():
        obj = int(torch.randint(args.train_objects, (), generator=generator,
                                device=device))
        cam_in = zoo.random_view_cameras(args.views_in, generator, CAMERA_DIST, device=device)
        cam_full = zoo.random_view_cameras(args.views_out, generator, CAMERA_DIST,
                                           device=device)
        return lobe_loss(modules, testing.index_lobe_shape(pool, obj), cam_in, cam_full,
                         input_size, args.frame_loss_weight)

    n_params = sum(p.numel() for m in modules.values() for p in m.parameters())
    distill.log(f"# {n_params / 1e6:.1f}M trainable params | {args.train_objects} train "
                "objects")
    optimizer, schedule = distill.make_optimizer(modules, args.lr, args.steps)
    history = []
    t0 = time.time()
    for i in range(args.steps):
        loss, terms = distill.train_step(optimizer, schedule, i, loss_fn)
        if i in snapshot_steps:
            distill.save_params(modules, args.out, f"unseen_objects_step{i}", keys=False)
        if i and (i % distill.LOG_EVERY == 0 or i == args.steps - 1):
            history.append(distill.history_row(i, loss, terms))
            distill.log(f"step {i}: loss={float(loss):.4f} "
                        f"({i / (time.time() - t0):.1f} steps/s)")
            if args.max_seconds and time.time() - t0 > args.max_seconds:
                distill.log(f"# wall-clock budget {args.max_seconds:.0f}s exceeded; "
                            f"stopping at step {i}")
                break
    (args.out / "history.json").write_text(json.dumps(history))
    distill.save_params(modules, args.out, "unseen_objects")
    return history


if __name__ == "__main__":
    main()
