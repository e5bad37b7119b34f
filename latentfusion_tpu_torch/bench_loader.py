"""Benchmark the synthetic-data pipeline on the host (counterpart of
``tools/bench_loader.py``).

    python -m latentfusion_tpu_torch.bench_loader [--width 640] [--height 480]
        [--in-views 8] [--out-views 24] [--verts 2000] [--workers 2]
        [--batch 2] [--transport quantized]

For the training item's shape (by default 8 input and 24 output views of
640x480, the published recipe's), one JSON line a stage:

- ``rasterizer``: ms a render and renders a second of the compiled
  rasterizer (geometry and shading) on one procedural blob;
- ``dataset_inline``: seconds an item and renders a second of the whole
  ``SyntheticDataset`` chain (materials, lights, augmentation, packing) in
  this process;
- ``loader``: seconds a batch, renders a second and the steps a second it
  could feed, through ``data.loader.IterableLoader(device=None)`` with
  ``--workers`` worker processes and ``--transport`` (the quantised
  transport, or float32 without the flag).

Host-only, as the JAX tool: nothing runs on a GPU. The blobs are written to
a temporary directory, removed on return.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np


def bench_rasterizer(paths, width, height, iters=32) -> dict:
    from .data import rendering

    obj, _ = rendering.load_object(paths[0], size=0.35)
    ctx = rendering.SceneContext(
        obj, np.array([[500.0 * width / 640, 0, width / 2],
                       [0, 500.0 * width / 640, height / 2],
                       [0, 0, 1]], np.float32))
    ctx.randomize_lights(3, 8)
    ctx.specular = 0.3
    ctx.roughness = 0.4
    renderer = rendering.Renderer(width, height)
    rng = np.random.RandomState(0)
    ctx.set_pose(np.array([0, 0, 1.0], np.float32), np.array([1, 0, 0, 0], np.float32))
    renderer.render(ctx)  # warm (geometry merge cache)
    t0 = time.perf_counter()
    for _ in range(iters):
        ctx.set_pose(np.array([0, 0, 1.0], np.float32), rng.randn(4).astype(np.float32))
        renderer.render(ctx)
    dt = (time.perf_counter() - t0) / iters
    return {"stage": "rasterizer", "ms_per_render": round(dt * 1e3, 2),
            "renders_per_s": round(1.0 / dt, 1)}


def bench_dataset(ds, n_items=4) -> dict:
    views = ds.num_inputs * 2 + ds.num_outputs
    it = iter(ds)
    next(it)  # warm
    t0 = time.perf_counter()
    for _ in range(n_items):
        next(it)
    dt = (time.perf_counter() - t0) / n_items
    return {"stage": "dataset_inline", "s_per_item": round(dt, 3),
            "renders_per_s_per_worker": round(views / dt, 1)}


def bench_loader(ds, workers, transport, batch_size, n_batches=3) -> dict:
    from .data.loader import IterableLoader

    loader = IterableLoader(ds, batch_size=batch_size, num_workers=workers, device=None,
                            transport=transport)
    views = ds.num_inputs * 2 + ds.num_outputs
    try:
        it = iter(loader)
        next(it)  # warm (worker start and first fills)
        t0 = time.perf_counter()
        for _ in range(n_batches):
            next(it)
        dt = (time.perf_counter() - t0) / n_batches
    finally:
        loader.shutdown()
    return {"stage": "loader", "workers": workers,
            "transport": transport or "f32",
            "s_per_batch": round(dt, 3),
            "renders_per_s": round(batch_size * views / dt, 1),
            "steps_per_s_ceiling": round(1.0 / dt, 3)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--in-views", type=int, default=8)
    ap.add_argument("--out-views", type=int, default=24)
    ap.add_argument("--verts", type=int, default=2000,
                    help="mesh complexity of the procedural blobs")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=2,
                    help="loader batch (items/step; train.sh uses 16)")
    ap.add_argument("--transport", choices=["quantized"], default=None)
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Prints the three JSON lines; returns them as dicts."""
    from .data.synthetic import SyntheticDataset, make_procedural_blobs

    args = parse_args(argv)
    lines = []

    def emit(record):
        print(json.dumps(record), flush=True)
        lines.append(record)

    with tempfile.TemporaryDirectory() as tmp:
        paths = make_procedural_blobs(Path(tmp), 4, args.verts)
        emit(bench_rasterizer(paths, args.width, args.height))
        ds = SyntheticDataset(paths, num_input_views=args.in_views,
                              num_output_views=args.out_views, width=args.width,
                              height=args.height, random_materials=True)
        ds.worker_init_fn(0)
        emit(bench_dataset(ds))
        # Each worker makes its own renderer and pose generator.
        ds._renderer = None
        ds._generator = None
        emit(bench_loader(ds, args.workers, args.transport, args.batch))
    return lines


if __name__ == "__main__":
    main()
