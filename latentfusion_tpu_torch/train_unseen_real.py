"""Train on the mesh data path (the training half of
``tools/train_unseen_real.py``; its evaluation on held-out meshes is
``unseen_real.py``).

Procedural lobe meshes (pool seed ``--pool-seed``, ``--train-objects`` of
them) rendered by the host rasterizer through the synthetic stream (random
materials and textures, random color backgrounds, mask corruption, color
noise, size jitter; 256x192 by default), supervised with the
reconstruction step of the published recipe at the family's input size
(128^2 for demo; hard smooth-L1 depth
over the top ``--depth-k`` pixels, mask BCE, random orientation, the noisy
depth input), demo family, bf16, Adam (0, 0.99) on a cosine decay to 1 %.

Loader workers render items into a host queue that a pump thread drains;
the items, quantised (uint8 color and mask, float16 depth), go into a
ring buffer of ``--buffer-items`` on the device. Training waits for
``--min-buffer`` items, then runs chunks of ``--chunk-steps`` steps, each
step on the buffer item a device generator draws. Every item is a
rasterizer render; the fresh-item count is in ``history.json``.

    python -m latentfusion_tpu_torch.train_unseen_real --steps 60000 \\
        --out DIR [--workers 8] [--device cpu]

Writes ``unseen_real.npz`` (the JAX tool's leaves, no keys file) and
``history.json``, every ``--save-every`` steps and at the end.
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from pathlib import Path

import torch

from . import dtypes
from . import train_encoder_distill as distill

CAMERA_DIST = 5.78
PENDING_MAX = 512


def get_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=60000)
    parser.add_argument("--train-objects", type=int, default=128)
    parser.add_argument("--pool-seed", type=int, default=0)
    parser.add_argument("--views-in", type=int, default=6)
    parser.add_argument("--views-out", type=int, default=8)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--out", type=Path, required=True,
                        help="output directory (no default, so that a run cannot "
                             "overwrite the committed artifacts/unseen_real)")
    parser.add_argument("--render-width", type=int, default=256)
    parser.add_argument("--render-height", type=int, default=192)
    parser.add_argument("--workers", type=int, default=1,
                        help="loader worker processes (each owns a rasterizer)")
    parser.add_argument("--buffer-items", type=int, default=256,
                        help="device-resident ring buffer capacity (quantised items)")
    parser.add_argument("--chunk-steps", type=int, default=200,
                        help="train steps per chunk")
    parser.add_argument("--min-buffer", type=int, default=24,
                        help="items required before training starts")
    parser.add_argument("--mask-noise-p", type=float, default=0.25)
    parser.add_argument("--color-noise-level", type=float, default=0.05)
    parser.add_argument("--depth-noise-level", type=float, default=0.0)
    parser.add_argument("--depth-k", type=int, default=4096,
                        help="hard-pixel top-k of the depth loss")
    parser.add_argument("--max-seconds", type=float, default=0.0,
                        help="wall-clock budget: stop at the first chunk past it")
    parser.add_argument("--save-every", type=int, default=10000)
    parser.add_argument("--resume-npz", type=Path, default=None,
                        help="warm-start from a previous run's unseen_real.npz (fresh "
                             "optimizer state and schedule)")
    parser.add_argument("--assets-dir", type=Path, default=None,
                        help="procedural textures, backgrounds and meshes "
                             "(default: OUT/assets)")
    parser.add_argument("--family", choices=["demo", "mid", "tiny"], default="demo",
                        help="the zoo family (demo: the committed checkpoint's)")
    parser.add_argument("--device", default="cuda", help="default the card")
    return parser.parse_args(argv)


def step_config(depth_k: int) -> dict:
    """The published recipe's step at 128^2 (tools/train.sh's losses)."""
    return {"camera_dist": CAMERA_DIST, "cube_size": 1.0, "random_orientation": True,
            "g_depth_recon_loss_type": "hard_smooth_l1", "g_depth_recon_loss_weight": 25.0,
            "g_depth_recon_loss_k": depth_k,
            "g_mask_recon_loss_type": "binary_cross_entropy",
            "g_mask_recon_loss_weight": 25.0, "color_random_background": True,
            "crop_random_background": True, "generator_input_depth": True}


class RingBuffer:
    """``capacity`` quantised items on ``device``, written in turn over the
    oldest: the item written n-th lives at slot n % capacity."""

    def __init__(self, first_item, capacity: int, device):
        from .data.loader import tree_map

        self.capacity = capacity
        self.written = 0
        self.slots = tree_map(lambda a: torch.zeros((capacity, *a.shape),
                                                    dtype=torch.from_numpy(a).dtype,
                                                    device=device), first_item)

    @property
    def filled(self) -> int:
        return min(self.written, self.capacity)

    def write(self, item) -> None:
        pos = self.written % self.capacity

        def put(slot, a):
            slot[pos].copy_(torch.from_numpy(a))

        _zip_map(put, self.slots, item)
        self.written += 1

    def take(self, index: torch.Tensor):
        """The item at slot ``index`` (a device scalar) as a batch of one,
        widened to float32."""
        from .data.loader import decode_transport, tree_map

        return decode_transport(tree_map(lambda s: s.index_select(0, index.view(1)),
                                         self.slots))


def _zip_map(fn, a, b):
    if isinstance(a, dict):
        for k in a:
            _zip_map(fn, a[k], b[k])
    else:
        fn(a, b)


def run_chunk(step, state, buffer: RingBuffer, chunk: int, generator, schedule):
    """``chunk`` steps, each on the buffer slot ``generator`` draws among the
    filled ones; returns the state and the scalars averaged over the chunk
    (device tensors)."""
    acc = {}
    for _ in range(chunk):
        index = torch.randint(buffer.filled, (), generator=generator,
                              device=generator.device)
        for group in state.optimizer.param_groups:
            group["lr"] = schedule(state.step)
        state, scalars = step(state, buffer.take(index), generator)
        for k, v in scalars.items():
            acc[k] = acc.get(k, 0.0) + v
    return state, {k: v / chunk for k, v in acc.items()}


def make_dataset(args, assets: Path):
    """The rig's stream over the training pool's meshes."""
    from .data import synthetic
    from .unseen_real import pool_meshes

    _, _, mesh_paths = pool_meshes(assets, args.pool_seed, args.train_objects, False)
    tex_dir, bg_dir = assets / "textures", assets / "backgrounds"
    if not (tex_dir / "tex_000.png").exists():
        synthetic.make_procedural_textures(tex_dir)
    if not (bg_dir / "bg_000.png").exists():
        synthetic.make_procedural_backgrounds(bg_dir)
    return synthetic.SyntheticDataset(
        mesh_paths, num_input_views=args.views_in, num_output_views=args.views_out,
        width=args.render_width, height=args.render_height, size_jitter=(0.6, 1.0),
        random_materials=True, use_textures=True, textures_dir=tex_dir,
        color_random_background=True, color_background_dir=bg_dir,
        mask_noise_p=args.mask_noise_p, color_noise_level=args.color_noise_level,
        depth_noise_level=args.depth_noise_level, seed=args.pool_seed, emit_in_gt=False)


class Pump:
    """A thread moving the loader's host items into a bounded pending list."""

    def __init__(self, loader):
        self.loader = loader
        self.pending = []
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.fresh_items = 0
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        for item in self.loader:
            with self.lock:
                self.pending.append({k: {kk: vv[0] for kk, vv in g.items()}
                                     for k, g in item.items()})
                if len(self.pending) > PENDING_MAX:
                    self.pending.pop(0)
            self.fresh_items += 1
            if self.stop.is_set():
                return

    def drain(self) -> list:
        with self.lock:
            items, self.pending = self.pending, []
        return items

    def wait(self, count: int) -> None:
        while True:
            with self.lock:
                if len(self.pending) >= count:
                    return
            if not self.thread.is_alive():
                raise RuntimeError("the loader stopped before the buffer filled")
            time.sleep(0.2)

    def close(self, timeout: float = 120.0):
        self.stop.set()
        self.thread.join(timeout=timeout)
        self.loader.shutdown()


@dtypes.compute_dtype()
def main(argv=None) -> list:
    """Train; returns the history."""
    from .data.loader import IterableLoader
    from .device import resolve_device
    from .train.step import init_train_state, make_optimizer, make_recon_train_step
    from .train_unseen_objects import family_modules, load_leaves
    from .utils import cosine_decay_schedule

    args = get_args(argv)
    device = resolve_device(args.device)
    dtypes.set_compute_dtype("bfloat16")
    args.out.mkdir(parents=True, exist_ok=True)
    assets = args.assets_dir or args.out / "assets"
    generator = torch.Generator(device).manual_seed(0)
    modules, _ = family_modules(args.family, device, generator)
    if args.resume_npz is not None:
        load_leaves(modules, args.resume_npz)
        distill.log(f"# warm-start from {args.resume_npz}")
    state = init_train_state(modules, make_optimizer("adam", args.lr))
    schedule = cosine_decay_schedule(args.lr, max(args.steps, 1), alpha=0.01)
    step = make_recon_train_step(modules["sculptor"], modules["fuser"],
                                 modules["photographer"], config=step_config(args.depth_k))

    loader = IterableLoader(make_dataset(args, assets), batch_size=1,
                            num_workers=args.workers, device=None, transport="quantized",
                            decode=False)
    pump = Pump(loader)
    history = []
    try:
        distill.log("# waiting for the render buffer...")
        pump.wait(args.min_buffer)
        fresh = pump.drain()
        buffer = RingBuffer(fresh[0], args.buffer_items, device)
        for item in fresh:
            buffer.write(item)
        chunk = max(1, args.chunk_steps)
        t0 = time.time()
        done = 0
        while done < args.steps:
            for item in pump.drain():
                buffer.write(item)
            state, aux = run_chunk(step, state, buffer, chunk, generator, schedule)
            done += chunk
            row = {"step": done, "loss": float(aux["loss/generator/total"]),
                   "depth": float(aux["loss/generator/depth"]),
                   "mask": float(aux["loss/generator/mask"]),
                   "fresh_items": pump.fresh_items,
                   "steps_per_s": done / max(time.time() - t0, 1e-9)}
            history.append(row)
            distill.log(f"step {done}: loss={row['loss']:.4f} fresh={row['fresh_items']} "
                        f"({row['steps_per_s']:.1f} steps/s)")
            if args.save_every and done % args.save_every < chunk:
                distill.save_params(modules, args.out, "unseen_real", keys=False)
                (args.out / "history.json").write_text(json.dumps(history))
            if args.max_seconds and time.time() - t0 > args.max_seconds:
                distill.log(f"# wall-clock budget {args.max_seconds:.0f}s exceeded; "
                            f"stopping at step {done}")
                break
    finally:
        pump.close()
    (args.out / "history.json").write_text(json.dumps(history))
    distill.save_params(modules, args.out, "unseen_real", keys=False)
    return history


if __name__ == "__main__":
    main()
