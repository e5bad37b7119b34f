"""Time the recurrent fuser's fold over views at the flagship fuser's
shapes (counterpart of ``tools/bench_fuser.py``).

    python -m latentfusion_tpu_torch.bench_fuser [--channels 256]
        [--size 16] [--iters 20] [--cpu]

``recon.fusion.GRUFuser(in_channels=C)`` (weights N(0, 1), seed 0) folds 8,
16 and 24 views of (C, S, S, S) latents (N(0, 1), seed 0) in bfloat16. For
each view count the JAX tool's loop body (``acc += fold(z + acc * 1e-9)
.mean()``) runs ``--iters`` times: the first run's seconds by the host's
clock (``first call``), then ms a fold of a second run between CUDA events
(the host's clock on the CPU). The JAX tool's A/B of an unrolled chain
against ``nn.scan`` has no counterpart: the port's fold is an eager loop of
cell calls (the unrolled chain), so there is one row per view count. The
caller's compute dtype is restored on return. Runs on the GPU unless
``--cpu``.
"""
from __future__ import annotations

import argparse
import time

import torch

from . import dtypes, zoo
from .device import resolve_device, synchronize
from .recon.fusion import GRUFuser
from .utils import profiling

VIEWS = (8, 16, 24)


def make_fuser(channels: int, device, seed: int = 0) -> GRUFuser:
    """``GRUFuser(in_channels=channels)`` with N(0, 1) weights from
    ``seed``, on ``device``, in eval mode."""
    fuser = zoo.init_weights_(GRUFuser(in_channels=channels),
                              torch.Generator().manual_seed(seed))
    return fuser.to(device).eval()


@torch.no_grad()
def fold(fuser, z) -> torch.Tensor:
    """The fused latent (B, 1, C, S, S, S) of views (B, V, C, S, S, S)."""
    return fuser(z)[0]


@torch.no_grad()
def loop(fuser, z, iters: int) -> torch.Tensor:
    acc = torch.zeros((), device=z.device)
    for _ in range(iters):
        acc = acc + fold(fuser, z + acc * 1e-9).mean()
    return acc


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--channels", type=int, default=256)
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--iters", type=int, default=20)
    return p.parse_args(argv)


@dtypes.compute_dtype()
def main(argv=None) -> dict:
    """Prints a line per view count; returns {views: {"first_s": seconds,
    "fold_ms": ms}}."""
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    dtypes.set_compute_dtype("bfloat16")
    c, s = args.channels, args.size
    fuser = make_fuser(c, device)
    results = {}
    for v in VIEWS:
        zv = torch.randn((1, v, c, s, s, s),
                         generator=torch.Generator().manual_seed(0)).to(device)
        t0 = time.perf_counter()
        float(loop(fuser, zv, args.iters))
        synchronize(device)
        first = time.perf_counter() - t0
        step = profiling.elapsed_ms(lambda: float(loop(fuser, zv, args.iters)),
                                    device) / args.iters
        print(f"V={v:2d} {'unroll':6s}: first call {first:6.2f}s  fold {step:7.2f} ms",
              flush=True)
        results[v] = {"first_s": first, "fold_ms": step}
    return results


if __name__ == "__main__":
    main()
