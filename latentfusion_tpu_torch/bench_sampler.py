"""Microbenchmark the 3D volume sampler at the flagship decode's shapes
(counterpart of ``tools/bench_sampler.py``).

    python -m latentfusion_tpu_torch.bench_sampler [--n 8] [--c 256]
        [--size 16] [--iters 50] [--backends cuda,plain,aten] [--cpu]

Backends: ``cuda``, the hand-written kernel K1 (``ops.fused_sample.
grid_sample_3d``: K1-fwd, and K1-bwd-grid for the backward; the JAX tool's
``fused`` and ``pallas``, since K1 also serves the tiled sampler's larger
volumes); ``plain``, K1's plain PyTorch twins as one differentiable function
(``grid_sample_3d_plain`` forward, ``grid_sample_3d_bwd_grid_plain``
backward; the JAX tool's ``gather``); ``aten``, ``F.grid_sample``, the
library call PERF.md's tables time beside the kernels (in fp32: it takes the
grid in the volume's dtype, and a bfloat16 grid would move the samples).
The JAX tool's ``matmul``, ``matmul_cl`` and ``gather_cl`` are XLA
formulations with nothing to port.

Modes: ``fwd`` (the sample) and ``fwd+bwd`` with respect to the grid (the
pose-refinement cotangent; the volume's gradient is not asked for). Each
mode runs the JAX tool's loop body eagerly ``--iters`` times (``fwd``:
``acc += fn(vol, grid + acc * 1e-9).mean()``; ``fwd+bwd``: ``acc += loss``
and ``grid -= 1e-9 * dloss/dgrid`` with ``loss = fn(vol, grid).sum()``),
once to warm up and once timed between CUDA events (the host's clock on
the CPU); the line gives ms an iteration and the TFLOP/s of the dense
one-hot matmul that computes the same sample (2 N C S^6 operations). The
volume runs in bfloat16 (``dtypes``), as in the JAX tool; the caller's
compute dtype is restored on return. Runs on the GPU unless ``--cpu``.
"""
from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from . import dtypes
from .device import resolve_device
from .dtypes import get_compute_dtype
from .ops import fused_sample
from .utils import profiling

# The JAX tool's backend names that have a counterpart here.
ALIASES = {"fused": "cuda", "pallas": "cuda", "gather": "plain"}


class PlainSample3d(torch.autograd.Function):
    """K1's plain twins as one function of the grid: the forward samples
    the volume in the compute dtype, the backward is d/dgrid."""

    @staticmethod
    def forward(ctx, volume, grid, padding_mode):
        volume = volume.to(get_compute_dtype())
        ctx.save_for_backward(volume, grid)
        ctx.padding_mode = padding_mode
        return fused_sample.grid_sample_3d_plain(volume, grid, padding_mode, volume.dtype)

    @staticmethod
    def backward(ctx, g):
        if ctx.needs_input_grad[0]:
            raise NotImplementedError("the plain backend differentiates the grid only")
        volume, grid = ctx.saved_tensors
        return None, fused_sample.grid_sample_3d_bwd_grid_plain(
            volume, grid, g.contiguous(), ctx.padding_mode), None


BACKENDS = {
    "cuda": lambda v, g: fused_sample.grid_sample_3d(v, g, padding_mode="border"),
    "plain": lambda v, g: PlainSample3d.apply(v.contiguous(), g.contiguous(), "border"),
    "aten": lambda v, g: F.grid_sample(v, g, mode="bilinear", padding_mode="border",
                                       align_corners=False),
}


def backend(name: str):
    """The sampler of a backend name (or of a JAX tool's name for it)."""
    name = ALIASES.get(name, name)
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}: one of {sorted(BACKENDS)} "
                         f"(or the JAX tool's {sorted(ALIASES)})")
    return BACKENDS[name]


@torch.no_grad()
def loop_fwd(fn, vol, grid, iters: int) -> torch.Tensor:
    acc = torch.zeros((), device=vol.device)
    for _ in range(iters):
        acc = acc + fn(vol, grid + acc * 1e-9).mean()
    return acc


def loop_bwd(fn, vol, grid, iters: int) -> torch.Tensor:
    acc = torch.zeros((), device=vol.device)
    g = grid
    with torch.enable_grad():
        for _ in range(iters):
            g = g.detach().requires_grad_()
            val = fn(vol, g).sum()
            (dg,) = torch.autograd.grad(val, g)
            g = g - 1e-9 * dg
            acc = acc + val.detach()
    return acc


def inputs(n: int, c: int, s: int, device):
    """vol (n, c, s, s, s) N(0, 1) (seed 0) and grid (n, s, s, s, 3)
    uniform in [-1, 1] (seed 1)."""
    vol = torch.randn((n, c, s, s, s), generator=torch.Generator().manual_seed(0))
    grid = torch.rand((n, s, s, s, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
    return vol.to(device), grid.to(device)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=8, help="batch (hypotheses)")
    p.add_argument("--c", type=int, default=256)
    p.add_argument("--size", type=int, default=16)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--backends", default="cuda,plain,aten")
    return p.parse_args(argv)


@dtypes.compute_dtype()
def main(argv=None) -> dict:
    """Prints a line per backend and mode; returns {"<backend> <mode>":
    {"ms": ms an iteration, "acc": the loop's accumulator}}."""
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else "cuda")
    dtypes.set_compute_dtype("bfloat16")
    n, c, s = args.n, args.c, args.size
    vol, grid = inputs(n, c, s, device)
    matmul_flops = 2 * n * c * (s ** 3) * (s ** 3)
    results = {}
    for name in args.backends.split(","):
        fn = backend(name)
        for mode, loop in (("fwd", loop_fwd), ("fwd+bwd", loop_bwd)):
            loop(fn, vol, grid, args.iters)
            out = {}
            dt = profiling.elapsed_ms(
                lambda: out.update(acc=float(loop(fn, vol, grid, args.iters))),
                device) / 1e3 / args.iters
            eff = matmul_flops / dt / 1e12
            print(f"{name:7s} {mode:7s}: {dt * 1e3:8.3f} ms/call "
                  f"({eff:6.1f} TFLOP/s dense-matmul-equivalent)", flush=True)
            results[f"{name} {mode}"] = {"ms": dt * 1e3, "acc": out["acc"]}
    return results


if __name__ == "__main__":
    main()
