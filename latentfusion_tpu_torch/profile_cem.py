"""Trace the cross-entropy (CEM) coarse search and print the top device ops
(counterpart of ``tools/profile_cem.py``).

    python -m latentfusion_tpu_torch.profile_cem [--samples 128] [--iters 10]
        [--top 30] [--trace-dir DIR] [--parse-only] [--device cpu]

The cross_entropy_quick shape (``--samples`` hypotheses an iteration, 48
elites, 6 GMM components, learning rate 0.75, flipped samples, depth
ranking of 16) on ``profile_refinement``'s flagship model and target; it
locates the cost beyond the render (the GMM fit, the sort, the full-frame
loss, the ranking). One ``estimate`` (generator seed 5) warms up; the next
(seed 6) is traced and read as ``profile_refinement`` reads its trace. The
caller's compute dtype is restored on return. Runs on the GPU unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import torch

from . import dtypes
from .device import resolve_device
from .pose import estimation
from .profile_refinement import flagship_model, target_setup, trace_call
from .utils.profiling import top_ops


def estimator_kwargs(samples: int = 128, iters: int = 10) -> dict:
    """``CrossEntropyPoseEstimator``'s arguments in the JAX tool."""
    return dict(ranking_size=16, loss_weights={"depth": 1.0}, num_samples=samples,
                num_iters=iters, num_elites=48, num_gmm_components=6, learning_rate=0.75,
                sample_flipped=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--trace-dir", type=Path,
                   default=Path(tempfile.gettempdir()) / "lf_cem_trace")
    p.add_argument("--parse-only", action="store_true")
    p.add_argument("--samples", type=int, default=128)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the host)")
    return p.parse_args(argv)


@dtypes.compute_dtype()
def main(argv=None):
    """Prints the top ops of the traced estimate; returns their ms by name."""
    args = parse_args(argv)
    if not args.parse_only:
        device = resolve_device(args.device)
        dtypes.set_compute_dtype("bfloat16")
        model = flagship_model(device=device)
        inputs = target_setup(model, n=0)
        est = estimation.CrossEntropyPoseEstimator(
            model=model, **estimator_kwargs(args.samples, args.iters))

        def run(seed):
            est.estimate(inputs["z_obj"], inputs["target_obs"],
                         generator=torch.Generator(device).manual_seed(seed))

        trace_call(lambda: run(6), lambda: run(5), args.trace_dir, device)
    return top_ops(args.trace_dir, k=args.top, device=args.device)


if __name__ == "__main__":
    main()
