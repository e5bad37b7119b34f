"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--unseen-latent-rank]
                          [--accuracy-seeds N [N ...] [--with-unseen]]

Phases, each announced on its own line before it starts and reported on one
line after it ends:

1. device: the card's name and power limit; build the five CUDA kernels
   (K1-fwd, K1-bwd-grid and K1-bwd-vol in csrc/fused_sample.cu, K2-fwd and
   K2-bwd in csrc/lrelu_pnorm.cu) with nvcc, one process per source,
   started together. Then the reference objects o0 and o1 (held-out
   objects 0 and 1 of the unseen-object rig's lobe pool, seed 7919) are
   rendered by the lobe oracle at the rig's 16 reference cameras of
   480x640 (latentfusion_tpu_torch/unseen_cameras.json); each view's sums
   of depth, mask and color must agree with the JAX package's render's.
2. kernels: each kernel against its plain PyTorch version at the shapes of
   the build + render path, of the refinement backward and of the training
   step (K1-bwd-vol on the flagship recipe's decode and encode grids, with
   the share of samples border padding clips, its plan, and its time under
   other plans), with kernel, plain and library times (device time by torch.profiler, warm-up
   excluded; the redesigned kernels also by CUDA events back to back): K1-fwd
   at the render (128 hypotheses) and refinement (8) shapes, K1-bwd-grid at
   the refinement shape, K2-fwd at the 8 shapes of a refinement step's 19
   calls and of a CEM render's (batch 128), K2-bwd at those of a refinement
   step, each run twice for the same bits (every kernel but K1-bwd-vol's
   atomic one), the K2 tables with their launch-weighted sums. Then K1 at a
   shape of the tiled sampler K3 (volumes over 17^3), which K1 serves, and
   the kernels that serve volumes whose channel does not fit in shared
   memory (K1-fwd's gather kernel, K1-bwd-grid's per-sample kernel,
   K1-bwd-vol's atomic kernel) at vol (1, 8, 48^3); each K1-fwd timing
   names the kernel that served it, and the launch counters must show which
   K1-bwd-grid and K1-bwd-vol kernel ran (staged and tiled at 16^3 and
   32^3). Then K1's kernels at the shapes of the multi-object and latent
   paths (two objects' CEM render and refinement step; a latent refinement
   step's render, autoencode decode and Sculptor camera->object sampling)
   and of phase 9 (the demo and mid families' 8^3 latents: 16 views'
   camera->object sampling, four objects' CEM render and refinement step),
   each against its plain version, twice for the same bits, and timed.
3. flagship: for each reference object (o0 and o1, 16 rendered views of
   480x640 RGB-D), build the latent object with the flagship
   family (weights drawn from --seed) and render it from 128 hypothesis
   cameras; the launch counters must show both kernels on this path, and
   the result must agree with the same path on the plain versions. One
   render of the first object is profiled: device time by kernel.
4. demo: the same at the demo family with the learned weights of
   artifacts/encoder_distill/encoder_distill.npz.
5. pose, flagship: the latent of views 0-14 of o0, then the pose of
   view 15 (known) by CEM (configs/cross_entropy_quick.toml), then gradient
   refinement (configs/adam_quick.toml); the launch counters must show all
   four kernels on this path. The refinement runs again from the first
   run's coarse cameras and must end on the same final pose and loss
   history bits (if not, the ops that torch's deterministic-algorithms
   check flags and the modules whose backward parts the bits are printed
   first). One step is timed as the package runs it (cuDNN's deterministic
   algorithms) and with cuDNN's default selection. One step is recorded:
   K2's calls must match phase 2's table, and the backward of each of the
   decoder's linear resizes, run twice, must give the same bits. One
   refinement step must agree with the plain versions (see
   gradient_check). One refinement step is profiled: device time by
   kernel, and K2-fwd's and K2-bwd's totals beside phase 2's sums. Then
   the latent path on the same target: configs/cross_entropy_latent.toml
   then configs/adam_latent.toml; the launch counters must show all five
   kernels, two refinements from the same coarse cameras must end on the
   same bits, one step's K1 calls must be shapes phase 2 held, and one
   step must agree with the plain versions; ms per step, peak memory and
   a profile of one step.
6. pose accuracy, demo family with the learned weights: the latent of 16
   shaded views of the analytic ellipsoid, then CEM + refinement on 8
   seeded target poses; ADD-S within a tenth of the diameter on at least 7.
   One refinement step must agree with the plain versions. The same for
   the Metropolis estimator as the coarse stage (tools/metropolis_eval.py's
   128 chains, 300 iterations), and for all 8 targets as one
   ``estimate_batch`` of CEM and refinement. ``--accuracy-seeds`` runs
   only these three rigs, ungated, at each seed given.
7. training, flagship: the published recipe's generator step
   (train/step.py make_recon_train_step, no discriminator) with weights
   N(0, 1) from --seed, on batches of the analytic ellipsoid rendered on
   the card: global batch 8 objects in 2 microbatches, 8 input and 24
   output views of 640x480 zoomed to 256^2, depth hard smooth-L1 (k 16384)
   and mask BCE at weight 25, Adam lr 1e-3, betas (0, 0.99). One step's
   gradient must agree with the plain versions (see gradient_check);
   the launch counters must show K1-fwd, K1-bwd-vol, K2-fwd and K2-bwd on
   it. Two steps from the same state and batch must give the same gradient
   bits (the step runs on cuDNN's deterministic selection); the same with
   cuDNN's default selection patched in, and ms per step under each, are
   printed. Then ms per step, peak memory and a profile of one step, a run
   on a pool of batches
   whose held-out loss must fall, and ms per step with K1-bwd-vol's tiled
   kernel and with the atomic kernel it replaced, in turns.
8. the pose service (latentfusion_tpu_torch/serve.py) at flagship width,
   weights from --seed: two rounds of ping, register o0 and o1 (views 0-14),
   estimates of view 15 of o0, of that frame twice and of o0 and o1
   together, a malformed line, an unknown command and a shutdown, through
   ``serve_lines``. The responses must be the protocol's, the single
   estimate the direct coarse + fine estimate with the same seed, and each
   object's refinement step in the two-object batch its single-object
   step. Seconds, launches and peak memory per request.
9. unseen objects: the pool-128 checkpoint
   (artifacts/unseen_objects_pool128, demo family) on held-out objects 0-3
   of lobe pool seed 7919, never rendered in its training: the latent of
   each from JAX's 16 reference views, then JAX's 6 target poses at the
   published budget (CEM 128 x 10, 48 elites, refinement 16 x 150, depth
   ranking), each target index one ``estimate_batch`` over the 4 objects;
   at least 16 of 24 within a tenth of the diameter (the JAX record is 19).
   Every K1 call must be a shape phase 2 held. Then one target index at
   the mid width (the flagship's widths at 128^2) with weights N(0, 1)
   from --seed, for time, memory and launches. ``--unseen-latent-rank``
   adds an ungated pass with the latent ranking term at 0.2;
   ``--with-unseen`` runs this rig, ungated, at each of --accuracy-seeds.
10. reconstruction: the demo family with the learned weights on 16 shaded
   reference views and 8 targets of the ellipsoid oracle, whose cameras
   and JAX fp32 results are latentfusion_tpu_torch/recon_cameras.json. The
   views go through ``Observation.save`` and ``load`` (the loaded arrays
   must be the quantised ones, bit for bit); then the latent,
   ``render_full`` at the targets, ``render_ibr_basic``, ``render_full``
   with ``input_obs`` and ``render_ibr`` with the published generator
   config (tools/train_ibr.py, N(0, 1) weights from --seed). The launch
   counters must show K1-fwd and K2-fwd; the pass must agree with the same
   pass on the plain versions (5e-4, masked colors and depth where both
   masks agree, flips at most 0.1 % of the pixels); each target's sums of
   depth, mask and color must agree with JAX's record (SUMS_TOL); the mask
   IoU and depth error against the truth are printed beside JAX's, with
   ``estimate_camera``'s translation error, ms and peak memory per call of
   8 targets and one ``render_ibr`` profiled by op (time and memory).
11. model options and the GAN step: (a) the training tool's default
   architecture at input 256 (latentfusion_tpu/train/args.py:94-125: 32^3
   camera volumes and latent, factor projections, the pool:max fuser),
   predicting color, depth and mask, with an occlusion module of the
   tool's default --fuser-config shape and the multi-scale discriminator
   (64, 128, 256, 512 over 3 scales) on color + depth + mask, the tool's
   loss defaults and instance noise at weight 1, weights N(0, 1) from
   --seed, Adam (0, 0.99) for both, on phase 7's batches (global batch 8
   in 2 microbatches, 8 + 24 views): the loss and the G and D gradients
   of a step on one object of the batch at the initial weights against
   the plain versions (see gradient_check: the step is ill-conditioned
   there, so the loss and each gradient tensor are also held to their own
   floors, and the PixelNorm sites near zero are counted); two steps from
   the same state and batch, the same loss, gradient and parameter bits:
   one timed (ms, peak memory), one profiled with its launches, K1 and K2
   shapes and losses (all finite), and the discriminator's device time
   read from its trace (the ``discriminator`` profiler range of
   train/step.py and the backward of the ops inside it).
   (b) At flagship width: the Blend and the LSTM fusers each build o0 and
   render 128 hypotheses (against the plain versions, as phase 3); one
   Blend training step on phase 7's batch with the input views
   reconstructed, the noisy depth input and RMSprop, and the same step with
   remat: the same gradient and parameter bits, peak memory of each; a
   Photographer with skip connections decodes the 16 views of o0 at their
   own cameras from the Sculptor's intermediates, forward and backward,
   against the plain versions. Every K1 call of the phase must be a shape
   phase 2 held (phase 2 holds K1-fwd and K1-bwd-vol at the Blend weights'
   one channel, at the training microbatch's shapes with the input views
   reconstructed, and at the tool architecture's 32^3 volumes). Phase 3
   also checks that a GRU build launches K1-fwd once (the Sculptor maps
   its camera intermediates only for a fuser that reads them) and that the
   latent is the same bits as with them mapped.

Then one ``kernels`` JSON line (each kernel's launches on the main path of
the slice that ported it: phase 5's pose path, phase 7's training step for
K1-bwd-vol; ``launches_by_path`` has every path, phases 10 and 11's too). The last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero, as does a
machine without a GPU. TF32 is off throughout, so kernel and plain paths
compare in fp32.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parent
POOL128 = ROOT / "artifacts" / "unseen_objects_pool128"
DISTILL = ROOT / "artifacts" / "encoder_distill"
CONFIGS = ROOT / "configs"
N_HYPOTHESES = 128
N_REFINE = 8  # adam_quick's hypotheses
CAMERA_DIST = 5.78  # the reference objects are unit-sized, seen from ~5.7
# The reference objects o0 and o1: held-out objects 0 and 1 of the unseen-object
# rig's lobe pool (seed 7919), rendered at the rig's 16 reference cameras.
HELDOUT_POOL_SEED = 7919
SUMS_TOL = 1e-3  # a view's depth and color sums, relative; its mask count, of its pixels
UNSEEN_OBJECTS, UNSEEN_TARGETS, UNSEEN_INPUT_SIZE = 4, 6, 128
UNSEEN_BUDGET = {"cem_samples": 128, "cem_iters": 10, "cem_elites": 48,
                 "refine_samples": 16, "refine_iters": 150}
UNSEEN_GATE = 16  # of 24 held-out targets within 0.1d (the JAX record: 19)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak memory rate
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
FP32_TOL = 1e-5  # kernel vs plain, fp32: same arithmetic, other sum order
BF16_TOL = 2.0 ** -7  # bf16 output: one rounding step, relative
NET_TOL = 5e-4  # a network's output on the kernels vs on the plain versions
# K2-fwd vs its plain version in fp32: about 1 ulp per element (6e-8), 4e-7
# at most relative to the largest value (phase 2). The gradient's noise
# floor perturbs the activations at both sizes, rounded up.
FLOOR_EPS = (1e-7, 4e-7)
FLOOR_FACTOR = 3.0  # a gradient gated by its noise floor may reach 3x it
# The gradient of a parameter that does not reach the output (a conv bias
# before instance norm), relative to the largest gradient: rounding noise.
NOISE_ONLY_TOL = 1e-3
NEAR_ZERO_INV = 1e3  # a K2 site whose PixelNorm scale exceeds this sits near zero
WITNESS_DRAWS = 2  # draws per backward kernel of backward_witness's floor
ORACLE_AXES = (0.21, 0.36, 0.5)  # tools/train_encoder_distill.py's ellipsoid
ORACLE_DIAMETER = 2 * max(ORACLE_AXES)
RECON_CAMERAS = ROOT / "latentfusion_tpu_torch" / "recon_cameras.json"
# The IBR generator's published block config (tools/train_ibr.py:32).
RECON_GENERATOR_CONFIG = ((64, "D", 128, "D", 256, "D", 512),
                          (512, "U", 256, "U", 128, "U", 64))
# The published recipe (tools/train_reconstruct.py): global batch 8 in 2
# microbatches, 8 input and 24 output views, 640x480 renders.
TRAIN_BATCH, TRAIN_MICROBATCHES, TRAIN_IN, TRAIN_OUT = 8, 2, 8, 24
TRAIN_POOL, TRAIN_STEPS, TRAIN_EVERY = 3, 20, 10
TRAIN_TIMED = 10  # steps timed with CUDA events, after 2 warm-up steps
# Phase 11 (a): the training tool's default architecture at input 256
# (latentfusion_tpu/train/args.py:94-125): camera volumes and latent of 32^3.
GAN_INPUT_SIZE, GAN_LATENT_SIZE = 256, 32
TOOL_SCULPTOR = dict(
    image_config=((64, "D", 64, "D", 128, "D", 256, "D", 512, "D", 512, "D", 512),
                  (512, "U", 512, "U", 512, "U", 256)),
    camera_config=(32, 64, 128), object_config=(128, 256))
TOOL_PHOTOGRAPHER = dict(
    image_config=((256, "D", 512, "D", 512, "D", 512),
                  (512, "U", 512, "U", 512, "U", 256, "U", 128, "U", 64, "U", 32)),
    camera_config=(256, 256, 256), object_config=(256, 256))
GAN_D_CONFIG, GAN_D_SCALES = (64, 128, 256, 512), 3
# The tool's default --fuser-config: the Blend fuser's U-Net here, and the
# occlusion module's (no shipped configuration sets one).
OPTION_UNET3D_CONFIG = ((4, "D", 4, "D", 8, "D", 16), (16, "U", 8, "U", 4, "U", 4))
# K2-bwd's calls in one flagship refinement step (8 hypotheses): x's shape
# and calls per step (phase 5 checks them against a step).
REFINE_K2_CALLS = (((8, 256, 16, 16, 16), 2), ((8, 256, 16, 16), 3),
                   ((8, 512, 16, 16), 2), ((8, 512, 8, 8), 4), ((8, 512, 4, 4), 2),
                   ((8, 196, 32, 32), 2), ((8, 128, 64, 64), 2),
                   ((8, 64, 128, 128), 2))


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(message: str) -> None:
    say(f"FAIL: {message}")
    sys.exit(1)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)


def event_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """ms per call of ``fn`` run back to back, by CUDA events: the device's
    time or, where the host queues work slower than the device runs it,
    the host's."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device ms per call of ``fn``: the summed device time of the kernels
    it launches (torch.profiler), warm-up excluded. A wrapper's host time
    (tens of microseconds a call) would hide a short kernel from CUDA events
    timed back to back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ phases
def phase_device(build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say(smi)
    t0 = time.perf_counter()
    build.build_all()
    return smi, time.perf_counter() - t0


def phase_kernels(fused_sample, lrelu_pnorm, seed):
    """Every kernel against its plain version; returns the timing record of
    each kernel at its main-path shape."""
    from latentfusion_tpu_torch import transforms
    from latentfusion_tpu_torch import zoo

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    records = {}

    # K1 on the grids of the flagship path for object o0: decode (one
    # shared latent, 128 cameras for a CEM render, the first 8 for a
    # refinement step) and encode (16 views, each its own volume). The
    # volumes are random; the grids set the access pattern.
    obs = reference_views(0, dev)
    size = zoo.FLAGSHIP_INPUT_SIZE
    decode_grid = transforms.object_to_camera_grid(
        hypothesis_cameras(obs, size, CAMERA_DIST, g), 16)
    encode_grid = transforms.camera_to_object_grid(
        obs.camera.zoom(None, size, CAMERA_DIST), 16)
    del obs
    k1_table = []
    for label, nv, grid in (("render", 1, decode_grid),
                            ("refine", 1, decode_grid[:N_REFINE].contiguous()),
                            ("encode", 16, encode_grid)):
        n, c = grid.shape[0], 256
        vol32 = torch.randn(nv, c, 16, 16, 16, generator=g, device=dev)
        for padding in ("border", "zeros"):
            for dtype in (torch.float32, torch.bfloat16):
                vol = vol32.to(dtype)
                out = fused_sample.grid_sample_3d_fused(vol, grid, padding, dtype)
                ref = fused_sample.grid_sample_3d_plain(vol, grid, padding, dtype)
                torch.cuda.synchronize()
                err = rel_err(out, ref)
                tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
                say(f"  K1 {label} NV={nv} N={n} C={c} 16^3 {padding} "
                    f"{str(dtype)[6:]}: rel err {err:.3g} (tol {tol:.3g})")
                if not err <= tol:
                    fail(f"K1 {label} {padding} {dtype} disagrees with plain")
        if label in ("render", "refine"):
            vol = vol32
            row = time_k1(fused_sample, vol, grid, "border", f"{label} NV={nv} N={n} C={c} 16^3")
            k1_table.append(row)
            if label == "render":
                records["K1"] = dict(
                    name="fused_sample_fwd", route="cuda",
                    source="latentfusion_tpu_torch/csrc/fused_sample.cu",
                    replaces="latentfusion_tpu/ops/pallas_fused_sample.py:314",
                    max_abs_err=row["max_abs_err"], ms=row["ms"],
                    plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                    bound_by=row["bound_by"], library_ms=row["library_ms"])
        del vol32, vol, out, ref
    del decode_grid, encode_grid, grid

    # K2-fwd at the 19 calls of a refinement step (8 hypotheses) and of a
    # CEM render of 128, fp32 and bf16, each run twice for the same bits.
    k2_tables = {}
    for label, batch in (("refinement step", N_REFINE), ("CEM render of 128", N_HYPOTHESES)):
        k2_tables[label] = k2_table(
            "K2-fwd", label, [((batch, *shape[1:]), n) for shape, n in REFINE_K2_CALLS],
            lambda shape, dtype: (torch.randn(*shape, generator=g, device=dev).to(dtype),),
            lambda x: lrelu_pnorm.lrelu_pixel_norm_fwd(x, 0.2, 1e-8),
            lambda x: lrelu_pnorm.lrelu_pixel_norm_plain(x, 0.2, 1e-8),
            lambda x: 2 * x.numel() * 4 + x[:, 0].numel() * 4, 6.0)
    last = k2_tables["CEM render of 128"]["rows"][-1]  # (128, 64, 128^2)
    records["K2"] = dict(
        name="lrelu_pnorm_fwd", route="cuda",
        source="latentfusion_tpu_torch/csrc/lrelu_pnorm.cu",
        replaces="latentfusion_tpu/ops/pallas_lrelu_pnorm.py:87",
        max_abs_err=last["max_abs_err"], ms=last["ms"], plain_ms=last["plain_ms"],
        bound_ms=last["bound_ms"], bound_by=last["bound_by"], library_ms=None)
    torch.cuda.empty_cache()
    return records, k1_table, k2_tables


def as_tuple(result) -> tuple:
    return result if isinstance(result, tuple) else (result,)


def k2_table(name, label, calls, make, run, plain, nbytes, flops_per_element):
    """K2 (``run(*make(shape, dtype))``, returning a tensor or a tuple of
    tensors) against ``plain`` on the same inputs at each (shape, calls) of
    ``calls``, fp32 and bf16, each run twice for the same bits; fp32 timed.
    Prints the table and its launch-weighted sum; returns both."""
    rows = []
    for shape, calls_per in calls:
        for dtype in (torch.float32, torch.bfloat16):
            args = make(shape, dtype)
            out, again, ref = (as_tuple(f(*args)) for f in (run, run, plain))
            torch.cuda.synchronize()
            err = max(rel_err(a, b) for a, b in zip(out, ref))
            tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
            same = all(torch.equal(a, b) for a, b in zip(out, again))
            say(f"  {name} {shape} {str(dtype)[6:]}: rel err {err:.3g} (tol {tol:.3g}); "
                f"run twice, same bits: {same}")
            if not err <= tol:
                fail(f"{name} {shape} {dtype} disagrees with plain")
            if not same:
                fail(f"{name} {shape} {dtype} is not bit-reproducible")
            if dtype == torch.float32:
                ms, events = time_ms(lambda: run(*args)), event_ms(lambda: run(*args))
                plain_ms = time_ms(lambda: plain(*args), iters=3)
                b, by = bound_ms(nbytes(args[0]), flops_per_element * args[0].numel())
                rows.append(dict(shape=shape, per_step=calls_per, ms=ms, event_ms=events,
                                 bound_ms=b, bound_by=by, plain_ms=plain_ms,
                                 max_abs_err=float((out[0] - ref[0]).abs().max())))
            del args, out, again, ref
    say(f"  {name} at the {label}'s shapes, float32 (launches, kernel device ms, bound ms "
        f"by bytes, plain device ms, kernel ms back to back by CUDA events):")
    for row in rows:
        say(f"    {str(row['shape']):24s} x{row['per_step']}  {row['ms']:.4f}  "
            f"{row['bound_ms']:.4f}  {row['plain_ms']:.4f}  {row['event_ms']:.4f}")
    total = {k: sum(r["per_step"] * r[k] for r in rows)
             for k in ("ms", "bound_ms", "plain_ms", "event_ms")}
    say(f"  {name} per {label} ({sum(r['per_step'] for r in rows)} calls), "
        f"launch-weighted: {total['ms']:.4f} ms of device time, bound "
        f"{total['bound_ms']:.4f} ms, plain {total['plain_ms']:.4f} ms; back to "
        f"back by CUDA events {total['event_ms']:.4f} ms")
    return dict(rows=rows, per_step=total)


def time_k1(fused_sample, vol, grid, padding, label):
    """K1-fwd (fp32 out) against its plain version and F.grid_sample: one
    row of the K1 table, with the kernel that served the shape."""
    n = grid.shape[0]
    out = fused_sample.grid_sample_3d_fused(vol, grid, padding)
    ref = fused_sample.grid_sample_3d_plain(vol, grid, padding)
    torch.cuda.synchronize()
    run = lambda: fused_sample.grid_sample_3d_fused(vol, grid, padding)
    ms, events = time_ms(run), event_ms(run)
    plain = time_ms(lambda: fused_sample.grid_sample_3d_plain(vol, grid, padding), iters=3)
    vol_n = vol.expand(n, -1, -1, -1, -1)
    lib = time_ms(lambda: torch.nn.functional.grid_sample(
        vol_n, grid, mode="bilinear", padding_mode=padding, align_corners=False))
    nbytes = (vol.numel() + grid.numel() + out.numel()) * 4
    # 8 multiply-adds per output + ~40 operations per sample.
    b, by = bound_ms(nbytes, 16.0 * out.numel() + 40.0 * grid[..., 0].numel())
    row = dict(shape=label, kernel=fused_sample.fwd_kernel(vol.shape),
               max_abs_err=float((out - ref).abs().max()), rel_err=rel_err(out, ref),
               ms=ms, event_ms=events, plain_ms=plain, bound_ms=b, bound_by=by,
               library_ms=lib)
    say(f"  K1-fwd {label} {padding} float32, {row['kernel']} kernel: {ms:.4f} ms "
        f"(back to back by CUDA events {events:.4f} ms), bound {b:.4f} ms ({by}), "
        f"plain {plain:.3f} ms, F.grid_sample {lib:.4f} ms (device time)")
    return row


def phase_bwd_kernels(fused_sample, lrelu_pnorm, seed):
    """The backward kernels against their plain versions at the shapes of
    the flagship refinement backward (8 hypotheses); returns their timing
    records."""
    from latentfusion_tpu_torch import transforms
    from latentfusion_tpu_torch import zoo

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    records = {}

    # K1-bwd-grid on the decode grid of 8 hypotheses of object o0 (one
    # shared latent, 256 channels, 16^3 samples).
    obs = reference_views(0, dev)
    cams = hypothesis_cameras(obs, zoo.FLAGSHIP_INPUT_SIZE, CAMERA_DIST, g)[:N_REFINE]
    grid = transforms.object_to_camera_grid(cams, 16)
    del obs
    n, c = grid.shape[0], 256
    vol = torch.randn(1, c, 16, 16, 16, generator=g, device=dev)
    gout = torch.randn(n, c, 16, 16, 16, generator=g, device=dev)
    for padding in ("border", "zeros"):
        out, again = bwd_grid_twice(fused_sample, vol, grid, gout, padding, "staged")
        ref = fused_sample.grid_sample_3d_bwd_grid_plain(vol, grid, gout, padding)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        same = bool(torch.equal(out, again))
        say(f"  K1-bwd-grid NV=1 N={n} C={c} 16^3 {padding} float32, staged kernel "
            f"{fused_sample.bwd_grid_plan(vol.shape, n, grid[0, ..., 0].numel())}: rel err "
            f"{err:.3g} (tol {FP32_TOL:.3g}); run twice, same bits: {same}")
        if not err <= FP32_TOL:
            fail(f"K1-bwd-grid {padding} disagrees with plain")
        if not same:
            fail(f"K1-bwd-grid {padding} is not bit-reproducible")
        if padding == "border":
            run = lambda: fused_sample.grid_sample_3d_bwd_grid(vol, grid, gout, padding)
            ms, events = time_ms(run), event_ms(run)
            plain = time_ms(lambda: fused_sample.grid_sample_3d_bwd_grid_plain(
                vol, grid, gout, padding), iters=3)
            vol_n = vol.expand(n, -1, -1, -1, -1).contiguous()
            lib = time_ms(lambda: torch.ops.aten.grid_sampler_3d_backward(
                gout, vol_n, grid, 0, 1, False, [False, True]))
            nbytes = (gout.numel() + vol.numel() + 2 * grid.numel()) * 4
            # Per sample and channel: 8 corner loads into 3 x 8 multiply-adds
            # and 3 more for g; ~60 operations per sample for the taps.
            flops = 2.0 * 27 * gout.numel() + 60.0 * grid[..., 0].numel()
            b, by = bound_ms(nbytes, flops)
            alt, alt_ms = bwd_grid_two_waves(fused_sample, vol, grid, gout, padding)
            say(f"  K1-bwd-grid refinement shape, border float32: {ms:.4f} ms (back to back "
                f"by CUDA events {events:.4f} ms), bound {b:.4f} ms ({by}), plain "
                f"{plain:.3f} ms, aten grid_sampler_3d_backward (grid only) {lib:.4f} ms "
                f"(device time); with {alt} {alt_ms:.4f} ms")
            records["K1b"] = dict(
                name="fused_sample_bwd_grid", route="cuda",
                source="latentfusion_tpu_torch/csrc/fused_sample.cu",
                replaces="latentfusion_tpu/ops/pallas_fused_sample.py:352",
                max_abs_err=float((out - ref).abs().max()), ms=ms, plain_ms=plain,
                bound_ms=b, bound_by=by, library_ms=lib)
            del vol_n
    del vol, gout, grid, out, again, ref

    # K2-bwd at every shape of the refinement step (8 hypotheses).
    def inputs(shape, dtype):
        x = torch.randn(*shape, generator=g, device=dev).to(dtype)
        gy = torch.randn(*shape, generator=g, device=dev).to(dtype)
        return x, lrelu_pnorm.lrelu_pixel_norm_fwd(x, 0.2, 1e-8)[1], gy

    table = k2_table(
        "K2-bwd", "refinement step", REFINE_K2_CALLS, inputs,
        lambda x, inv, gy: lrelu_pnorm.lrelu_pixel_norm_bwd(x, inv, gy, 0.2),
        lambda x, inv, gy: lrelu_pnorm.lrelu_pixel_norm_bwd_plain(x, inv, gy, 0.2),
        lambda x: 3 * x.numel() * 4 + x[:, 0].numel() * 4, 8.0)
    last = table["rows"][-1]
    records["K2b"] = dict(
        name="lrelu_pnorm_bwd", route="cuda",
        source="latentfusion_tpu_torch/csrc/lrelu_pnorm.cu",
        replaces="latentfusion_tpu/ops/pallas_lrelu_pnorm.py:104",
        max_abs_err=last["max_abs_err"], ms=last["ms"], plain_ms=last["plain_ms"],
        bound_ms=last["bound_ms"], bound_by=last["bound_by"], library_ms=None)
    torch.cuda.empty_cache()
    return records, table


def bwd_grid_two_waves(fused_sample, vol, grid, gout, padding):
    """K1-bwd-grid's staged kernel with twice its plan's channel groups (two
    waves of blocks, the 264 or more that one SM each would fill twice):
    the plan and the device ms, beside which the plan's own one wave is
    chosen."""
    n, c = grid.shape[0], vol.shape[1]
    plan = fused_sample.bwd_grid_plan(vol.shape, n, grid[0, ..., 0].numel())
    chunks = -(-c // plan.chunk)
    group_channels = plan.chunk * -(-chunks // min(chunks, 2 * plan.groups))
    groups = -(-c // group_channels)
    alt = plan._replace(group_channels=group_channels, groups=groups,
                        blocks=plan.blocks // plan.groups * groups)
    with mock.patch.object(fused_sample, "bwd_grid_plan", lambda *_: alt):
        ms = time_ms(lambda: fused_sample.grid_sample_3d_bwd_grid(vol, grid, gout, padding))
    return alt, ms


def bwd_grid_twice(fused_sample, vol, grid, gout, padding, kernel):
    """K1-bwd-grid twice on one input; fails unless both calls went
    through ``kernel`` ("staged" or "per_sample") by its launch counter."""
    counter = {"staged": "BWD_GRID_LAUNCHES",
               "per_sample": "BWD_GRID_PER_SAMPLE_LAUNCHES"}[kernel]
    before = getattr(fused_sample, counter)
    out = fused_sample.grid_sample_3d_bwd_grid(vol, grid, gout, padding)
    again = fused_sample.grid_sample_3d_bwd_grid(vol, grid, gout, padding)
    if getattr(fused_sample, counter) != before + 2:
        fail(f"K1-bwd-grid at vol {tuple(vol.shape)} did not go through the {kernel} kernel")
    return out, again


def train_config():
    """The published recipe's step settings (tools/train_reconstruct.py; the
    camera distance is its auto_camera_dist for 640x480 renders)."""
    from latentfusion_tpu_torch.recon.utils import optimal_camera_dist

    return {"camera_dist": optimal_camera_dist(615.0, 480, 3 ** 0.5 / 2, slack=0.1),
            "random_orientation": True, "g_depth_recon_loss_type": "hard_smooth_l1",
            "g_depth_recon_loss_weight": 25.0, "g_depth_recon_loss_k": 16384,
            "g_mask_recon_loss_weight": 25.0}


def train_batch(generator, batch_size=TRAIN_BATCH):
    """One raw oracle batch of the recipe's views, rendered on the card."""
    from latentfusion_tpu_torch import testing

    return testing.render_training_batch(generator, batch_size, TRAIN_IN, TRAIN_OUT,
                                         device="cuda")


def lib_bwd_vol(vol_shape, grid, g, padding):
    """aten's grid-sample backward, input gradient only, on the volume
    repeated to N, then the sum over each volume's group."""
    nv, n = vol_shape[0], grid.shape[0]
    vol_n = torch.zeros((n, *vol_shape[1:]), device=grid.device)
    pad = {"zeros": 0, "border": 1}[padding]

    def run():
        dv, _ = torch.ops.aten.grid_sampler_3d_backward(
            g, vol_n, grid, 0, pad, False, [True, False])
        return dv.reshape(nv, n // nv, *vol_shape[1:]).sum(1)
    return run


def clipped_share(grid, dhw) -> float:
    """The share of samples that border padding clips on at least one axis
    of a volume of ``dhw`` (D, H, W)."""
    size = torch.tensor(dhw[::-1], dtype=torch.float32, device=grid.device)
    x = ((grid + 1) * size - 1) / 2
    return float(((x < 0) | (x > size - 1)).any(-1).float().mean())


def bwd_vol_twice(fused_sample, grid, gout, shape, padding, kernel="tiled"):
    """K1-bwd-vol twice on one input; fails unless both calls went through
    ``kernel`` ("tiled" or "atomic") by its launch counter."""
    counter = {"tiled": "BWD_VOL_LAUNCHES", "atomic": "BWD_VOL_ATOMIC_LAUNCHES"}[kernel]
    before = getattr(fused_sample, counter)
    out = fused_sample.grid_sample_3d_bwd_vol(grid, gout, shape, padding)
    again = fused_sample.grid_sample_3d_bwd_vol(grid, gout, shape, padding)
    if getattr(fused_sample, counter) != before + 2:
        fail(f"K1-bwd-vol at vol {tuple(shape)} did not go through the {kernel} kernel")
    return out, again


def bwd_vol_alternatives(fused_sample, grid, gout, shape, padding):
    """K1-bwd-vol's tiled kernel under other plans than its own: one slice,
    twice the plan's slices, and half its channels a block; each plan's
    (channels, slices, blocks) beside its device ms."""
    n, k = grid.shape[0], grid[0, ..., 0].numel()
    plan = fused_sample.bwd_vol_plan(shape, n, k)
    per_volume = n // shape[0] * k
    rows = []
    for channels, slices in ((plan.channels, 1), (plan.channels, 2 * plan.slices),
                             (max(1, plan.channels // 2), plan.slices)):
        slice_len = -(-per_volume // slices)
        slice_len = -(-slice_len // 256) * 256
        slices = -(-per_volume // slice_len)
        alt = plan._replace(channels=channels, slices=slices, slice_len=slice_len,
                            smem=fused_sample._bwd_vol_smem(channels, plan.class_words,
                                                            plan.shared_taps),
                            blocks=shape[0] * slices * -(-shape[1] // channels))
        if alt == plan:
            continue
        with mock.patch.object(fused_sample, "bwd_vol_plan", lambda *_: alt):
            ms = time_ms(lambda: fused_sample.grid_sample_3d_bwd_vol(grid, gout, shape, padding))
        rows.append(((alt.channels, alt.slices, alt.blocks), round(ms, 4)))
    return rows


def phase_train_kernels(fused_sample, seed):
    """K1-bwd-vol against its plain version on the grids of the flagship
    training microbatch (4 objects): decode (each object's latent read by
    its 24 output views) and encode (one camera volume per input view), each
    run twice for the same bits; returns its timing record at the decode
    shape and its rows at both shapes."""
    from latentfusion_tpu_torch import transforms, zoo
    from latentfusion_tpu_torch.recon.utils import process_batch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    objects = TRAIN_BATCH // TRAIN_MICROBATCHES
    proc = process_batch(train_batch(g, objects), 1.0, train_config()["camera_dist"],
                         zoo.FLAGSHIP_INPUT_SIZE, generator=g)
    grids = {"decode": (objects, transforms.object_to_camera_grid(proc["out_gt"]["camera"], 16)),
             "encode": (objects * TRAIN_IN,
                        transforms.camera_to_object_grid(proc["in"]["camera"], 16))}
    del proc
    records, rows = {}, {}
    for label, (nv, grid) in grids.items():
        n, c = grid.shape[0], 256
        shape = (nv, c, 16, 16, 16)
        plan = fused_sample.bwd_vol_plan(shape, n, grid[0, ..., 0].numel())
        say(f"  K1-bwd-vol {label} NV={nv} N={n} C={c} 16^3: samples clipped by border "
            f"padding on at least one axis {clipped_share(grid, shape[2:]):.4f}; tiled "
            f"kernel {plan}")
        gout = torch.randn(n, c, 16, 16, 16, generator=g, device=dev)
        for padding in ("border", "zeros"):
            for dtype in (torch.float32, torch.bfloat16):
                gd = gout.to(dtype)
                out, again = bwd_vol_twice(fused_sample, grid, gd, shape, padding)
                ref = fused_sample.grid_sample_3d_bwd_vol_plain(grid, gd, shape, padding)
                torch.cuda.synchronize()
                err, same = rel_err(out, ref), bool(torch.equal(out, again))
                say(f"  K1-bwd-vol {label} {padding} g {str(dtype)[6:]}: rel err {err:.3g} "
                    f"(tol {FP32_TOL:.3g}); run twice, same bits: {same}")
                if not err <= FP32_TOL:
                    fail(f"K1-bwd-vol {label} {padding} {dtype} disagrees with plain")
                if not same:
                    fail(f"K1-bwd-vol {label} {padding} {dtype} is not bit-reproducible")
                del gd, out, again, ref
        run = lambda: fused_sample.grid_sample_3d_bwd_vol(grid, gout, shape, "border")
        ms, events = time_ms(run), event_ms(run)
        plain = time_ms(lambda: fused_sample.grid_sample_3d_bwd_vol_plain(
            grid, gout, shape, "border"), iters=3)
        lib = time_ms(lib_bwd_vol(shape, grid, gout, "border"))
        out = run()
        ref = fused_sample.grid_sample_3d_bwd_vol_plain(grid, gout, shape, "border")
        nbytes = (gout.numel() + grid.numel() + out.numel()) * 4
        # 8 corners: a multiply and an add each per sample and channel,
        # plus ~40 operations per sample for the taps.
        b, by = bound_ms(nbytes, 16.0 * gout.numel() + 40.0 * grid[..., 0].numel())
        alts = bwd_vol_alternatives(fused_sample, grid, gout, shape, "border")
        say(f"  K1-bwd-vol {label}, border float32: {ms:.4f} ms (back to back by CUDA "
            f"events {events:.4f} ms), bound {b:.4f} ms ({by}), plain {plain:.3f} ms, aten "
            f"backward + group sum {lib:.4f} ms (device time); other plans (channels a "
            f"block, slices, blocks): ms {json.dumps(alts)}")
        rows[label] = dict(ms=ms, event_ms=events, bound_ms=b, plain_ms=plain,
                           library_ms=lib, plan=plan._asdict(), other_plans=alts,
                           clipped=clipped_share(grid, shape[2:]))
        if label == "decode":
            records["K1bv"] = dict(
                name="fused_sample_bwd_vol", route="cuda",
                source="latentfusion_tpu_torch/csrc/fused_sample.cu",
                replaces="latentfusion_tpu/ops/pallas_fused_sample.py:372",
                max_abs_err=float((out - ref).abs().max()), ms=ms, plain_ms=plain,
                bound_ms=b, bound_by=by, library_ms=lib)
        del gout, out, ref
    del grids, grid
    torch.cuda.empty_cache()
    return records, rows


def phase_k3_shape(fused_sample, seed):
    """K1's three kernels at a shape of K3 (ops/pallas_volume.py: an
    unshared volume over 17^3): vol (4, 64, 32^3), grid (4, 32^3), fp32,
    against their plain versions, timed beside F.grid_sample and aten's
    backward; K1-bwd-grid through its staged kernel, twice for the same
    bits. Then the kernels that serve volumes whose channel does not fit in
    shared memory, at vol (1, 8, 48^3): the forward's gather kernel and
    K1-bwd-grid's per-sample kernel."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    vol = torch.randn(4, 64, 32, 32, 32, generator=g, device=dev)
    grid = torch.rand(4, 32, 32, 32, 3, generator=g, device=dev) * 2.4 - 1.2
    gout = torch.randn(4, 64, 32, 32, 32, generator=g, device=dev)
    pad = "border"
    out = {"K1-fwd": time_k1(fused_sample, vol, grid, pad, "K3's shape vol (4, 64, 32^3), grid (4, 32^3)")}
    runs = {
        "K1-bwd-grid": (lambda: fused_sample.grid_sample_3d_bwd_grid(vol, grid, gout, pad),
                        lambda: fused_sample.grid_sample_3d_bwd_grid_plain(vol, grid, gout, pad),
                        lambda: torch.ops.aten.grid_sampler_3d_backward(
                            gout, vol, grid, 0, 1, False, [False, True]),
                        (vol.numel() + 2 * grid.numel() + gout.numel()) * 4),
        "K1-bwd-vol": (lambda: fused_sample.grid_sample_3d_bwd_vol(grid, gout, vol.shape, pad),
                       lambda: fused_sample.grid_sample_3d_bwd_vol_plain(
                           grid, gout, vol.shape, pad),
                       lambda: torch.ops.aten.grid_sampler_3d_backward(
                           gout, vol, grid, 0, 1, False, [True, False]),
                       (vol.numel() + grid.numel() + gout.numel()) * 4),
    }
    for name, (kernel, plain, lib, nbytes) in runs.items():
        err = rel_err(kernel(), plain())
        torch.cuda.synchronize()
        b, by = bound_ms(nbytes, 16.0 * gout.numel())
        out[name] = dict(ms=time_ms(kernel), plain_ms=time_ms(plain, iters=3),
                         library_ms=time_ms(lib), bound_ms=b, bound_by=by, rel_err=err)
        say(f"  {name} at K3's shape vol (4, 64, 32^3), grid (4, 32^3), {pad}, float32: "
            f"rel err {err:.3g} (tol {FP32_TOL:.3g}), {json.dumps(out[name])}")
    for name, row in out.items():
        if not row["rel_err"] <= FP32_TOL:
            fail(f"{name} at K3's shape disagrees with plain")
    bwd_grid, again = bwd_grid_twice(fused_sample, vol, grid, gout, pad, "staged")
    plan = fused_sample.bwd_grid_plan(vol.shape, grid.shape[0], grid[0, ..., 0].numel())
    alt, alt_ms = bwd_grid_two_waves(fused_sample, vol, grid, gout, pad)
    say(f"  K1-bwd-grid at K3's shape, staged kernel {plan}: run twice, same bits: "
        f"{bool(torch.equal(bwd_grid, again))}; with {alt} {alt_ms:.4f} ms")
    if not torch.equal(bwd_grid, again):
        fail("K1-bwd-grid at K3's shape is not bit-reproducible")
    bwd_vol, again = bwd_vol_twice(fused_sample, grid, gout, vol.shape, pad)
    plan = fused_sample.bwd_vol_plan(vol.shape, grid.shape[0], grid[0, ..., 0].numel())
    say(f"  K1-bwd-vol at K3's shape, tiled kernel {plan}: run twice, same bits: "
        f"{bool(torch.equal(bwd_vol, again))}; other plans (channels a block, slices, "
        f"blocks): ms {json.dumps(bwd_vol_alternatives(fused_sample, grid, gout, vol.shape, pad))}")
    if not torch.equal(bwd_vol, again):
        fail("K1-bwd-vol at K3's shape is not bit-reproducible")
    del vol, grid, gout, bwd_grid, bwd_vol, again

    vol32 = torch.randn(1, 8, 48, 48, 48, generator=g, device=dev)
    grid = torch.rand(2, 32, 32, 32, 3, generator=g, device=dev) * 2.4 - 1.2
    for padding in ("border", "zeros"):
        for dtype in (torch.float32, torch.bfloat16):
            vol = vol32.to(dtype)
            before = fused_sample.GATHER_LAUNCHES
            res = fused_sample.grid_sample_3d_fused(vol, grid, padding, dtype)
            ref = fused_sample.grid_sample_3d_plain(vol, grid, padding, dtype)
            torch.cuda.synchronize()
            err = rel_err(res, ref)
            tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
            say(f"  K1-fwd vol (1, 8, 48^3), grid (2, 32^3) {padding} {str(dtype)[6:]}, "
                f"{fused_sample.fwd_kernel(vol.shape)} kernel: rel err {err:.3g} (tol {tol:.3g})")
            if fused_sample.GATHER_LAUNCHES != before + 1:
                fail("K1-fwd at 48^3 did not go through the gather kernel")
            if not err <= tol:
                fail(f"K1-fwd gather {padding} {dtype} disagrees with plain")
    out["K1-fwd gather"] = time_k1(fused_sample, vol32, grid, "border",
                                   "vol (1, 8, 48^3), grid (2, 32^3)")
    gout = torch.randn(2, 8, 32, 32, 32, generator=g, device=dev)
    for padding in ("border", "zeros"):
        res, again = bwd_grid_twice(fused_sample, vol32, grid, gout, padding, "per_sample")
        err = rel_err(res, fused_sample.grid_sample_3d_bwd_grid_plain(vol32, grid, gout, padding))
        same = bool(torch.equal(res, again))
        say(f"  K1-bwd-grid vol (1, 8, 48^3), grid (2, 32^3) {padding} float32, per-sample "
            f"kernel: rel err {err:.3g} (tol {FP32_TOL:.3g}); run twice, same bits: {same}")
        if not err <= FP32_TOL:
            fail(f"K1-bwd-grid per-sample {padding} disagrees with plain")
        if not same:
            fail(f"K1-bwd-grid per-sample {padding} is not bit-reproducible")
        # The atomic d/dvol kernel: its bits change from run to run.
        res, _ = bwd_vol_twice(fused_sample, grid, gout, vol32.shape, padding, "atomic")
        err = rel_err(res, fused_sample.grid_sample_3d_bwd_vol_plain(
            grid, gout, vol32.shape, padding))
        say(f"  K1-bwd-vol vol (1, 8, 48^3), grid (2, 32^3) {padding} float32, atomic "
            f"kernel: rel err {err:.3g} (tol {FP32_TOL:.3g})")
        if not err <= FP32_TOL:
            fail(f"K1-bwd-vol atomic {padding} disagrees with plain")
    del vol32, vol, grid, gout, res, again, ref
    torch.cuda.empty_cache()
    return out


def k1_at(fused_sample, op, label, vol, grid, gout=None, padding="border"):
    """One K1 kernel ("fwd", "bwd_grid" or "bwd_vol") at one shape, fp32:
    against its plain version, run twice for the same bits through the
    kernel its counter names (staged or tiled: every volume here is 16^3 or 8^3),
    then kernel, plain and library device ms and the bound. Returns the
    row."""
    nv, n, c = vol.shape[0], grid.shape[0], vol.shape[1]
    samples = grid[..., 0].numel()
    pad = {"zeros": 0, "border": 1}[padding]
    vol_n = vol.repeat_interleave(n // nv, dim=0) if op != "bwd_vol" else None
    if op == "fwd":
        counter, plan = "LAUNCHES", fused_sample.fwd_kernel(vol.shape)
        run = lambda: fused_sample.grid_sample_3d_fused(vol, grid, padding)
        plain = lambda: fused_sample.grid_sample_3d_plain(vol, grid, padding)
        lib = lambda: torch.nn.functional.grid_sample(
            vol_n, grid, mode="bilinear", padding_mode=padding, align_corners=False)
        nbytes = (vol.numel() + grid.numel() + n * c * grid[0, ..., 0].numel()) * 4
        flops = 16.0 * c * samples + 40.0 * samples
    elif op == "bwd_grid":
        counter = "BWD_GRID_LAUNCHES"
        plan = fused_sample.bwd_grid_plan(vol.shape, n, grid[0, ..., 0].numel())
        run = lambda: fused_sample.grid_sample_3d_bwd_grid(vol, grid, gout, padding)
        plain = lambda: fused_sample.grid_sample_3d_bwd_grid_plain(vol, grid, gout, padding)
        lib = lambda: torch.ops.aten.grid_sampler_3d_backward(
            gout, vol_n, grid, 0, pad, False, [False, True])
        nbytes = (gout.numel() + vol.numel() + 2 * grid.numel()) * 4
        flops = 2.0 * 27 * gout.numel() + 60.0 * samples
    else:
        counter = "BWD_VOL_LAUNCHES"
        plan = fused_sample.bwd_vol_plan(vol.shape, n, grid[0, ..., 0].numel())
        run = lambda: fused_sample.grid_sample_3d_bwd_vol(grid, gout, vol.shape, padding)
        plain = lambda: fused_sample.grid_sample_3d_bwd_vol_plain(grid, gout, vol.shape,
                                                                  padding)
        lib = lib_bwd_vol(vol.shape, grid, gout, padding)
        nbytes = (gout.numel() + grid.numel() + vol.numel()) * 4
        flops = 16.0 * gout.numel() + 40.0 * samples
    before = getattr(fused_sample, counter)
    out, again = run(), run()
    served = getattr(fused_sample, counter) == before + 2
    ref = plain()
    torch.cuda.synchronize()
    err, same = rel_err(out, ref), bool(torch.equal(out, again))
    b, by = bound_ms(nbytes, flops)
    row = dict(op=op, path=label, vol=list(vol.shape), grids=n, padding=padding,
               kernel=str(plan), max_abs_err=float((out - ref).abs().max()), rel_err=err,
               same_bits=same, ms=time_ms(run), plain_ms=time_ms(plain, iters=3),
               library_ms=time_ms(lib), bound_ms=b, bound_by=by)
    say(f"  K1-{op} {label}: vol {tuple(vol.shape)}, {n} grids of "
        f"{'x'.join(map(str, grid.shape[1:4]))}, {padding} float32, "
        f"{plan}: rel err {err:.3g} (tol {FP32_TOL:.3g}); run twice, same bits: {same}; "
        f"{row['ms']:.4f} ms, bound {b:.4f} ms ({by}), plain {row['plain_ms']:.3f} ms, "
        f"library {row['library_ms']:.4f} ms (device time)")
    if not served:
        fail(f"K1-{op} {label} did not go through its shared-memory kernel")
    if not err <= FP32_TOL:
        fail(f"K1-{op} {label} disagrees with plain")
    if not same:
        fail(f"K1-{op} {label} is not bit-reproducible")
    return row


def phase_new_shapes(fused_sample, seed):
    """K1's three kernels at the shapes of the multi-object and latent paths
    (flagship, 256 channels): two objects' CEM render (2 x 128 hypotheses)
    and refinement step (2 x 8); a latent refinement step of 16 hypotheses:
    the render (one latent), the target's autoencode decode (16 latents, one
    grid each) and the Sculptor's camera->object sampling (16 camera
    volumes of 128 and 256 channels); and the unseen-object rig's (phase 9;
    8^3 latents, the demo family's 128 channels and the mid family's 256):
    the Sculptor's camera->object sampling of 16 views (64, 128 and 256
    channels), four objects' CEM render (4 x 128 hypotheses) and refinement
    step (4 x 16). Returns the rows and the set of (op, volume shape, grids)
    held, which phases 5 and 9 check their recorded K1 calls against."""
    from latentfusion_tpu_torch import transforms, zoo
    from latentfusion_tpu_torch.camera import Camera

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    size = zoo.FLAGSHIP_INPUT_SIZE
    obs = [reference_views(i, dev) for i in (0, 1)]
    cams = [hypothesis_cameras(o, size, CAMERA_DIST, g) for o in obs]
    latent_cams = cams[0][:16]
    grids = {"render2": transforms.object_to_camera_grid(Camera.cat(cams), 16),
             "refine2": transforms.object_to_camera_grid(
                 Camera.cat([c[:N_REFINE] for c in cams]), 16),
             "latent": transforms.object_to_camera_grid(latent_cams, 16),
             "sculptor": transforms.camera_to_object_grid(latent_cams, 16)}
    # The unseen-object rig at 128^2: 16 reference views; four objects'
    # hypotheses (each object's 128 hypotheses of o0's or o1's views).
    unseen = [hypothesis_cameras(obs[i % 2], UNSEEN_INPUT_SIZE, CAMERA_DIST, g)
              for i in range(UNSEEN_OBJECTS)]
    grids.update({
        "unseen_build": transforms.camera_to_object_grid(
            obs[0].camera.zoom(None, UNSEEN_INPUT_SIZE, CAMERA_DIST), 8),
        "unseen_render": transforms.object_to_camera_grid(Camera.cat(unseen), 8),
        "unseen_refine": transforms.object_to_camera_grid(
            Camera.cat([c[:UNSEEN_BUDGET["refine_samples"]] for c in unseen]), 8)})
    del cams, obs, unseen
    cases = (("fwd", "two-object CEM render", 2, 256, "render2"),
             ("fwd", "two-object refinement", 2, 256, "refine2"),
             ("bwd_grid", "two-object refinement", 2, 256, "refine2"),
             ("fwd", "latent render", 1, 256, "latent"),
             ("bwd_grid", "latent render", 1, 256, "latent"),
             ("fwd", "latent autoencode decode", 16, 256, "latent"),
             ("bwd_grid", "latent autoencode decode", 16, 256, "latent"),
             ("bwd_vol", "latent autoencode decode", 16, 256, "latent"),
             ("fwd", "latent Sculptor camera->object", 16, 128, "sculptor"),
             ("fwd", "latent Sculptor camera->object", 16, 256, "sculptor"),
             ("bwd_grid", "latent Sculptor camera->object", 16, 256, "sculptor"))
    for c, family in ((128, "demo"), (256, "mid")):
        cases += (("fwd", f"unseen {family} Sculptor camera->object", 16, c, "unseen_build"),
                  ("fwd", f"unseen {family} Sculptor camera->object", 16, c // 2, "unseen_build"),
                  ("fwd", f"unseen {family} four-object CEM render", 4, c, "unseen_render"),
                  ("fwd", f"unseen {family} four-object refinement", 4, c, "unseen_refine"),
                  ("bwd_grid", f"unseen {family} four-object refinement", 4, c,
                   "unseen_refine"))
    rows = []
    for op, label, nv, c, key in cases:
        grid = grids[key]
        size = 8 if key.startswith("unseen") else 16
        vol = torch.randn(nv, c, size, size, size, generator=g, device=dev)
        gout = (None if op == "fwd" else
                torch.randn(grid.shape[0], c, *grid.shape[1:4], generator=g, device=dev))
        rows.append(k1_at(fused_sample, op, label, vol, grid, gout))
        if (op, key) == ("bwd_grid", "refine2"):
            alt, alt_ms = bwd_grid_two_waves(fused_sample, vol, grid, gout, "border")
            rows[-1]["two_waves"] = [str(alt), alt_ms]
            say(f"  K1-bwd_grid two-object refinement with twice its plan's groups "
                f"{alt}: {alt_ms:.4f} ms")
        if op == "bwd_vol":
            rows[-1]["other_plans"] = bwd_vol_alternatives(fused_sample, grid, gout,
                                                           vol.shape, "border")
            say(f"  K1-bwd_vol {label}, other plans (channels a block, slices, blocks): "
                f"ms {json.dumps(rows[-1]['other_plans'])}")
        del vol, gout
    del grids, grid
    torch.cuda.empty_cache()
    return rows, {(r["op"], tuple(r["vol"]), r["grids"]) for r in rows}


def reference_views(index: int, device):
    """Reference object o<index> (held-out object ``index`` of the lobe pool
    of seed HELDOUT_POOL_SEED) at the unseen-object rig's 16 reference
    cameras of 480x640, rendered by the lobe oracle: an Observation of
    shaded color, depth and mask."""
    from latentfusion_tpu_torch import testing, unseen_eval

    pool, _ = testing.sample_lobe_shapes(HELDOUT_POOL_SEED, index + 1, device=device)
    ref_cams, _ = unseen_eval.load_cameras(device=device)
    return testing.lobe_observation(testing.index_lobe_shape(pool, index), ref_cams)


def check_reference_views(device) -> None:
    """Render o0 and o1 and hold each view's sums of depth and color
    (relative) and its mask's count (of the view's pixels) within SUMS_TOL
    of the JAX package's fp32 render's (``unseen_cameras.json``). Prints,
    ungated, how far they are from the sums of the JAX package's renders
    made on the TPU (``refs_o*.npz``), whose reduced-precision products move
    the grazing rays."""
    from latentfusion_tpu_torch import unseen_eval

    sums = json.loads(unseen_eval.CAMERAS.read_text())["sums"]
    worst = {}
    for index in (0, 1):
        obs = reference_views(index, device)
        pixels = obs.camera.width * obs.camera.height
        got = {k: getattr(obs, k).double().flatten(1).sum(1).cpu().numpy()
               for k in ("depth", "mask", "color")}
        for source in ("jax_float32", "frames"):
            for k, v in got.items():
                ref = np.asarray(sums[f"o{index}"][source][k])
                err = np.abs(v - ref) / (pixels if k == "mask" else np.abs(ref))
                key = (source, k)
                worst[key] = max(worst.get(key, 0.0), float(err.max()))
        del obs
    say(f"  reference views o0 and o1 (16 x 480x640 each) rendered; largest difference of "
        f"a view's sums (depth and color relative, mask count over the view's pixels) from "
        f"the JAX fp32 render's {json.dumps({k: v for (s, k), v in worst.items() if s == 'jax_float32'})} "
        f"(tol {SUMS_TOL}), from the JAX renders made on the TPU, not gated, "
        f"{json.dumps({k: v for (s, k), v in worst.items() if s == 'frames'})}")
    if not max(v for (s, _), v in worst.items() if s == "jax_float32") <= SUMS_TOL:
        fail("the reference views' renders disagree with the JAX package's")


def hypothesis_cameras(obs, input_size, camera_dist, generator):
    """128 cameras: uniform random rotations, the reference views' mean
    translation, the first view's intrinsic, zoomed like the references."""
    from latentfusion_tpu_torch import three
    from latentfusion_tpu_torch.camera import Camera
    from latentfusion_tpu_torch.three import quaternion

    quats = quaternion.random(N_HYPOTHESES, generator)
    trans = obs.camera.translation.mean(0, keepdim=True).expand(N_HYPOTHESES, 3)
    cam = Camera(obs.camera.intrinsic[:1].expand(N_HYPOTHESES, 3, 4),
                 three.to_extrinsic_matrix(trans, quats), z_span=obs.camera.z_span,
                 width=obs.camera.width, height=obs.camera.height,
                 device=obs.color.device)
    return cam.zoom(None, input_size, camera_dist)


def profile_render(model, z, cams) -> None:
    """Print the device time of one render by kernel (torch.profiler)."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        model.render_latent_object(z, cams, return_latent=False)
        torch.cuda.synchronize()
    say(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))


def drive_slice(label, model, objects, kernels, seed, profile):
    """Build + render each object through the kernels (counted), then time
    it and hold it against the same path on the plain versions."""
    from latentfusion_tpu_torch import modules, transforms

    counts = {}
    for name, index in objects:
        obs = reference_views(index, model.device)
        cams = hypothesis_cameras(obs, model.input_size, model.camera_dist,
                                  torch.Generator(device=model.device).manual_seed(seed))
        reset_counters(kernels)
        z = model.build_latent_object(obs)
        y, _ = model.render_latent_object(z, cams, return_latent=False)
        torch.cuda.synchronize()
        counts[name] = read_counters(kernels)
        if not (counts[name]["K1"] > 0 and counts[name]["K2"] > 0):
            fail(f"{label} {name}: a kernel was not launched: {counts[name]}")
        size = model.photographer.out_size
        for key in ("depth", "mask"):
            if tuple(y[key].shape) != (1, N_HYPOTHESES, 1, size, size):
                fail(f"{label} {name}: {key} shape {tuple(y[key].shape)}")
            if not bool(torch.isfinite(y[key]).all()):
                fail(f"{label} {name}: {key} is not finite")
        coverage = float((y["mask"] > 0.5).float().mean())

        t0 = time.perf_counter()
        model.build_latent_object(obs)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        render_ms = event_ms(lambda: model.render_latent_object(
            z, cams, return_latent=False), iters=3, warmup=1)
        if profile and name == objects[0][0]:
            profile_render(model, z, cams)

        with transforms.volume_sample_backend("torch"), \
                modules.lrelu_pnorm_backend("torch"):
            z_ref = model.build_latent_object(obs)
            y_ref, _ = model.render_latent_object(z_ref, cams, return_latent=False)
        # The heads' logits are compared: the masked depth thresholds the
        # mask at 0.5, so a pixel whose mask sits within rounding of 0.5 may
        # flip; the share of such pixels is reported beside.
        errs = {key: rel_err(y[key], y_ref[key])
                for key in ("depth_logits", "mask_logits")}
        errs["latent"] = rel_err(z, z_ref)
        flips = float(((y["mask"] > 0.5) != (y_ref["mask"] > 0.5)).float().mean())
        say(f"  {label} {name}: latent {tuple(z.shape)}, launches {counts[name]}, "
            f"mask coverage {coverage:.4f}, build {build_s:.3f} s, render of "
            f"{N_HYPOTHESES} {render_ms:.1f} ms = "
            f"{N_HYPOTHESES / render_ms * 1e3:.1f} hypotheses/s, kernels vs "
            f"plain rel err {json.dumps(errs)} (tol {NET_TOL}), mask flips "
            f"{flips:.2e}")
        if not max(errs.values()) <= NET_TOL:
            fail(f"{label} {name}: kernel path disagrees with the plain path")
        del z, y, z_ref, y_ref, obs
        torch.cuda.empty_cache()
    return counts


def reset_counters(kernels) -> None:
    fused_sample, lrelu_pnorm = kernels
    fused_sample.LAUNCHES = fused_sample.BWD_GRID_LAUNCHES = 0
    fused_sample.BWD_VOL_LAUNCHES = 0
    lrelu_pnorm.LAUNCHES = lrelu_pnorm.BWD_LAUNCHES = 0


def read_counters(kernels) -> dict:
    fused_sample, lrelu_pnorm = kernels
    return {"K1": fused_sample.LAUNCHES, "K1b": fused_sample.BWD_GRID_LAUNCHES,
            "K1bv": fused_sample.BWD_VOL_LAUNCHES,
            "K2": lrelu_pnorm.LAUNCHES, "K2b": lrelu_pnorm.BWD_LAUNCHES}


def views(obs, start: int, stop: int):
    """Views start..stop-1 of an Observation as their own Observation."""
    from latentfusion_tpu_torch.observation import Observation

    return Observation(obs.color[start:stop], obs.depth[start:stop],
                       obs.mask[start:stop], obs.camera[start:stop])


def profile_step(fn):
    """Print the device time of one call of ``fn`` by kernel (torch.profiler);
    returns the profiler's averages by name and its events."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    say(averages.table(sort_by="self_device_time_total", row_limit=15))
    return averages, prof.events()


def range_device_ms(events, name: str) -> float:
    """Device ms of the work of the profiler ranges called ``name``: the ops
    inside them, and the backward of those ops (autograd's
    evaluate_function events with the sequence number and forward thread
    of an op inside a range)."""
    def walk(event):
        yield event
        for child in event.cpu_children:
            yield from walk(child)

    ranges = [e for e in events if e.name == name]
    forward = {(e.sequence_nr, e.thread) for r in ranges for e in walk(r) if e.sequence_nr >= 0}
    backward = [e for e in events if e.name.startswith("autograd::engine::evaluate_function")
                and (e.sequence_nr, e.fwd_thread) in forward]
    return sum(e.device_time_total for e in ranges + backward) / 1e3


def kernel_device_ms(averages, name_part: str):
    """Device ms and calls of the kernels whose name holds ``name_part``."""
    rows = [e for e in averages if name_part in e.key]
    return sum(e.self_device_time_total for e in rows) / 1e3, sum(e.count for e in rows)


def record_step(step_fn, keep_resizes: bool = True):
    """One call of ``step_fn`` with K2-fwd's and K2-bwd's input shapes
    counted, {shape: (forward calls, backward calls)}, and the inputs of
    the linear resizes (decoder blocks, U-Net heads, the Photographer's
    last resize) kept unless ``keep_resizes`` is False."""
    from latentfusion_tpu_torch.modules import blocks, unet
    from latentfusion_tpu_torch.ops import interpolate as resize_mod, lrelu_pnorm
    from latentfusion_tpu_torch.recon import models

    k2_shapes, resizes = {}, []
    fwd, bwd = lrelu_pnorm.lrelu_pixel_norm_fwd, lrelu_pnorm.lrelu_pixel_norm_bwd
    resize = resize_mod.interpolate

    def count(x, which):
        calls = k2_shapes.get(tuple(x.shape), (0, 0))
        k2_shapes[tuple(x.shape)] = tuple(n + (i == which) for i, n in enumerate(calls))

    def spy_fwd(x, slope, eps):
        count(x, 0)
        return fwd(x, slope, eps)

    def spy_bwd(x, inv, g, slope):
        count(x, 1)
        return bwd(x, inv, g, slope)

    def spy_resize(x, scale_factor=None, size=None, mode="nearest"):
        if mode != "nearest" and keep_resizes:
            resizes.append((x.detach().clone(), scale_factor, mode))
        return resize(x, scale_factor=scale_factor, size=size, mode=mode)

    with mock.patch.object(lrelu_pnorm, "lrelu_pixel_norm_fwd", spy_fwd), \
            mock.patch.object(lrelu_pnorm, "lrelu_pixel_norm_bwd", spy_bwd), \
            mock.patch.object(blocks, "interpolate", spy_resize), \
            mock.patch.object(unet, "interpolate", spy_resize), \
            mock.patch.object(models, "interpolate", spy_resize):
        step_fn()
    torch.cuda.synchronize()
    return k2_shapes, resizes


def resize_backward_repeats(resizes, seed) -> bool:
    """The backward of each recorded linear resize, run twice on one
    upstream gradient: True if every pair has the same bits. Also prints
    the same check for F.interpolate, whose backward adds with atomics."""
    from latentfusion_tpu_torch.ops.interpolate import interpolate

    g = torch.Generator(device=resizes[0][0].device).manual_seed(seed)
    linear = {3: "linear", 4: "bilinear", 5: "trilinear"}
    same, same_lib = True, True
    for x, scale, mode in resizes:
        gy = None

        def grad(fn):
            nonlocal gy
            xx = x.clone().requires_grad_()
            y = fn(xx)
            if gy is None:
                gy = torch.randn(y.shape, generator=g, device=y.device)
            return torch.autograd.grad(y, xx, gy)[0]

        def lib(xx):
            size = [int(np.floor(d * scale)) for d in xx.shape[2:]]
            return torch.nn.functional.interpolate(xx, size=size, mode=linear[xx.dim()],
                                                   align_corners=False)

        port = lambda xx: interpolate(xx, scale_factor=scale, mode=mode)
        pair = [grad(port) for _ in range(2)]
        lib_pair = [grad(lib) for _ in range(2)]
        torch.cuda.synchronize()
        same &= bool(torch.equal(*pair))
        same_lib &= bool(torch.equal(*lib_pair))
        say(f"    resize {tuple(x.shape)} x{scale} {mode}: backward run twice, same bits "
            f"{bool(torch.equal(*pair))} (F.interpolate: {bool(torch.equal(*lib_pair))}); "
            f"port vs F.interpolate rel err {rel_err(pair[0], lib_pair[0]):.3g}")
    say(f"  the decoder's resizes, backward twice: same bits {same} "
        f"(F.interpolate: {same_lib})")
    return same


def step_repeats(step_fn) -> bool:
    """Whether two calls of ``step_fn() -> (loss, {name: gradient})`` give
    the same bits."""
    (l1, g1), (l2, g2) = step_fn(), step_fn()
    return bool(torch.equal(l1, l2)) and all(torch.equal(g1[k], g2[k]) for k in g1)


def parting_modules(step_fn, network) -> list:
    """The leaf modules of ``network`` whose backward gave other bits in two
    calls of ``step_fn`` from the same incoming gradient: (name, class,
    input shapes), in the order the backward reached them."""
    records = {}

    def hook(name):
        def record(module, grad_input, grad_output):
            records.setdefault(name, []).append(
                ([None if t is None else t.clone() for t in grad_input],
                 [None if t is None else t.clone() for t in grad_output]))
        return record

    leaves = [(n, m) for n, m in network.named_modules() if not list(m.children())]
    handles = [m.register_full_backward_hook(hook(n)) for n, m in leaves]
    try:
        runs = []
        for _ in range(2):
            records = {}
            step_fn()
            torch.cuda.synchronize()
            runs.append(records)
    finally:
        for h in handles:
            h.remove()

    def same(a, b):
        return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))

    modules = dict(leaves)
    parting = []
    for name, calls in runs[0].items():
        for (gin1, gout1), (gin2, gout2) in zip(calls, runs[1][name]):
            if same(gout1, gout2) and not same(gin1, gin2):
                parting.append((name, type(modules[name]).__name__,
                                [None if t is None else list(t.shape) for t in gin1]))
    return parting


def nondeterministic_ops(step_fn) -> list:
    """The ops that torch's deterministic-algorithms check flags in one call
    of ``step_fn`` (warn_only: a diagnostic, switched off again after)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step_fn()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).split("\n")[0][:160] for w in caught})


def phase_pose_flagship(model, kernels, seed, k2_tables):
    """CEM then refinement for view 15 of o0 from the latent of views
    0-14; then the refinement again from the same coarse cameras, which must
    end on the same bits, and a step's cost of the deterministic cuDNN
    selection that makes it so. ``k2_tables`` holds phase 2's K2-fwd and
    K2-bwd tables of a refinement step ("fwd", "bwd"). Returns the launch
    counts of the pose path by kernel."""
    from latentfusion_tpu_torch.pose import estimation, metrics

    obs = reference_views(0, model.device)
    target = views(obs, 15, 16)
    z = model.build_latent_object(views(obs, 0, 15))
    del obs
    coarse = estimation.load_from_config(CONFIGS / "cross_entropy_quick.toml", model)
    fine = estimation.load_from_config(CONFIGS / "adam_quick.toml", model,
                                       track_stats=True)

    def estimate():
        g = torch.Generator(device=model.device).manual_seed(seed)
        t0 = time.perf_counter()
        reset_counters(kernels)
        cams = coarse.estimate(z, target, generator=g)
        torch.cuda.synchronize()
        cem_s = time.perf_counter() - t0
        cem_counts = read_counters(kernels)
        reset_counters(kernels)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        best, stats = fine.estimate(z, target, camera=cams[:fine.num_samples])
        end.record()
        torch.cuda.synchronize()
        refine_ms = start.elapsed_time(end)
        whole_s = time.perf_counter() - t0
        return cams, best, stats, cem_s, cem_counts, read_counters(kernels), refine_ms, whole_s

    # The first estimate is counted and checked; the second is timed.
    cams, best, stats, _, cem_counts, refine_counts, _, _ = estimate()
    counts = {k: cem_counts[k] + refine_counts[k] for k in cem_counts}
    if not all(counts[k] > 0 for k in ("K1", "K1b", "K2", "K2b")):
        fail(f"pose: a kernel was not launched on the pose path: {counts}")
    steps = stats["num_steps"]
    history = stats["loss_history"][:steps]
    if not (bool(torch.isfinite(history).all()) and len(best) == fine.ranking_size
            and bool(torch.isfinite(best.translation).all())):
        fail("pose: the refinement's losses or poses are not finite")
    cams2, _, stats2, cem_s, _, _, refine_ms, whole_s = estimate()
    steps2 = stats2["num_steps"]
    m_coarse = metrics.camera_metrics(target.camera, cams[0], None, 1.0)
    m_refined = metrics.camera_metrics(target.camera, best[0], None, 1.0)
    say(f"  pose flagship o0 view 15: CEM {coarse.num_iters} iterations of "
        f"{coarse.num_samples} in {cem_s:.3f} s; refinement {steps2} steps "
        f"(first run {steps}) at {refine_ms / steps2:.2f} ms per step "
        f"({N_REFINE} hypotheses); whole estimate {whole_s:.3f} s; loss "
        f"{float(history[0]):.5f} -> {float(history.min()):.5f}; seeded "
        f"weights, so the pose is not expected to be right: coarse "
        f"{json.dumps(m_coarse)}, refined {json.dumps(m_refined)}")
    say(f"  launches, CEM {json.dumps(cem_counts)} (per iteration "
        f"{json.dumps({k: v / coarse.num_iters for k, v in cem_counts.items()})}), "
        f"refinement {json.dumps(refine_counts)} (per step "
        f"{json.dumps({k: v / steps for k, v in refine_counts.items()})})")

    # Run to run: the refinement again from the first run's coarse cameras.
    again, stats3 = fine.estimate(z, target, camera=cams[:fine.num_samples])
    torch.cuda.synchronize()
    same_cem = all(torch.equal(a, b) for a, b in ((cams.extrinsic, cams2.extrinsic),
                                                  (cams.viewport, cams2.viewport)))
    same_pose = (torch.equal(best.extrinsic, again.extrinsic)
                 and torch.equal(best.viewport, again.viewport))
    same_loss = torch.equal(stats["loss_history"][:steps],
                            stats3["loss_history"][:stats3["num_steps"]])
    say(f"  run to run: CEM cameras of the two estimates the same bits {same_cem}; "
        f"refinement twice from the same coarse cameras: final poses the same bits "
        f"{same_pose}, loss histories the same bits {same_loss} ({steps} and "
        f"{stats3['num_steps']} steps; the timed estimate {steps2})")

    zcams = cams[:N_REFINE].zoom(None, model.input_size, model.camera_dist)
    step = lambda: fine.loss_and_grads(z, target, zcams)
    if not (same_pose and same_loss):
        flagged = nondeterministic_ops(step)
        say(f"  ops flagged by torch.use_deterministic_algorithms(True, warn_only=True) "
            f"in one refinement step: {json.dumps(flagged)}")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            repeats_det = step_repeats(step)
        finally:
            torch.use_deterministic_algorithms(False)
        say(f"  one refinement step twice: loss and camera gradient the same bits "
            f"{step_repeats(step)}; with torch.use_deterministic_algorithms(True) "
            f"{repeats_det}")
        say(f"  modules whose backward parts the bits from the same incoming "
            f"gradient: {json.dumps(parting_modules(step, fine.model.photographer))}")
        fail("pose: two refinements from the same coarse cameras ended on other bits")
    deterministic_cost(step)

    k2_shapes, resizes = record_step(step)
    expected = {shape: n for shape, n in REFINE_K2_CALLS}
    say(f"  K2 calls in one refinement step by shape (forward, backward): "
        f"{json.dumps({str(k): v for k, v in k2_shapes.items()})}")
    if k2_shapes != {shape: (n, n) for shape, n in expected.items()}:
        fail(f"pose: K2's calls in a refinement step are not phase 2's table: {k2_shapes}")
    if not resize_backward_repeats(resizes, seed):
        fail("pose: a decoder resize's backward changed bits run to run")
    del resizes

    gradient_check("flagship refinement step", step, fine.model.photographer, kernels)
    say("  one refinement step (8 hypotheses, forward and backward), device time by kernel:")
    averages, _ = profile_step(step)
    for name, kernel, table in (("K2-fwd", "lrelu_pnorm_fwd_kernel", k2_tables["fwd"]),
                                ("K2-bwd", "lrelu_pnorm_bwd_kernel", k2_tables["bwd"])):
        ms, calls = kernel_device_ms(averages, kernel)
        say(f"  {name} in the step's profile: {ms:.4f} ms in {calls} calls; phase 2's "
            f"launch-weighted sum {table['per_step']['ms']:.4f} ms (bound "
            f"{table['per_step']['bound_ms']:.4f} ms)")
    ms, calls = kernel_device_ms(averages, "fused_sample_bwd_grid")
    say(f"  K1-bwd-grid in the step's profile (staged kernel and the groups' sum): "
        f"{ms:.4f} ms in {calls} launches")
    torch.cuda.empty_cache()
    return counts


def record_k1(fused_sample, step_fn) -> dict:
    """One call of ``step_fn`` with K1's calls counted by (op, volume
    shape, grids): {key: calls}."""
    calls = {}
    wrapped = {"fwd": "grid_sample_3d_fused", "bwd_grid": "grid_sample_3d_bwd_grid",
               "bwd_vol": "grid_sample_3d_bwd_vol"}

    def spy(op, fn):
        def run(*args):
            vol_shape = tuple(args[0].shape) if op != "bwd_vol" else tuple(args[2])
            grid = args[1] if op != "bwd_vol" else args[0]
            key = (op, vol_shape, grid.shape[0])
            calls[key] = calls.get(key, 0) + 1
            return fn(*args)
        return run

    with contextlib.ExitStack() as stack:
        for op, name in wrapped.items():
            stack.enter_context(mock.patch.object(
                fused_sample, name, spy(op, getattr(fused_sample, name))))
        step_fn()
        torch.cuda.synchronize()
    return calls


def phase_latent_flagship(model, kernels, seed, held):
    """The latent path for view 15 of o0 from the latent of views
    0-14: CEM scored by the latent term (configs/cross_entropy_latent.toml)
    then refinement with it (configs/adam_latent.toml), each launch-counted
    with its peak memory; the refinement again from the same coarse cameras
    must end on the same bits; one step's K1 calls, recorded, must be
    shapes phase 2 held (``held``); one step against the plain versions
    (gradient_check) and its device-time profile. Returns the launch counts
    of the CEM and of the refinement."""
    from torch import nn

    from latentfusion_tpu_torch.pose import estimation

    obs = reference_views(0, model.device)
    target = views(obs, 15, 16)
    z = model.build_latent_object(views(obs, 0, 15))
    del obs
    coarse = estimation.load_from_config(CONFIGS / "cross_entropy_latent.toml", model)
    fine = estimation.load_from_config(CONFIGS / "adam_latent.toml", model,
                                       track_stats=True)
    g = torch.Generator(device=model.device).manual_seed(seed)
    reset_counters(kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cams = coarse.estimate(z, target, generator=g)
    torch.cuda.synchronize()
    cem_s, cem_counts = time.perf_counter() - t0, read_counters(kernels)
    cem_peak = torch.cuda.max_memory_allocated() / 1e9
    reset_counters(kernels)
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    best, stats = fine.estimate(z, target, camera=cams[:fine.num_samples])
    end.record()
    torch.cuda.synchronize()
    refine_ms, refine_counts = start.elapsed_time(end), read_counters(kernels)
    refine_peak = torch.cuda.max_memory_allocated() / 1e9
    counts = {k: cem_counts[k] + refine_counts[k] for k in cem_counts}
    steps = stats["num_steps"]
    history = stats["loss_history"][:steps]
    say(f"  latent CEM {coarse.num_iters} iterations of {coarse.num_samples} in "
        f"{cem_s:.3f} s, peak memory {cem_peak:.2f} GB, launches {json.dumps(cem_counts)}; "
        f"latent refinement {steps} steps of {fine.num_samples} at "
        f"{refine_ms / steps:.2f} ms per step (CUDA events over the refinement), peak "
        f"memory {refine_peak:.2f} GB, launches {json.dumps(refine_counts)} (per step "
        f"{json.dumps({k: v / steps for k, v in refine_counts.items()})}); loss "
        f"{float(history[0]):.5f} -> {float(history.min()):.5f}")
    if not all(counts[k] > 0 for k in ("K1", "K1b", "K1bv", "K2", "K2b")):
        fail(f"latent: a kernel was not launched on the latent path: {counts}")
    if not (bool(torch.isfinite(history).all()) and len(best) == fine.ranking_size
            and bool(torch.isfinite(best.translation).all())):
        fail("latent: the refinement's losses or poses are not finite")

    again, stats2 = fine.estimate(z, target, camera=cams[:fine.num_samples])
    torch.cuda.synchronize()
    same_pose = (torch.equal(best.extrinsic, again.extrinsic)
                 and torch.equal(best.viewport, again.viewport))
    same_loss = torch.equal(history, stats2["loss_history"][:stats2["num_steps"]])
    say(f"  latent refinement twice from the same coarse cameras: final poses the same "
        f"bits {same_pose}, loss histories the same bits {same_loss} ({steps} and "
        f"{stats2['num_steps']} steps)")
    zcams = cams[:fine.num_samples].zoom(None, model.input_size, model.camera_dist)
    step = lambda: fine.loss_and_grads(z, target, zcams)
    networks = nn.ModuleList([model.sculptor, model.photographer])
    if not (same_pose and same_loss):
        say(f"  ops flagged by torch.use_deterministic_algorithms(True, warn_only=True) "
            f"in one latent step: {json.dumps(nondeterministic_ops(step))}")
        say(f"  modules whose backward parts the bits from the same incoming "
            f"gradient: {json.dumps(parting_modules(step, networks))}")
        fail("latent: two refinements from the same coarse cameras ended on other bits")

    calls = record_k1(kernels[0], step)
    say(f"  K1 calls in one latent refinement step (op, volume, grids: calls): "
        f"{json.dumps({str(k): v for k, v in calls.items()})}")
    missing = [k for k in calls if k not in held]
    if missing:
        fail(f"latent: K1 ran at shapes phase 2 did not hold: {missing}")
    k2_shapes, _ = record_step(step)
    say(f"  K2 calls in one latent refinement step by shape (forward, backward): "
        f"{json.dumps({str(k): v for k, v in k2_shapes.items()})}")
    gradient_check("flagship latent refinement step", step, networks, kernels)
    say("  one latent refinement step (16 hypotheses, forward and backward), device "
        "time by kernel:")
    profile_step(step)
    del z, target, cams, best, again
    torch.cuda.empty_cache()
    return cem_counts, refine_counts


def deterministic_cost(step) -> None:
    """Print one refinement step's time as the package runs it (cuDNN's
    deterministic algorithms) and with cuDNN's default selection patched in,
    in turns: CUDA events (10 steps after 2 warm-ups) and device time
    (torch.profiler)."""
    from latentfusion_tpu_torch.pose import estimation

    times = {"deterministic": [], "default": []}
    for label in ("deterministic", "default", "default", "deterministic"):
        with contextlib.ExitStack() as stack:
            if label == "default":
                stack.enter_context(mock.patch.object(
                    estimation, "deterministic_cudnn", contextlib.nullcontext))
            times[label].append((event_ms(step), time_ms(step, iters=3)))
    say("  one refinement step, ms by CUDA events / device ms, two runs each in turns: "
        + "; ".join(f"cuDNN {k} selection " + ", ".join(f"{e:.2f} / {d:.2f}" for e, d in v)
                    for k, v in times.items()))


def per_tensor_rel(grads, ref, names) -> dict:
    """Each tensor's max |a - b| over its reference's max |b|."""
    return {k: float((grads[k] - ref[k]).abs().max()) / max(float(ref[k].abs().max()), 1e-30)
            for k in names}


def worst_rel(grads, ref) -> float:
    """The largest of each tensor's max |a - b| over its reference's max |b|."""
    return max(per_tensor_rel(grads, ref, list(ref)).values())


@contextlib.contextmanager
def plain_backward(kernels, jittered=None, draw=0):
    """K1-bwd-grid, K1-bwd-vol and K2-bwd on their plain versions; the
    outputs of the one named ``jittered`` ("K1-bwd-vol" or "K2-bwd")
    multiplied by (1 + FLOOR_EPS[0] N(0, 1)), draw ``draw``."""
    fused_sample, lrelu_pnorm = kernels
    plain = {"K1-bwd-grid": (fused_sample, "grid_sample_3d_bwd_grid",
                             fused_sample.grid_sample_3d_bwd_grid_plain),
             "K1-bwd-vol": (fused_sample, "grid_sample_3d_bwd_vol",
                            fused_sample.grid_sample_3d_bwd_vol_plain),
             "K2-bwd": (lrelu_pnorm, "lrelu_pixel_norm_bwd", lrelu_pnorm.lrelu_pixel_norm_bwd_plain)}

    def jitter(fn):
        calls = []

        def run(*args):
            out = fn(*args)
            calls.append(None)
            g = torch.Generator(device=out.device).manual_seed(1000 * draw + len(calls))
            return out * (1 + FLOOR_EPS[0] * torch.randn(out.shape, generator=g, device=out.device))
        return run

    with contextlib.ExitStack() as stack:
        for name, (module, attr, fn) in plain.items():
            stack.enter_context(mock.patch.object(
                module, attr, jitter(fn) if name == jittered else fn))
        yield


def gradient_check(label, grads_fn, network, kernels, noise_only=(),
                   ill_conditioned=False) -> None:
    """``grads_fn() -> (loss, {name: gradient})`` on the kernels against the
    same call on the plain versions (``transforms`` and ``modules`` on their
    "torch" backends), each gradient relative to its reference's largest
    magnitude.

    Gated at NET_TOL: the loss, and the gradient with the forward shared
    (the kernels' forward, the plain K1-bwd-grid, K1-bwd-vol and K2-bwd).
    Gated at FLOOR_FACTOR times its noise floor: the gradient end to end.
    PixelNorm lifts near-zero activations to unit scale, and the losses
    pass hard gates (the refinement's mask, the training's top-k), so the
    gradient jumps between discrete values with the activations' last bits.
    Its floor is the largest of 6 draws of how far the plain gradient moves
    when every convolution of ``network`` multiplies its output by (1 + eps
    N(0, 1)), 3 draws for each eps of FLOOR_EPS. The gradients named in
    ``noise_only`` (parameters that do not reach the output, whose gradient
    is rounding noise) are left out of those comparisons and gated below
    NOISE_ONLY_TOL of the largest gradient instead.

    With ``ill_conditioned`` (a step whose forward and backward both
    amplify last-bit differences) the loss is gated at the larger of
    NET_TOL and FLOOR_FACTOR times its own noise floor (the same perturbed
    runs), and the backward alone gets a floor too: for each tensor, how
    far the gradient with the forward shared moves when the plain K2-bwd's
    or K1-bwd-vol's outputs are multiplied by (1 + eps N(0, 1)), eps =
    FLOOR_EPS[0], WITNESS_DRAWS draws each; the shared gradient of each
    tensor is then gated at the larger of NET_TOL and FLOOR_FACTOR times its
    own floor. A tensor whose floor is above NET_TOL is one that rounding
    in the backward alone moves, whatever computes it."""
    from latentfusion_tpu_torch import modules, testing, transforms

    def worst(grads, ref):
        return worst_rel({k: v for k, v in grads.items() if k not in noise_only},
                         {k: v for k, v in ref.items() if k not in noise_only})

    loss_k, grads_k = grads_fn()
    _, grads_k2 = grads_fn()
    with plain_backward(kernels):
        _, grads_s = grads_fn()
    floors, loss_floors = [], []
    with transforms.volume_sample_backend("torch"), modules.lrelu_pnorm_backend("torch"):
        loss_p, grads_p = grads_fn()
        for eps in FLOOR_EPS:
            for draw in range(3):
                with testing.convs_perturbed(network, eps, draw):
                    loss, grads = grads_fn()
                floors.append(worst(grads, grads_p))
                loss_floors.append(rel_err(loss, loss_p))
                del grads
    names = [k for k in grads_k if k not in noise_only]
    shared = per_tensor_rel(grads_k, grads_s, names)
    shared_tol, loss_tol = dict.fromkeys(names, NET_TOL), NET_TOL
    if ill_conditioned:
        loss_tol = max(NET_TOL, FLOOR_FACTOR * max(loss_floors))
        moved = {}
        for kernel in ("K2-bwd", "K1-bwd-vol"):
            for draw in range(WITNESS_DRAWS):
                with plain_backward(kernels, kernel, draw):
                    rel = per_tensor_rel(grads_fn()[1], grads_s, names)
                moved[kernel] = {k: max(moved.get(kernel, {}).get(k, 0.0), rel[k])
                                 for k in names}
        floor = {k: max(m[k] for m in moved.values()) for k in names}
        shared_tol = {k: max(NET_TOL, FLOOR_FACTOR * floor[k]) for k in names}
        ill = sorted((k for k in names if floor[k] > NET_TOL), key=floor.get, reverse=True)
        say(f"  {label}: the loss's noise floor {json.dumps(loss_floors)}, tol "
            f"{loss_tol:.3g}; backward-only floor (the plain K2-bwd's or K1-bwd-vol's outputs "
            f"perturbed by {FLOOR_EPS[0]:g}, {WITNESS_DRAWS} draws each), largest "
            f"{json.dumps({k: max(v.values()) for k, v in moved.items()})}; {len(ill)} "
            f"tensors with a floor above {NET_TOL} (name, floor, shared err) "
            f"{json.dumps([(k, f'{floor[k]:.3g}', f'{shared[k]:.3g}') for k in ill])}; the "
            f"others' largest shared err "
            f"{max((shared[k] for k in names if k not in ill), default=0.0):.3g}")
    loss_err, shared_err = rel_err(loss_k, loss_p), max(shared.values())
    grad_err, grad_tol = worst(grads_k, grads_p), FLOOR_FACTOR * max(floors)
    largest = max(float(v.abs().max()) for v in grads_k.values())
    noise = max((float(grads[k].abs().max()) / largest for grads in (grads_k, grads_p)
                 for k in noise_only), default=0.0)

    def farthest(grads, ref):
        errs = per_tensor_rel(grads, ref, names)
        return [(k, f"{errs[k]:.3g}") for k in sorted(errs, key=errs.get, reverse=True)[:3]]

    say(f"  {label} ({len(grads_k)} gradients), kernels vs plain: loss rel err "
        f"{loss_err:.3g} (tol {loss_tol:.3g}); gradient with the forward shared "
        f"{shared_err:.3g} (tol {NET_TOL}"
        f"{', or 3x the backward-only floor of a tensor' if ill_conditioned else ''}); "
        f"end to end {grad_err:.3g}, noise "
        f"floor (plain, convolutions perturbed by {FLOOR_EPS}) {json.dumps(floors)}, "
        f"tol {FLOOR_FACTOR:g} x largest = {grad_tol:.3g}; kernels repeated "
        f"{worst(grads_k2, grads_k):.3g}, "
        f"same bits {all(torch.equal(grads_k2[n], grads_k[n]) for n in grads_k)} (not gated)"
        + (f"; {len(noise_only)} gradients of parameters that do not reach the output, "
           f"largest {noise:.3g} of the largest gradient (tol {NOISE_ONLY_TOL})"
           if noise_only else ""))
    say(f"    farthest with the forward shared {farthest(grads_k, grads_s)}; end to end "
        f"{farthest(grads_k, grads_p)}")
    if not (loss_err <= loss_tol and all(shared[k] <= shared_tol[k] for k in names)):
        fail(f"{label}: the kernels disagree with the plain versions")
    if not grad_err <= grad_tol:
        fail(f"{label}: the gradient on the kernels is beyond its noise floor")
    if not noise <= NOISE_ONLY_TOL:
        fail(f"{label}: a parameter that does not reach the output has a gradient")


def phase_pose_accuracy(model, kernels, seed, checks=True):
    """The oracle rig of tools/train_encoder_distill.py: ADD-S of CEM +
    refinement on 8 targets with the learned demo weights; then of the
    Metropolis estimator as the coarse stage at tools/metropolis_eval.py's
    budget with the same refinement; then of all 8 targets as one
    ``estimate_batch`` of CEM and refinement (the latent 8 times, as the
    service batches frames of one object). The reference views and targets
    are drawn from ``seed``. Each gated at 7 of 8. ``checks`` adds a
    refinement step against the plain versions. Returns the launch counts
    of the Metropolis estimates and of the batch, and the hits."""
    from latentfusion_tpu_torch import testing, zoo
    from latentfusion_tpu_torch.camera import Camera
    from latentfusion_tpu_torch.pose import estimation, metrics
    from latentfusion_tpu_torch.three import orientation, quaternion

    dev = model.device
    oracle = testing.EllipsoidOracleModel(zoo.DEMO_INPUT_SIZE, zoo.DEMO_CAMERA_DIST,
                                          ORACLE_AXES, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    ref_cams = zoo.random_view_cameras(16, g, zoo.DEMO_CAMERA_DIST, device=dev)
    gt_cams = [testing.make_camera(1, z=zoo.DEMO_CAMERA_DIST, f=615.0, width=640,
                                   height=480, quats=quaternion.random(1, g),
                                   device=dev) for _ in range(8)]
    targets = [oracle.make_observation(gt) for gt in gt_cams]
    z = model.build_latent_object(oracle.make_observation(ref_cams, shaded=True))
    points = (orientation.evenly_distributed_points(512, device=dev)
              * torch.tensor(ORACLE_AXES, device=dev))
    coarse = estimation.CrossEntropyPoseEstimator(
        model=model, num_gmm_components=6, sample_flipped=True, num_samples=128,
        num_iters=10, num_elites=48, learning_rate=0.75,
        loss_weights={"depth": 1.0}, ranking_size=16)
    metropolis = estimation.MetropolisPoseEstimator(
        model=model, num_samples=128, num_iters=300, loss_weights={"depth": 1.0},
        ranking_size=16)
    fine = estimation.GradientPoseEstimator(
        model=model, ranking_size=8, loss_weights={"depth": 1.0, "ov_depth": 0.3},
        learning_rate=0.01, num_samples=16, num_iters=150, converge_threshold=1e-6,
        converge_patience=25, optimizer="adam", track_stats=True)

    def score(label, i, gt, cams, best, stats):
        mc = metrics.camera_metrics(gt, cams[0], points, 1.0)
        mr = metrics.camera_metrics(gt, best[0], points, 1.0)
        ok = mr["add_s"] < 0.1 * ORACLE_DIAMETER
        if not ok:
            say(f"  {label} target {i} missed; the rig's reference cameras, the target's "
                f"camera and the coarse cameras handed to refinement: " + json.dumps(
                    {"reference": camera_record(ref_cams), "target": camera_record(gt),
                     "coarse": camera_record(cams[:16])}))
        say(f"  {label} target {i}: coarse add_s {mc['add_s']:.4f} rot "
            f"{mc['rotation_dist']:.3f}; refined ({stats['num_steps']} steps) add_s "
            f"{mr['add_s']:.4f} rot {mr['rotation_dist']:.3f} trans "
            f"{mr['translation_dist']:.4f}; 0.1d {ok}")
        return ok

    hits, single_s = {}, {}
    counts = {}
    for label, est in (("CEM", coarse), ("Metropolis", metropolis)):
        hits[label], single_s[label] = 0, []
        reset_counters(kernels)
        for i, (gt, target) in enumerate(zip(gt_cams, targets)):
            t0 = time.perf_counter()
            cams = est.estimate(z, target, generator=g)
            best, stats = fine.estimate(z, target, camera=cams[:16])
            torch.cuda.synchronize()
            single_s[label].append(time.perf_counter() - t0)
            if i == 0 and label == "CEM" and checks:
                zcams = cams[:16].zoom(None, model.input_size, model.camera_dist)
                gradient_check("demo refinement step",
                               lambda: fine.loss_and_grads(z, target, zcams),
                               model.photographer, kernels)
            hits[label] += score(label, i, gt, cams, best, stats)
        counts[label] = read_counters(kernels)
        say(f"  {label}: ADD-S within 0.1 diameter: {hits[label]}/8 = {hits[label] / 8:.3f} "
            f"({sum(single_s[label]):.1f} s for 8 targets, s per target "
            f"{json.dumps([round(x, 3) for x in single_s[label]])}); launches "
            f"{json.dumps(counts[label])}")

    reset_counters(kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    z8 = torch.cat([z] * len(targets))
    coarse_out = coarse.estimate_batch(z8, targets, generator=g)
    results, stats = fine.estimate_batch(z8, targets,
                                         cameras=Camera.cat([c[:16] for c in coarse_out]))
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    counts["batch"] = read_counters(kernels)
    hits["batch"] = sum(score("batch", i, gt, cams, best, {"num_steps": stats["num_steps"]})
                        for i, (gt, cams, best) in enumerate(zip(gt_cams, coarse_out, results)))
    say(f"  estimate_batch of the 8 targets (CEM then refinement, {stats['num_steps']} "
        f"steps): ADD-S within 0.1 diameter {hits['batch']}/8; {batch_s:.2f} s per batch "
        f"against {sum(single_s['CEM']):.2f} s for the 8 single CEM estimates; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
        f"{json.dumps(counts['batch'])}")
    if checks:
        for label, n in hits.items():
            if n < 7:
                fail(f"pose accuracy ({label}): {n}/8 targets within 0.1 diameter, "
                     f"fewer than 7")
    del z, z8, targets
    torch.cuda.empty_cache()
    return counts, hits


def camera_record(cam) -> dict:
    """A camera's leaves as lists, exact to the last bit of each float32."""
    return {"intrinsic": cam.intrinsic.tolist(), "extrinsic": cam.extrinsic.tolist(),
            "viewport": cam.viewport.tolist(), "z_span": cam.z_span, "width": cam.width,
            "height": cam.height}


def batch_step_check(fine, z_objs, targets, cams) -> None:
    """One refinement step of two objects from their coarse cameras
    (zoomed, object-major), with the forward shared: each object's loss and
    camera gradient from the batch's objective (the estimator's own step,
    ``loss_and_grads(num_objects=2)``) against those of the object's
    single-object objective (its hypotheses' losses against its own
    target, summed and divided by their count) on the same render. Gated at
    NET_TOL. Also prints, ungated, how far a separate single-object step
    (its own forward at batch 8) lands from the batch's."""
    from latentfusion_tpu_torch.observation import Observation
    from latentfusion_tpu_torch.pose import estimation
    from latentfusion_tpu_torch.pose import utils as pu

    num_objects, views = len(targets), len(cams) // len(targets)
    target = estimation.repeat_frames(Observation.collate(targets), views)
    loss_e, grads_e = fine.loss_and_grads(z_objs, target, cams, num_objects=num_objects)
    leaves = {k: v.detach().requires_grad_() for k, v in pu.camera_params(cams).items()}
    with torch.enable_grad(), estimation.deterministic_cudnn():
        cam = cams.replace(**leaves)
        z_depth, z_mask_logits, _ = fine._render_zoomed(z_objs, cam)

        def objective(rows, tgt):
            loss_dict = fine.loss_func(tgt, z_depth[rows], z_mask_logits[rows], cam[rows])
            return sum(estimation.weigh_losses(loss_dict, fine.loss_weights).values())

        loss_b = objective(slice(None), target)
        losses_b = loss_b.detach()
        grads_b = torch.autograd.grad(loss_b.sum() / views, list(leaves.values()),
                                      retain_graph=True)
        errs, separate = [], []
        for b, tgt in enumerate(targets):
            rows = slice(b * views, (b + 1) * views)
            loss_s = objective(rows, tgt)
            grads_s = torch.autograd.grad(loss_s.sum() / views, list(leaves.values()),
                                          retain_graph=True)
            errs.append(max([rel_err(losses_b[rows], loss_s.detach())] + [
                worst_rel({0: gb[rows]}, {0: gs[rows]}) for gb, gs in zip(grads_b, grads_s)]))
            loss_1, grads_1 = fine.loss_and_grads(z_objs[b:b + 1], tgt, cams[rows])
            separate.append(max([rel_err(loss_e[rows], loss_1)] + [
                worst_rel({0: grads_e[k][rows]}, {0: grads_1[k]}) for k in grads_1]))
    same = all(torch.equal(grads_e[k], g) for k, g in zip(leaves, grads_b))
    estimator_err = max([rel_err(loss_e, losses_b)] + [worst_rel({0: grads_e[k]}, {0: g})
                                                     for k, g in zip(leaves, grads_b)])
    say(f"  two-object refinement step, forward shared: each object's loss and camera "
        f"gradient from the batch against its single-object objective, rel err "
        f"{json.dumps(errs)} (tol {NET_TOL}); the estimator's batch step against the "
        f"batch objective {estimator_err:.3g} (same bits {same}); a separate "
        f"single-object step (its own forward) against the batch's block, not gated: "
        f"{json.dumps(separate)}")
    if not max(errs + [estimator_err]) <= NET_TOL:
        fail("service: an object's step in the batch is not its single-object step")


def phase_service(model, kernels, seed):
    """The service at flagship width: a PoseService (cross_entropy_quick
    then adam_quick, top 8) driven through serve_lines, two rounds of
    ping, register o0 and o1 (views 0-14 of each), an estimate of
    view 15 of o0, of that frame twice, of o0 and o1 together, a malformed
    line, an unknown command and a shutdown. Gates: the responses; the
    single estimate against the direct coarse + fine estimate with the same
    seed; a two-object step against its objects' single-object steps.
    Prints seconds, launches and peak memory per request. Returns the warm
    round's launches summed over its requests."""
    import io
    import tempfile

    from latentfusion_tpu_torch import serve
    from latentfusion_tpu_torch.camera import Camera
    from latentfusion_tpu_torch.observation import Observation
    from latentfusion_tpu_torch.pose import estimation

    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for index, obj in enumerate(("o0", "o1")):
            obs = reference_views(index, model.device)
            arrays = {"color": obs.color, "depth": obs.depth, "mask": obs.mask,
                      "intrinsic": obs.camera.intrinsic, "extrinsic": obs.camera.extrinsic}
            arrays = {k: v.cpu().numpy() for k, v in arrays.items()}
            del obs
            for part, rows in (("refs", slice(0, 15)), ("target", slice(15, 16))):
                paths[part, obj] = str(Path(tmp) / f"{part}_{obj}.npz")
                np.savez(paths[part, obj], **{
                    k: (v if k == "intrinsic" and v.ndim == 2 else v[rows])
                    for k, v in arrays.items()})
        service = serve.PoseService(model, CONFIGS / "cross_entropy_quick.toml",
                                    CONFIGS / "adam_quick.toml", top_k=N_REFINE)
        requests = [
            {"cmd": "ping", "id": "ping"},
            {"cmd": "register", "object": "o0", "npz": paths["refs", "o0"], "id": "register o0"},
            {"cmd": "register", "object": "o1", "npz": paths["refs", "o1"], "id": "register o1"},
            {"cmd": "estimate", "object": "o0", "npz": paths["target", "o0"], "seed": seed,
             "id": "estimate one frame"},
            {"cmd": "estimate", "object": "o0", "npz": [paths["target", "o0"]] * 2,
             "seed": seed, "id": "estimate two frames of o0"},
            {"cmd": "estimate", "object": ["o0", "o1"],
             "npz": [paths["target", "o0"], paths["target", "o1"]], "seed": seed,
             "id": "estimate o0 and o1"},
            "{malformed",
            {"cmd": "teleport", "id": "unknown command"},
            {"cmd": "shutdown", "id": "shutdown"}]
        handle, per_request = service.handle, []

        def counted(req):
            reset_counters(kernels)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            resp = handle(req)
            torch.cuda.synchronize()
            per_request.append((req.get("id"), time.perf_counter() - t0,
                                read_counters(kernels),
                                torch.cuda.max_memory_allocated() / 1e9))
            return resp

        service.handle = counted
        rounds = []
        for label in ("first", "warm"):
            per_request.clear()
            out = io.StringIO()
            stopped = serve.serve_lines(service, io.StringIO("\n".join(
                r if isinstance(r, str) else json.dumps(r) for r in requests) + "\n"), out)
            resp = [json.loads(line) for line in out.getvalue().splitlines()]
            rounds.append(resp)
            say(f"  {label} round: {len(resp)} responses, ok "
                f"{[r['ok'] for r in resp]}, shutdown {stopped}")
            for rid, secs, counts, peak in per_request:
                say(f"    {rid}: {secs:.3f} s, peak memory {peak:.2f} GB, launches "
                    f"{json.dumps(counts)}")
            if not (stopped and [r["ok"] for r in resp] == [True] * 6 + [False] * 2 + [True]
                    and resp[-1].get("shutdown")
                    and [r.get("id") for r in resp[7:]] == ["unknown command", "shutdown"]
                    and len(resp[4]["poses"]) == 2 and len(resp[5]["poses"]) == 2):
                fail(f"service: the {label} round's responses are not the protocol's: "
                     f"{[{k: v for k, v in r.items() if k != 'poses'} for r in resp]}")
            warm_counts = {k: sum(c[k] for _, _, c, _ in per_request) for k in per_request[0][2]}
        service.handle = handle

        target = serve.observation_from_npz(paths["target", "o0"], model.device)
        g = torch.Generator(device=model.device).manual_seed(seed)
        z0 = service.latents["o0"]
        direct = service.estimate_one(z0, target, N_REFINE, g)
        got = torch.tensor(rounds[1][3]["extrinsic"], device=model.device)
        err = rel_err(got, direct.extrinsic[0])
        same = bool(torch.equal(got, direct.extrinsic[0]))
        say(f"  the single-frame response against the direct coarse + fine estimate with "
            f"the same seed: extrinsic rel err {err:.3g} (tol {NET_TOL}), same bits {same}; "
            f"first and warm rounds' poses the same "
            f"{rounds[0][3]['extrinsic'] == rounds[1][3]['extrinsic']}")
        if not err <= NET_TOL:
            fail("service: the single-frame response is not the direct estimate")

        targets = [target, serve.observation_from_npz(paths["target", "o1"], model.device)]
        z_objs = torch.cat([z0, service.latents["o1"]])
        t0 = time.perf_counter()
        coarse_out = service.coarse.estimate_batch(
            z_objs, targets, generator=torch.Generator(device=model.device).manual_seed(seed))
        torch.cuda.synchronize()
        coarse_s = time.perf_counter() - t0
        cams = Camera.cat([c[:N_REFINE] for c in coarse_out]).zoom(
            None, model.input_size, model.camera_dist)
        batch_step_check(service.fine, z_objs, targets, cams)
        rep = estimation.repeat_frames(Observation.collate(targets), N_REFINE)
        step = lambda: service.fine.loss_and_grads(z_objs, rep, cams, num_objects=2)
        say(f"  the two-object request's parts: CEM estimate_batch ({service.coarse.num_iters} "
            f"iterations of 2 x {service.coarse.num_samples}) {coarse_s:.3f} s; one refinement "
            f"step of 2 x {N_REFINE} {event_ms(step):.2f} ms by CUDA events, "
            f"{time_ms(step, iters=3):.2f} ms of device time")
    del service, direct, coarse_out
    torch.cuda.empty_cache()
    return warm_counts


def unseen_round(label, model, views, clouds, extra, seed, held, kernels) -> dict:
    """One pass of the unseen-object rig (``unseen_eval.evaluate_batch``):
    for each target index one ``estimate_batch`` of CEM and one of
    refinement over the objects of ``views`` (each (reference
    Observation, [(camera, target Observation)])), launch-counted, with its
    peak memory; every K1 call, recorded, must be a shape phase 2 held
    (``held``; None skips the check). Prints hits by object, seconds per
    batch, peak memory and launches; returns them with the rows."""
    from latentfusion_tpu_torch import unseen_eval

    g = torch.Generator(device=model.device).manual_seed(seed)
    out = {}
    reset_counters(kernels)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    calls = record_k1(kernels[0], lambda: out.update(zip(("rows", "seconds"), (
        unseen_eval.evaluate_batch(model, [v[0] for v in views], [v[1] for v in views],
                                   clouds, UNSEEN_BUDGET, extra, tag=f"  {label} ",
                                   generator=g)))))
    out.update(total_s=time.perf_counter() - t0, counts=read_counters(kernels),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               hits=[sum(r["add_s_01d"] for r in rows) for rows in out["rows"]])
    say(f"  {label}: within 0.1d by object {out['hits']}, {sum(out['hits'])} of "
        f"{sum(len(rows) for rows in out['rows'])}; s per batch of {len(views)} objects "
        f"{json.dumps([round(x, 3) for x in out['seconds']])} ({out['total_s']:.1f} s with the "
        f"builds); peak memory {out['peak_gb']:.2f} GB; launches {json.dumps(out['counts'])}; "
        f"K1 calls (op, volume, grids: calls) {json.dumps({str(k): v for k, v in calls.items()})}")
    if held is not None:
        missing = [k for k in calls if k not in held]
        if missing:
            fail(f"unseen objects: K1 ran at shapes phase 2 did not hold: {missing}")
    return out


def phase_unseen(kernels, seed, held, checks=True, latent_rank=False) -> dict:
    """The unseen-object rig of tools/train_unseen_objects.py on the
    pool-128 checkpoint (demo family, ``artifacts/unseen_objects_pool128``):
    held-out objects 0-3 of lobe pool seed 7919, never rendered in its
    training, each from JAX's 16 reference views, at JAX's 6 target
    cameras, at the published budget (CEM 128 x 10, 48 elites, then
    refinement 16 x 150, depth-only ranking), each target index one
    ``estimate_batch`` over the 4 objects; gated (``checks``) at UNSEEN_GATE
    of 24 within 0.1d. ``latent_rank`` adds an ungated pass with the latent
    ranking term at 0.2 (its K1 calls not checked against phase 2's
    shapes). Then one target index at the mid width (the
    flagship's widths at 128^2) with N(0, 1) weights drawn from ``seed``, for
    time, memory and launches. Returns the passes by name."""
    from latentfusion_tpu_torch import testing, unseen_eval, zoo
    from latentfusion_tpu_torch.recon.inference import LatentFusionModel

    dev = torch.device("cuda")
    model = unseen_eval.build_model("demo", POOL128 / "unseen_objects.npz", dev)
    ref_cams, target_cams = unseen_eval.load_cameras(16, UNSEEN_TARGETS, dev)
    pool, clouds = testing.sample_lobe_shapes(HELDOUT_POOL_SEED, UNSEEN_OBJECTS, device=dev)
    views = [unseen_eval.object_views(pool, h, ref_cams, target_cams)
             for h in range(UNSEEN_OBJECTS)]
    passes = {"demo": unseen_round("pool-128", model, views, clouds, {}, seed, held, kernels)}
    if latent_rank:
        # The latent term's autoencode runs K1 at shapes phase 2 does not hold.
        passes["latent_rank"] = unseen_round("pool-128, latent ranking 0.2", model, views,
                                             clouds, {"latent": 0.2}, seed, None, kernels)
    hits = sum(passes["demo"]["hits"])
    if checks and hits < UNSEEN_GATE:
        fail(f"unseen objects: {hits} of {UNSEEN_OBJECTS * UNSEEN_TARGETS} held-out targets "
             f"within 0.1d, fewer than {UNSEEN_GATE}")
    del model
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(seed)
    mid = LatentFusionModel(zoo.mid_sculptor(generator=gen), None,
                            zoo.mid_fuser(generator=gen), None,
                            zoo.mid_photographer(generator=gen), None,
                            camera_dist=unseen_eval.CAMERA_DIST)
    passes["mid"] = unseen_round("mid width, N(0, 1) weights (accuracy not expected)", mid,
                                 [(ref, targets[:1]) for ref, targets in views], clouds, {},
                                 seed, held, kernels)
    del mid, views
    torch.cuda.empty_cache()
    return passes


def train_grads(step, mods, batch, rotations):
    """One step's loss and parameter gradients. The state's optimizer is SGD
    at learning rate 0, so the weights stay as they are."""
    from latentfusion_tpu_torch.train import step as tstep

    state = tstep.init_train_state(mods, tstep.make_optimizer("sgd", 0.0))
    _, scalars = step(state, batch, rotations=rotations)
    return scalars["loss/generator/total"], {
        f"{name}.{pname}": p.grad.clone() for name, m in mods.items()
        for pname, p in m.named_parameters()}


def train_determinism(step, mods, batch, rotations) -> dict:
    """One training step's gradients twice as the package runs it (cuDNN's
    deterministic selection, ``pose.estimation.deterministic_cudnn``) and
    twice with cuDNN's default selection patched in: for each, whether the
    two runs give the same bits and the first parameter (in module order)
    whose gradient parts. Then ms per step (CUDA events, 2 steps after a
    warm-up) under each, in turns (deterministic, default, default,
    deterministic), and the cost of the deterministic selection."""
    from latentfusion_tpu_torch.pose import estimation
    from latentfusion_tpu_torch.train import step as tstep

    selections = {"deterministic": contextlib.nullcontext,
                  "default": lambda: mock.patch.object(estimation, "deterministic_cudnn",
                                                       contextlib.nullcontext)}
    out = {}
    for label, selection in selections.items():
        with selection():
            _, first = train_grads(step, mods, batch, rotations)
            _, second = train_grads(step, mods, batch, rotations)
        parted = [k for k in first if not torch.equal(first[k], second[k])]
        out[label] = {"same_bits": not parted, "parameters_parted": len(parted),
                      "first_parted": parted[0] if parted else None, "ms": []}
        del first, second
    frozen = tstep.init_train_state(mods, tstep.make_optimizer("sgd", 0.0))
    for label in ("deterministic", "default", "default", "deterministic"):
        with selections[label]():
            out[label]["ms"].append(event_ms(
                lambda: step(frozen, batch, rotations=rotations), iters=2, warmup=1))
    det, dflt = (sum(out[k]["ms"]) / len(out[k]["ms"]) for k in ("deterministic", "default"))
    out["cost"] = (det - dflt) / dflt
    say(f"  training step twice from the same state and batch, and ms per step, under "
        f"cuDNN's deterministic selection (the package's) and its default: {json.dumps(out)}")
    if not out["deterministic"]["same_bits"]:
        fail("training: two steps from the same state and batch gave other gradient bits")
    return out


def phase_train(kernels, seed):
    """The flagship recipe's generator step: gradient check, launches on one
    step, ms per step, peak memory, a profile, and TRAIN_STEPS steps on a
    pool of TRAIN_POOL batches with the held-out loss read every
    TRAIN_EVERY steps. Returns the launch counts of one step."""
    from torch import nn

    from latentfusion_tpu_torch import zoo
    from latentfusion_tpu_torch.three import quaternion
    from latentfusion_tpu_torch.train import step as tstep

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    mods = {"sculptor": zoo.flagship_sculptor(generator=gen),
            "fuser": zoo.flagship_fuser(generator=gen),
            "photographer": zoo.flagship_photographer(generator=gen)}
    step = tstep.make_recon_train_step(mods["sculptor"], mods["fuser"],
                                       mods["photographer"], config=train_config(),
                                       num_microbatches=TRAIN_MICROBATCHES)
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    t0 = time.perf_counter()
    pool = [train_batch(g) for _ in range(TRAIN_POOL)]
    holdout = train_batch(g)
    torch.cuda.synchronize()
    say(f"  {TRAIN_POOL + 1} oracle batches of {TRAIN_BATCH} objects x ({TRAIN_IN} + "
        f"{TRAIN_OUT}) views of 640x480 rendered in {time.perf_counter() - t0:.2f} s")
    rotations = [quaternion.random(1, g) for _ in range(TRAIN_MICROBATCHES)]
    gradient_check("training step", lambda: train_grads(step, mods, pool[0], rotations),
                   nn.ModuleList(mods.values()), kernels)
    train_determinism(step, mods, pool[0], rotations)

    adam = tstep.init_train_state(mods, tstep.make_optimizer("adam", 1e-3))
    frozen = tstep.init_train_state(mods, tstep.make_optimizer("sgd", 0.0))
    upright = [quaternion.identity(1, device=dev)] * TRAIN_MICROBATCHES

    def held_out():
        _, scalars = step(frozen, holdout, rotations=upright)
        return {k.split("/")[-1]: float(v) for k, v in scalars.items()}

    readings = [(0, held_out())]
    reset_counters(kernels)
    step(adam, pool[0], generator=g)
    torch.cuda.synchronize()
    counts = read_counters(kernels)
    if not all(counts[k] > 0 for k in ("K1", "K1bv", "K2", "K2b")):
        fail(f"training: a kernel was not launched on the step: {counts}")
    events = []
    t0 = time.perf_counter()
    for i in range(1, TRAIN_STEPS):
        if i == 2:
            torch.cuda.reset_peak_memory_stats()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        _, scalars = step(adam, pool[i % TRAIN_POOL], generator=g)
        end.record()
        events.append((start, end))
        if (i + 1) % TRAIN_EVERY == 0:
            readings.append((i + 1, held_out()))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [s.elapsed_time(e) for s, e in events[1:1 + TRAIN_TIMED]]
    say(f"  launches on one step: {json.dumps(counts)}")
    say(f"  step (global batch {TRAIN_BATCH}, {TRAIN_MICROBATCHES} microbatches): "
        f"{sum(step_ms) / len(step_ms):.1f} ms per step (CUDA events, steps 2-"
        f"{1 + len(step_ms)}: {json.dumps([round(t, 1) for t in step_ms])}); "
        f"{TRAIN_STEPS - 1} steps and {len(readings) - 1} held-out readings in "
        f"{wall_s:.1f} s; peak memory {peak_gb:.2f} GB (max_memory_allocated from "
        f"step 2 on, the batch pool included)")
    say(f"  held-out loss by step: {json.dumps(readings)}")
    if not all(np.isfinite(r["total"]) for _, r in readings):
        fail("training: a held-out loss is not finite")
    if not readings[-1][1]["total"] < readings[0][1]["total"]:
        fail("training: the held-out loss did not fall")
    say(f"  one training step (global batch {TRAIN_BATCH}), device time by kernel:")
    profile_step(lambda: step(frozen, pool[0], rotations=upright))
    bwd_vol_in_step(kernels[0], lambda: step(frozen, pool[0], rotations=upright))
    del pool, holdout, mods, adam, frozen
    torch.cuda.empty_cache()
    return counts


def bwd_vol_in_step(fused_sample, run_step, steps: int = 4) -> None:
    """ms per training step (CUDA events) with K1-bwd-vol's tiled kernel
    and with the atomic kernel it replaced, taken in turns (tiled, atomic,
    atomic, tiled), ``steps`` steps a turn after a warm-up step."""
    times = {"tiled": [], "atomic": []}
    for kernel in ("tiled", "atomic", "atomic", "tiled"):
        with mock.patch.object(fused_sample, "bwd_vol_kernel", lambda _, k=kernel: k):
            run_step()
            for _ in range(steps):
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                run_step()
                end.record()
                torch.cuda.synchronize()
                times[kernel].append(start.elapsed_time(end))
    mean = {k: sum(v) / len(v) for k, v in times.items()}
    say(f"  training step with K1-bwd-vol's tiled kernel {mean['tiled']:.1f} ms, with the "
        f"atomic kernel it replaced {mean['atomic']:.1f} ms (difference "
        f"{mean['atomic'] - mean['tiled']:.1f} ms; turns tiled, atomic, atomic, tiled, "
        f"{steps} steps each, CUDA events: {json.dumps({k: [round(t, 1) for t in v] for k, v in times.items()})})")

def recon_inputs(device):
    """Phase 10's record (``recon_cameras.json``), its 16 reference and 8
    target cameras, the oracle, the shaded reference views and the targets'
    true depth and mask."""
    from latentfusion_tpu_torch import testing, zoo
    from latentfusion_tpu_torch.camera import Camera

    rec = json.loads(RECON_CAMERAS.read_text())
    K = torch.tensor(rec["intrinsic"])

    def cameras(part):
        ext = torch.tensor(rec[part]["extrinsic"])
        return Camera(K.expand(len(ext), 3, 3), ext, z_span=0.5, width=640, height=480,
                      device=device)

    oracle = testing.EllipsoidOracleModel(zoo.DEMO_INPUT_SIZE, zoo.DEMO_CAMERA_DIST,
                                          tuple(rec["oracle_axes"]), device=device)
    refs, targets = cameras("reference"), cameras("targets")
    return rec, oracle.make_observation(refs, shaded=True), targets, \
        oracle.make_observation(targets)


def png_round_trip(obs):
    """Save ``obs`` with ``Observation.save``, load it back, and fail unless
    the loaded arrays are the saved ones after the codec's quantisation
    (color ``uint8(255 c) / 255``, depth ``uint16(1000 d) / 1000``, mask
    ``d > 0.5``), bit for bit, and the cameras agree within 1e-6."""
    import tempfile

    from latentfusion_tpu_torch.observation import Observation

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        obs.save(tmp)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = Observation.load(tmp, device=obs.color.device)
        load_s = time.perf_counter() - t0
    want = {"color": (255.0 * obs.color.cpu().numpy()).astype(np.uint8).astype(np.float32) / 255.0,
            "depth": (1000.0 * obs.depth.cpu().numpy()).astype(np.uint16).astype(np.float32)
            / 1000.0,
            "mask": (obs.mask.cpu().numpy() > 0.5).astype(np.float32)}
    exact = {k: bool(np.array_equal(getattr(loaded, k).cpu().numpy(), v))
             for k, v in want.items()}
    cam_err = max(rel_err(getattr(loaded.camera, k), getattr(obs.camera, k))
                  for k in ("intrinsic", "viewport", "log_quaternion", "translation"))
    say(f"  Observation.save + load of {len(obs)} views of 640x480: {save_s:.2f} s + "
        f"{load_s:.2f} s; arrays the quantised ones bit for bit {json.dumps(exact)}; "
        f"cameras within {cam_err:.2e} (tol 1e-6)")
    if not (all(exact.values()) and cam_err <= 1e-6):
        fail("reconstruction: Observation.load does not give back what save wrote")
    return loaded


def recon_pass(model, ibr_model, refs, targets) -> dict:
    """The reconstruction API on phase 10's inputs: the latent of ``refs``,
    ``render_full`` at the targets, ``render_ibr_basic`` at the zoomed
    targets, ``render_full`` with ``input_obs``, ``render_ibr`` with the
    generator of ``ibr_model``."""
    z = model.build_latent_object(refs)
    zoom = targets.zoom(None, model.input_size, model.camera_dist)
    basic, _ = model.render_ibr_basic(z, refs, zoom, return_latent=False)
    learned, _ = ibr_model.render_ibr(z, refs, zoom, return_latent=False)
    return {"latent": z, "full": model.render_full(z, targets),
            "full_ibr": model.render_full(z, targets, input_obs=refs),
            "basic": basic, "learned": learned}


def recon_against_plain(out, ref) -> dict:
    """The kernel path's outputs against the plain path's: the latent, the
    full-frame mask, and the learned IBR color whole; the depth and colors
    that the mask's 0.5 threshold gates on the pixels where both masks fall
    on the same side, with the share of the other pixels (flips)."""
    errs = {"latent": rel_err(out["latent"], ref["latent"]),
            "full mask": rel_err(out["full"]["mask"], ref["full"]["mask"]),
            "render_ibr color": rel_err(out["learned"]["color"], ref["learned"]["color"])}
    same = (out["full"]["mask"] > 0.5) == (ref["full"]["mask"] > 0.5)
    same_zoom = (out["basic"]["mask"][0] > 0.5) == (ref["basic"]["mask"][0] > 0.5)
    for name, a, b, keep in (("full depth", out["full"]["depth"], ref["full"]["depth"], same),
                             ("full ibr color", out["full_ibr"]["color"],
                              ref["full_ibr"]["color"], same),
                             ("ibr_basic color", out["basic"]["color"], ref["basic"]["color"],
                              same_zoom)):
        errs[name] = rel_err(a * keep, b * keep)
    flips = max(float((~same).float().mean()), float((~same_zoom).float().mean()))
    return errs, flips


def recon_sums(out, truth) -> list:
    """Per target: the sums phase 10's record holds, and the mask IoU and
    mean depth error inside both masks against the truth."""
    rows = []
    for i in range(len(truth)):
        pred = out["full"]["mask"][i, 0] > 0.5
        true = truth.mask[i, 0] > 0.5
        both = pred & true
        depth = out["full"]["depth"][i, 0].double()
        basic = out["basic"]["color"][i].double()
        rows.append({
            "depth": float(depth.sum()), "mask": float(out["full"]["mask"][i].double().sum()),
            "color_ibr_basic": float(basic.sum()), "color_ibr_basic_abs": float(basic.abs().sum()),
            "color_full": float(out["full_ibr"]["color"][i].double().sum()),
            "iou": float(both.sum() / (pred | true).sum().clamp_min(1)),
            "depth_err": float((depth - truth.depth[i, 0].double()).abs()[both].mean())})
    return rows


def phase_recon(model, kernels, seed) -> dict:
    """The reconstruction API at the demo family with the learned weights
    (``render_full``, ``render_ibr_basic``, ``render_full`` with
    ``input_obs``, ``render_ibr``) on phase 10's inputs. Returns the launch
    counts of one pass."""
    from latentfusion_tpu_torch import modules, transforms, zoo
    from latentfusion_tpu_torch.modules.unet import UNet2d
    from latentfusion_tpu_torch.recon.inference import LatentFusionModel

    dev = model.device
    rec, refs, targets, truth = recon_inputs(dev)
    loaded = png_round_trip(refs)
    del refs
    views = len(loaded)
    generator = zoo.init_weights_(UNet2d(1 + 5 * views, (views,) * 3, RECON_GENERATOR_CONFIG),
                                  torch.Generator().manual_seed(seed))
    ibr_model = LatentFusionModel(model.sculptor, None, model.fuser, None,
                                  model.photographer, None, camera_dist=model.camera_dist,
                                  device=dev, generator=generator)

    reset_counters(kernels)
    out = recon_pass(model, ibr_model, loaded, targets)
    torch.cuda.synchronize()
    counts = read_counters(kernels)
    if not (counts["K1"] > 0 and counts["K2"] > 0):
        fail(f"reconstruction: a kernel was not launched: {counts}")
    for key, shape in (("depth", (8, 1, 480, 640)), ("mask", (8, 1, 480, 640))):
        if tuple(out["full"][key].shape) != shape or not bool(torch.isfinite(out["full"][key]).all()):
            fail(f"reconstruction: render_full {key} {tuple(out['full'][key].shape)}")
    if (tuple(out["full_ibr"]["color"].shape) != (8, 3, 480, 640)
            or tuple(out["learned"]["color"].shape) != (8, 3, 128, 128)
            or not bool(torch.isfinite(out["learned"]["color"]).all())):
        fail("reconstruction: the IBR colors have the wrong shape or are not finite")

    with transforms.volume_sample_backend("torch"), modules.lrelu_pnorm_backend("torch"):
        ref = recon_pass(model, ibr_model, loaded, targets)
    errs, flips = recon_against_plain(out, ref)
    say(f"  kernels vs plain rel err {json.dumps(errs)} (tol {NET_TOL}), mask 0.5 flips "
        f"{flips:.2e} of the pixels (tol {SUMS_TOL}); launches {json.dumps(counts)}")
    if not (max(errs.values()) <= NET_TOL and flips <= SUMS_TOL):
        fail("reconstruction: the kernel path disagrees with the plain path")
    del ref

    got = recon_sums(out, truth)
    pixels = 640 * 480
    worst = {"depth": 0.0, "mask": 0.0, "color_ibr_basic": 0.0, "color_full": 0.0}
    for g, want in zip(got, rec["jax_float32"]):
        worst["depth"] = max(worst["depth"], abs(g["depth"] - want["depth"]) / abs(want["depth"]))
        worst["mask"] = max(worst["mask"], abs(g["mask"] - want["mask"]) / pixels)
        worst["color_ibr_basic"] = max(worst["color_ibr_basic"], abs(
            g["color_ibr_basic"] - want["color_ibr_basic"]) / want["color_ibr_basic_abs"])
        worst["color_full"] = max(worst["color_full"], abs(
            g["color_full"] - want["color_full"]) / abs(want["color_full"]))
    say(f"  per-target sums against JAX's fp32 record, largest difference (depth and "
        f"color relative, the basic IBR color to its sum of magnitudes, mask over the "
        f"frame's pixels): {json.dumps(worst)} (tol {SUMS_TOL})")
    say(f"  mask IoU by target {json.dumps([round(g['iou'], 4) for g in got])} "
        f"(JAX {json.dumps([round(w['iou'], 4) for w in rec['jax_float32']])}); mean depth "
        f"error inside both masks {json.dumps([round(g['depth_err'], 5) for g in got])} "
        f"(JAX {json.dumps([round(w['depth_err'], 5) for w in rec['jax_float32']])})")
    if not max(worst.values()) <= SUMS_TOL:
        fail("reconstruction: the per-target sums disagree with JAX's record")

    estimated = truth.estimate_camera()
    trans_err = torch.linalg.norm(estimated.translation - targets.translation, dim=1)
    say(f"  estimate_camera on each target: translation error "
        f"{json.dumps([round(float(x), 5) for x in trans_err])} (object diameter "
        f"{2 * max(rec['oracle_axes'])})")

    z = out["latent"]
    zoom = targets.zoom(None, model.input_size, model.camera_dist)
    timings = {}
    for name, fn in (("render_full of 8", lambda: model.render_full(z, targets)),
                     ("render_ibr_basic of 8", lambda: model.render_ibr_basic(
                         z, loaded, zoom, return_latent=False)),
                     ("render_ibr of 8", lambda: ibr_model.render_ibr(
                         z, loaded, zoom, return_latent=False))):
        torch.cuda.reset_peak_memory_stats()
        ms = event_ms(fn, iters=3, warmup=1)
        timings[name] = {"ms": round(ms, 2),
                         "peak_gb": round(torch.cuda.max_memory_allocated() / 1e9, 3)}
    say(f"  ms and peak memory: {json.dumps(timings)}")
    # One render_ibr by op: device time and the memory each op allocates.
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities, profile_memory=True) as prof:
        ibr_model.render_ibr(z, loaded, zoom, return_latent=False)
        torch.cuda.synchronize()
    say(prof.key_averages().table(sort_by="self_cuda_memory_usage", row_limit=10))
    del out, loaded, ibr_model
    torch.cuda.empty_cache()
    return counts


def phase_eleven(kernels, seed, held, smi) -> dict:
    """Phase 11 (a) and (b); returns the launch counts by path."""
    say("== phase 11/11: the model options and the GAN training step: the training tool's "
        "default architecture with the discriminator; the Blend and LSTM fusers and skip "
        "connections at flagship width")
    t11 = time.perf_counter()
    options = phase_options(kernels, seed, held)
    t_options = time.perf_counter() - t11
    gan_counts = phase_gan(kernels, seed, held)
    say(f"   phase 11 launches: GAN step {json.dumps(gan_counts)}, options "
        f"{json.dumps(options)}; phase 11 took {time.perf_counter() - t11:.1f} s "
        f"((b) {t_options:.1f} s) on {smi}")
    return {"gan_step": gan_counts, **options}


def build_launches(model, kernels) -> None:
    """The flagship build of o0: K1-fwd launches, with the Sculptor's camera
    intermediates mapped only for a fuser that reads them (the GRU fuser
    does not: one launch, the last camera block's output) and with them
    forced on (one a camera block, the last reused); the latent must be the
    same bits."""
    fused_sample = kernels[0]
    obs = reference_views(0, model.device)
    sculptor = model.sculptor
    launches, latents = [], []
    for force in (False, True):
        forward = sculptor.forward
        patch = (mock.patch.object(sculptor, "forward", lambda x, cam, **_: forward(
            x, cam, camera_intermediates=True)) if force else contextlib.nullcontext())
        reset_counters(kernels)
        with patch:
            latents.append(model.build_latent_object(obs))
        torch.cuda.synchronize()
        launches.append(fused_sample.LAUNCHES)
    same = bool(torch.equal(*latents))
    blocks = len(sculptor.camera_blocks)
    say(f"  flagship build of o0: K1-fwd launches {launches[0]} (with the camera "
        f"intermediates mapped: {launches[1]}; {blocks} camera blocks); the latent the same "
        f"bits {same}")
    if not (same and launches == [1, blocks]):
        fail("flagship build: the camera intermediates changed the latent or the launches")


def tool_models(generator):
    """The training tool's default architecture at input 256
    (latentfusion_tpu/train/args.py:94-125: factor projections, the
    pool:max fuser, bilinear resizes, no input mask), predicting color, depth
    and mask, with the occlusion module at OPTION_UNET3D_CONFIG; and the
    multi-scale discriminator at its defaults on color + depth + mask.
    Weights N(0, 1) from ``generator``."""
    from latentfusion_tpu_torch import zoo
    from latentfusion_tpu_torch.pggan import MultiScaleDiscriminator
    from latentfusion_tpu_torch.recon import fusion
    from latentfusion_tpu_torch.recon.models import Photographer, Sculptor

    sculptor = Sculptor(in_size=GAN_INPUT_SIZE, projection_type="factor", input_color=True,
                        input_depth=False, input_mask=False, cube_size=1.0,
                        scale_mode="bilinear", **TOOL_SCULPTOR)
    photographer = Photographer(in_size=GAN_LATENT_SIZE, projection_type="factor",
                                occlusion_config=OPTION_UNET3D_CONFIG, predict_color=True,
                                predict_depth=True, predict_mask=True, cube_size=1.0,
                                scale_mode="bilinear", **TOOL_PHOTOGRAPHER)
    mods = {"sculptor": zoo.init_weights_(sculptor, generator).cuda(),
            "fuser": fusion.get_fuser("pool:max", TOOL_SCULPTOR["object_config"][-1], 1.0,
                                      generator=generator),
            "photographer": zoo.init_weights_(photographer, generator).cuda()}
    disc = MultiScaleDiscriminator(5, GAN_D_CONFIG, GAN_D_SCALES, generator=generator)
    return mods, disc


def gan_config(**extra):
    """The training tool's step settings (args.py:138-154): color, depth
    (L1) and mask (BCE) at 50, the mask beta prior at 1 (parameter 0.01),
    the GAN term at 1, instance noise std 0.2, the discriminator on color,
    depth and mask; the camera distance is its auto_camera_dist for 640x480
    renders."""
    from latentfusion_tpu_torch.recon.utils import optimal_camera_dist

    return dict(camera_dist=optimal_camera_dist(615.0, 480, 3 ** 0.5 / 2, slack=0.1),
                random_orientation=False, discriminator_input_color=True,
                discriminator_input_depth=True, discriminator_input_mask=True,
                g_gan_loss_weight=1.0, g_color_recon_loss_weight=50.0,
                g_color_recon_loss_type="l1", g_color_recon_loss_k=2000,
                g_depth_recon_loss_weight=50.0, g_depth_recon_loss_type="l1",
                g_depth_recon_loss_k=2000, g_mask_recon_loss_weight=50.0,
                g_mask_beta_loss_weight=1.0, g_mask_beta_loss_param=0.01,
                input_noise_std=0.2, **extra)


def gan_grads(step, mods, disc, batch, seed, noise_weight, rotations=None):
    """One step's generator loss and the generator's and the
    discriminator's gradients ("discriminator." names), with both
    optimizers SGD at learning rate 0 and the noise drawn from a generator
    seeded with ``seed``."""
    from latentfusion_tpu_torch.train import step as tstep

    sgd = tstep.make_optimizer("sgd", 0.0)
    state = tstep.init_gan_train_state(mods, sgd, disc, sgd if disc is not None else None)
    g = torch.Generator(device="cuda").manual_seed(seed)
    _, scalars = step(state, batch, g, rotations, noise_weight)
    nets = dict(mods, **({"discriminator": disc} if disc is not None else {}))
    return scalars["loss/generator/total"], {
        f"{name}.{pname}": p.grad.clone() for name, m in nets.items()
        for pname, p in m.named_parameters()}


def phase_option_shapes(fused_sample, seed):
    """K1-fwd and K1-bwd-vol against their plain versions at every shape of
    phase 11's paths: at flagship width the render of 128, a build of 16
    views (the Sculptor's camera intermediates of 128 and 256 channels and
    the Blend weights at one channel), the skip-connection decode of the
    16 views, and a training microbatch (4 objects x 8 input views: the
    Sculptor's sampling and the Blend weights; 4 objects x 32 views decoded
    with the input views reconstructed); and the training tool's default
    architecture, whose camera volumes are 32^3 (its microbatch: 4 objects
    x TRAIN_IN input and TRAIN_OUT output views). Returns the rows and the
    (op, volume, grids) held, which phase 11 checks its K1 calls against."""
    from latentfusion_tpu_torch import transforms, zoo
    from latentfusion_tpu_torch.camera import Camera
    from latentfusion_tpu_torch.recon.utils import process_batch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 13)
    objects = TRAIN_BATCH // TRAIN_MICROBATCHES
    obs = reference_views(0, dev)
    zoomed = obs.camera.zoom(None, zoo.FLAGSHIP_INPUT_SIZE, CAMERA_DIST)
    build = transforms.camera_to_object_grid(zoomed, 16)
    skip = transforms.object_to_camera_grid(zoomed, 16)
    render = transforms.object_to_camera_grid(
        hypothesis_cameras(obs, zoo.FLAGSHIP_INPUT_SIZE, CAMERA_DIST, g), 16)
    del obs, zoomed
    proc = process_batch(train_batch(g, objects), 1.0, train_config()["camera_dist"],
                         zoo.FLAGSHIP_INPUT_SIZE, generator=g)
    recon = Camera.vcat((proc["in_gt"]["camera"], proc["out_gt"]["camera"]),
                        batch_size=objects)
    grids = {"build": build, "skip": skip, "render": render,
             "train_encode": transforms.camera_to_object_grid(proc["in"]["camera"], 16),
             "train_recon": transforms.object_to_camera_grid(recon, 16)}
    del proc, recon
    gan = process_batch(train_batch(g, objects), 1.0,
                        gan_config()["camera_dist"], GAN_INPUT_SIZE, random_orientation=False)
    grids["gan_encode"] = transforms.camera_to_object_grid(gan["in"]["camera"], GAN_LATENT_SIZE)
    grids["gan_decode"] = transforms.object_to_camera_grid(gan["out_gt"]["camera"],
                                                           GAN_LATENT_SIZE)
    del gan
    n_in = objects * TRAIN_IN
    n_gan = objects * TRAIN_IN
    cases = (("fwd", "render of 128", 1, 256, "render"),
             ("fwd", "Sculptor camera->object, build of 16 views", 16, 128, "build"),
             ("fwd", "Sculptor camera->object, build of 16 views", 16, 256, "build"),
             ("fwd", "Blend weights, build of 16 views", 16, 1, "build"),
             ("fwd", "skip-connection decode of 16 views", 16, 256, "skip"),
             ("bwd_vol", "skip-connection decode of 16 views", 16, 256, "skip"),
             ("fwd", "Blend weights, training microbatch", n_in, 1, "train_encode"),
             ("bwd_vol", "Blend weights, training microbatch", n_in, 1, "train_encode"),
             ("fwd", "Sculptor camera->object, training microbatch", n_in, 128, "train_encode"),
             ("fwd", "Sculptor camera->object, training microbatch", n_in, 256, "train_encode"),
             ("bwd_vol", "Sculptor camera->object, training microbatch", n_in, 256,
              "train_encode"),
             ("fwd", "decode with the input views, training microbatch", objects, 256,
              "train_recon"),
             ("bwd_vol", "decode with the input views, training microbatch", objects, 256,
              "train_recon"),
             ("fwd", "tool default: Sculptor camera->object at 32^3", n_gan, 128, "gan_encode"),
             ("bwd_vol", "tool default: Sculptor camera->object at 32^3", n_gan, 128,
              "gan_encode"),
             ("fwd", "tool default: decode at 32^3", objects, 256, "gan_decode"),
             ("bwd_vol", "tool default: decode at 32^3", objects, 256, "gan_decode"))
    rows = []
    for op, label, nv, c, key in cases:
        grid = grids[key]
        size = grid.shape[1]
        vol = torch.randn(nv, c, size, size, size, generator=g, device=dev)
        gout = (None if op == "fwd" else
                torch.randn(grid.shape[0], c, *grid.shape[1:4], generator=g, device=dev))
        rows.append(k1_at(fused_sample, op, label, vol, grid, gout))
        del vol, gout
        torch.cuda.empty_cache()
    del grids, grid
    torch.cuda.empty_cache()
    return rows, {(r["op"], tuple(r["vol"]), r["grids"]) for r in rows}


def k2_at_shapes(lrelu_pnorm, shapes, seed) -> dict:
    """K2-fwd and K2-bwd against their plain versions at each shape of
    ``shapes``, fp32, on N(0, 1) inputs with every fourth site zero in all
    channels (a masked-out pixel through a zero bias: PixelNorm of a zero
    vector, inv 1/sqrt(eps)), each kernel run twice for the same bits.
    Returns the largest relative error of each."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for shape in shapes:
        x = torch.randn(shape, generator=g, device="cuda")
        x.view(shape[0], shape[1], -1)[:, :, ::4] = 0.0
        gy = torch.randn(shape, generator=g, device="cuda")
        (y, inv), (y2, _) = (lrelu_pnorm.lrelu_pixel_norm_fwd(x, 0.2, 1e-8) for _ in range(2))
        y_p, inv_p = lrelu_pnorm.lrelu_pixel_norm_plain(x, 0.2, 1e-8)
        dx, dx2 = (lrelu_pnorm.lrelu_pixel_norm_bwd(x, inv, gy, 0.2) for _ in range(2))
        dx_p = lrelu_pnorm.lrelu_pixel_norm_bwd_plain(x, inv_p, gy, 0.2)
        torch.cuda.synchronize()
        errs = {"fwd": rel_err(y, y_p), "bwd": rel_err(dx, dx_p)}
        worst = {k: max(worst[k], errs[k]) for k in worst}
        if not (max(errs.values()) <= FP32_TOL and torch.equal(y, y2) and torch.equal(dx, dx2)):
            fail(f"K2 at {shape} with zero sites disagrees with plain or repeats other "
                 f"bits: {errs}")
        del x, gy, y, y2, y_p, inv, inv_p, dx, dx2, dx_p
    torch.cuda.empty_cache()
    return worst


def check_k1_shapes(label, calls, held) -> None:
    say(f"  K1 calls in {label} (op, volume, grids: calls): "
        f"{json.dumps({str(k): v for k, v in calls.items()})}")
    missing = [k for k in calls if k not in held]
    if missing:
        fail(f"{label}: K1 ran at shapes phase 2 did not hold: {missing}")


@contextlib.contextmanager
def near_zero_sites(lrelu_pnorm, counts: dict):
    """Count K2-fwd's sites (a pixel or voxel across its channels) and those
    whose PixelNorm scale 1 / sqrt(mean x^2 + eps) exceeds NEAR_ZERO_INV
    into ``counts`` ("sites", "near_zero")."""
    fwd = lrelu_pnorm.lrelu_pixel_norm_fwd

    def spy(x, slope, eps):
        y, inv = fwd(x, slope, eps)
        counts["sites"] = counts.get("sites", 0) + inv.numel()
        counts["near_zero"] = counts.get("near_zero", 0) + int((inv > NEAR_ZERO_INV).sum())
        return y, inv

    with mock.patch.object(lrelu_pnorm, "lrelu_pixel_norm_fwd", spy):
        yield


def first_call_counted(fn, lrelu_pnorm, counts: dict):
    """``fn`` with its first call's near-zero PixelNorm sites counted."""
    calls = []

    def run():
        calls.append(None)
        if len(calls) > 1:
            return fn()
        with near_zero_sites(lrelu_pnorm, counts):
            return fn()
    return run


def snapshot(nets) -> tuple:
    """(parameters, gradients) of every named parameter of ``nets``, on the host."""
    named = [(f"{n}.{k}", p) for n, m in nets.items() for k, p in m.named_parameters()]
    return ({k: p.detach().cpu() for k, p in named},
            {k: p.grad.detach().cpu() for k, p in named if p.grad is not None})


def phase_gan(kernels, seed, held):
    """Phase 11 (a): the training tool's default architecture with the
    discriminator (``tool_models``) on phase 7's batches: TRAIN_BATCH
    objects in TRAIN_MICROBATCHES microbatches of TRAIN_IN + TRAIN_OUT views
    of 640x480, G and D on Adam (0, 0.99) at 1e-3.
    At the initial weights, on one object, the gradient check (kernels vs
    plain, G and D) with the backward-only floor, and the PixelNorm sites
    near zero. Two steps from the same state and batch, each started with
    the gradients, the optimizer state and the allocator's cache freed (at
    this peak, a step started with the last one's Adam state still held gave
    other bits, likely cuDNN's deterministic selection taking another
    algorithm for want of workspace): the first timed by CUDA
    events with its peak memory, the second profiled with its launches and
    its K1 and K2 shapes recorded, the discriminator's device time read
    from its trace, and gated to give the first's loss, gradient and
    parameter bits. Every loss finite. Returns the launch counts of the
    step."""
    from torch import nn

    from latentfusion_tpu_torch.train import step as tstep
    from latentfusion_tpu_torch.utils import ExponentialScheduler

    fused_sample, lrelu_pnorm = kernels
    gen = torch.Generator().manual_seed(seed + 11)
    mods, disc = tool_models(gen)
    nets = dict(mods, discriminator=disc)
    config = gan_config()
    noise_weight = ExponentialScheduler(1.0, 1e-4, 1000).get(0)
    args = (mods["sculptor"], mods["fuser"], mods["photographer"], disc)
    step = tstep.make_recon_train_step(*args, config=config,
                                       num_microbatches=TRAIN_MICROBATCHES)
    step_one = tstep.make_recon_train_step(*args, config=config, num_microbatches=1)
    g = torch.Generator(device="cuda").manual_seed(seed + 12)
    t0 = time.perf_counter()
    batch = train_batch(g)
    one = train_batch(g, 1)
    torch.cuda.synchronize()
    say(f"  oracle batches of {TRAIN_BATCH} and 1 objects x ({TRAIN_IN} + {TRAIN_OUT}) views of "
        f"640x480 rendered in {time.perf_counter() - t0:.2f} s")
    params = sum(p.numel() for m in nets.values() for p in m.parameters())
    say(f"  parameters: generator {sum(p.numel() for m in mods.values() for p in m.parameters())}"
        f", discriminator {sum(p.numel() for p in disc.parameters())} ({params} in all)")

    near = {}
    gradient_check(
        "GAN step on one object of the batch, at the initial weights",
        first_call_counted(lambda: gan_grads(step_one, mods, disc, one, seed, noise_weight),
                           lrelu_pnorm, near),
        nn.ModuleList(nets.values()), kernels,
        noise_only={f"discriminator.{k}" for k in disc.cancelled_parameters()}
        | {f"photographer.{k}" for k in mods["photographer"].cancelled_parameters()},
        ill_conditioned=True)
    say(f"    K2-fwd sites (pixels or voxels) with inv > {NEAR_ZERO_INV:g} in that step: "
        f"{near['near_zero']} of {near['sites']}")
    del one

    start_state = {n: {k: v.detach().cpu() for k, v in m.state_dict().items()}
                   for n, m in nets.items()}
    adam = tstep.make_optimizer("adam", 1e-3)
    runs, calls, k2 = [], {}, {}
    for run in ("timed", "profiled"):
        state = None
        for n, m in nets.items():
            m.load_state_dict(start_state[n])
            m.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = tstep.init_gan_train_state(mods, adam, disc, adam)
        holder = {}

        def one_step():
            holder.update(scalars=step(state, batch, torch.Generator(device="cuda").manual_seed(
                seed), None, noise_weight)[1])

        if run == "timed":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            one_step()
            end.record()
            torch.cuda.synchronize()
            step_ms, peak_gb = start.elapsed_time(end), torch.cuda.max_memory_allocated() / 1e9
        else:
            reset_counters(kernels)
            say("  the same GAN step, device time by kernel:")
            averages, events = profile_step(lambda: calls.update(record_k1(
                fused_sample, lambda: k2.update(shapes=record_step(
                    one_step, keep_resizes=False)[0]))))
            counts = read_counters(kernels)
        runs.append((snapshot(nets), {k: float(v) for k, v in holder["scalars"].items()}))
    state = None
    del start_state

    def parted(a, b):
        (params_a, grads_a), scalars_a = a
        (params_b, grads_b), scalars_b = b
        names = [k for k in params_a if not (torch.equal(params_a[k], params_b[k]) and (
            grads_a.keys() == grads_b.keys() and (k not in grads_a
                                                  or torch.equal(grads_a[k], grads_b[k]))))]
        return names + [k for k in scalars_a if scalars_a[k] != scalars_b[k]]

    parted_runs = parted(runs[0], runs[1])
    scalars = runs[0][1]
    del runs
    total = sum(e.self_device_time_total for e in averages
                if e.device_type == DeviceType.CUDA) / 1e3
    d_ms = range_device_ms(events, tstep.DISCRIMINATOR_RANGE)
    del averages, events
    losses = {k.split("loss/")[-1]: v for k, v in scalars.items()}
    say(f"  GAN step (global batch {TRAIN_BATCH}, {TRAIN_MICROBATCHES} microbatches, Adam) "
        f"{step_ms:.1f} ms (CUDA events), peak memory {peak_gb:.2f} GB (max_memory_allocated, "
        f"the batch included); device time in the profiled step {total:.1f} ms, the "
        f"discriminator's ops and their backward {d_ms:.1f} ms ({d_ms / total:.4f} of it); "
        f"the profiled step the timed one's loss, gradient and parameter bits "
        f"{not parted_runs} ({len(parted_runs)} parted"
        f"{', first ' + parted_runs[0] if parted_runs else ''}); launches "
        f"{json.dumps(counts)}; losses {json.dumps(losses)}")
    check_k1_shapes("one GAN step", calls, held)
    if parted_runs:
        fail("GAN step: two steps from the same state and batch gave other bits")
    if not all(counts[k] > 0 for k in ("K1", "K1bv", "K2", "K2b")):
        fail(f"GAN step: a kernel was not launched on the step: {counts}")
    if not all(np.isfinite(v) for v in losses.values()):
        fail("GAN step: a loss is not finite")
    k2_errs = k2_at_shapes(lrelu_pnorm, sorted(k2["shapes"]), seed)
    say(f"  K2 calls in one GAN step by shape (forward, backward): "
        f"{json.dumps({str(k): v for k, v in sorted(k2['shapes'].items())})}; K2-fwd and K2-bwd "
        f"at each, a quarter of the sites zero, against plain: largest rel err "
        f"{json.dumps(k2_errs)} (tol {FP32_TOL}), twice the same bits")
    del batch, mods, disc, nets
    torch.cuda.empty_cache()
    return counts


def phase_options(kernels, seed, held):
    """Phase 11 (b): the options at the flagship width. The Blend and LSTM
    fusers each build o0 from 16 views and render 128 hypotheses (phase 3's
    rig, against the plain versions); one Blend training step (phase 7's
    batch, generator_input_depth, reconstruct_input, RMSprop) and the same
    step with remat: the same gradient and parameter bits, peak memory of
    each; skip connections: the 16 views decoded at their own cameras from
    the Sculptor's intermediates, forward and backward, against the plain
    versions. Every K1 call recorded must be a shape phase 2 held. Returns
    the launch counts by path."""
    from torch import nn

    from latentfusion_tpu_torch import zoo
    from latentfusion_tpu_torch.augment import gan_normalize
    from latentfusion_tpu_torch.recon import fusion
    from latentfusion_tpu_torch.recon.inference import LatentFusionModel
    from latentfusion_tpu_torch.recon.models import Photographer, Sculptor
    from latentfusion_tpu_torch.three import quaternion
    from latentfusion_tpu_torch.train import step as tstep

    fused_sample = kernels[0]
    gen = torch.Generator().manual_seed(seed + 14)
    sculptor = zoo.flagship_sculptor(generator=gen)
    photographer = zoo.flagship_photographer(generator=gen)
    out = {}
    for label, fuser in (("blend", fusion.get_fuser("blend", 256, 1.0,
                                                    block_config=OPTION_UNET3D_CONFIG,
                                                    generator=gen)),
                         ("lstm", fusion.get_fuser("lstm", 256, 1.0, generator=gen))):
        model = LatentFusionModel(sculptor, None, fuser, None, photographer, None,
                                  camera_dist=CAMERA_DIST)
        counts = {}
        calls = record_k1(fused_sample, lambda: counts.update(
            drive_slice(f"{label} fuser", model, [("o0", 0)], kernels, seed, profile=False)))
        check_k1_shapes(f"the {label} build and render", calls, held)
        out[f"{label}_build_render"] = counts["o0"]
        del model, fuser
    torch.cuda.empty_cache()

    # One Blend training step from the same state, without and with remat.
    kw = dict(in_size=zoo.FLAGSHIP_INPUT_SIZE, image_config=zoo.SCULPTOR_IMAGE_CONFIG,
              camera_config=zoo.SCULPTOR_CAMERA_CONFIG, object_config=zoo.SCULPTOR_OBJECT_CONFIG,
              projection_type="factor", input_color=True, input_depth=True, input_mask=True,
              cube_size=1.0, scale_mode="nearest")
    mods = {"sculptor": zoo.init_weights_(Sculptor(**kw), gen).cuda(),
            "fuser": fusion.get_fuser("blend", 256, 1.0, block_config=OPTION_UNET3D_CONFIG,
                                      generator=gen),
            "photographer": zoo.flagship_photographer(generator=gen)}
    start_state = {n: {k: v.clone() for k, v in m.state_dict().items()} for n, m in mods.items()}
    g = torch.Generator(device="cuda").manual_seed(seed + 15)
    batch = train_batch(g)
    rotations = [quaternion.random(1, g) for _ in range(TRAIN_MICROBATCHES)]
    config = dict(train_config(), generator_input_depth=True, reconstruct_input=True)
    results = {}
    for remat in (False, True):
        for n, m in mods.items():
            m.load_state_dict(start_state[n])
        step = tstep.make_recon_train_step(mods["sculptor"], mods["fuser"], mods["photographer"],
                                           config=dict(config, remat=remat),
                                           num_microbatches=TRAIN_MICROBATCHES)
        state = tstep.init_train_state(mods, tstep.make_optimizer("rmsprop", 1e-3))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters(kernels)
        holder = {}
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        calls = record_k1(fused_sample, lambda: holder.update(scalars=step(
            state, batch, torch.Generator(device="cuda").manual_seed(seed), rotations)[1]))
        end.record()
        torch.cuda.synchronize()
        results[remat] = dict(
            ms=start.elapsed_time(end), peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            counts=read_counters(kernels), scalars=holder["scalars"],
            grads={f"{n}.{k}": p.grad.clone() for n, m in mods.items()
                   for k, p in m.named_parameters()},
            params={f"{n}.{k}": p.detach().clone() for n, m in mods.items()
                    for k, p in m.named_parameters()})
        check_k1_shapes(f"the Blend training step{' with remat' if remat else ''}", calls, held)
    plain, remat = results[False], results[True]
    same_grads = all(torch.equal(plain["grads"][k], remat["grads"][k]) for k in plain["grads"])
    same_params = all(torch.equal(plain["params"][k], remat["params"][k])
                      for k in plain["params"])
    losses = {k.split("loss/")[-1]: float(v) for k, v in plain["scalars"].items()}
    say(f"  Blend training step (global batch {TRAIN_BATCH}, {TRAIN_MICROBATCHES} "
        f"microbatches, {TRAIN_IN} + {TRAIN_OUT} views, the input views reconstructed, the "
        f"noisy depth input, RMSprop): {plain['ms']:.1f} ms, peak memory "
        f"{plain['peak_gb']:.2f} GB, launches {json.dumps(plain['counts'])}; with remat "
        f"{remat['ms']:.1f} ms, peak {remat['peak_gb']:.2f} GB, launches "
        f"{json.dumps(remat['counts'])}; the same gradient bits {same_grads}, the same "
        f"parameters after RMSprop {same_params}; losses {json.dumps(losses)} (first "
        f"step, not warmed up)")
    if not (same_grads and same_params):
        fail("Blend training step: remat gave other bits")
    if not all(np.isfinite(v) for v in losses.values()):
        fail("Blend training step: a loss is not finite")
    if not all(plain["counts"][k] > 0 for k in ("K1", "K1bv", "K2", "K2b")):
        fail(f"Blend training step: a kernel was not launched: {plain['counts']}")
    out["blend_train_step"] = plain["counts"]
    del results, plain, remat, mods, batch, start_state
    torch.cuda.empty_cache()

    # Skip connections: 16 views of o0 decoded at their own cameras.
    model = LatentFusionModel(sculptor, None, zoo.flagship_fuser(generator=gen), None,
                              photographer, None, camera_dist=CAMERA_DIST)
    obs = model.preprocess_observation(reference_views(0, model.device))
    skip = Photographer(in_size=zoo.FLAGSHIP_INPUT_SIZE // 16,
                        image_config=zoo.PHOTOGRAPHER_IMAGE_CONFIG,
                        camera_config=zoo.PHOTOGRAPHER_CAMERA_CONFIG, object_config=None,
                        projection_type="factor", skip_connections=True, predict_color=False,
                        predict_depth=True, predict_mask=True, cube_size=1.0,
                        scale_mode="nearest")
    skip = zoo.init_weights_(skip, gen).cuda()
    with torch.no_grad():
        z, z_cam_mid, z_obj_mid = sculptor(
            torch.cat((obs.color, gan_normalize(obs.mask)), dim=1), obs.camera,
            camera_intermediates=True)
    # The one camera block reads the last intermediate only.
    inputs = [z, z_cam_mid[-1]]
    for t in inputs:
        t.requires_grad_(True)
    r = None

    def grads_fn():
        nonlocal r
        logits, _, _ = skip(z, obs.camera, z_cam_mid, z_obj_mid)
        if r is None:
            r = torch.randn(logits.shape, generator=torch.Generator(device="cuda").manual_seed(
                seed), device="cuda")
        names = [f"photographer.{k}" for k, _ in skip.named_parameters()] + [
            "z", "z_cam_mid.-1"]
        loss = (logits * r).sum()
        grads = torch.autograd.grad(loss, [p for _, p in skip.named_parameters()] + inputs)
        return loss.detach(), dict(zip(names, grads))

    reset_counters(kernels)
    calls = record_k1(fused_sample, grads_fn)
    out["skip_decode"] = read_counters(kernels)
    check_k1_shapes("the skip-connection decode", calls, held)
    say(f"  skip-connection decode of 16 views (z {tuple(z.shape)}, intermediates "
        f"{[tuple(t.shape) for t in z_cam_mid]}), forward and backward: launches "
        f"{json.dumps(out['skip_decode'])}")
    if not all(out["skip_decode"][k] > 0 for k in ("K1", "K1bv", "K2", "K2b")):
        fail(f"skip connections: a kernel was not launched: {out['skip_decode']}")
    gradient_check("skip-connection decode", grads_fn, skip, kernels)
    del z, z_cam_mid, z_obj_mid, inputs, obs, model, skip, sculptor, photographer
    torch.cuda.empty_cache()
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--accuracy-seeds", type=int, nargs="+", default=None,
                        help="build the kernels, run phase 6's three accuracy rigs "
                             "(CEM, Metropolis, estimate_batch) ungated at each seed, "
                             "print the hits and exit")
    parser.add_argument("--with-unseen", action="store_true",
                        help="with --accuracy-seeds, also run phase 9's unseen-object rig "
                             "ungated at each seed")
    parser.add_argument("--unseen-latent-rank", action="store_true",
                        help="phase 9 also runs the rig with the latent ranking term at 0.2 "
                             "(ungated)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() is "
              "False", file=sys.stderr)
        sys.exit(2)

    from latentfusion_tpu_torch import zoo
    from latentfusion_tpu_torch.ops import _build, fused_sample, lrelu_pnorm
    from latentfusion_tpu_torch.recon.checkpoint import (from_jax_params,
                                                         load_params_npz,
                                                         split_state_dict)
    from latentfusion_tpu_torch.recon.inference import LatentFusionModel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    kernels = (fused_sample, lrelu_pnorm)
    objects = [("o0", 0), ("o1", 1)]
    t_start = time.perf_counter()

    say("== phase 1/11: device, kernel build, reference views")
    smi, build_s = phase_device(_build)
    say(f"   device: {torch.cuda.get_device_name(0)}; kernels built in {build_s:.2f} s")
    check_reference_views(torch.device("cuda"))
    state = split_state_dict(from_jax_params(load_params_npz(
        DISTILL / "encoder_distill.npz", DISTILL / "encoder_distill_keys.json")))

    def demo_model():
        return LatentFusionModel(zoo.demo_sculptor(), state["sculptor"],
                                 zoo.demo_fuser(), state["fuser"],
                                 zoo.demo_photographer(), state["photographer"],
                                 camera_dist=zoo.DEMO_CAMERA_DIST)

    demo = demo_model()
    if args.accuracy_seeds is not None:
        table = {}
        for seed in args.accuracy_seeds:
            say(f"== phase 6 at seed {seed}")
            table[seed] = phase_pose_accuracy(demo, kernels, seed, checks=False)[1]
            if args.with_unseen:
                say(f"== phase 9 at seed {seed}")
                passes = phase_unseen(kernels, seed, None, checks=False,
                                      latent_rank=args.unseen_latent_rank)
                table[seed].update({f"unseen {k}": sum(v["hits"]) for k, v in passes.items()
                                    if k != "mid"})
        say(f"   hits by seed (phase 6 of 8, phase 9 of 24), {smi}: {json.dumps(table)} "
            f"({time.perf_counter() - t_start:.1f} s)")
        return

    say("== phase 2/11: kernels against their plain versions")
    records, k1_table, k2f_tables = phase_kernels(fused_sample, lrelu_pnorm, args.seed)
    bwd_records, k2b_table = phase_bwd_kernels(fused_sample, lrelu_pnorm, args.seed)
    records.update(bwd_records)
    train_records, bwd_vol_rows = phase_train_kernels(fused_sample, args.seed)
    records.update(train_records)
    k3 = phase_k3_shape(fused_sample, args.seed)
    new_rows, held = phase_new_shapes(fused_sample, args.seed)
    option_rows, option_held = phase_option_shapes(fused_sample, args.seed)
    say(f"   kernels: {json.dumps({k: {m: v[m] for m in ('ms', 'plain_ms', 'bound_ms', 'library_ms')} for k, v in records.items()})}")
    say(f"   K1-fwd by shape (kernel that served it): "
        f"{json.dumps([{m: r[m] for m in ('shape', 'kernel', 'ms', 'bound_ms', 'plain_ms', 'library_ms')} for r in k1_table + [k3['K1-fwd'], k3['K1-fwd gather']]])}")
    say(f"   K1 at K3's shape: {json.dumps(k3)}")
    say(f"   K1-bwd-vol at the training shapes: {json.dumps(bwd_vol_rows)}")
    say(f"   K1 at the multi-object and latent shapes: {json.dumps(new_rows)}")
    say(f"   K1 at phase 11's shapes: {json.dumps(option_rows)}")

    say(f"== phase 3/11: flagship build from 16 views + render of {N_HYPOTHESES}")
    gen = torch.Generator().manual_seed(args.seed)
    flagship = LatentFusionModel(zoo.flagship_sculptor(generator=gen), None,
                                 zoo.flagship_fuser(generator=gen), None,
                                 zoo.flagship_photographer(generator=gen), None,
                                 camera_dist=CAMERA_DIST)
    counts = drive_slice("flagship", flagship, objects, kernels, args.seed,
                         profile=True)
    say(f"   flagship launches per object: {json.dumps(counts)}")
    build_launches(flagship, kernels)

    say(f"== phase 4/11: demo family, learned weights, render of {N_HYPOTHESES}")
    demo_counts = drive_slice("demo", demo, objects, kernels, args.seed,
                              profile=False)
    say(f"   demo launches per object: {json.dumps(demo_counts)}")

    say("== phase 5/11: flagship pose of view 15 of o0: CEM "
        "(cross_entropy_quick) then refinement (adam_quick); then the latent path "
        "(cross_entropy_latent, adam_latent)")
    pose_counts = phase_pose_flagship(flagship, kernels, args.seed, {
        "fwd": k2f_tables["refinement step"], "bwd": k2b_table})
    say(f"   pose path launches: {json.dumps(pose_counts)}")
    latent_cem, latent_refine = phase_latent_flagship(flagship, kernels, args.seed, held)
    say(f"   latent path launches: CEM {json.dumps(latent_cem)}, refinement "
        f"{json.dumps(latent_refine)}")
    torch.cuda.empty_cache()

    say("== phase 6/11: pose accuracy, demo family, learned weights, 8 oracle targets: "
        "CEM, Metropolis, estimate_batch")
    accuracy_counts, _ = phase_pose_accuracy(demo, kernels, args.seed)
    del demo
    torch.cuda.empty_cache()

    say(f"== phase 7/11: flagship training step, global batch {TRAIN_BATCH} in "
        f"{TRAIN_MICROBATCHES} microbatches, {TRAIN_IN} + {TRAIN_OUT} views")
    train_counts = phase_train(kernels, args.seed)
    say(f"   training step launches: {json.dumps(train_counts)}")

    say("== phase 8/11: the pose service at flagship width, two rounds of requests")
    service_counts = phase_service(flagship, kernels, args.seed)
    say(f"   service launches, warm round: {json.dumps(service_counts)}")
    del flagship
    torch.cuda.empty_cache()

    say(f"== phase 9/11: unseen objects, pool-128 checkpoint, {UNSEEN_OBJECTS} held-out objects "
        f"x {UNSEEN_TARGETS} targets in estimate_batch; then the mid width")
    t9 = time.perf_counter()
    unseen = phase_unseen(kernels, args.seed, held, latent_rank=args.unseen_latent_rank)
    say(f"   unseen objects: {sum(unseen['demo']['hits'])} of "
        f"{UNSEEN_OBJECTS * UNSEEN_TARGETS} within 0.1d (gate {UNSEEN_GATE}); phase 9 took "
        f"{time.perf_counter() - t9:.1f} s on {smi}")

    say("== phase 10/11: the reconstruction API, demo family, learned weights: 16 oracle "
        "views through save + load, render_full, render_ibr_basic and render_ibr at 8 targets")
    t10 = time.perf_counter()
    recon_counts = phase_recon(demo_model(), kernels, args.seed)
    say(f"   reconstruction launches: {json.dumps(recon_counts)}; phase 10 took "
        f"{time.perf_counter() - t10:.1f} s on {smi}")

    options = phase_eleven(kernels, args.seed, option_held, smi)

    total = time.perf_counter() - t_start
    say(f"   total {total:.1f} s on {smi}")
    paths = {"pose": pose_counts, "train_step": train_counts,
             "latent_cem": latent_cem, "latent_refine": latent_refine,
             "metropolis_8_targets": accuracy_counts["Metropolis"],
             "estimate_batch_8_targets": accuracy_counts["batch"],
             "service_warm_round": service_counts,
             "unseen_demo_batches": unseen["demo"]["counts"],
             "unseen_mid_round": unseen["mid"]["counts"],
             "reconstruction": recon_counts, **options}
    for key in records:
        records[key]["launches_by_path"] = {path: c[key] for path, c in paths.items()}
        records[key]["launches"] = train_counts[key] if key == "K1bv" else pose_counts[key]
    say(json.dumps({"kernels": [records[k] for k in ("K1", "K1b", "K1bv", "K2", "K2b")]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
