"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--unseen-latent-rank]
                          [--accuracy-seeds N [N ...] [--with-unseen]]
                          [--eval-variants] [--parallel-only] [--tools-only]

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
   each against its plain version, twice for the same bits, and timed;
   and K1-fwd and K1-bwd-vol at phase 13's shapes (the recipe's decode and
   encode at batch 8 in bf16 and fp32, train_ibr's fp32 encode and
   decode), in their dtypes; and K1's kernels at the shapes and dtypes of
   phase 6's metropolis_eval run and phase 14's legs that no other row
   holds (EVAL_K1_SHAPES: the demo family's 8^3 latents, bf16 in
   metropolis_eval and serving_accuracy's in-process half); and K2-fwd and
   K2-bwd at the PGGAN generator's 6 shapes (phase 15 (e)), as the
   refinement step's table.
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
   kernels, the refinement run again from the same coarse cameras for its
   first LATENT_REPEAT_STEPS steps must give the same loss-history bits (a
   cut for time: the whole 150 before), one step's K1 calls must be shapes phase 2 held, and one
   step must agree with the plain versions; ms per step, peak memory and
   a profile of one step.
6. pose accuracy, demo family with the learned weights: the latent of 16
   shaded views of the analytic ellipsoid, then all 8 seeded target poses
   as one ``estimate_batch`` of CEM and refinement (fp32); ADD-S within a
   tenth of the diameter on at least 7. One refinement step (the first
   target's coarse cameras) must agree with the plain versions. Then
   ``metropolis_eval.main`` at the JAX record's budget (bf16, JAX's
   cameras from eval_cameras.json): CEM and the Metropolis estimator (128
   chains, 300 iterations) as the coarse stage, refinement 16 x 150, each
   at least 7 of 8, beside the record's 8 of 8; every K1 call at a shape
   and dtype phase 2 held. ``--accuracy-seeds`` runs only the seed-drawn
   rigs (CEM, Metropolis, estimate_batch), ungated, at each seed given.
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
   kernel and with the atomic kernel it replaced. (To make room for
   phase 15 these two timings take one step of each after a warm-up, where
   they took two steps a turn in four turns.)
8. the pose service (latentfusion_tpu_torch/serve.py) at flagship width,
   weights from --seed: a round of ping, register o0 and o1 (views 0-14),
   estimates of view 15 of o0, of that frame twice and of o0 and o1
   together, a malformed line, an unknown command and a shutdown, through
   ``serve_lines``, then a warm round of o0's requests alone. The responses must be the protocol's, the single
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

12. the data path: (a) tools/train_unseen_real.py's training stream
   (:197-212) at phase 7's sizes: 32 lobe meshes of pool seed 0 (32 x 64 a
   lobe), 48 procedural textures and 24 backgrounds (PNG), random
   materials, textures and color backgrounds, mask corruption p 0.25, color
   noise 0.05, size jitter (0.6, 1.0), 8 + 24 views of 640x480 an item,
   global batch 8. The compiled rasterizer must agree with its numpy twin on
   one view; the loader's items a second at 1 worker and at min(cpus, 16)
   workers; a batch pinned and copied to the card, and its quantised
   transport widened on the card, must equal the host's arrays bit for
   bit (bytes per batch both ways). Then phase 7's flagship step (weights
   N(0, 1) from --seed) on a loader batch (the quantised transport): two
   steps from the same state and batch the same loss and gradient bits,
   launching K1-fwd, K1-bwd-vol, K2-fwd and K2-bwd at K1 shapes phase 2
   held (the loader-fed steps are phase 13's). (b) latentfusion_tpu_torch/unseen_real.py's
   rig on artifacts/unseen_real/unseen_real.npz: held-out objects 0-3 of
   lobe pool seed 7919 as meshes (48 x 96 a lobe) rasterized at the 16
   reference and 6 target cameras of unseen_cameras.json, each target index
   one ``estimate_batch`` at the record's budget (CEM 128 x 10, 48 elites,
   refinement 16 x 150, latent ranking 0.2); at least 13 of 24 within 0.1d
   (run 3's JAX record, 16, less 3), every K1 call a shape phase 2 held;
   render seconds, seconds and peak memory per batch. ``--with-unseen``
   runs (b) ungated at each of --accuracy-seeds too.
13. the trainer: (a) ``train_reconstruct.main`` on tools/train.sh's flags
   verbatim (bf16 ``--use-amp``, batch 8, 8 + 24 views, the GRU fuser, no
   discriminator, 5 workers) but for the dataset (phase 12's 32 lobe
   meshes), the texture and background banks (tests/data/jpeg_bank, the
   JAX package's procedural JPEGs) and 1 epoch of 2 batches (cut from 2
   epochs to make room for phase 15); then
   ``--resume`` from its epoch-latest checkpoint with ``--branch`` for one
   epoch of 1 batch (2 batches before phase 15 came). Per iteration: the step's ms by CUDA events, ``time/data_load``,
   launches (K1-fwd, K1-bwd-vol, K2-fwd and K2-bwd must run, every K1 call
   in bf16 at a shape phase 2 held in bf16); peak memory; every loss
   finite; the device's idle share over 2 loader-fed iterations (3
   before phase 15 came); the loss
   of one loader batch in fp32 against bf16 (RECIPE_BF16_LOSS_TOL, the CPU
   test's bound; the same bits fail); the exported ``.pth`` through ``LatentFusionModel.from_checkpoint``,
   o0 built and 128 hypotheses rendered against the plain versions (as
   phase 3). (b) ``train_ibr.main`` on that ``.pth`` at the tool's defaults
   (blend_flow, the published generator config, the discriminator; batch 8
   of 16 + 8 views), 2 iterations: ms, peak memory, launches, losses
   finite (K1-fwd, K2-fwd and K2-bwd must run). (c) ``train_unseen_real.main``
   with 8 workers, two chunks of 10 steps (20 before phase 15 came; demo
   family, 6 + 8 views of
   256x192, 32 meshes), then the encoder-distill and unseen-objects rigs
   (6 steps each, the first with one evaluation target): s per step, a
   finite loss, each npz read back by the evaluation half's loader.

14. the evaluation harnesses, demo family with the learned weights,
   written as a reference-schema ``.pth`` (read back bit for bit): (a)
   ``evaluate_bop.main`` on a LINEMOD-layout scene of the ellipsoid (40
   frames at 640x480, the checkpoint's f 615: at LINEMOD's camera it
   misses in JAX too, PERF.md §6; PNGs by png.py), 16 reference
   views, 8 frames in one ``--batch-frames 8`` run (ADD-S 0.1d on at least
   6) and one frame alone; (b) ``poserbpf_comparison.main`` on the
   committed synthetic MOPED capture (tests/data/moped_synth), refining
   with configs/adam_track.toml (adam_quick at lr 1e-3), 8 tracked frames,
   ADD-S 0.1d against the ellipsoid's points on at least 6; (c)
   ``serving_accuracy.main`` at its defaults (2 held-out objects of
   pool-128, 3 rounds, latent ranking 0.2): ``estimate_batch`` (bf16) on
   at least 4 of 6, the service process on at least 5 of 6, beside JAX's
   records (5 and 6); (d) ``examples.pose_estimation`` on the built-in
   cube and ``examples.reconstruction`` (its PNG read back, 5 row bands:
   the IBR color drawn). Each leg: s,
   peak memory, launches (K1-fwd, K1-bwd-grid, K2-fwd and K2-bwd must run,
   but K1-bwd-grid and K2-bwd in the reconstruction example; K1-bwd-vol
   in (c)), every K1 call at a shape and dtype phase 2 held.
   ``--eval-variants`` runs (a) and (b) alone under the settings they do
   not run, ungated (phase_eval_variants).

15. the parallel layer (latentfusion_tpu_torch/parallel). The machine has
   one card: 2 ranks, spawned as ``chip_smoke.py --rank-worker`` processes,
   share it over gloo (a file:// rendezvous in _build/parallel), which
   carries CUDA tensors for all_reduce and broadcast; FSDP, which needs
   reduce_scatter and all_gather, runs on a one-rank NCCL mesh (FSDP_RANKS;
   two FSDP ranks are tests/test_torch_parallel.py's). (a) The recipe's step
   (RECIPE_FLAGS' architecture, weights N(0, 1) from --seed, bf16, Adam at
   the tool's rate), 2 steps on 2 global batches of phase 7's (8 objects,
   8 + 24 views) at 2 ranks, each on its slice, against one process on the
   same batches: the losses and the parameters after the steps within 3x
   the step's noise floor (every convolution's output times (1 + eps
   N(0, 1)) in bf16, eps PARALLEL_FLOOR_EPS), the ranks' parameters the same
   bits, K1-bwd-vol and K2-bwd launched on each rank. (b) The same steps
   with the modules sharded by ``parallel.shard_fsdp`` on that one-rank
   mesh, the same gate. (c) The demo ``.pth`` (phase 14's) on phase 6's
   oracle: CEM (cross_entropy_quick), refinement (adam_quick, 3 steps),
   Metropolis (32 chains, 20 iterations) and a two-object refinement
   ``estimate_batch`` with the hypotheses sharded over the 2 ranks, against
   one process (tests/test_parallel.py's tolerances: loss histories 1e-5,
   poses 1e-4; CEM's top camera, or its ADD-S 0.1d outcome where ranking
   ties move it), the ranks' estimates the same bits. (d) The flagship
   Photographer's decode of 128 hypotheses with its convolutions' weights
   cut over the 2 ranks (``parallel.shard_tp``) against the unsharded
   decode: depth and mask within tests/test_parallel.py's 1e-5 of the
   largest value, the ranks' outputs the same bits. (e) The PGGAN EncoderDecoder at
   DEFAULT_BLOCK_CONFIG, forward and backward on 4 images of 256^2 through
   K2 against the plain K2 path (NET_TOL), its K2 calls the rows phase 2
   holds (generator_k2_calls); then ``poserbpf_comparison --video`` for 2
   frames of the MOPED capture, its PNG frames read back at 240x320. s per
   leg, ms per step and per decode beside the unsharded ones.
   ``--parallel-only`` runs phase 15 alone (with phase 2's generator rows
   and phase 14's ``.pth``).

16. the measurement tools, each through its ``main`` with an argv in this
   process (traces under _build/tools): ``profile_refinement`` at its
   defaults (the flagship family with random weights in bf16, Adam on 8
   hypotheses for 20 steps, one estimate traced) and ``profile_cem`` at
   128 samples x 10 iterations (its top 15 ops), each printing its trace's
   top device ops in the JAX tool's format; ``profile_decode``;
   ``bench_sampler`` on the backends cuda, plain and aten;
   ``bench_fuser``; ``bench_loader`` at its defaults (640x480, 8 + 24
   views, 2 workers, batch 2). Gates: every tool returns and prints its
   lines in the JAX tool's format; each profiler's trace names K1-fwd's
   and K2-fwd's kernels (``fused_sample_fwd_staged_kernel``,
   ``lrelu_pnorm_fwd_kernel``), and refinement's also K1-bwd-grid's and
   K2-bwd's, each launched as many times as its launch counter rose over
   the traced call, and no ``aten::grid_sampler_3d`` on either lane;
   bench_sampler's cuda and plain loops' accumulators agree within
   BF16_TOL, relative, in each mode. Each profiler's traced window's
   device-busy share is printed, and each tool's seconds.
   ``--tools-only`` builds the kernels and runs phase 16 alone.

Then one ``kernels`` JSON line (each kernel's launches on the main path of
the slice that ported it: phase 5's pose path, phase 7's training step for
K1-bwd-vol; ``launches_by_path`` has every path, phases 10-16's too). The last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero, as does a
machine without a GPU. TF32 is off throughout, so kernel and plain paths
compare in fp32.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
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
LATENT_REPEAT_STEPS = 25  # phase 5's latent refinement repeat (150 before)
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
# The kernels a step that trains the Sculptor must launch (phases 7, 11
# (a) and (b), 12 (a), and 13's recipe and rigs).
TRAIN_STEP_KERNELS = ("K1", "K1bv", "K2", "K2b")
# The pool run: 7 steps, the held-out loss at steps 0 and 6 (12 and 10
# until the evaluation harnesses' phase 14 needed the time).
TRAIN_POOL, TRAIN_STEPS, TRAIN_EVERY = 3, 7, 6
TRAIN_TIMED = 5  # steps timed with CUDA events, after 2 warm-up steps
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


T_START = time.perf_counter()


def say(*parts) -> None:
    if parts and str(parts[0]).startswith("== phase"):
        parts = (*parts, f"(at {time.perf_counter() - T_START:.1f} s)")
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
    from latentfusion_tpu_torch.utils import profiling

    for _ in range(warmup):
        fn()
    return profiling.elapsed_ms(lambda: [fn() for _ in range(iters)], "cuda") / iters


NO_DEVICE_RECORDS = "no CUDA activity"  # utils.profiling.profile's error for such a session


def profiled(fn, profile_memory: bool = False):
    """One call of ``fn`` under ``utils.profiling.profile``; returns the
    profiler. A profiler session on this machine now and then keeps no
    device records (``profile`` raises): the call is not repeated (it may
    change state), the loss is said, and the tables read no device time."""
    from latentfusion_tpu_torch.utils import profiling

    try:
        with profiling.profile(device="cuda", profile_memory=profile_memory) as prof:
            fn()
    except RuntimeError as err:
        if NO_DEVICE_RECORDS not in str(err):
            raise
        say("  (the profiler kept no device records of this call: its device times read 0)")
    return prof


def time_ms(fn, iters: int = 10, warmup: int = 2, sessions: int = 5) -> float:
    """Device ms per call of ``fn``: the summed device time of the kernels
    it launches (torch.profiler through ``utils.profiling``), warm-up
    excluded. A wrapper's host time (tens of microseconds a call) would
    hide a short kernel from CUDA events timed back to back. A profiler
    session that keeps no device records (see ``profiled``) raises; the
    calls are then profiled again, up to ``sessions`` times in all."""
    from latentfusion_tpu_torch.utils import profiling

    for _ in range(warmup):
        fn()
    for session in range(sessions):
        torch.cuda.synchronize()
        try:
            with profiling.profile(device="cuda") as prof:
                for _ in range(iters):
                    fn()
            return profiling.device_ms(prof) / iters
        except RuntimeError as err:
            if NO_DEVICE_RECORDS not in str(err) or session == sessions - 1:
                raise
            say(f"  (profiler session {session + 1} of {sessions} recorded no CUDA "
                f"activity: profiled again)")


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
                           clipped=clipped_share(grid, shape[2:]), held=("bwd_vol", shape, n))
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


def k1_at(fused_sample, op, label, vol, grid, gout=None, padding="border",
          dtype=torch.float32):
    """One K1 kernel ("fwd", "bwd_grid" or "bwd_vol") at one shape, its
    volume, output (fwd) or cotangent (bwd) in ``dtype``: against its plain
    version, run twice for the same bits through the kernel its counter
    names (staged or tiled: every volume here is 16^3 or 8^3), then kernel,
    plain and library device ms and the bound. Returns the row."""
    vol = vol.to(dtype) if op != "bwd_vol" else vol
    gout = gout.to(dtype) if gout is not None else None
    nv, n, c = vol.shape[0], grid.shape[0], vol.shape[1]
    samples = grid[..., 0].numel()
    pad = {"zeros": 0, "border": 1}[padding]
    vol_n = vol.repeat_interleave(n // nv, dim=0) if op != "bwd_vol" else None
    size = torch.tensor([], dtype=dtype).element_size()
    if op == "fwd":
        counter, plan = "LAUNCHES", fused_sample.fwd_kernel(vol.shape)
        run = lambda: fused_sample.grid_sample_3d_fused(vol, grid, padding, dtype)
        plain = lambda: fused_sample.grid_sample_3d_plain(vol, grid, padding, dtype)
        grid_lib = grid.to(dtype)
        lib = lambda: torch.nn.functional.grid_sample(
            vol_n, grid_lib, mode="bilinear", padding_mode=padding, align_corners=False)
        nbytes = (vol.numel() + n * c * grid[0, ..., 0].numel()) * size + grid.numel() * 4
        flops = 16.0 * c * samples + 40.0 * samples
    elif op == "bwd_grid":
        counter = "BWD_GRID_LAUNCHES"
        plan = fused_sample.bwd_grid_plan(vol.shape, n, grid[0, ..., 0].numel())
        run = lambda: fused_sample.grid_sample_3d_bwd_grid(vol, grid, gout, padding)
        plain = lambda: fused_sample.grid_sample_3d_bwd_grid_plain(vol, grid, gout, padding)
        grid_lib = grid.to(dtype)  # aten takes one dtype for its three inputs
        lib = lambda: torch.ops.aten.grid_sampler_3d_backward(
            gout, vol_n, grid_lib, 0, pad, False, [False, True])
        nbytes = (gout.numel() + vol.numel()) * size + 2 * grid.numel() * 4
        flops = 2.0 * 27 * gout.numel() + 60.0 * samples
    else:
        counter = "BWD_VOL_LAUNCHES"
        plan = fused_sample.bwd_vol_plan(vol.shape, n, grid[0, ..., 0].numel())
        run = lambda: fused_sample.grid_sample_3d_bwd_vol(grid, gout, vol.shape, padding)
        plain = lambda: fused_sample.grid_sample_3d_bwd_vol_plain(grid, gout, vol.shape,
                                                                  padding)
        lib = lib_bwd_vol(vol.shape, grid, gout.float(), padding)
        nbytes = gout.numel() * size + (grid.numel() + vol.numel()) * 4
        flops = 16.0 * gout.numel() + 40.0 * samples
    before = getattr(fused_sample, counter)
    out, again = run(), run()
    served = getattr(fused_sample, counter) == before + 2
    ref = plain()
    torch.cuda.synchronize()
    err, same = rel_err(out, ref), bool(torch.equal(out, again))
    b, by = bound_ms(nbytes, flops)
    # A bf16 output rounds once after the fp32 sum: one rounding step apart
    # where the two sum orders straddle a rounding boundary.
    tol = BF16_TOL if op == "fwd" and dtype == torch.bfloat16 else FP32_TOL
    row = dict(op=op, path=label, vol=list(vol.shape), grids=n, padding=padding,
               dtype=str(dtype)[6:], kernel=str(plan),
               max_abs_err=float((out.float() - ref.float()).abs().max()), rel_err=err,
               same_bits=same, ms=time_ms(run), plain_ms=time_ms(plain, iters=3),
               library_ms=time_ms(lib), bound_ms=b, bound_by=by)
    say(f"  K1-{op} {label}: vol {tuple(vol.shape)}, {n} grids of "
        f"{'x'.join(map(str, grid.shape[1:4]))}, {padding} {str(dtype)[6:]}, "
        f"{plan}: rel err {err:.3g} (tol {tol:.3g}); run twice, same bits: {same}; "
        f"{row['ms']:.4f} ms, bound {b:.4f} ms ({by}), plain {row['plain_ms']:.3f} ms, "
        f"library {row['library_ms']:.4f} ms (device time)")
    if not served:
        fail(f"K1-{op} {label} did not go through its shared-memory kernel")
    if not err <= tol:
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
    from latentfusion_tpu_torch.utils import profiling

    say(profiling.table(profiled(lambda: model.render_latent_object(
        z, cams, return_latent=False))))


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
    from latentfusion_tpu_torch.utils import profiling

    prof = profiled(fn)
    say(profiling.table(prof))
    return prof.key_averages(), prof.events()


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


def record_k1(fused_sample, step_fn, dtypes: bool = False) -> dict:
    """One call of ``step_fn`` with K1's calls counted by (op, volume
    shape, grids[, the dtype of the volume (fwd) or the cotangent (bwd)]):
    {key: calls}."""
    calls = {}
    wrapped = {"fwd": "grid_sample_3d_fused", "bwd_grid": "grid_sample_3d_bwd_grid",
               "bwd_vol": "grid_sample_3d_bwd_vol"}

    def spy(op, fn):
        def run(*args):
            vol_shape = tuple(args[0].shape) if op != "bwd_vol" else tuple(args[2])
            grid = args[1] if op != "bwd_vol" else args[0]
            key = (op, vol_shape, grid.shape[0])
            if dtypes:
                operand = {"fwd": args[0], "bwd_grid": args[2], "bwd_vol": args[1]}[op]
                key += (str(operand.dtype)[6:],)
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

    # The repeat runs LATENT_REPEAT_STEPS of the steps (a cut for time):
    # every step's loss reads the cameras of the step before, so the same
    # history bits over them is the same trajectory.
    fine.num_iters = LATENT_REPEAT_STEPS
    again, stats2 = fine.estimate(z, target, camera=cams[:fine.num_samples])
    torch.cuda.synchronize()
    fine.num_iters = steps
    same_loss = torch.equal(history[:LATENT_REPEAT_STEPS],
                            stats2["loss_history"][:stats2["num_steps"]])
    say(f"  latent refinement again from the same coarse cameras for "
        f"{stats2['num_steps']} of its {steps} steps: loss histories the same bits "
        f"{same_loss}")
    zcams = cams[:fine.num_samples].zoom(None, model.input_size, model.camera_dist)
    step = lambda: fine.loss_and_grads(z, target, zcams)
    networks = nn.ModuleList([model.sculptor, model.photographer])
    if not same_loss:
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


def phase_pose_accuracy(model, kernels, seed, checks=True, legs=("CEM", "Metropolis")):
    """The oracle rig of tools/train_encoder_distill.py (fp32): ADD-S of
    CEM + refinement on 8 targets with the learned demo weights and of the
    Metropolis estimator as the coarse stage at tools/metropolis_eval.py's
    budget with the same refinement (``legs``; the main run takes them from
    ``metropolis_eval.main``, phase_metropolis_eval); then of all 8 targets
    as one ``estimate_batch`` of CEM and refinement (the latent 8 times, as
    the service batches frames of one object). The reference views and
    targets are drawn from ``seed``. Each gated at 7 of 8. ``checks`` adds
    a refinement step against the plain versions (from the batch's first
    coarse cameras) and the gates. Returns the launch counts of each leg
    and the hits."""
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
        if label not in legs:
            continue
        hits[label], single_s[label] = 0, []
        reset_counters(kernels)
        for i, (gt, target) in enumerate(zip(gt_cams, targets)):
            t0 = time.perf_counter()
            cams = est.estimate(z, target, generator=g)
            best, stats = fine.estimate(z, target, camera=cams[:16])
            torch.cuda.synchronize()
            single_s[label].append(time.perf_counter() - t0)
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
    single = (f" against {sum(single_s['CEM']):.2f} s for the 8 single CEM estimates"
              if "CEM" in single_s else "")
    say(f"  estimate_batch of the 8 targets (CEM then refinement, {stats['num_steps']} "
        f"steps): ADD-S within 0.1 diameter {hits['batch']}/8; {batch_s:.2f} s per "
        f"batch{single}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"launches {json.dumps(counts['batch'])}")
    if checks:
        zcams = coarse_out[0][:16].zoom(None, model.input_size, model.camera_dist)
        gradient_check("demo refinement step",
                       lambda: fine.loss_and_grads(z, targets[0], zcams),
                       model.photographer, kernels)
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
    leaves = {k: v.detach().requires_grad_()
              for k, v in pu.camera_params(cams, optimize_viewport=True).items()}
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
    then adam_quick, top 8) driven through serve_lines: a round of ping,
    register o0 and o1 (views 0-14 of each), an estimate of view 15 of o0,
    of that frame twice, of o0 and o1 together, a malformed line, an
    unknown command and a shutdown; then a warm round of the same without
    o1 and the two-frame requests. Gates: the responses; the
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
        # The warm round is o0's alone (phase 14 needed the time).
        warm = [r for r in requests if not isinstance(r, dict) or r["id"] not in (
            "register o1", "estimate two frames of o0", "estimate o0 and o1")]
        single = []
        for label, reqs in (("first", requests), ("warm, o0 only", warm)):
            per_request.clear()
            out = io.StringIO()
            stopped = serve.serve_lines(service, io.StringIO("\n".join(
                r if isinstance(r, str) else json.dumps(r) for r in reqs) + "\n"), out)
            resp = [json.loads(line) for line in out.getvalue().splitlines()]
            single.append(resp[[r.get("id") if isinstance(r, dict) else None
                                for r in reqs].index("estimate one frame")])
            expect_ok = [isinstance(r, dict) and r["cmd"] != "teleport" for r in reqs]
            pairs = [resp[i] for i, r in enumerate(reqs)
                     if isinstance(r, dict) and isinstance(r.get("npz"), list)]
            say(f"  {label} round: {len(resp)} responses, ok "
                f"{[r['ok'] for r in resp]}, shutdown {stopped}")
            for rid, secs, counts, peak in per_request:
                say(f"    {rid}: {secs:.3f} s, peak memory {peak:.2f} GB, launches "
                    f"{json.dumps(counts)}")
            if not (stopped and [r["ok"] for r in resp] == expect_ok
                    and resp[-1].get("shutdown")
                    and [r.get("id") for r in resp[-2:]] == ["unknown command", "shutdown"]
                    and all(len(r["poses"]) == 2 for r in pairs)):
                fail(f"service: the {label} round's responses are not the protocol's: "
                     f"{[{k: v for k, v in r.items() if k != 'poses'} for r in resp]}")
            warm_counts = {k: sum(c[k] for _, _, c, _ in per_request) for k in per_request[0][2]}
        service.handle = handle

        target = serve.observation_from_npz(paths["target", "o0"], model.device)
        g = torch.Generator(device=model.device).manual_seed(seed)
        z0 = service.latents["o0"]
        direct = service.estimate_one(z0, target, N_REFINE, g)
        got = torch.tensor(single[1]["extrinsic"], device=model.device)
        err = rel_err(got, direct.extrinsic[0])
        same = bool(torch.equal(got, direct.extrinsic[0]))
        say(f"  the single-frame response against the direct coarse + fine estimate with "
            f"the same seed: extrinsic rel err {err:.3g} (tol {NET_TOL}), same bits {same}; "
            f"first and warm rounds' poses the same "
            f"{single[0]['extrinsic'] == single[1]['extrinsic']}")
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
    whose gradient parts. Then ms per step (CUDA events, 1 step after a
    warm-up) under each (deterministic, then default; before phase 15 came,
    two steps a turn in four turns), and the cost of the deterministic
    selection."""
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
    for label in ("deterministic", "default"):
        with selections[label]():
            out[label]["ms"].append(event_ms(
                lambda: step(frozen, batch, rotations=rotations), iters=1, warmup=1))
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
    if not all(counts[k] > 0 for k in TRAIN_STEP_KERNELS):
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
    bwd_vol_in_step(kernels[0], lambda: step(frozen, pool[0], rotations=upright), steps=1)
    del pool, holdout, mods, adam, frozen
    torch.cuda.empty_cache()
    return counts


def bwd_vol_in_step(fused_sample, run_step, steps: int = 2) -> None:
    """ms per training step (CUDA events) with K1-bwd-vol's tiled kernel
    and with the atomic kernel it replaced (tiled, then atomic), ``steps``
    steps each after a warm-up step."""
    times = {"tiled": [], "atomic": []}
    for kernel in ("tiled", "atomic"):
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
        f"{mean['atomic'] - mean['tiled']:.1f} ms; tiled then atomic, "
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
    from latentfusion_tpu_torch.utils import profiling

    prof = profiled(lambda: ibr_model.render_ibr(z, loaded, zoom, return_latent=False),
                    profile_memory=True)
    say(profiling.table(prof, sort_by="self_cuda_memory_usage", row_limit=10))
    del out, loaded, ibr_model
    torch.cuda.empty_cache()
    return counts


def phase_eleven(kernels, seed, held, smi) -> dict:
    """Phase 11 (a) and (b); returns the launch counts by path."""
    say("== phase 11/16: the model options and the GAN training step: the training tool's "
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


# Phase 12: the data path. (a) tools/train_unseen_real.py's stream
# conditions (:197-212) at phase 7's sizes; (b) its held-out evaluation.
DATA_SHAPES, DATA_WORKERS_MAX = 32, 16
# The JAX record that artifacts/unseen_real/unseen_real.npz reproduces (run
# 3's held-out evaluation, run3/pose_eval.json; PERF.md §6), by object; run
# 2's (the top-level pose_eval.json) beside it.
REAL_RECORD = {"run 3": [2, 5, 6, 3], "run 2": [6, 3, 4, 0]}
REAL_GATE = sum(REAL_RECORD["run 3"]) - 3  # phase 9's margin of 3
DATA_DIR = ROOT / "latentfusion_tpu_torch" / "_build" / "data"


def tree_bytes(batch) -> int:
    if isinstance(batch, dict):
        return sum(tree_bytes(v) for v in batch.values())
    return int(batch.nbytes) if isinstance(batch, np.ndarray) else batch.numel() * batch.element_size()


def tree_equal(a, b) -> bool:
    """Whether two batches (tensors or numpy arrays) hold the same dtypes,
    shapes and bits."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k]) for k in a)
    a, b = (x.cpu() if torch.is_tensor(x) else torch.from_numpy(x) for x in (a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def idle_share(fn) -> dict:
    """One call of ``fn`` profiled: the share of its window (first event to
    last) in which no kernel or copy ran on the device, and the busy ms."""
    from latentfusion_tpu_torch.utils import profiling

    busy = profiling.device_busy(profiled(fn))
    return {k: busy[k] for k in ("idle_share", "busy_ms", "window_ms")}


def _write_asset(job) -> None:
    """One procedural texture or background written as PNG (a pool task)."""
    from latentfusion_tpu_torch import png
    from latentfusion_tpu_torch.data import synthetic

    kind, i, path = job
    make = synthetic.procedural_texture if kind == "texture" else synthetic.procedural_background
    png.write_png(path, make(i))


def data_assets():
    """The lobe meshes (pool seed 0, DATA_SHAPES shapes, the tool's 32 x 64
    a lobe), the 48 procedural textures and 24 color backgrounds of
    ``make_procedural_textures`` and ``make_procedural_backgrounds`` (their
    files, written by a pool of processes), under the gitignored build
    directory."""
    import multiprocessing

    from latentfusion_tpu_torch import testing

    t0 = time.perf_counter()
    textures, backgrounds = DATA_DIR / "textures", DATA_DIR / "backgrounds"
    for d in (textures, backgrounds):
        d.mkdir(parents=True, exist_ok=True)
    jobs = ([("texture", i, textures / f"tex_{i:03d}.png") for i in range(48)]
            + [("background", i, backgrounds / f"bg_{i:03d}.png") for i in range(24)])
    with multiprocessing.get_context("fork").Pool(os.cpu_count()) as pool:
        pending = pool.map_async(_write_asset, jobs)
        pool_, _ = testing.sample_lobe_shapes(0, DATA_SHAPES, device="cpu")
        meshes = testing.lobe_shape_meshes(pool_, DATA_DIR / "meshes")
        pending.get()
    say(f"  {len(meshes)} lobe meshes, 48 textures and 24 backgrounds written in "
        f"{time.perf_counter() - t0:.1f} s")
    return meshes, textures, backgrounds


def data_dataset(meshes, textures, backgrounds, seed):
    """tools/train_unseen_real.py's stream (:197-212) at phase 7's views and
    frame: random materials and textures, random color backgrounds, mask
    corruption p 0.25, color noise 0.05, size jitter (0.6, 1.0), no clean
    input group."""
    from latentfusion_tpu_torch.data import synthetic

    return synthetic.SyntheticDataset(
        meshes, num_input_views=TRAIN_IN, num_output_views=TRAIN_OUT, width=640, height=480,
        size_jitter=(0.6, 1.0), random_materials=True, use_textures=True,
        textures_dir=textures, color_random_background=True,
        color_background_dir=backgrounds, mask_noise_p=0.25, color_noise_level=0.05,
        seed=seed, emit_in_gt=False)


def loader_rate(dataset, workers: int, batch_size: int, batches: int):
    """Items a second of a host loader (numpy batches in the quantised
    transport) with ``workers`` processes, timed after its first batch
    (which starts the workers); and that first batch."""
    from latentfusion_tpu_torch.data import loader

    feed = loader.IterableLoader(dataset, batch_size=batch_size, num_workers=workers,
                                 prefetch_factor=2, device=None, transport="quantized",
                                 decode=False)
    try:
        it = iter(feed)
        first = next(it)
        t0 = time.perf_counter()
        for _ in range(batches):
            next(it)
        rate = batches * batch_size / (time.perf_counter() - t0)
    finally:
        feed.shutdown()
    return rate, first


def rasterizer_check(meshes) -> dict:
    """One 640x480 view of the first mesh, textured and lit with specular,
    by the compiled rasterizer and by its numpy twin."""
    from latentfusion_tpu_torch.data import rasterizer, rendering, synthetic

    obj, _ = rendering.load_object(meshes[0])
    ctx = rendering.SceneContext(obj, np.asarray(synthetic.INTRINSIC, np.float32))
    rng = np.random.RandomState(0)
    texture = rng.rand(64, 64, 3).astype(np.float32)
    for mesh in obj.meshes:
        mesh.texture, mesh.uv_scale = texture, 3.0
    ctx.lights = [(np.asarray([1.0, -1.0, -2.0], np.float32), np.ones(3, np.float32), 8.0)]
    ctx.specular, ctx.roughness = 0.4, 0.3
    ctx.set_pose([0.05, -0.03, 2.2], [0.8, 0.3, -0.4, 0.2])
    t0 = time.perf_counter()
    color, depth, mask = rendering.Renderer(640, 480).render(ctx)
    t1 = time.perf_counter()
    pc, pd, _ = rendering.Renderer(640, 480, plain=True).render(ctx)
    stats = rasterizer.agreement(color, depth, pc, pd)
    stats.update(pixels=int(mask.sum()), ms=(t1 - t0) * 1e3,
                 plain_ms=(time.perf_counter() - t1) * 1e3)
    say(f"  rasterizer against its numpy twin, one 640x480 view ({stats['pixels']} pixels): "
        f"{json.dumps(stats)} (bounds {json.dumps(rasterizer.AGREEMENT)})")
    if not (stats["pixels"] > 1000 and rasterizer.agrees(stats)):
        fail("data: the rasterizer disagrees with its numpy twin")
    return stats


def transfer_checks(encoded) -> dict:
    """A quantised batch widened on the host, pinned and copied to the card
    on a side stream, against the host's arrays; and the quantised batch
    copied and widened on the card, against the host's widening."""
    from latentfusion_tpu_torch.data import loader

    dev = torch.device("cuda")
    stream = torch.cuda.Stream()
    host = loader.decode_transport(encoded)
    pinned = loader.tree_map(lambda a: torch.from_numpy(a).pin_memory(), host)
    on_card = loader.to_device(pinned, dev, stream)
    widened = loader.decode_transport(loader.to_device(loader.to_tensors(encoded), dev, stream))
    stream.synchronize()
    out = {"pinned_same_bits": tree_equal(on_card, host),
           "quantized_same_bits": tree_equal(widened, host),
           "bytes_per_batch": tree_bytes(host), "quantized_bytes_per_batch": tree_bytes(encoded)}
    say(f"  transfers of a batch of {TRAIN_BATCH}: {json.dumps(out)}")
    if not out["pinned_same_bits"]:
        fail("data: the batch after the pinned copy to the card is not the host batch")
    if not out["quantized_same_bits"]:
        fail("data: the quantised batch widened on the card is not the host's widening")
    return {"held": on_card, **out}


def phase_data_training(kernels, seed, held) -> dict:
    """Phase 12 (a): the synthetic stream of meshes through the loader (the
    quantised transport, as the tool's) into phase 7's flagship step (fp32,
    2 microbatches): two steps on a loader batch, the same bits, their
    launches counted and their K1 shapes ones phase 2 held (``held``). The
    loader-fed steps of the training tool are phase 13's. Returns the
    launches of the two steps and the measurements."""
    from latentfusion_tpu_torch import zoo
    from latentfusion_tpu_torch.three import quaternion
    from latentfusion_tpu_torch.train import step as tstep

    meshes, textures, backgrounds = data_assets()
    dataset = data_dataset(meshes, textures, backgrounds, seed)
    rasterizer_check(meshes)
    cpus = os.cpu_count()
    workers = min(cpus, DATA_WORKERS_MAX)
    rate_1, _ = loader_rate(dataset, 1, 1, 3)
    rate_n, host = loader_rate(dataset, workers, TRAIN_BATCH, 2)
    say(f"  os.cpu_count() {cpus}; loader items/s: 1 worker {rate_1:.2f}, {workers} workers "
        f"{rate_n:.2f} (8 + 24 views of 640x480 an item)")
    moved = transfer_checks(host)
    held_batch = moved.pop("held")

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    mods = {"sculptor": zoo.flagship_sculptor(generator=gen),
            "fuser": zoo.flagship_fuser(generator=gen),
            "photographer": zoo.flagship_photographer(generator=gen)}
    step = tstep.make_recon_train_step(mods["sculptor"], mods["fuser"], mods["photographer"],
                                       config=train_config(),
                                       num_microbatches=TRAIN_MICROBATCHES)
    g = torch.Generator(device=dev).manual_seed(seed + 12)
    rotations = [quaternion.random(1, g) for _ in range(TRAIN_MICROBATCHES)]
    grads = []
    reset_counters(kernels)
    calls = record_k1(kernels[0], lambda: grads.extend(
        train_grads(step, mods, held_batch, rotations) for _ in range(2)))
    counts = read_counters(kernels)
    first, second = grads
    parted = [k for k in first[1] if not torch.equal(first[1][k], second[1][k])]
    same = bool(torch.equal(first[0], second[0])) and not parted
    say(f"  two steps from the same state and loader batch: the same loss and gradient bits "
        f"{same} ({len(parted)} parameters parted); loss {float(first[0]):.4f}; launches "
        f"{json.dumps(counts)}; K1 calls (op, volume, grids: calls) "
        f"{json.dumps({str(k): v for k, v in calls.items()})}")
    if not same:
        fail("data: two training steps on a loader batch gave other bits")
    if not all(counts[k] > 0 for k in TRAIN_STEP_KERNELS):
        fail(f"data: a kernel was not launched on the loader-batch steps: {counts}")
    missing = [k for k in calls if k not in held]
    if missing:
        fail(f"data: K1 ran at shapes phase 2 did not hold: {missing}")
    if not all(np.isfinite(float(g[0])) for g in grads):
        fail("data: a loss of a loader-batch step is not finite")
    del first, second, grads, mods, held_batch, step
    torch.cuda.empty_cache()
    return {"counts": counts, "items_per_s": {"1": rate_1, str(workers): rate_n}, **moved}


def phase_data_heldout(kernels, seed, held, checks=True) -> dict:
    """Phase 12 (b): unseen_real.py's rig on artifacts/unseen_real/unseen_real.npz:
    held-out objects 0-3 rasterized at the 16 reference and 6 target cameras,
    each target index one estimate_batch at the record's budget with the
    latent ranking term at 0.2; gated (``checks``) at REAL_GATE of 24."""
    from latentfusion_tpu_torch import unseen_eval, unseen_real

    dev = torch.device("cuda")
    model = unseen_eval.build_model("demo", unseen_real.CHECKPOINT, dev, keys=unseen_real.KEYS)
    ref_cams, target_cams = unseen_eval.load_cameras(16, UNSEEN_TARGETS, dev)
    _, clouds, paths = unseen_real.pool_meshes(DATA_DIR, 0, UNSEEN_OBJECTS, True)
    views, render_s = unseen_real.rasterized_views(paths, ref_cams, target_cams)
    say(f"  rendered {UNSEEN_OBJECTS} x (16 + {UNSEEN_TARGETS}) views of 640x480 by the "
        f"rasterizer in {render_s:.2f} s")
    out = unseen_round("unseen_real.npz, rasterized views, latent ranking 0.2", model, views,
                       clouds, {"latent": unseen_real.RANK_LATENT_WEIGHT}, seed, held, kernels)
    hits = sum(out["hits"])
    say(f"  held-out within 0.1d by object {out['hits']} ({hits} of "
        f"{UNSEEN_OBJECTS * UNSEEN_TARGETS}); JAX's records on the TPU: "
        f"{json.dumps(REAL_RECORD)} (gate {REAL_GATE}, run 3's count less 3)")
    if checks and hits < REAL_GATE:
        fail(f"unseen real: {hits} of {UNSEEN_OBJECTS * UNSEEN_TARGETS} held-out targets "
             f"within 0.1d, fewer than {REAL_GATE}")
    del model, views
    torch.cuda.empty_cache()
    out["render_s"] = render_s
    return out


def phase_data_shapes(fused_sample, seed):
    """K1's kernels at phase 12's new shapes, against their plain versions:
    the flagship training microbatch's decode (4 objects x 24 output views),
    and the real-data rig's latent ranking term at the demo width (8^3, 128
    channels): the Sculptor's camera->object sampling of the 4 targets and
    of 4 objects x 16 hypotheses, forward and backward. Returns the rows and
    the (op, volume, grids) held."""
    from latentfusion_tpu_torch import transforms, zoo
    from latentfusion_tpu_torch.camera import Camera
    from latentfusion_tpu_torch.recon.utils import process_batch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 14)
    objects = TRAIN_BATCH // TRAIN_MICROBATCHES
    proc = process_batch(train_batch(g, objects), 1.0, train_config()["camera_dist"],
                         zoo.FLAGSHIP_INPUT_SIZE, generator=g)
    obs = reference_views(0, dev)
    hyps = [hypothesis_cameras(obs, UNSEEN_INPUT_SIZE, CAMERA_DIST, g)[:16]
            for _ in range(UNSEEN_OBJECTS)]
    grids = {"decode": transforms.object_to_camera_grid(proc["out_gt"]["camera"], 16),
             "targets": transforms.camera_to_object_grid(
                 obs.camera[:UNSEEN_OBJECTS].zoom(None, UNSEEN_INPUT_SIZE, CAMERA_DIST), 8),
             "hypotheses": transforms.camera_to_object_grid(Camera.cat(hyps), 8)}
    del proc, obs, hyps
    n_hyp = UNSEEN_OBJECTS * 16
    cases = (("fwd", "training decode, microbatch", objects, 256, "decode"),
             ("fwd", "unseen real latent: targets camera->object", UNSEEN_OBJECTS, 128,
              "targets"),
             ("fwd", "unseen real latent: hypotheses camera->object", n_hyp, 128, "hypotheses"),
             ("bwd_grid", "unseen real latent: hypotheses camera->object", n_hyp, 128,
              "hypotheses"),
             ("bwd_vol", "unseen real latent: hypotheses camera->object", n_hyp, 128,
              "hypotheses"))
    rows = []
    for op, label, nv, c, key in cases:
        grid = grids[key]
        size = grid.shape[1]
        vol = torch.randn(nv, c, size, size, size, generator=g, device=dev)
        gout = (None if op == "fwd" else
                torch.randn(grid.shape[0], c, *grid.shape[1:4], generator=g, device=dev))
        rows.append(k1_at(fused_sample, op, label, vol, grid, gout))
        del vol, gout
    del grids, grid
    torch.cuda.empty_cache()
    return rows, {(r["op"], tuple(r["vol"]), r["grids"]) for r in rows}


def phase_twelve(kernels, seed, held, smi) -> dict:
    """Phase 12 (a) and (b); returns the launch counts by path."""
    say("== phase 12/16: the data path: meshes, the rasterizer, augmentation and the loader "
        "into the flagship training step; held-out objects of unseen_real.npz on "
        "rasterized views")
    t12 = time.perf_counter()
    fed = phase_data_training(kernels, seed, held)
    t_fed = time.perf_counter() - t12
    real = phase_data_heldout(kernels, seed, held)
    say(f"   phase 12 launches: two loader-batch steps {json.dumps(fed['counts'])}, held-out "
        f"batches {json.dumps(real['counts'])}; phase 12 took {time.perf_counter() - t12:.1f} s "
        f"((a) {t_fed:.1f} s) on {smi}")
    return {"data_fed_train_steps": fed["counts"], "unseen_real_batches": real["counts"]}


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
    if not all(counts[k] > 0 for k in TRAIN_STEP_KERNELS):
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
    if not all(plain["counts"][k] > 0 for k in TRAIN_STEP_KERNELS):
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


# ---------------------------------------------------------------- phase 13
JPEG_BANK = ROOT / "tests" / "data" / "jpeg_bank"
TRAINER_DIR = ROOT / "latentfusion_tpu_torch" / "_build" / "trainer"
# tools/train.sh's flags, verbatim but for the dataset, the two banks, the
# save directory and the epochs.
RECIPE_FLAGS = [
    "--histogram-interval", "-1", "--plot-interval", "500", "--show-interval", "1000",
    "--color-noise-level", "0.05", "--depth-noise-level", "0.00", "--num-workers", "5",
    "--base-name", "shapenet,256", "--input-size", "256", "--batch-size", "8",
    "--batch-groups", "2", "--num-input-views", "8", "--num-output-views", "24",
    "--optimizer", "adam", "--generator-lr", "0.00075", "--discriminator-lr", "0.00075",
    "--sculptor-image-config", "64,D,128,D,196,D,256,D,512,D,512,D,512:512,U,512,U,256",
    "--sculptor-camera-config", "64,128,256", "--sculptor-object-config", "256,256",
    "--sculptor-projection-type", "factor", "--photographer-object-config", "none",
    "--photographer-camera-config", "256,256",
    "--photographer-image-config", "256,D,512,D,512:512,U,512,U,512,U,256,U,196,U,128,U,64",
    "--photographer-projection-type", "factor", "--fuser-type", "gru",
    "--g-depth-recon-loss-type", "hard_smooth_l1", "--g-depth-recon-loss-weight", "25.0",
    "--g-depth-recon-loss-k", "16384", "--g-depth-recon-loss-k-milestones", "15,30,45,60",
    "--g-mask-recon-loss-type", "binary_cross_entropy", "--g-mask-recon-loss-weight", "25.0",
    "--g-mask-beta-loss-weight", "0.0", "--random-orientation", "--crop-predicted-mask",
    "--generator-input-mask", "--no-discriminator", "--color-random-background",
    "--crop-random-background", "--mask-noise-p", "0.25", "--predict-depth",
    "--predict-mask", "--scale-mode", "nearest", "--use-amp", "--data-parallel"]
# One epoch (two before phase 15 came: each epoch starts its loader's
# workers anew, about 15 s).
RECIPE_EPOCHS, RECIPE_BATCHES = 1, 2
# The recipe's loss in fp32 against bf16 on one batch, relative: the CPU
# test's bound (tests/test_torch_dtypes.py, BF16_LOSS_TOL).
RECIPE_BF16_LOSS_TOL = 1e-2
IDLE_ITERATIONS = 2
# The kernels train_ibr must launch: its reconstruction is frozen (no K1
# backward), its generator and discriminator run K2 both ways.
IBR_KERNELS = ("K1", "K2", "K2b")


class StepSpy:
    """Wraps the step a training tool makes: per call, device ms by CUDA
    events, the launches of the call, and its scalars."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.rows = []

    def wrap(self, make):
        def made(*args, **kwargs):
            step = make(*args, **kwargs)

            def run(state, batch, *a, **kw):
                before = read_counters(self.kernels)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                out = step(state, batch, *a, **kw)
                end.record()
                end.synchronize()
                after = read_counters(self.kernels)
                self.rows.append({"ms": start.elapsed_time(end),
                                  "launches": {k: after[k] - before[k] for k in after},
                                  "losses": {k: float(v) for k, v in out[1].items()}})
                return out
            return run
        return made


def trainer_k1_cases(seed):
    """The (op, label, volume, grid, dtype) of every K1 call of phase 13's
    training paths: the recipe's step on a batch of 8 objects in one pass
    (8 + 24 views, latent 256 x 16^3) in bf16, and in fp32 for the loss
    comparison; train_ibr's reconstruction forward (fp32) at its 16 input
    views and 16 + 8 decoded ones."""
    from latentfusion_tpu_torch import testing, transforms, zoo
    from latentfusion_tpu_torch.camera import Camera
    from latentfusion_tpu_torch.recon.utils import process_batch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 15)
    proc = process_batch(train_batch(g, TRAIN_BATCH), 1.0, train_config()["camera_dist"],
                         zoo.FLAGSHIP_INPUT_SIZE, generator=g)
    ibr = process_batch(testing.render_training_batch(g, TRAIN_BATCH, 16, 8, device="cuda"),
                        1.0, train_config()["camera_dist"], zoo.FLAGSHIP_INPUT_SIZE,
                        random_orientation=False)
    grids = {"decode": transforms.object_to_camera_grid(proc["out_gt"]["camera"], 16),
             "encode": transforms.camera_to_object_grid(proc["in"]["camera"], 16),
             "ibr encode": transforms.camera_to_object_grid(ibr["in"]["camera"], 16),
             "ibr decode": transforms.object_to_camera_grid(Camera.vcat(
                 (ibr["in_gt"]["camera"], ibr["out_gt"]["camera"]), TRAIN_BATCH), 16)}
    del proc, ibr
    nv = {"decode": TRAIN_BATCH, "encode": TRAIN_BATCH * TRAIN_IN,
          "ibr encode": TRAIN_BATCH * 16, "ibr decode": TRAIN_BATCH}
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for op in ("fwd", "bwd_vol"):
            for key in ("decode", "encode"):
                cases.append((op, f"trainer recipe {key}", nv[key], grids[key], dtype))
    for key in ("ibr encode", "ibr decode"):
        cases.append(("fwd", f"train_ibr {key}", nv[key], grids[key], torch.float32))
    return cases


def phase_trainer_shapes(fused_sample, seed):
    """K1-fwd and K1-bwd-vol at phase 13's shapes (trainer_k1_cases), in
    their dtypes, against their plain versions. Returns the rows and the
    (op, volume, grids, dtype) held."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 16)
    rows = []
    for op, label, nv, grid, dtype in trainer_k1_cases(seed):
        c, size = 256, grid.shape[1]
        vol = torch.randn(nv, c, size, size, size, generator=g, device=dev)
        gout = (None if op == "fwd" else
                torch.randn(grid.shape[0], c, *grid.shape[1:4], generator=g, device=dev))
        rows.append(k1_at(fused_sample, op, label, vol, grid, gout, dtype=dtype))
        del vol, gout
    torch.cuda.empty_cache()
    return rows, {(r["op"], tuple(r["vol"]), r["grids"], r["dtype"]) for r in rows}


def recipe_argv(meshes_dir, save_dir, epochs, extra=()):
    return ["--dataset-type", "paths", "--dataset-path", str(meshes_dir),
            "--textures-path", str(JPEG_BANK / "textures"),
            "--color-background-path", str(JPEG_BANK / "backgrounds"),
            "--save-dir", str(save_dir), "--batches-per-epoch", str(RECIPE_BATCHES),
            "--num-epochs", str(epochs), *RECIPE_FLAGS, *extra]


def run_tool(kernels, module, maker, argv):
    """``module.main(argv)`` with the step it makes spied on and the
    counters set to 0 just before: (trainer, the path's launches, its K1
    calls by (op, volume, grids, dtype), the spy's rows, peak GB, seconds)."""
    spy = StepSpy(kernels)
    mod, name = maker
    torch.cuda.reset_peak_memory_stats()
    reset_counters(kernels)
    out = {}
    t0 = time.perf_counter()
    with mock.patch.object(mod, name, spy.wrap(getattr(mod, name))):
        calls = record_k1(kernels[0], lambda: out.update(trainer=module.main(argv)),
                          dtypes=True)
    seconds = time.perf_counter() - t0
    counts = read_counters(kernels)
    return (out["trainer"], counts, calls, spy.rows,
            torch.cuda.max_memory_allocated() / 2 ** 30, seconds)


def iteration_summary(label, trainer, rows, counts, calls, held, peak_gb, seconds, smi,
                      required, amp):
    """Print a tool run's numbers; fail on a kernel of ``required`` not
    launched, a K1 shape phase 2 did not hold in its dtype, a K1 call not in
    bf16 under ``amp`` (the tool's --use-amp), or a loss that is not
    finite."""
    loads = list(trainer.plotter.moving_meters["time/data_load"].values)
    per_iter = {k: sum(r["launches"][k] for r in rows) / len(rows) for k in counts}
    say(f"  {label}: {len(rows)} iterations in {seconds:.1f} s, on {smi}")
    say(f"    step ms (CUDA events) {json.dumps([round(r['ms'], 1) for r in rows])}; "
        f"time/data_load s {json.dumps([round(x, 3) for x in loads])}; peak memory "
        f"{peak_gb:.2f} GB")
    say(f"    launches on the path {json.dumps(counts)}, per iteration {json.dumps(per_iter)}; "
        f"K1 calls (op, volume, grids, dtype: calls) "
        f"{json.dumps({str(k): v for k, v in calls.items()})}")
    say(f"    losses {json.dumps([r['losses'] for r in rows])}")
    if not all(counts[k] > 0 for k in required):
        fail(f"{label}: a kernel of {required} was not launched: {counts}")
    missing = [k for k in calls if k not in held]
    if missing:
        fail(f"{label}: K1 ran at shapes phase 2 did not hold in that dtype: {missing}")
    not_bf16 = [k for k in calls if amp and k[-1] != "bfloat16"]
    if not_bf16:
        fail(f"{label}: under --use-amp K1 ran outside bf16: {not_bf16}")
    if not all(np.isfinite(v) for r in rows for v in r["losses"].values()):
        fail(f"{label}: a loss is not finite")
    return {"ms": [r["ms"] for r in rows], "data_load_s": loads, "peak_gb": peak_gb,
            "per_iteration": per_iter, "seconds": seconds}


def recipe_loss(step, mods, batch, rotations, dtype) -> float:
    """The recipe step's generator loss on ``batch`` in ``dtype``, the
    weights unchanged (SGD at learning rate 0)."""
    from latentfusion_tpu_torch import dtypes
    from latentfusion_tpu_torch.train import step as tstep

    try:
        with dtypes.compute_dtype(dtype):
            state = tstep.init_train_state(mods, tstep.make_optimizer("sgd", 0.0))
            _, scalars = step(state, batch, None, rotations)
        loss = float(scalars["loss/generator/total"])
    finally:
        for m in mods.values():
            m.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()
    return loss


def phase_recipe(kernels, seed, held, smi, meshes_dir) -> dict:
    """Phase 13 (a): train_reconstruct.main on tools/train.sh's flags (bf16),
    RECIPE_EPOCHS epoch of 2 batches, then --resume --branch for one more; idle share
    over 3 loader-fed iterations; the loss in fp32 against bf16; the .pth
    exported, loaded, built and rendered against the plain versions."""
    from latentfusion_tpu_torch import dtypes, train_reconstruct
    from latentfusion_tpu_torch.recon.inference import LatentFusionModel
    from latentfusion_tpu_torch.three import quaternion
    from latentfusion_tpu_torch.train import step as tstep

    save_dir = TRAINER_DIR / "runs"
    maker = (tstep, "make_recon_train_step")
    trainer, counts, calls, rows, peak, secs = run_tool(
        kernels, train_reconstruct, maker, recipe_argv(meshes_dir, save_dir, RECIPE_EPOCHS))
    first = iteration_summary("train_reconstruct, train.sh's flags, bf16", trainer, rows,
                              counts, calls, held, peak, secs, smi, TRAIN_STEP_KERNELS, amp=True)
    latest = trainer.save_dir / "ckpt-epoch-latest.npz.pkl"
    del trainer
    torch.cuda.empty_cache()
    trainer, counts2, calls2, rows2, peak2, secs2 = run_tool(
        kernels, train_reconstruct, maker,
        recipe_argv(meshes_dir, save_dir, 1, ("--resume", str(latest), "--branch",
                                              "--batches-per-epoch", "1")))
    resumed = iteration_summary("train_reconstruct --resume --branch, one epoch of 1 batch",
                                trainer,
                                rows2, counts2, calls2, held, peak2, secs2, smi,
                                TRAIN_STEP_KERNELS, amp=True)
    if not trainer.save_dir.name.startswith("shapenet,256-branch"):
        fail(f"recipe: the resumed run is not a branch: {trainer.save_dir.name}")

    # Idle share of 3 loader-fed iterations (the recipe's step, in bf16 as
    # the tool ran it).
    batches = iter(trainer.loader)
    try:
        with dtypes.compute_dtype(torch.bfloat16):
            held_batch = next(batches)
            trainer.run_iteration(held_batch)
            torch.cuda.synchronize()
            idle = idle_share(lambda: [trainer.run_iteration(next(batches))
                                       for _ in range(IDLE_ITERATIONS)])
    finally:
        trainer.loader.shutdown()
    say(f"  {IDLE_ITERATIONS} loader-fed iterations profiled: device idle share "
        f"{idle['idle_share']:.4f} (busy {idle['busy_ms']:.1f} of {idle['window_ms']:.1f} ms)"
        f" on {smi}")

    # The loss in fp32 against bf16, one batch, the same weights and draws.
    mods = {"sculptor": trainer.sculptor, "fuser": trainer.fuser,
            "photographer": trainer.photographer}
    config = dict(trainer.kwargs, camera_dist=trainer.camera_dist)
    step = tstep.make_recon_train_step(trainer.sculptor, trainer.fuser, trainer.photographer,
                                       config=config)
    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    rotations = [quaternion.random(1, g)]
    total = torch.cuda.get_device_properties(0).total_memory / 2 ** 30
    objects = TRAIN_BATCH if 2 * max(peak, peak2) < 0.9 * total else 1
    batch = {k: {kk: v[:objects] for kk, v in grp.items()} for k, grp in held_batch.items()}
    losses = {str(d)[6:]: recipe_loss(step, mods, batch, rotations, d)
              for d in (torch.bfloat16, torch.float32)}
    rel = abs(losses["bfloat16"] - losses["float32"]) / abs(losses["float32"])
    say(f"  the recipe's loss on {objects} of {TRAIN_BATCH} objects of a loader batch "
        f"(bf16 peak {max(peak, peak2):.1f} GB of {total:.1f}): {json.dumps(losses)}, "
        f"relative difference {rel:.3g} (tol {RECIPE_BF16_LOSS_TOL})")
    if not rel <= RECIPE_BF16_LOSS_TOL:
        fail("recipe: the bf16 loss is not within tolerance of the fp32 loss")
    if losses["bfloat16"] == losses["float32"]:
        fail("recipe: the bf16 and fp32 losses are the same bits: the policy did nothing")
    del step, batch, held_batch, mods
    torch.cuda.empty_cache()

    pth = TRAINER_DIR / "recipe.pth"
    trainer.export_torch_checkpoint(pth)
    model = LatentFusionModel.from_checkpoint(pth)
    render = drive_slice("recipe .pth", model, [("o0", 0)], kernels, seed, profile=False)
    del model, trainer
    torch.cuda.empty_cache()
    return {"counts": counts, "resumed_counts": counts2, "render": render["o0"],
            "first": first, "resumed": resumed, "idle": idle, "losses": losses,
            "pth": pth}


def phase_ibr_train(kernels, held, smi, meshes_dir, pth) -> dict:
    """Phase 13 (b): train_ibr.main on (a)'s .pth with the tool's defaults
    (blend_flow, the published generator config, the discriminator; batch
    8 of 16 + 8 views), 2 iterations."""
    from latentfusion_tpu_torch import train_ibr
    from latentfusion_tpu_torch.train import ibr_step

    argv = ["--recon-checkpoint", str(pth), "--dataset-type", "paths",
            "--dataset-path", str(meshes_dir), "--save-dir", str(TRAINER_DIR / "ibr"),
            "--base-name", "recipe", "--batches-per-epoch", "2", "--num-epochs", "1"]
    trainer, counts, calls, rows, peak, secs = run_tool(
        kernels, train_ibr, (ibr_step, "make_ibr_train_step"), argv)
    out = iteration_summary("train_ibr on the recipe's .pth, the tool's defaults", trainer,
                            rows, counts, calls, held, peak, secs, smi, IBR_KERNELS,
                            amp=False)
    del trainer
    torch.cuda.empty_cache()
    return {"counts": counts, **out}


RIG_CHUNK_STEPS, RIG_WORKERS, RIG_OBJECTS = 10, 8, 32
DISTILL_RIG_STEPS = 6


def timed_calls(module, name, times):
    """``module.name`` wrapped to append each call's synchronised seconds
    to ``times``."""
    fn = getattr(module, name)

    def run(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out
    return mock.patch.object(module, name, run)


def rig_readback(label, npz, keys) -> None:
    """The rig's npz through the evaluation half's loader (demo family)."""
    from latentfusion_tpu_torch import unseen_eval

    model = unseen_eval.build_model("demo", npz, torch.device("cuda"), keys=keys)
    n = sum(p.numel() for m in (model.sculptor, model.fuser, model.photographer)
            for p in m.parameters())
    say(f"    {label}: {npz.name} read back by unseen_eval.build_model ({n} parameters)")
    del model


def phase_train_rigs(kernels, smi) -> dict:
    """Phase 13 (c): train_unseen_real with RIG_WORKERS workers and two
    chunks at its sizes (demo family, 6 + 8 views of 256x192, bf16; the
    pool cut to RIG_OBJECTS meshes); then the encoder-distill and
    unseen-objects rigs for DISTILL_RIG_STEPS steps each and one evaluation
    target. Each rig's npz is read back by the evaluation half's loader."""
    from latentfusion_tpu_torch import (train_encoder_distill, train_unseen_objects,
                                        train_unseen_real, unseen_real)

    counts = {}
    out = TRAINER_DIR / "unseen_real"
    chunks = []
    reset_counters(kernels)
    t0 = time.perf_counter()
    with timed_calls(train_unseen_real, "run_chunk", chunks):
        history = train_unseen_real.main([
            "--steps", str(2 * RIG_CHUNK_STEPS), "--chunk-steps", str(RIG_CHUNK_STEPS),
            "--workers", str(RIG_WORKERS), "--train-objects", str(RIG_OBJECTS),
            "--out", str(out), "--assets-dir", str(DATA_DIR)])
    counts["train_unseen_real"] = read_counters(kernels)
    per_step = [c / RIG_CHUNK_STEPS for c in chunks]
    say(f"  train_unseen_real: {len(chunks)} chunks of {RIG_CHUNK_STEPS} steps, "
        f"{RIG_WORKERS} workers, {time.perf_counter() - t0:.1f} s in all; s per step by chunk "
        f"{json.dumps([round(x, 4) for x in per_step])}; history {json.dumps(history)}; "
        f"launches {json.dumps(counts['train_unseen_real'])} on {smi}")
    if not all(np.isfinite(row["loss"]) for row in history):
        fail("train_unseen_real: a loss is not finite")
    if not all(counts["train_unseen_real"][k] > 0 for k in TRAIN_STEP_KERNELS):
        fail(f"train_unseen_real: a kernel was not launched: {counts['train_unseen_real']}")
    rig_readback("train_unseen_real", out / "unseen_real.npz", unseen_real.KEYS)
    for label, module, argv, stem in (
            ("train_encoder_distill", train_encoder_distill,
             ["--eval-targets", "1", "--eval-views", "16"], "encoder_distill"),
            ("train_unseen_objects", train_unseen_objects, [], "unseen_objects")):
        steps = []
        rig_out = TRAINER_DIR / stem
        reset_counters(kernels)
        t0 = time.perf_counter()
        with timed_calls(train_encoder_distill, "train_step", steps):
            result = module.main(["--steps", str(DISTILL_RIG_STEPS), "--out", str(rig_out),
                                  *argv])
        counts[label] = read_counters(kernels)
        history = json.loads((rig_out / "history.json").read_text())
        say(f"  {label}: {DISTILL_RIG_STEPS} steps, s per step "
            f"{json.dumps([round(x, 4) for x in steps])}, {time.perf_counter() - t0:.1f} s "
            f"in all; history {json.dumps(history)}; launches "
            f"{json.dumps(counts[label])} on {smi}")
        if isinstance(result, dict):
            say(f"    evaluation: ADD-S 0.1d {result['add_s_0.1d']} on "
                f"{len(result['targets'])} target(s)")
        if not all(np.isfinite(v) for row in history for v in row.values()):
            fail(f"{label}: a loss is not finite")
        if not all(counts[label][k] > 0 for k in TRAIN_STEP_KERNELS):
            fail(f"{label}: a kernel was not launched: {counts[label]}")
        rig_readback(label, rig_out / f"{stem}.npz", rig_out / f"{stem}_keys.json")
    return counts


def phase_thirteen(kernels, seed, held, smi) -> dict:
    """Phase 13 (a), (b) and (c); returns the launch counts by path."""
    say("== phase 13/16: the trainer: train_reconstruct on tools/train.sh's flags (bf16, "
        "JPEG banks), --resume --branch, the .pth rendered; train_ibr on it; the rigs' "
        "training halves")
    t13 = time.perf_counter()
    meshes_dir = DATA_DIR / "meshes"
    recipe = phase_recipe(kernels, seed, held, smi, meshes_dir)
    t_a = time.perf_counter() - t13
    ibr = phase_ibr_train(kernels, held, smi, meshes_dir, recipe["pth"])
    t_b = time.perf_counter() - t13 - t_a
    rigs = phase_train_rigs(kernels, smi)
    say(f"   phase 13 launches: recipe {json.dumps(recipe['counts'])}, resumed "
        f"{json.dumps(recipe['resumed_counts'])}, train_ibr {json.dumps(ibr['counts'])}, "
        f"rigs {json.dumps(rigs)}; phase 13 took {time.perf_counter() - t13:.1f} s ((a) "
        f"{t_a:.1f} s, (b) {t_b:.1f} s) on {smi}")
    return {"trainer_recipe": recipe["counts"], "trainer_resumed": recipe["resumed_counts"],
            "trainer_pth_render": recipe["render"], "train_ibr": ibr["counts"], **rigs}


# ---------------------------------------------------------------- phase 14
EVAL_DIR = ROOT / "latentfusion_tpu_torch" / "_build" / "eval"
MOPED = ROOT / "tests" / "data" / "moped_synth"
METROPOLIS_RECORD = ROOT / "artifacts" / "metropolis" / "pose_eval.json"
SERVING_RECORD = ROOT / "artifacts" / "serving" / "accuracy.json"
# The scene's camera: the checkpoint's own, the LINEMOD-style canonical
# intrinsic of zoo.canonical_camera (f 615 at 640x480). The zoom keeps a
# camera's focal, so the encoder-distill weights, trained at f 615 only, see
# the object 7 % small at LINEMOD's published f 572.4 (PERF.md §6).
BOP_K = ((615.0, 0.0, 320.0), (0.0, 615.0, 240.0), (0.0, 0.0, 1.0))
LINEMOD_K = ((572.4114, 0.0, 325.2611), (0.0, 573.5704, 242.0490), (0.0, 0.0, 1.0))
# The frames' translation noise about (0, 0, 5.78): none, as the accuracy
# rigs' targets (metropolis_eval, phase 6); RIG_VIEW_JITTER is their
# reference views' (zoo.random_view_cameras), run by --eval-variants.
BOP_JITTER, RIG_VIEW_JITTER = (0.0, 0.0, 0.0), (0.1, 0.1, 0.25)
# MOPED tracking refines at a tenth of adam_quick's learning rate (PERF.md §6).
TRACK_CONFIG = CONFIGS / "adam_track.toml"
BOP_FRAMES, BOP_DIAMETER_MM = 40, 100.0
BOP_GATE, MOPED_GATE, METROPOLIS_GATE = 6, 6, 7  # of 8
SERVING_GATES = {"estimate_batch": 4, "served": 5}  # of 6 (JAX's record: 5 and 6)
# The kernels each evaluation leg must launch (the pose path's four; the
# serving record's latent ranking term also autoencodes, K1-bwd-vol).
EVAL_KERNELS = ("K1", "K1b", "K2", "K2b")


# K1's calls on phase 6's metropolis_eval run and phase 14's legs, by (op,
# volume, grids, dtype of the volume (fwd) or cotangent (bwd)), as each leg
# prints them: the demo family's 8^3
# latent of 128 channels; 16 views' camera->object sampling, renders of
# 128 hypotheses a frame, refinements of 8 or 16 a frame, the latent term's
# autoencode of 16 hypotheses an object.
_DEMO = (128, 8, 8, 8)
EVAL_K1_SHAPES = (
    # metropolis_eval (bf16): the build, CEM and Metropolis renders, refinement 16.
    ("fwd", (16, *_DEMO), 16, "bfloat16"), ("fwd", (1, *_DEMO), 128, "bfloat16"),
    ("fwd", (1, *_DEMO), 16, "bfloat16"), ("bwd_grid", (1, *_DEMO), 16, "bfloat16"),
    # serving_accuracy's in-process half (bf16): two objects, the latent term.
    ("fwd", (2, *_DEMO), 2, "bfloat16"), ("fwd", (2, *_DEMO), 256, "bfloat16"),
    ("fwd", (2, *_DEMO), 32, "bfloat16"), ("bwd_grid", (2, *_DEMO), 32, "bfloat16"),
    ("fwd", (32, *_DEMO), 32, "bfloat16"), ("bwd_grid", (32, *_DEMO), 32, "bfloat16"),
    ("bwd_vol", (32, *_DEMO), 32, "bfloat16"),
    # evaluate_bop, 8 frames in one batch and one alone; poserbpf_comparison;
    # the pose example (8 views); the reconstruction example (6 views) (fp32).
    ("fwd", (16, *_DEMO), 16, "float32"), ("fwd", (8, *_DEMO), 1024, "float32"),
    ("fwd", (8, *_DEMO), 64, "float32"), ("bwd_grid", (8, *_DEMO), 64, "float32"),
    ("fwd", (1, *_DEMO), 128, "float32"), ("fwd", (1, *_DEMO), 8, "float32"),
    ("bwd_grid", (1, *_DEMO), 8, "float32"), ("fwd", (8, *_DEMO), 8, "float32"),
    ("fwd", (6, *_DEMO), 6, "float32"), ("fwd", (1, *_DEMO), 6, "float32"),
    ("fwd", (1, *_DEMO), 1, "float32"))


def phase_eval_shapes(fused_sample, seed, held):
    """K1 at the shapes of EVAL_K1_SHAPES that no earlier row of phase 2
    holds (``held``) in their dtype, against the plain versions: each
    volume random, its grids those of hypothesis cameras around o0 at the
    demo family's 128^2. Returns the rows and the (op, volume, grids,
    dtype) held."""
    from latentfusion_tpu_torch import transforms
    from latentfusion_tpu_torch.camera import Camera

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 17)
    obs = reference_views(0, dev)
    rows = []
    for op, vol, grids, dtype in EVAL_K1_SHAPES:
        if (op, vol, grids, dtype) in held:
            continue
        blocks = -(-grids // N_HYPOTHESES)
        cams = Camera.cat([hypothesis_cameras(obs, UNSEEN_INPUT_SIZE, CAMERA_DIST, g)
                           for _ in range(blocks)])[:grids]
        grid = transforms.object_to_camera_grid(cams, vol[2])
        v = torch.randn(*vol, generator=g, device=dev)
        gout = (None if op == "fwd" else
                torch.randn(grids, vol[1], *grid.shape[1:4], generator=g, device=dev))
        rows.append(k1_at(fused_sample, op, "evaluation harnesses", v, grid, gout,
                          dtype=getattr(torch, dtype)))
        del v, gout, grid
    torch.cuda.empty_cache()
    return rows, {(r["op"], tuple(r["vol"]), r["grids"], r["dtype"]) for r in rows}


def write_demo_pth(state, path) -> None:
    """The demo family with ``state``'s weights as a reference-schema
    ``.pth`` (``LatentFusionModel.from_checkpoint``'s input); reading it
    back must give the same tensors, bit for bit."""
    from latentfusion_tpu_torch import zoo
    from latentfusion_tpu_torch.recon.inference import LatentFusionModel

    common = dict(projection_type="factor", cube_size=1.0, scale_mode="nearest")
    sculptor = dict(in_size=zoo.DEMO_INPUT_SIZE, image_config=zoo.DEMO_SCULPTOR_IMAGE_CONFIG,
                    camera_config=zoo.DEMO_SCULPTOR_CAMERA_CONFIG,
                    object_config=zoo.DEMO_SCULPTOR_OBJECT_CONFIG, input_color=True,
                    input_depth=True, input_mask=True, **common)
    photographer = dict(in_size=zoo.DEMO_INPUT_SIZE // 16,
                        image_config=zoo.DEMO_PHOTOGRAPHER_IMAGE_CONFIG,
                        camera_config=zoo.DEMO_PHOTOGRAPHER_CAMERA_CONFIG, object_config=None,
                        predict_color=False, predict_depth=True, predict_mask=True, **common)
    fuser = zoo.demo_fuser(device="cpu")

    def weights(name):
        return {k: torch.as_tensor(v).detach().cpu().clone() for k, v in state[name].items()}

    torch.save({"name": "encoder_distill", "epoch": 0, "meter_hists": {},
                "args": {"camera_dist": zoo.DEMO_CAMERA_DIST, "no_discriminator": True},
                "modules": {
                    "sculptor": {"args": sculptor, "state_dict": weights("sculptor")},
                    "photographer": {"args": photographer,
                                     "state_dict": weights("photographer")},
                    "fuser": {"type": "GRUFuser", "args": {"in_channels": fuser.in_channels,
                                                           "cube_size": fuser.cube_size},
                              "state_dict": weights("fuser")}}}, path)
    model = LatentFusionModel.from_checkpoint(path)
    for name in ("sculptor", "fuser", "photographer"):
        got = getattr(model, name).state_dict()
        if set(got) != set(state[name]) or not all(
                torch.equal(got[k].cpu(), torch.as_tensor(v).cpu())
                for k, v in state[name].items()):
            fail(f"the .pth's {name} does not read back as the npz's tensors")
    say(f"  {path.name}: the demo family with encoder_distill.npz's weights, read back by "
        f"from_checkpoint bit for bit")
    del model


def eval_leg(label, kernels, fn, held, smi, required=EVAL_KERNELS) -> dict:
    """``fn()`` with the counters set to 0 just before and K1's calls
    recorded by (op, volume, grids, dtype); fails if a kernel of
    ``required`` did not run or (``held`` not None) a K1 call is at a shape
    and dtype phase 2 did not hold. Prints s, peak memory and launches."""
    out = {}
    torch.cuda.reset_peak_memory_stats()
    reset_counters(kernels)
    t0 = time.perf_counter()
    calls = record_k1(kernels[0], lambda: out.update(result=fn()), dtypes=True)
    out.update(seconds=time.perf_counter() - t0, counts=read_counters(kernels),
               peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30, calls=calls)
    say(f"  {label}: {out['seconds']:.1f} s, peak memory {out['peak_gb']:.2f} GiB, launches "
        f"{json.dumps(out['counts'])} on {smi}; K1 calls (op, volume, grids, dtype: calls) "
        f"{json.dumps({str(k): v for k, v in calls.items()})}")
    if not all(out["counts"][k] > 0 for k in required):
        fail(f"{label}: a kernel of {required} was not launched: {out['counts']}")
    if held is not None:
        missing = [k for k in calls if k not in held]
        if missing:
            fail(f"{label}: K1 ran at shapes phase 2 did not hold in that dtype: {missing}")
    return out


def write_bop_scene(root: Path, seed: int, k=BOP_K, jitter=BOP_JITTER):
    """A LINEMOD-layout scene of the oracle ellipsoid (ORACLE_AXES, 100 mm
    across) at BOP_FRAMES random poses (uniform rotations, the translation
    (0, 0, 5.78) + N(0, ``jitter``) in object units), camera ``k``
    (BOP_K unless given), 640x480: rgb
    (shaded), depth (uint16 mm), mask_visib, scene_camera.json,
    scene_gt.json, models_eval/models_info.json and the object's PLY, all
    PNGs by png.write_png. Returns the scene directory."""
    from latentfusion_tpu_torch import png, testing, three, zoo
    from latentfusion_tpu_torch.camera import Camera
    from latentfusion_tpu_torch.three import orientation, quaternion

    scene = root / "test" / "000001"
    for d in ("rgb", "depth", "mask_visib"):
        (scene / d).mkdir(parents=True, exist_ok=True)
    (root / "models_eval").mkdir(parents=True, exist_ok=True)
    (root / "models").mkdir(exist_ok=True)
    mm = BOP_DIAMETER_MM / ORACLE_DIAMETER
    half = [a * mm for a in ORACLE_AXES]
    (root / "models_eval" / "models_info.json").write_text(json.dumps({"1": {
        "diameter": BOP_DIAMETER_MM, "min_x": -half[0], "min_y": -half[1], "min_z": -half[2],
        "size_x": 2 * half[0], "size_y": 2 * half[1], "size_z": 2 * half[2]}}))
    pts = orientation.evenly_distributed_points(512, device="cpu") * torch.tensor(half)
    (root / "models_eval" / "obj_000001.ply").write_text("\n".join(
        ["ply", "format ascii 1.0", f"element vertex {len(pts)}", "property float x",
         "property float y", "property float z", "element face 1",
         "property list uchar int vertex_indices", "end_header"]
        + [f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}" for p in pts.tolist()] + ["3 0 1 2"]) + "\n")
    g = torch.Generator().manual_seed(seed + 14)
    quats = quaternion.random(BOP_FRAMES, g)
    trans = (torch.tensor([0.0, 0.0, zoo.DEMO_CAMERA_DIST])
             + torch.randn(BOP_FRAMES, 3, generator=g) * torch.tensor(jitter))
    extrinsic = three.to_extrinsic_matrix(trans, quats)
    k = torch.tensor(k)
    oracle = testing.EllipsoidOracleModel(zoo.DEMO_INPUT_SIZE, zoo.DEMO_CAMERA_DIST, ORACLE_AXES)
    cams = Camera(k.expand(BOP_FRAMES, 3, 3), extrinsic, width=640, height=480)
    obs = oracle.make_observation(cams, shaded=True)
    color = (obs.color.clamp(0, 1) * 255).round().to(torch.uint8).permute(0, 2, 3, 1).cpu()
    mask = obs.mask[:, 0] > 0.5
    depth = (obs.depth[:, 0] * mm * mask).round().to(torch.int32).cpu().numpy()
    cam_json, gt_json = {}, {}
    for i in range(BOP_FRAMES):
        png.write_png(scene / "rgb" / f"{i:06d}.png", color[i].numpy())
        png.write_png(scene / "depth" / f"{i:06d}.png", depth[i].astype(np.uint16))
        png.write_png(scene / "mask_visib" / f"{i:06d}_000000.png",
                      mask[i].cpu().numpy().astype(np.uint8) * 255)
        cam_json[str(i)] = {"cam_K": k.reshape(-1).tolist(), "depth_scale": 1.0}
        gt_json[str(i)] = [{"obj_id": 1, "cam_R_m2c": extrinsic[i, :3, :3].reshape(-1).tolist(),
                            "cam_t_m2c": (extrinsic[i, :3, 3] * mm).tolist()}]
    (scene / "scene_camera.json").write_text(json.dumps(cam_json))
    (scene / "scene_gt.json").write_text(json.dumps(gt_json))
    del obs
    return scene


def phase_bop(kernels, held, smi, pth, seed) -> dict:
    """Phase 14 (a): evaluate_bop.main on a LINEMOD-layout oracle scene, 16
    reference views, 8 frames in one estimate_batch (gated at BOP_GATE
    within ADD-S 0.1d), then one frame alone."""
    from latentfusion_tpu_torch import evaluate_bop
    from latentfusion_tpu_torch.pose import format as pf

    t0 = time.perf_counter()
    root = EVAL_DIR / "lm"
    scene = write_bop_scene(root, seed)
    say(f"  BOP scene: {BOP_FRAMES} frames written in {time.perf_counter() - t0:.1f} s")
    argv = ["--checkpoint", str(pth), "--dataset-path", str(root), "--scene-path", str(scene),
            "--object-id", "1", "--num-input-views", "16", "--seed", str(seed)]
    runs = {}
    for name, extra in (("batch", ["--num-frames", "8", "--batch-frames", "8"]),
                        ("single", ["--num-frames", "1"])):
        leg = eval_leg(f"evaluate_bop {' '.join(extra)}", kernels, lambda: evaluate_bop.main(
            argv + extra + ["--out", str(EVAL_DIR / f"bop_{name}.json")]), held, smi)
        rows, acc = leg["result"]
        hits = sum(r["add_s_01d"] for r in rows)
        means = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]
                 if isinstance(rows[0][k], float) and k != "seconds"}
        say(f"    ADD-S within 0.1d on {hits} of {len(rows)} frames; s per frame "
            f"{json.dumps([r['seconds'] for r in rows])}; add_s (mm) "
            f"{json.dumps([round(r['add_s'], 2) for r in rows])}\n"
            + pf.metrics_table(means, name=f"    obj_000001 mean ({len(rows)} frames)")
            + "\n" + pf.metrics_table(acc, name="    accuracy"))
        runs[name] = {"hits": hits, "frames": len(rows), "counts": leg["counts"],
                      "s_per_frame": rows[0]["seconds"], "seconds": leg["seconds"],
                      "peak_gb": leg["peak_gb"]}
    if runs["batch"]["hits"] < BOP_GATE:
        fail(f"BOP: {runs['batch']['hits']} of 8 frames within ADD-S 0.1d, fewer than "
             f"{BOP_GATE}")
    return runs


def phase_moped(kernels, held, smi, pth, fine_config=TRACK_CONFIG, gate=MOPED_GATE) -> dict:
    """Phase 14 (b): poserbpf_comparison.main on the committed synthetic
    MOPED capture, refining with ``fine_config``: frame 0 coarse then fine,
    7 frames warm-started; ADD-S of each against the ellipsoid's points,
    gated at ``gate`` of 8."""
    from latentfusion_tpu_torch import poserbpf_comparison
    from latentfusion_tpu_torch.pose import metrics
    from latentfusion_tpu_torch.three import orientation

    leg = eval_leg(f"poserbpf_comparison --fine-config {fine_config.name}", kernels,
                   lambda: poserbpf_comparison.main(
                       ["--checkpoint", str(pth), "--reference-scene", str(MOPED / "reference"),
                        "--eval-scene", str(MOPED / "evaluation"), "--fine-config",
                        str(fine_config), "--out", str(EVAL_DIR / "moped")]), held, smi)
    rows, cameras = leg["result"]
    dev = torch.device("cuda")
    points = (orientation.evenly_distributed_points(512, device=dev)
              * torch.tensor(ORACLE_AXES, device=dev))
    add_s = [metrics.camera_metrics(gt, est, points, 1.0)["add_s"] for gt, est in cameras]
    hits = sum(a < 0.1 * ORACLE_DIAMETER for a in add_s)
    seconds = [r["seconds"] for r in rows]
    say(f"    tracked {len(rows)} frames: ADD-S (object units) "
        f"{json.dumps([round(a, 4) for a in add_s])}, within 0.1d on {hits}; the tool's rotation "
        f"and translation distances {json.dumps([[round(r['rotation_dist'], 4), round(r['translation_dist'], 4)] for r in rows])}; "
        f"s for frame 0 {seconds[0]:.3f}, s per warm frame "
        f"{json.dumps([round(s, 3) for s in seconds[1:]])} on {smi}")
    if hits < gate:
        fail(f"MOPED: {hits} of {len(rows)} tracked frames within ADD-S 0.1d, fewer than "
             f"{gate}")
    return {"hits": hits, "frames": len(rows), "counts": leg["counts"],
            "cold_s": seconds[0], "warm_s": float(np.mean(seconds[1:])),
            "seconds": leg["seconds"], "peak_gb": leg["peak_gb"]}


def phase_metropolis_eval(kernels, held, smi, seed) -> dict:
    """Phase 6's CEM and Metropolis legs: metropolis_eval.main at the
    record's budget (8 targets, 128 chains x 300 MH steps, CEM 128 x 10,
    refinement 16 x 150; bf16), each gated at METROPOLIS_GATE of 8."""
    from latentfusion_tpu_torch import metropolis_eval

    leg = eval_leg("metropolis_eval", kernels, lambda: metropolis_eval.main(
        ["--out", str(EVAL_DIR / "metropolis"), "--checkpoint",
         str(DISTILL / "encoder_distill.npz"), "--seed", str(seed)]), held, smi)
    summary, record = leg["result"], json.loads(METROPOLIS_RECORD.read_text())
    out = {"counts": leg["counts"], "seconds": leg["seconds"], "peak_gb": leg["peak_gb"]}
    for part in ("metropolis", "cem_control"):
        hits = sum(r["add_s_01d"] for r in summary[part]["targets"])
        out[part] = {"hits": hits, "warm_s": summary[part]["warm_seconds_per_object"]}
        say(f"    {part}: ADD-S within 0.1d {hits}/8 = {summary[part]['add_s_0.1d']:.3f} "
            f"(the JAX record {record[part]['add_s_0.1d']:.3f}); s per target "
            f"{json.dumps([r['seconds'] for r in summary[part]['targets']])}")
        if hits < METROPOLIS_GATE:
            fail(f"metropolis_eval ({part}): {hits}/8 within 0.1d, fewer than "
                 f"{METROPOLIS_GATE}")
    return out


def phase_serving(kernels, held, smi) -> dict:
    """Phase 14 (c): serving_accuracy.main at its defaults (2 held-out
    objects of pool-128, 3 rounds, latent ranking 0.2): estimate_batch in
    process (bf16), then the frames through the service process."""
    from latentfusion_tpu_torch import serving_accuracy

    leg = eval_leg("serving_accuracy", kernels, lambda: serving_accuracy.main(
        ["--out", str(EVAL_DIR / "serving"), "--checkpoint",
         str(POOL128 / "unseen_objects.npz")]), held, smi, required=EVAL_KERNELS + ("K1bv",))
    summary, record = leg["result"], json.loads(SERVING_RECORD.read_text())
    out = {"counts": leg["counts"], "seconds": leg["seconds"], "peak_gb": leg["peak_gb"]}
    for half, gate in SERVING_GATES.items():
        rounds = summary[half]["rounds"]
        hits = sum(d["add_s_01d"] for r in rounds for d in r["objects"])
        out[half] = {"hits": hits, "warm_s": summary[half]["warm_seconds_joint"],
                     "cold_s": rounds[0]["seconds_joint"]}
        say(f"    {half}: ADD-S within 0.1d {hits}/6 = {summary[half]['add_s_0.1d']:.3f} "
            f"(the JAX record {record[half]['add_s_0.1d']:.3f}); s per round of 2 objects "
            f"{json.dumps([r['seconds_joint'] for r in rounds])}")
        if hits < gate:
            fail(f"serving_accuracy ({half}): {hits}/6 within 0.1d, fewer than {gate}")
    return out


def phase_examples(kernels, held, smi, pth) -> dict:
    """Phase 14 (d): the pose example in synthetic mode on the built-in
    cube and the reconstruction example, both on the .pth."""
    from latentfusion_tpu_torch import png
    from latentfusion_tpu_torch.examples import pose_estimation, reconstruction

    pose = eval_leg("examples.pose_estimation (cube)", kernels,
                    lambda: pose_estimation.main(["--checkpoint", str(pth)]), held, smi)
    say("    its table:\n" + pose["result"])
    out_png = EVAL_DIR / "reconstruction.png"
    recon = eval_leg("examples.reconstruction", kernels, lambda: reconstruction.main(
        ["--checkpoint", str(pth), "--out", str(out_png)]), held, smi, required=("K1", "K2"))
    grid = recon["result"]
    back = png.read_png(out_png)
    rows = back.shape[0] // 162  # a row band: one 160^2 image padded by 2
    say(f"    {out_png.name}: {back.shape} read back by png.read_png (the grid {grid.shape}; "
        f"{rows} row bands)")
    if back.shape != (grid.shape[1], grid.shape[2], 3) or back.shape[1] != 162 or (
            not np.array_equal(back, (grid.transpose(1, 2, 0) * 255).astype(np.uint8))):
        fail(f"examples.reconstruction: the PNG reads back at {back.shape}")
    if rows != 5:  # the example's try swallows a failed render_ibr_basic
        fail(f"examples.reconstruction: {rows} row bands, not 5: the IBR color was not drawn")
    return {"pose": pose["counts"], "reconstruction": recon["counts"],
            "pose_s": pose["seconds"], "reconstruction_s": recon["seconds"]}


def phase_eval_variants(kernels, smi, state, seed) -> None:
    """``--eval-variants``: phase 14 (a) and (b) under the settings they do
    not run, ungated: the BOP scene at LINEMOD's published camera and with
    the rigs' view noise, each at scene seeds ``seed`` to ``seed`` + 2, the
    gated scene at ``seed`` + 1 to + 5; the MOPED tracking with the tool's
    default refinement (adam_quick, lr 1e-2)."""
    from latentfusion_tpu_torch import evaluate_bop

    EVAL_DIR.mkdir(parents=True, exist_ok=True)
    pth = EVAL_DIR / "encoder_distill.pth"
    write_demo_pth(state, pth)
    phase_moped(kernels, None, smi, pth, CONFIGS / "adam_quick.toml", gate=0)
    cases = ([("LINEMOD's camera", LINEMOD_K, BOP_JITTER, s) for s in range(seed, seed + 3)]
             + [("the rigs' view noise", BOP_K, RIG_VIEW_JITTER, s)
                for s in range(seed, seed + 3)]
             + [("the gated scene", BOP_K, BOP_JITTER, s) for s in range(seed + 1, seed + 6)])
    for label, k, jitter, s in cases:
        root = EVAL_DIR / f"variant_{label[:8].strip()}_{s}" / "lm"
        scene = write_bop_scene(root, s, k=k, jitter=jitter)
        rows, _ = evaluate_bop.main(["--checkpoint", str(pth), "--dataset-path", str(root),
                                     "--scene-path", str(scene), "--object-id", "1",
                                     "--num-input-views", "16", "--num-frames", "8",
                                     "--batch-frames", "8", "--seed", str(s)])
        say(f"  BOP, {label}, scene seed {s}: ADD-S within 0.1d on "
            f"{sum(r['add_s_01d'] for r in rows)} of 8; add_s (mm) "
            f"{json.dumps([round(r['add_s'], 2) for r in rows])}; translation (mm) "
            f"{json.dumps([round(r['translation_dist'], 1) for r in rows])} on {smi}")


def phase_fourteen(kernels, seed, held, smi, state, metropolis) -> dict:
    """Phase 14 (a)-(d); ``metropolis`` is phase 6's metropolis_eval run.
    Returns the launch counts by path."""
    say("== phase 14/16: the evaluation harnesses: BOP, MOPED tracking, the serving record, "
        "the examples (demo family, learned weights)")
    t14 = time.perf_counter()
    EVAL_DIR.mkdir(parents=True, exist_ok=True)
    pth = EVAL_DIR / "encoder_distill.pth"
    write_demo_pth(state, pth)
    bop = phase_bop(kernels, held, smi, pth, seed)
    moped = phase_moped(kernels, held, smi, pth)
    serving = phase_serving(kernels, held, smi)
    if metropolis is not None:
        say(f"    the records beside JAX's: metropolis_eval (phase 6) Metropolis "
            f"{metropolis['metropolis']['hits']}/8, CEM {metropolis['cem_control']['hits']}/8 "
            f"(JAX 8/8, 8/8); serving_accuracy estimate_batch "
            f"{serving['estimate_batch']['hits']}/6, served {serving['served']['hits']}/6 "
            f"(JAX 5/6, 6/6)")
    examples = phase_examples(kernels, held, smi, pth)
    say(f"   phase 14: BOP {json.dumps(bop)}, MOPED {json.dumps(moped)}, serving "
        f"{json.dumps(serving)}, examples {json.dumps(examples)}; phase 14 took "
        f"{time.perf_counter() - t14:.1f} s on {smi}")
    return {"bop": bop["batch"]["counts"], "bop_single": bop["single"]["counts"],
            "moped": moped["counts"], "serving_accuracy": serving["counts"],
            "example": examples["pose"], "example_reconstruction": examples["reconstruction"]}


# ------------------------------------------------------------- phase 15
PARALLEL_DIR = ROOT / "latentfusion_tpu_torch" / "_build" / "parallel"
PARALLEL_RANKS = 2
RANK_TIMEOUT_S = 420
# Two ranks share the one card over gloo, which carries CUDA tensors for
# all_reduce and broadcast (the DP step's gradient average, the hypothesis
# and TP gathers), while NCCL refuses two ranks on one device. Gloo carries
# no reduce_scatter or all_gather for CUDA tensors, which FSDP2 needs: the
# FSDP leg runs fully_shard on a one-rank NCCL mesh (FSDP_RANKS), fixed
# here, not chosen at run time; two ranks of FSDP are the CPU test's
# (tests/test_torch_parallel.py, gloo).
FSDP_RANKS = 1
PARALLEL_STEPS = 2
# The bf16 step's noise floor: every convolution's output times (1 + eps
# N(0, 1)), rounded back to bf16, with eps the same multiples of bf16's
# unit (2^-7) as FLOOR_EPS are of fp32's (2^-23).
PARALLEL_FLOOR_EPS = tuple(e * 2.0 ** 16 for e in FLOOR_EPS)
LOSS_TOL_15, POSE_TOL_15, DECODE_TOL_15 = 1e-5, 1e-4, 1e-5  # tests/test_parallel.py
REFINE_ITERS_15, METROPOLIS_15 = 3, (32, 20)  # refinement steps; chains, iterations
GENERATOR_BATCH, GENERATOR_SIZE = 4, 256
VIDEO_FRAMES = 2
# The video leg writes frames; tracking accuracy is phase 14's, so it
# tracks at a small budget.
VIDEO_COARSE = """type = "cross_entropy"
[loss_weights]
depth = 1.0
[args]
num_samples = 32
num_iters = 2
ranking_size = 8
num_elites = 8
num_gmm_components = 2
learning_rate = 0.75
"""
VIDEO_FINE = """type = "gradient"
[loss_weights]
depth = 1.0
ov_depth = 0.3
[args]
optimizer = "adam"
num_iters = 5
num_samples = 8
ranking_size = 8
learning_rate = 0.001
converge_threshold = 1e-6
converge_patience = 10
"""


def generator_k2_calls(batch=GENERATOR_BATCH, size=GENERATOR_SIZE) -> list:
    """K2's (shape, calls) in one forward of the PGGAN EncoderDecoder at
    ``DEFAULT_BLOCK_CONFIG`` on ``batch`` images of ``size``^2 (each block
    resizes, then two conv + K2; the same calls again in the backward)."""
    from latentfusion_tpu_torch.pggan.generator import DEFAULT_BLOCK_CONFIG

    calls = {}
    cfg = DEFAULT_BLOCK_CONFIG
    for i, c in enumerate(cfg[1:]):  # encoder: halve, then c channels
        shape = (batch, c, size >> (i + 1), size >> (i + 1))
        calls[shape] = calls.get(shape, 0) + 2
    out = list(reversed(cfg))[1:]
    for i, c in enumerate(out):  # decoder: double from the code's size
        side = size >> (len(cfg) - 2 - i)
        shape = (batch, c, side, side)
        calls[shape] = calls.get(shape, 0) + 2
    return sorted(calls.items())


def phase_generator_kernels(lrelu_pnorm, seed):
    """Phase 2's rows at the generator's K2 shapes: K2-fwd and K2-bwd
    against their plain versions, fp32 and bf16, twice for the same bits,
    timed against their bounds."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    calls = generator_k2_calls()
    fwd = k2_table(
        "K2-fwd", "generator forward", calls,
        lambda shape, dtype: (torch.randn(*shape, generator=g, device=dev).to(dtype),),
        lambda x: lrelu_pnorm.lrelu_pixel_norm_fwd(x, 0.2, 1e-8),
        lambda x: lrelu_pnorm.lrelu_pixel_norm_plain(x, 0.2, 1e-8),
        lambda x: 2 * x.numel() * 4 + x[:, 0].numel() * 4, 6.0)

    def inputs(shape, dtype):
        x = torch.randn(*shape, generator=g, device=dev).to(dtype)
        gy = torch.randn(*shape, generator=g, device=dev).to(dtype)
        return x, lrelu_pnorm.lrelu_pixel_norm_fwd(x, 0.2, 1e-8)[1], gy

    bwd = k2_table(
        "K2-bwd", "generator backward", calls, inputs,
        lambda x, inv, gy: lrelu_pnorm.lrelu_pixel_norm_bwd(x, inv, gy, 0.2),
        lambda x, inv, gy: lrelu_pnorm.lrelu_pixel_norm_bwd_plain(x, inv, gy, 0.2),
        lambda x: 3 * x.numel() * 4 + x[:, 0].numel() * 4, 8.0)
    torch.cuda.empty_cache()
    return {"fwd": fwd, "bwd": bwd, "calls": calls}


@contextlib.contextmanager
def convs_perturbed_in_dtype(network, eps: float, seed: int):
    """``testing.convs_perturbed`` that keeps each output's dtype: the
    product is taken in fp32 and rounded back (in bf16 the step's
    convolutions compute and return bf16)."""
    from latentfusion_tpu_torch.modules.equalized import EqualizedConv

    gens = {}

    def hook(_module, _inputs, y):
        g = gens.setdefault(y.device, torch.Generator(device=y.device).manual_seed(seed))
        noise = torch.randn(y.shape, generator=g, device=y.device)
        return (y.float() * (1 + eps * noise)).to(y.dtype)

    handles = [m.register_forward_hook(hook) for m in network.modules()
               if isinstance(m, EqualizedConv)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def recipe_setup(seed):
    """tools/train.sh's architecture (RECIPE_FLAGS) with weights N(0, 1)
    from ``seed`` on the card, the tool's step config and its learning
    rate: (modules, config, lr, the initial weights, ``seed``)."""
    from latentfusion_tpu_torch import train_reconstruct
    from latentfusion_tpu_torch.train import args as A

    args = train_reconstruct.get_args(["--save-dir", str(PARALLEL_DIR), *RECIPE_FLAGS])
    sc, fu, ph, _, _ = train_reconstruct.build_models(
        args, "cuda", torch.Generator(device="cuda").manual_seed(seed + 150))
    config = {k: v for k, v in vars(args).items()
              if isinstance(v, (int, float, str, bool, type(None)))}
    config["camera_dist"] = A.auto_camera_dist(args)
    mods = {"sculptor": sc, "fuser": fu, "photographer": ph}
    initial = {name: {k: v.detach().clone() for k, v in m.state_dict().items()}
               for name, m in mods.items()}
    return mods, config, args.generator_lr, initial, seed


def recipe_batches(seed) -> list:
    """PARALLEL_STEPS global batches of the recipe (phase 7's oracle
    batches, TRAIN_BATCH objects of 8 + 24 views), rendered on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed + 152)
    return [train_batch(g) for _ in range(PARALLEL_STEPS)]


def batch_sums(batch) -> list:
    """Each leaf's sum in float64, in a fixed order (the batch's identity
    across processes)."""
    return [float(v.double().sum()) for grp in sorted(batch)
            for _, v in sorted(batch[grp].items())]


def recipe_steps(kernels, recipe, batches, mesh=None, fsdp=False, perturb=None):
    """PARALLEL_STEPS steps of the recipe (bf16, Adam at the tool's rate,
    the step's draws from one generator) from the initial weights of
    ``recipe`` (``recipe_setup``'s, loaded afresh), one a batch; with
    ``mesh`` each process takes its slice of each global batch (``fsdp``:
    the modules sharded by ``parallel.shard_fsdp`` first, in place, so the
    FSDP run comes last). Returns the losses, ms per step (CUDA events), the
    launches and the parameters after the last step (sharded ones gathered
    whole)."""
    from torch import nn

    from latentfusion_tpu_torch import dtypes, parallel
    from latentfusion_tpu_torch.train import step as tstep

    mods, config, lr, initial, seed = recipe
    for name, m in mods.items():
        m.load_state_dict(initial[name])
    if fsdp:
        parallel.shard_fsdp(mods, mesh)
    state = tstep.init_train_state(mods, tstep.make_optimizer("adam", lr))
    step = tstep.make_recon_train_step(mods["sculptor"], mods["fuser"], mods["photographer"],
                                       None, config, mesh=mesh)
    rng = torch.Generator(device="cuda").manual_seed(seed + 151)
    local = [parallel.shard_batch(b, mesh) if mesh is not None else b for b in batches]
    losses, ms = [], []
    reset_counters(kernels)
    context = (convs_perturbed_in_dtype(nn.ModuleList(mods.values()), *perturb)
               if perturb else contextlib.nullcontext())
    with dtypes.compute_dtype(torch.bfloat16), context:
        for b in local:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            _, scalars = step(state, b, rng)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append(float(scalars["loss/generator/total"]))
    counts = read_counters(kernels)
    params = {f"{name}.{k}": v.detach().float().clone() for name, m in mods.items()
              for k, v in parallel.full_state_dict(m).items()}
    for m in mods.values():
        m.zero_grad(set_to_none=True)
    del state, step, local
    torch.cuda.empty_cache()
    return {"losses": losses, "ms": ms, "counts": counts, "params": params}


def params_rel(a: dict, b: dict) -> float:
    """The largest difference of any parameter tensor, relative to the
    larger of its largest magnitude in ``b`` and 1."""
    return max(float((a[k] - b[k]).abs().max()) / max(float(b[k].abs().max()), 1.0)
               for k in b)


def bit_sums(params: dict) -> list:
    """Position-weighted integer sums of each tensor's bits, on the card:
    equal lists mean the same bits (up to a collision)."""
    out = []
    for k in sorted(params):
        bits = params[k].cuda().contiguous().view(torch.int32).reshape(-1).long()
        weights = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out.append(int((bits * weights).sum()))
    return out


def estimator_inputs(model, seed) -> dict:
    """Phase 6's oracle at the demo family: the latent of 16 shaded views
    and two targets of 640x480 from ``seed``."""
    from latentfusion_tpu_torch import testing, zoo
    from latentfusion_tpu_torch.three import quaternion

    dev = model.device
    oracle = testing.EllipsoidOracleModel(zoo.DEMO_INPUT_SIZE, zoo.DEMO_CAMERA_DIST,
                                          ORACLE_AXES, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 153)
    ref_cams = zoo.random_view_cameras(16, g, zoo.DEMO_CAMERA_DIST, device=dev)
    gts = [testing.make_camera(1, z=zoo.DEMO_CAMERA_DIST, f=615.0, width=640, height=480,
                               quats=quaternion.random(1, g), device=dev) for _ in range(2)]
    with torch.no_grad():
        z = model.build_latent_object(oracle.make_observation(ref_cams, shaded=True))
    return {"z": z, "targets": [oracle.make_observation(gt) for gt in gts], "gts": gts}


def camera_leaves(cams) -> dict:
    return {"translation": cams.translation.cpu(), "log_quaternion": cams.log_quaternion.cpu()}


def run_estimators(model, inputs, mesh, seed) -> dict:
    """CEM (cross_entropy_quick), refinement (adam_quick, REFINE_ITERS_15
    steps, from its sunflower hypotheses), Metropolis (METROPOLIS_15) on
    the first target and one two-object refinement ``estimate_batch``,
    each from its own generator seeded from ``seed``; with ``mesh`` the
    hypotheses are sharded over its ranks. Returns each one's cameras,
    loss histories and seconds."""
    from latentfusion_tpu_torch.pose import estimation

    z, targets = inputs["z"], inputs["targets"]
    out = {}

    def gen(k):
        return torch.Generator(device="cuda").manual_seed(seed + 160 + k)

    cem = estimation.load_from_config(CONFIGS / "cross_entropy_quick.toml", model, mesh=mesh)
    fine = estimation.load_from_config(CONFIGS / "adam_quick.toml", model, mesh=mesh,
                                       num_iters=REFINE_ITERS_15, track_stats=True)
    chains, iters = METROPOLIS_15
    metropolis = estimation.MetropolisPoseEstimator(
        model=model, num_samples=chains, num_iters=iters, loss_weights={"depth": 1.0},
        ranking_size=8, mesh=mesh)
    for label, fn in (
            ("cem", lambda: (cem.estimate(z, targets[0], generator=gen(0)), None)),
            ("refine", lambda: fine.estimate(z, targets[0], generator=gen(1))),
            ("metropolis", lambda: (metropolis.estimate(z, targets[0], generator=gen(2)), None)),
            ("batch", lambda: fine.estimate_batch(torch.cat([z, z]), targets,
                                                  generator=gen(3)))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cams, stats = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        cams = cams if isinstance(cams, list) else [cams]
        out[label] = {"cameras": [camera_leaves(c) for c in cams], "seconds": seconds,
                      "loss_history": None if stats is None else stats["loss_history"].cpu()}
    return out


def tp_inputs(seed) -> dict:
    """A flagship latent (N(0, 1) from ``seed``) and 128 hypothesis cameras
    of reference object o0, as phase 3 renders them."""
    from latentfusion_tpu_torch import zoo

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 154)
    obs = reference_views(0, dev)
    cams = hypothesis_cameras(obs, zoo.FLAGSHIP_INPUT_SIZE, CAMERA_DIST, g)
    return {"z_obj": torch.randn(1, 1, 256, 16, 16, 16, generator=g, device=dev),
            "cameras": cams}


def tp_decode(seed, inputs, mesh=None) -> dict:
    """The flagship Photographer (weights N(0, 1) from ``seed``) decodes
    the 128 cameras; with ``mesh`` its convolutions are cut over the model
    axis (``parallel.shard_tp``). Returns depth and mask, ms and the
    convolutions cut."""
    from latentfusion_tpu_torch import parallel, zoo
    from latentfusion_tpu_torch.recon import models

    photographer = zoo.flagship_photographer(generator=torch.Generator().manual_seed(seed + 155))
    cut = parallel.shard_tp(photographer, mesh) if mesh is not None else 0
    with torch.no_grad():
        models.decode(photographer, inputs["z_obj"], inputs["cameras"][:2])  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, _, _ = models.decode(photographer, inputs["z_obj"], inputs["cameras"])
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    out = {"depth": y["depth"].cpu(), "mask": y["mask"].cpu(), "ms": ms, "cut": cut}
    del photographer, y
    torch.cuda.empty_cache()
    return out


def rank_worker(folder: Path, rank: int, world: int) -> None:
    """One rank of phase 15: a gloo group by a file:// rendezvous in
    ``folder``, the card shared with the other ranks; (a) the recipe's step
    data-parallel, (c) the sharded estimators, (d) the TP decode. Writes
    ``rank<r>.pt`` (rank 0 also the parameters and the decode)."""
    import torch.distributed as dist

    from latentfusion_tpu_torch import parallel
    from latentfusion_tpu_torch.ops import fused_sample, lrelu_pnorm
    from latentfusion_tpu_torch.recon.inference import LatentFusionModel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    kernels = (fused_sample, lrelu_pnorm)
    t0 = time.perf_counter()
    parallel.init_distributed("cuda", backend="gloo",
                              init_method=f"file://{folder / 'rendezvous'}",
                              rank=rank, world_size=world)
    inputs = torch.load(folder / "inputs.pt", weights_only=False)
    seed = inputs["seed"]
    meshes = {axis: parallel.make_mesh(world, axis) for axis in
              (parallel.DATA_AXIS, parallel.HYPOTHESIS_AXIS, parallel.MODEL_AXIS)}
    out = {"start_s": time.perf_counter() - t0}
    try:
        # The main process computes its one-process references of (c)-(e)
        # while the ranks start; the ranks' work waits for them.
        while not (folder / "go").exists():
            time.sleep(0.05)
        out["wait_s"] = time.perf_counter() - t0
        t = time.perf_counter()
        recipe = recipe_setup(seed)
        batches = recipe_batches(seed)
        out["batch_sums"] = [batch_sums(b) for b in batches]
        out["dp_setup_s"] = time.perf_counter() - t
        dp = recipe_steps(kernels, recipe, batches, meshes[parallel.DATA_AXIS])
        del batches, recipe
        out["dp"] = {k: dp[k] for k in ("losses", "ms", "counts")}
        out["dp"]["bits"] = bit_sums(dp["params"])
        if rank == 0:
            torch.save({k: v.cpu() for k, v in dp["params"].items()}, folder / "dp_params.pt")
        del dp
        torch.cuda.empty_cache()
        out["dp_s"] = time.perf_counter() - t
        t = time.perf_counter()
        model = LatentFusionModel.from_checkpoint(inputs["pth"])
        reset_counters(kernels)
        out["estimators"] = run_estimators(model, inputs, meshes[parallel.HYPOTHESIS_AXIS],
                                           seed)
        out["estimator_counts"] = read_counters(kernels)
        del model
        out["estimators_s"] = time.perf_counter() - t
        t = time.perf_counter()
        tp = tp_decode(seed, inputs, meshes[parallel.MODEL_AXIS])
        out["tp"] = {"ms": tp["ms"], "cut": tp["cut"],
                     "bits": bit_sums({"depth": tp["depth"], "mask": tp["mask"]})}
        if rank == 0:
            torch.save({"depth": tp["depth"], "mask": tp["mask"]}, folder / "tp.pt")
        out["tp_s"] = time.perf_counter() - t
    finally:
        torch.save(out, folder / f"rank{rank}.pt")
        dist.destroy_process_group()


def start_ranks(folder: Path, seed_inputs: dict) -> list:
    """Start PARALLEL_RANKS processes of ``chip_smoke.py --rank-worker`` on
    ``seed_inputs`` (each waits for ``folder/go``). Returns (process, log
    file) pairs."""
    for f in folder.glob("*"):
        f.unlink()
    torch.save(seed_inputs, folder / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    ranks = []
    for r in range(PARALLEL_RANKS):
        log = open(folder / f"log{r}.txt", "w")
        ranks.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank-worker", str(folder),
             str(r), str(PARALLEL_RANKS)], env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return ranks


def wait_ranks(folder: Path, ranks: list, t0: float) -> list:
    """Wait for the ranks (RANK_TIMEOUT_S from ``t0``; any left then is
    killed); each must exit 0. Returns their outputs."""
    try:
        for proc, _ in ranks:
            proc.wait(timeout=max(1.0, t0 + RANK_TIMEOUT_S - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for proc, log in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    codes = [proc.returncode for proc, _ in ranks]
    if any(codes):
        for r in range(PARALLEL_RANKS):
            say(f"  rank {r} (exit {codes[r]}), last lines: "
                + (folder / f"log{r}.txt").read_text()[-3000:])
        fail(f"phase 15: a rank failed: exit codes {codes}")
    return [torch.load(folder / f"rank{r}.pt", weights_only=False)
            for r in range(PARALLEL_RANKS)]


def same_tree(a, b) -> bool:
    """The same structure and the same tensor bits."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return True


def pose_close(a: dict, b: dict) -> float:
    """The largest difference of translation and log-quaternion."""
    return max(float((a[k] - b[k]).abs().max()) for k in ("translation", "log_quaternion"))


def check_estimators(sharded: dict, single: dict, inputs: dict, smi) -> None:
    """Phase 15 (c)'s gates: refinement and estimate_batch loss histories
    within LOSS_TOL_15 and final poses within POSE_TOL_15 (tests/
    test_parallel.py's); Metropolis' best pose within POSE_TOL_15; CEM the
    same top camera within POSE_TOL_15, or, where ranking ties moved it,
    the same ADD-S 0.1d outcome."""
    from latentfusion_tpu_torch.camera import Camera
    from latentfusion_tpu_torch.pose import metrics
    from latentfusion_tpu_torch.three import orientation

    dev = torch.device("cuda")
    points = (orientation.evenly_distributed_points(512, device=dev)
              * torch.tensor(ORACLE_AXES, device=dev))
    gt = inputs["gts"][0]

    def add_s(leaves):
        cam = Camera(gt.intrinsic, None, gt.z_span, gt.viewport,
                     log_quaternion=leaves["log_quaternion"][:1].to(dev),
                     translation=leaves["translation"][:1].to(dev),
                     width=gt.width, height=gt.height)
        return metrics.camera_metrics(gt, cam, points, 1.0)["add_s"]

    report = {}
    for label in ("cem", "refine", "metropolis", "batch"):
        s, o = sharded[label], single[label]
        top = max(pose_close({k: a[k][:1] for k in a}, {k: b[k][:1] for k in b})
                  for a, b in zip(s["cameras"], o["cameras"]))
        hist = (None if o["loss_history"] is None else
                float((s["loss_history"] - o["loss_history"]).abs().max()))
        report[label] = {"top_pose_diff": top, "loss_history_diff": hist,
                         "s_sharded": s["seconds"], "s_single": o["seconds"]}
        ok = top <= POSE_TOL_15 and (hist is None or hist <= LOSS_TOL_15)
        if label == "cem" and not ok:
            hits = [add_s(x["cameras"][0]) < 0.1 * ORACLE_DIAMETER for x in (s, o)]
            report[label]["add_s_hits"] = hits
            ok = hits[0] == hits[1]
        report[label]["ok"] = ok
    say(f"  (c) sharded estimators at {PARALLEL_RANKS} ranks against one process (demo .pth): "
        f"{json.dumps(report)} on {smi}")
    bad = [k for k, v in report.items() if not v["ok"]]
    if bad:
        fail(f"phase 15 (c): the sharded estimators part from the unsharded ones: {bad}")


def phase_generator_video(kernels, held_k2, smi, pth) -> dict:
    """Phase 15 (e): the EncoderDecoder at DEFAULT_BLOCK_CONFIG, forward
    and backward on GENERATOR_BATCH images of GENERATOR_SIZE^2 through K2,
    against the plain K2 path (NET_TOL); every K2 call at a shape phase 2
    held; then poserbpf_comparison --video for VIDEO_FRAMES frames of the
    MOPED capture, its frames read back."""
    from latentfusion_tpu_torch import modules, poserbpf_comparison, videos
    from latentfusion_tpu_torch.pggan import EncoderDecoder

    dev = torch.device("cuda")
    net = EncoderDecoder(3, 3, generator=torch.Generator().manual_seed(156))
    g = torch.Generator(device=dev).manual_seed(157)
    x = torch.randn(GENERATOR_BATCH, 3, GENERATOR_SIZE, GENERATOR_SIZE, generator=g, device=dev)
    style = torch.randn(GENERATOR_BATCH, 8, generator=g, device=dev)

    def run(backend):
        net.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_()
        with modules.lrelu_pnorm_backend(backend):
            y, _ = net(xi, style)
            y.square().mean().backward()
        torch.cuda.synchronize()
        return y.detach(), xi.grad, {k: p.grad.clone() for k, p in net.named_parameters()}

    t0 = time.perf_counter()
    reset_counters(kernels)
    k2_shapes, _ = record_step(lambda: run("hopper"), keep_resizes=False)
    counts = read_counters(kernels)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    y, gx, gp = run("hopper")
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    y_p, gx_p, gp_p = run("torch")
    errs = {"output": rel_err(y, y_p), "input_grad": rel_err(gx, gx_p),
            "param_grads": max(rel_err(gp[k], gp_p[k]) for k in gp)}
    expected = {shape: (n, n) for shape, n in held_k2}
    gen_s = time.perf_counter() - t0
    say(f"  (e) EncoderDecoder (DEFAULT_BLOCK_CONFIG) on {GENERATOR_BATCH} x {GENERATOR_SIZE}^2: "
        f"forward + backward {ms:.1f} ms (CUDA events), against the plain K2 path "
        f"{json.dumps(errs)} (tol {NET_TOL}); launches {json.dumps(counts)} (one forward and "
        f"backward); K2 "
        f"calls by shape (fwd, bwd) {json.dumps({str(k): v for k, v in k2_shapes.items()})}; "
        f"{gen_s:.1f} s on {smi}")
    if not (counts["K2"] > 0 and counts["K2b"] > 0):
        fail(f"phase 15 (e): the generator did not launch K2-fwd and K2-bwd: {counts}")
    if k2_shapes != expected:
        fail(f"phase 15 (e): the generator's K2 calls are not phase 2's rows: {k2_shapes}")
    if not max(errs.values()) <= NET_TOL:
        fail(f"phase 15 (e): the generator disagrees with the plain K2 path: {errs}")
    del net, x, y, gx, gp, y_p, gx_p, gp_p
    torch.cuda.empty_cache()

    out_dir = EVAL_DIR / "moped_video"
    coarse, fine = out_dir / "coarse.toml", out_dir / "fine.toml"
    out_dir.mkdir(parents=True, exist_ok=True)
    coarse.write_text(VIDEO_COARSE)
    fine.write_text(VIDEO_FINE)
    reset_counters(kernels)
    t0 = time.perf_counter()
    rows, _ = poserbpf_comparison.main(
        ["--checkpoint", str(pth), "--reference-scene", str(MOPED / "reference"),
         "--eval-scene", str(MOPED / "evaluation"), "--coarse-config", str(coarse),
         "--fine-config", str(fine), "--max-frames", str(VIDEO_FRAMES), "--video",
         "--out", str(out_dir)])
    video_s = time.perf_counter() - t0
    frames = list(videos.read_video(out_dir / "tracking.mp4"))
    shapes = sorted({f.shape for f in frames})
    say(f"  (e) poserbpf_comparison --video, {len(rows)} frames in {video_s:.1f} s: PNG frames "
        f"{sorted(p.name for p in (out_dir / 'tracking').iterdir())} read back at {shapes}; "
        f"launches {json.dumps(read_counters(kernels))}")
    if len(frames) != VIDEO_FRAMES or shapes != [(240, 320, 3)]:
        fail(f"phase 15 (e): the video's frames are not {VIDEO_FRAMES} of 240x320x3: {shapes}")
    return {"generator": counts, "generator_ms": ms, "errs": errs, "generator_s": gen_s,
            "video_s": video_s}


def phase_fifteen(kernels, seed, held_k2, smi, pth) -> dict:
    """Phase 15 (a)-(e) (the docstring's). Returns the launch counts by
    path."""
    import torch.distributed as dist

    from latentfusion_tpu_torch import parallel
    from latentfusion_tpu_torch.recon.inference import LatentFusionModel

    say(f"== phase 15/16: the parallel layer: {PARALLEL_RANKS} ranks sharing the card over "
        f"gloo (the data-parallel step, the sharded estimators, the TP decode), FSDP on "
        f"{FSDP_RANKS} NCCL rank, the PGGAN generator and the video writer")
    t15 = time.perf_counter()
    PARALLEL_DIR.mkdir(parents=True, exist_ok=True)
    model = LatentFusionModel.from_checkpoint(pth)
    est_inputs = estimator_inputs(model, seed)
    tp_in = tp_inputs(seed)
    ranks = start_ranks(PARALLEL_DIR, {"seed": seed, "pth": str(pth), **est_inputs, **tp_in})
    t_ranks = time.perf_counter()

    # While the ranks start: the one-process references of (c) and (d), and (e).
    t = time.perf_counter()
    reset_counters(kernels)
    single_est = run_estimators(model, est_inputs, None, seed)
    est_counts = read_counters(kernels)
    del model
    ref = tp_decode(seed, tp_in)
    gen = phase_generator_video(kernels, held_k2, smi, pth)
    torch.cuda.empty_cache()
    refs_s = time.perf_counter() - t
    (PARALLEL_DIR / "go").touch()
    outs = wait_ranks(PARALLEL_DIR, ranks, t_ranks)
    ranks_s = time.perf_counter() - t_ranks
    say(f"  {PARALLEL_RANKS} ranks in {ranks_s:.1f} s (the one-process references of (c) and "
        f"(d) and leg (e) ran here, {refs_s:.1f} s, while the ranks started): ranks ready at "
        f"{json.dumps([round(o['start_s'], 1) for o in outs])} s and released at "
        f"{json.dumps([round(o['wait_s'], 1) for o in outs])} s of their own clocks; (a) "
        f"{json.dumps([round(o['dp_s'], 1) for o in outs])} s (models and batches "
        f"{json.dumps([round(o['dp_setup_s'], 1) for o in outs])} s), (c) "
        f"{json.dumps([round(o['estimators_s'], 1) for o in outs])} s, (d) "
        f"{json.dumps([round(o['tp_s'], 1) for o in outs])} s")

    # (a) The data-parallel step against one process on the same global batches.
    t = time.perf_counter()
    recipe = recipe_setup(seed)
    batches = recipe_batches(seed)
    sums = [batch_sums(b) for b in batches]
    if any(o["batch_sums"] != sums for o in outs):
        fail("phase 15 (a): a rank rendered other global batches than this process")
    single = recipe_steps(kernels, recipe, batches)
    floors = []
    for eps in PARALLEL_FLOOR_EPS:
        pert = recipe_steps(kernels, recipe, batches, perturb=(eps, 0))
        floors.append({"loss": max(abs(a - b) for a, b in zip(pert["losses"], single["losses"])),
                       "params": params_rel(pert["params"], single["params"])})
        del pert
    floor = {k: max(f[k] for f in floors) for k in ("loss", "params")}
    dp_params = torch.load(PARALLEL_DIR / "dp_params.pt", map_location="cuda")
    dp = outs[0]["dp"]
    diff = {"loss": max(abs(a - b) for a, b in zip(dp["losses"], single["losses"])),
            "params": params_rel(dp_params, single["params"])}
    same_bits = all(o["dp"]["bits"] == dp["bits"] for o in outs) and \
        bit_sums(dp_params) == dp["bits"]
    dp_s = time.perf_counter() - t
    say(f"  (a) the recipe's step (bf16, global batch {TRAIN_BATCH}), {PARALLEL_STEPS} steps at "
        f"{PARALLEL_RANKS} ranks: losses {json.dumps(dp['losses'])} against one process "
        f"{json.dumps(single['losses'])}; ms per step by rank "
        f"{json.dumps([[round(x, 1) for x in o['dp']['ms']] for o in outs])} against "
        f"{json.dumps([round(x, 1) for x in single['ms']])}; |loss diff| {diff['loss']:.3g}, "
        f"parameters' largest relative diff {diff['params']:.3g}; noise floor (eps "
        f"{json.dumps(PARALLEL_FLOOR_EPS)}) {json.dumps(floor)}, gate {FLOOR_FACTOR}x; the "
        f"ranks' parameters the same bits: {same_bits}; launches by rank "
        f"{json.dumps([o['dp']['counts'] for o in outs])}; one process and the floor here "
        f"{dp_s:.1f} s on {smi}")
    if not (diff["loss"] <= FLOOR_FACTOR * floor["loss"]
            and diff["params"] <= FLOOR_FACTOR * floor["params"]):
        fail("phase 15 (a): the data-parallel step parts from the one-process step beyond "
             "3x its noise floor")
    if not same_bits:
        fail("phase 15 (a): the ranks' parameters are not the same bits")
    for o in outs:
        if not (o["dp"]["counts"]["K1bv"] > 0 and o["dp"]["counts"]["K2b"] > 0):
            fail(f"phase 15 (a): a rank did not launch K1-bwd-vol and K2-bwd: {o['dp']['counts']}")
    del dp_params

    # (b) FSDP on a one-rank NCCL mesh (FSDP_RANKS), the same steps, last:
    # fully_shard changes the modules in place.
    t = time.perf_counter()
    parallel.init_distributed("cuda", init_method=f"file://{PARALLEL_DIR / 'fsdp_rendezvous'}",
                              rank=0, world_size=FSDP_RANKS)
    try:
        fsdp = recipe_steps(kernels, recipe, batches, parallel.make_mesh_2d(1, FSDP_RANKS),
                            fsdp=True)
    finally:
        dist.destroy_process_group()
    del batches, recipe
    torch.cuda.empty_cache()
    fdiff = {"loss": max(abs(a - b) for a, b in zip(fsdp["losses"], single["losses"])),
             "params": params_rel(fsdp["params"], single["params"])}
    say(f"  (b) FSDP (fully_shard on a {FSDP_RANKS}-rank NCCL data x fsdp mesh: gloo carries no "
        f"reduce_scatter or all_gather for CUDA tensors, NCCL no two ranks on one card), "
        f"{PARALLEL_STEPS} steps: losses {json.dumps(fsdp['losses'])}, ms per step "
        f"{json.dumps([round(x, 1) for x in fsdp['ms']])}; against one process |loss diff| "
        f"{fdiff['loss']:.3g}, parameters {fdiff['params']:.3g} (gate {FLOOR_FACTOR}x the "
        f"floor); launches {json.dumps(fsdp['counts'])}; {time.perf_counter() - t:.1f} s")
    if not (fdiff["loss"] <= FLOOR_FACTOR * floor["loss"]
            and fdiff["params"] <= FLOOR_FACTOR * floor["params"]):
        fail("phase 15 (b): the FSDP step parts from the one-process step beyond 3x its "
             "noise floor")
    del single, fsdp

    # (c) The sharded estimators against one process.
    check_estimators(outs[0]["estimators"], single_est, est_inputs, smi)
    if not all(same_tree(o["estimators"], outs[0]["estimators"]) for o in outs[1:]):
        fail("phase 15 (c): the ranks returned other estimates")
    say(f"    launches by rank {json.dumps([o['estimator_counts'] for o in outs])}, one process "
        f"{json.dumps(est_counts)}")

    # (d) The TP decode against the unsharded decode.
    tp = torch.load(PARALLEL_DIR / "tp.pt")
    errs = {k: float((tp[k] - ref[k]).abs().max()) / float(ref[k].abs().max())
            for k in ("depth", "mask")}
    tp_same = all(o["tp"]["bits"] == outs[0]["tp"]["bits"] for o in outs)
    bound_met = all(errs[k] <= DECODE_TOL_15 for k in errs)
    say(f"  (d) TP decode of {tp_in['cameras'].length} hypotheses (flagship Photographer, "
        f"{outs[0]['tp']['cut']} convolutions cut over {PARALLEL_RANKS} ranks): ms by rank "
        f"{json.dumps([round(o['tp']['ms'], 1) for o in outs])} against {ref['ms']:.1f} "
        f"unsharded; error relative to the largest value {json.dumps(errs)} (tol "
        f"{DECODE_TOL_15}, tests/test_parallel.py's); the ranks' outputs the same bits: "
        f"{tp_same}")
    if not (bound_met and tp_same and outs[0]["tp"]["cut"] > 0):
        fail(f"phase 15 (d): the TP decode parts from the unsharded decode beyond "
             f"{DECODE_TOL_15} of its largest value, or the ranks' outputs differ")
    del ref, tp, tp_in, est_inputs
    torch.cuda.empty_cache()

    total = time.perf_counter() - t15
    say(f"   phase 15 took {total:.1f} s on {smi} (ranks {ranks_s:.1f} s; after them (a) and "
        f"its floor {dp_s:.1f} s here)")
    return {"parallel_dp_rank0": outs[0]["dp"]["counts"],
            "parallel_dp_rank1": outs[1]["dp"]["counts"],
            "parallel_estimators_rank0": outs[0]["estimator_counts"],
            "generator": gen["generator"]}


# Phase 16: the measurement tools (latentfusion_tpu_torch.profile_*, bench_*),
# each run through its main with an argv, its trace under TOOLS_DIR.
TOOLS_DIR = ROOT / "latentfusion_tpu_torch" / "_build" / "tools"
# The kernels a profiler's trace must name, by the counter that counts them.
TRACE_KERNELS = {"K1": "fused_sample_fwd_staged_kernel", "K2": "lrelu_pnorm_fwd_kernel",
                 "K1b": "fused_sample_bwd_grid_staged_kernel", "K2b": "lrelu_pnorm_bwd_kernel"}
PROFILERS = {"profile_refinement": ([], ("K1", "K2", "K1b", "K2b")),
             "profile_cem": (["--samples", "128", "--iters", "10", "--top", "15"], ("K1", "K2"))}
# Each tool's printed lines in the JAX tool's format.
OPS_HEADER = re.compile(r"^== plane: /device:cuda \(total \d+\.\d{2} ms\) ==$")
OPS_LINE = re.compile(r"^ *\d+\.\d{3} ms  [ \d]{2}\d\.\d%  x\d+ +\S.*$")
TOOL_LINES = {
    "profile_decode": re.compile(r"^.{40} +\d+\.\d{2} ms$"),
    "bench_sampler": re.compile(r"^(cuda|plain|aten) +(fwd|fwd\+bwd) *: +\d+\.\d{3} ms/call "
                                r"\( *\d+\.\d TFLOP/s dense-matmul-equivalent\)$"),
    "bench_fuser": re.compile(r"^V=(?: 8|16|24) unroll: first call +\d+\.\d{2}s  "
                              r"fold +\d+\.\d{2} ms$"),
}
LOADER_KEYS = [{"stage", "ms_per_render", "renders_per_s"},
               {"stage", "s_per_item", "renders_per_s_per_worker"},
               {"stage", "workers", "transport", "s_per_batch", "renders_per_s",
                "steps_per_s_ceiling"}]


class Tee(io.TextIOBase):
    """Writes to the script's standard output and keeps a copy."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def lines(self) -> list:
        return "".join(self.parts).splitlines()


def run_tool_main(name: str, argv: list):
    """``latentfusion_tpu_torch.<name>.main(argv)``: its result, the lines
    it printed and its seconds."""
    import importlib

    module = importlib.import_module(f"latentfusion_tpu_torch.{name}")
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        result = module.main(argv)
    return result, tee.lines(), time.perf_counter() - t0


def counted_profiles(kernels, deltas: list):
    """``utils.profiling.profile`` patched to record the launch counters'
    change over each traced region into ``deltas``."""
    from latentfusion_tpu_torch.utils import profiling

    real = profiling.profile

    @contextlib.contextmanager
    def profile(*args, **kwargs):
        before = read_counters(kernels)
        with real(*args, **kwargs) as prof:
            yield prof
        after = read_counters(kernels)
        deltas.append({k: after[k] - before[k] for k in after})

    return mock.patch.object(profiling, "profile", profile)


def check_profiler(name, lines, trace_dir, delta, required, smi) -> dict:
    """A profiler's gates: its table in the JAX format; the trace names
    each required kernel, as many times as the counters rose over the
    traced call; no aten::grid_sampler_3d on either lane. Returns its
    kernel launches and the window's device-busy share."""
    from latentfusion_tpu_torch.utils import profiling

    header = [i for i, line in enumerate(lines) if OPS_HEADER.match(line)]
    rows = lines[header[0] + 1:] if header else []
    if len(header) != 1 or not rows or not all(OPS_LINE.match(line) for line in rows):
        fail(f"{name}: its top-ops table is not in the JAX tool's format: {lines[-5:]}")
    trace = profiling.newest_trace(trace_dir)
    durations, counts = profiling.op_totals(trace, "cuda")
    host = profiling.op_totals(trace, "cpu")[0]
    if any("grid_sampler_3d" in op for op in list(durations) + list(host)):
        fail(f"{name}: the trace holds aten::grid_sampler_3d, the plain sampler")
    launches = {}
    for key in required:
        launches[key] = sum(c for op, c in counts.items() if TRACE_KERNELS[key] in op)
        if not launches[key]:
            fail(f"{name}: the trace names no {TRACE_KERNELS[key]}")
        if launches[key] != delta[key]:
            fail(f"{name}: the trace holds {launches[key]} launches of {TRACE_KERNELS[key]}, "
                 f"the counters {delta[key]}")
    busy = profiling.device_busy(trace)
    say(f"   {name}: trace {trace.relative_to(ROOT)} ({trace.stat().st_size / 1e6:.1f} MB), "
        f"launches {json.dumps(launches)} (the counters' change over the traced call "
        f"{json.dumps(delta)}), device busy {busy['busy_ms']:.2f} ms of a "
        f"{busy['window_ms']:.2f} ms window: busy share {busy['busy_share']:.4f} on {smi}")
    return {"launches": delta, "busy_share": busy["busy_share"],
            "window_ms": busy["window_ms"], "busy_ms": busy["busy_ms"]}


def phase_sixteen(kernels, smi) -> dict:
    """Phase 16: every measurement tool through its ``main`` at the JAX
    tool's defaults (profile_cem at 128 samples x 10 iterations, printing
    its top 15; bench_sampler on the backends cuda, plain and aten). The
    gates: each tool returns and prints its lines in the JAX tool's format;
    the profilers' traces name K1-fwd's and K2-fwd's kernels (and, in
    refinement, K1-bwd-grid's and K2-bwd's), each launched as many times
    as its counter rose over the traced call, and no aten::grid_sampler_3d;
    bench_sampler's cuda and plain loops' accumulators agree within
    phase 2's bf16 tolerance, relative, in each mode. Returns each
    profiler's launches by kernel counter over its traced call."""
    import shutil

    say("== phase 16/16: the measurement tools: profile_refinement, profile_cem, "
        "profile_decode, bench_sampler, bench_fuser and bench_loader through their main")
    t16 = time.perf_counter()
    out, seconds = {}, {}
    for name, (argv, required) in PROFILERS.items():
        trace_dir = TOOLS_DIR / name
        for attempt in range(2):
            shutil.rmtree(trace_dir, ignore_errors=True)
            deltas = []
            try:
                with counted_profiles(kernels, deltas):
                    _, lines, seconds[name] = run_tool_main(
                        name, ["--trace-dir", str(trace_dir), *argv])
                break
            except RuntimeError as err:
                if NO_DEVICE_RECORDS not in str(err) or attempt:
                    raise
                say(f"   {name}: the profiler kept no device records of the traced call "
                    f"(see profiled): the tool runs again")
        if len(deltas) != 1:
            fail(f"{name}: {len(deltas)} traced regions, not 1")
        out[name] = check_profiler(name, lines, trace_dir, deltas[0], required, smi)
    for name, argv in (("profile_decode", []), ("bench_sampler", ["--backends", "cuda,plain,aten"]),
                       ("bench_fuser", [])):
        result, lines, seconds[name] = run_tool_main(name, argv)
        want = {"profile_decode": 4, "bench_sampler": 6, "bench_fuser": 3}[name]
        if len(lines) != want or not all(TOOL_LINES[name].match(line) for line in lines):
            fail(f"{name}: {len(lines)} lines, not {want} in the JAX tool's format: {lines}")
        if name == "bench_sampler":
            for mode in ("fwd", "fwd+bwd"):
                cuda, plain = result[f"cuda {mode}"]["acc"], result[f"plain {mode}"]["acc"]
                err = abs(cuda - plain) / abs(plain)
                say(f"   bench_sampler {mode}: cuda's accumulator {cuda!r}, plain's {plain!r}, "
                    f"relative {err:.2e} (gate {BF16_TOL:.2e})")
                if not err <= BF16_TOL:
                    fail(f"bench_sampler {mode}: the kernel's loop parts from the plain one "
                         f"by {err:.2e}")
    result, lines, seconds["bench_loader"] = run_tool_main("bench_loader", [])
    records = [json.loads(line) for line in lines]
    if [set(r) for r in records] != LOADER_KEYS or result != records:
        fail(f"bench_loader: its JSON lines are not the JAX tool's: {lines}")
    say(f"   phase 16 seconds by tool: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}; "
        f"phase 16 took {time.perf_counter() - t16:.1f} s on {smi}")
    return {f"tools_{name}": rec["launches"] for name, rec in out.items()}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--accuracy-seeds", type=int, nargs="+", default=None,
                        help="build the kernels, run phase 6's three accuracy rigs "
                             "(CEM, Metropolis, estimate_batch) ungated at each seed, "
                             "print the hits and exit")
    parser.add_argument("--with-unseen", action="store_true",
                        help="with --accuracy-seeds, also run phase 9's and phase 12 (b)'s "
                             "unseen-object rigs ungated at each seed")
    parser.add_argument("--unseen-latent-rank", action="store_true",
                        help="phase 9 also runs the rig with the latent ranking term at 0.2 "
                             "(ungated)")
    parser.add_argument("--eval-variants", action="store_true",
                        help="build the kernels, run phase 14's BOP and MOPED legs under the "
                             "settings they do not run (ungated), and exit")
    parser.add_argument("--parallel-only", action="store_true",
                        help="build the kernels, hold K2 at the generator's shapes (phase 2's "
                             "rows), write phase 14's .pth, run phase 15 and exit")
    parser.add_argument("--tools-only", action="store_true",
                        help="build the kernels, run phase 16 (the measurement tools) and exit")
    parser.add_argument("--rank-worker", nargs=3, metavar=("DIR", "RANK", "WORLD"),
                        help="internal: one rank of phase 15 (spawned by the script)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke.py needs an NVIDIA GPU: torch.cuda.is_available() is "
              "False", file=sys.stderr)
        sys.exit(2)

    if args.rank_worker:
        folder, rank, world = args.rank_worker
        rank_worker(Path(folder), int(rank), int(world))
        return

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

    say("== phase 1/16: device, kernel build, reference views")
    smi, build_s = phase_device(_build)
    say(f"   device: {torch.cuda.get_device_name(0)}; kernels built in {build_s:.2f} s")
    if args.tools_only:
        phase_sixteen(kernels, smi)
        say(f"   ({time.perf_counter() - t_start:.1f} s)")
        return
    check_reference_views(torch.device("cuda"))
    state = split_state_dict(from_jax_params(load_params_npz(
        DISTILL / "encoder_distill.npz", DISTILL / "encoder_distill_keys.json")))

    def demo_model():
        return LatentFusionModel(zoo.demo_sculptor(), state["sculptor"],
                                 zoo.demo_fuser(), state["fuser"],
                                 zoo.demo_photographer(), state["photographer"],
                                 camera_dist=zoo.DEMO_CAMERA_DIST)

    demo = demo_model()
    if args.parallel_only:
        say("== phase 2/16, the generator's K2 rows only")
        gen_k2 = phase_generator_kernels(lrelu_pnorm, args.seed)
        EVAL_DIR.mkdir(parents=True, exist_ok=True)
        write_demo_pth(state, EVAL_DIR / "encoder_distill.pth")
        del demo
        torch.cuda.empty_cache()
        phase_fifteen(kernels, args.seed, gen_k2["calls"], smi, EVAL_DIR / "encoder_distill.pth")
        say(f"   ({time.perf_counter() - t_start:.1f} s)")
        return
    if args.eval_variants:
        say("== phase 14 (a) and (b) under other settings, ungated")
        phase_eval_variants(kernels, smi, state, args.seed)
        say(f"   ({time.perf_counter() - t_start:.1f} s)")
        return
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
                say(f"== phase 12 (b) at seed {seed}")
                table[seed]["unseen real"] = sum(
                    phase_data_heldout(kernels, seed, None, checks=False)["hits"])
        say(f"   hits by seed (phase 6 of 8, phases 9 and 12 of 24), {smi}: {json.dumps(table)} "
            f"({time.perf_counter() - t_start:.1f} s)")
        return

    say("== phase 2/16: kernels against their plain versions")
    records, k1_table, k2f_tables = phase_kernels(fused_sample, lrelu_pnorm, args.seed)
    bwd_records, k2b_table = phase_bwd_kernels(fused_sample, lrelu_pnorm, args.seed)
    records.update(bwd_records)
    train_records, bwd_vol_rows = phase_train_kernels(fused_sample, args.seed)
    records.update(train_records)
    k3 = phase_k3_shape(fused_sample, args.seed)
    new_rows, held = phase_new_shapes(fused_sample, args.seed)
    option_rows, option_held = phase_option_shapes(fused_sample, args.seed)
    data_rows, data_held = phase_data_shapes(fused_sample, args.seed)
    trainer_rows, trainer_held = phase_trainer_shapes(fused_sample, args.seed)
    data_held |= held | option_held | {row["held"] for row in bwd_vol_rows.values()}
    eval_held = {(*k, "float32") for k in data_held} | trainer_held
    eval_rows, new_eval_held = phase_eval_shapes(fused_sample, args.seed, eval_held)
    eval_held |= new_eval_held
    gen_k2 = phase_generator_kernels(lrelu_pnorm, args.seed)
    say(f"   kernels: {json.dumps({k: {m: v[m] for m in ('ms', 'plain_ms', 'bound_ms', 'library_ms')} for k, v in records.items()})}")
    say(f"   K1-fwd by shape (kernel that served it): "
        f"{json.dumps([{m: r[m] for m in ('shape', 'kernel', 'ms', 'bound_ms', 'plain_ms', 'library_ms')} for r in k1_table + [k3['K1-fwd'], k3['K1-fwd gather']]])}")
    say(f"   K1 at K3's shape: {json.dumps(k3)}")
    say(f"   K1-bwd-vol at the training shapes: {json.dumps(bwd_vol_rows)}")
    say(f"   K1 at the multi-object and latent shapes: {json.dumps(new_rows)}")
    say(f"   K1 at phase 11's shapes: {json.dumps(option_rows)}")
    say(f"   K1 at phase 12's shapes: {json.dumps(data_rows)}")
    say(f"   K1 at phase 13's shapes: {json.dumps(trainer_rows)}")
    say(f"   K1 at phase 6's metropolis_eval and phase 14's shapes: {json.dumps(eval_rows)}")

    say(f"== phase 3/16: flagship build from 16 views + render of {N_HYPOTHESES}")
    gen = torch.Generator().manual_seed(args.seed)
    flagship = LatentFusionModel(zoo.flagship_sculptor(generator=gen), None,
                                 zoo.flagship_fuser(generator=gen), None,
                                 zoo.flagship_photographer(generator=gen), None,
                                 camera_dist=CAMERA_DIST)
    counts = drive_slice("flagship", flagship, objects, kernels, args.seed,
                         profile=True)
    say(f"   flagship launches per object: {json.dumps(counts)}")
    build_launches(flagship, kernels)

    say(f"== phase 4/16: demo family, learned weights, render of {N_HYPOTHESES}")
    demo_counts = drive_slice("demo", demo, objects, kernels, args.seed,
                              profile=False)
    say(f"   demo launches per object: {json.dumps(demo_counts)}")

    say("== phase 5/16: flagship pose of view 15 of o0: CEM "
        "(cross_entropy_quick) then refinement (adam_quick); then the latent path "
        "(cross_entropy_latent, adam_latent)")
    pose_counts = phase_pose_flagship(flagship, kernels, args.seed, {
        "fwd": k2f_tables["refinement step"], "bwd": k2b_table})
    say(f"   pose path launches: {json.dumps(pose_counts)}")
    latent_cem, latent_refine = phase_latent_flagship(flagship, kernels, args.seed, held)
    say(f"   latent path launches: CEM {json.dumps(latent_cem)}, refinement "
        f"{json.dumps(latent_refine)}")
    torch.cuda.empty_cache()

    say("== phase 6/16: pose accuracy, demo family, learned weights, 8 oracle targets: "
        "estimate_batch (fp32) with the refinement step's gradient check; then "
        "metropolis_eval (bf16): CEM and Metropolis")
    t6 = time.perf_counter()
    accuracy_counts, _ = phase_pose_accuracy(demo, kernels, args.seed, legs=())
    del demo
    torch.cuda.empty_cache()
    metropolis = phase_metropolis_eval(kernels, eval_held, smi, args.seed)
    say(f"   phase 6 took {time.perf_counter() - t6:.1f} s on {smi}")

    say(f"== phase 7/16: flagship training step, global batch {TRAIN_BATCH} in "
        f"{TRAIN_MICROBATCHES} microbatches, {TRAIN_IN} + {TRAIN_OUT} views")
    train_counts = phase_train(kernels, args.seed)
    say(f"   training step launches: {json.dumps(train_counts)}")

    say("== phase 8/16: the pose service at flagship width, two rounds of requests (the "
        "warm one o0's alone)")
    service_counts = phase_service(flagship, kernels, args.seed)
    say(f"   service launches, warm round (o0 alone): {json.dumps(service_counts)}")
    del flagship
    torch.cuda.empty_cache()

    say(f"== phase 9/16: unseen objects, pool-128 checkpoint, {UNSEEN_OBJECTS} held-out objects "
        f"x {UNSEEN_TARGETS} targets in estimate_batch; then the mid width")
    t9 = time.perf_counter()
    unseen = phase_unseen(kernels, args.seed, held, latent_rank=args.unseen_latent_rank)
    say(f"   unseen objects: {sum(unseen['demo']['hits'])} of "
        f"{UNSEEN_OBJECTS * UNSEEN_TARGETS} within 0.1d (gate {UNSEEN_GATE}); phase 9 took "
        f"{time.perf_counter() - t9:.1f} s on {smi}")

    say("== phase 10/16: the reconstruction API, demo family, learned weights: 16 oracle "
        "views through save + load, render_full, render_ibr_basic and render_ibr at 8 targets")
    t10 = time.perf_counter()
    recon_counts = phase_recon(demo_model(), kernels, args.seed)
    say(f"   reconstruction launches: {json.dumps(recon_counts)}; phase 10 took "
        f"{time.perf_counter() - t10:.1f} s on {smi}")

    options = phase_eleven(kernels, args.seed, option_held, smi)
    data = phase_twelve(kernels, args.seed, data_held, smi)
    trainer = phase_thirteen(kernels, args.seed, trainer_held, smi)
    evaluation = phase_fourteen(kernels, args.seed, eval_held, smi, state, metropolis)
    parallel = phase_fifteen(kernels, args.seed, gen_k2["calls"], smi,
                             EVAL_DIR / "encoder_distill.pth")
    tools = phase_sixteen(kernels, smi)

    total = time.perf_counter() - t_start
    say(f"   total {total:.1f} s on {smi}")
    paths = {"pose": pose_counts, "train_step": train_counts,
             "latent_cem": latent_cem, "latent_refine": latent_refine,
             "metropolis_eval": metropolis["counts"],
             "estimate_batch_8_targets": accuracy_counts["batch"],
             "service_warm_round": service_counts,
             "unseen_demo_batches": unseen["demo"]["counts"],
             "unseen_mid_round": unseen["mid"]["counts"],
             "reconstruction": recon_counts, **options, **data, **trainer, **evaluation,
             **parallel, **tools}
    for key in records:
        records[key]["launches_by_path"] = {path: c[key] for path, c in paths.items()}
        records[key]["launches"] = train_counts[key] if key == "K1bv" else pose_counts[key]
    say(json.dumps({"kernels": [records[k] for k in ("K1", "K1b", "K1bv", "K2", "K2b")]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
