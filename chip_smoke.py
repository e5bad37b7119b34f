"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each announced on its own line before it starts and reported on one
line after it ends:

1. device: the card's name and power limit; build both CUDA kernels with
   nvcc (one process per source, started together).
2. kernels: each kernel against its plain PyTorch version at the shapes of
   the build + render path, with kernel, plain and library times (CUDA
   events, warm-up excluded), then one ``kernels`` JSON line.
3. flagship: for each committed object (artifacts/serving/frames/refs_o*.npz,
   16 views of 480x640 RGB-D), build the latent object with the flagship
   family (weights drawn from --seed) and render it from 128 hypothesis
   cameras; the launch counters must show both kernels on this path, and
   the result must agree with the same path on the plain versions. One
   render of the first object is profiled: device time by kernel.
4. demo: the same at the demo family with the learned weights of
   artifacts/encoder_distill/encoder_distill.npz.

The last line is ``{"ok": true, "device": {...}}``. Any failure exits
non-zero, as does a machine without a GPU. TF32 is off throughout, so
kernel and plain paths compare in fp32.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FRAMES = ROOT / "artifacts" / "serving" / "frames"
DISTILL = ROOT / "artifacts" / "encoder_distill"
N_HYPOTHESES = 128
CAMERA_DIST = 5.78  # the committed objects are unit-sized, seen from ~5.7
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 peak memory rate
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
FP32_TOL = 1e-5  # kernel vs plain, fp32: same arithmetic, other sum order
BF16_TOL = 2.0 ** -7  # bf16 output: one rounding step, relative
NET_TOL = 5e-4  # a network's output on the kernels vs on the plain versions


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(message: str) -> None:
    say(f"FAIL: {message}")
    sys.exit(1)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1.0)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
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
    # shared latent, 128 cameras) and encode (16 views, each its own
    # volume). The volumes are random; the grids set the access pattern.
    obs = load_views(FRAMES / "refs_o0.npz", dev)
    size = zoo.FLAGSHIP_INPUT_SIZE
    decode_grid = transforms.object_to_camera_grid(
        hypothesis_cameras(obs, size, CAMERA_DIST, g), 16)
    encode_grid = transforms.camera_to_object_grid(
        obs.camera.zoom(None, size, CAMERA_DIST), 16)
    del obs
    for label, nv, grid in (("decode", 1, decode_grid), ("encode", 16, encode_grid)):
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
                abs_err = float((out.float() - ref.float()).abs().max())
                say(f"  K1 {label} NV={nv} N={n} C={c} 16^3 {padding} "
                    f"{str(dtype)[6:]}: rel err {err:.3g} (tol {tol:.3g})")
                if not err <= tol:
                    fail(f"K1 {label} {padding} {dtype} disagrees with plain")
                if label == "decode" and padding == "border" and dtype == torch.float32:
                    ms = time_ms(lambda: fused_sample.grid_sample_3d_fused(vol, grid, padding))
                    plain = time_ms(lambda: fused_sample.grid_sample_3d_plain(vol, grid, padding), iters=3)
                    vol_n = vol.expand(n, -1, -1, -1, -1)
                    lib = time_ms(lambda: torch.nn.functional.grid_sample(
                        vol_n, grid, mode="bilinear", padding_mode=padding,
                        align_corners=False))
                    nbytes = vol.numel() * 4 + grid.numel() * 4 + out.numel() * 4
                    # 8 multiply-adds per output + ~40 operations per sample.
                    flops = 16.0 * out.numel() + 40.0 * grid[..., 0].numel()
                    b, by = bound_ms(nbytes, flops)
                    records["K1"] = dict(
                        name="fused_sample_fwd", route="cuda",
                        source="latentfusion_tpu_torch/csrc/fused_sample.cu",
                        replaces="latentfusion_tpu/ops/pallas_fused_sample.py:314",
                        max_abs_err=abs_err, ms=ms, plain_ms=plain, bound_ms=b,
                        bound_by=by, library_ms=lib)
        del vol32, vol, out, ref
    del decode_grid, encode_grid, grid

    # K2 at shapes of the path: a flagship camera block (3D, 128 cameras),
    # a decoder block with 196 channels, and the decoder's last block.
    shapes = ((N_HYPOTHESES, 196, 32, 32), (N_HYPOTHESES, 256, 16, 16, 16),
              (N_HYPOTHESES, 64, 128, 128))
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(*shape, generator=g, device=dev).to(dtype)
            y, inv = lrelu_pnorm.lrelu_pixel_norm_fwd(x, 0.2, 1e-8)
            y_ref, inv_ref = lrelu_pnorm.lrelu_pixel_norm_plain(x, 0.2, 1e-8)
            torch.cuda.synchronize()
            err = max(rel_err(y, y_ref), rel_err(inv, inv_ref))
            tol = FP32_TOL if dtype == torch.float32 else BF16_TOL
            say(f"  K2 {shape} {str(dtype)[6:]}: rel err {err:.3g} (tol {tol:.3g})")
            if not err <= tol:
                fail(f"K2 {shape} {dtype} disagrees with plain")
            if shape == shapes[-1] and dtype == torch.float32:
                ms = time_ms(lambda: lrelu_pnorm.lrelu_pixel_norm_fwd(x, 0.2, 1e-8))
                plain = time_ms(lambda: lrelu_pnorm.lrelu_pixel_norm_plain(x, 0.2, 1e-8), iters=3)
                nbytes = 2 * x.numel() * 4 + inv.numel() * 4
                b, by = bound_ms(nbytes, 6.0 * x.numel())
                records["K2"] = dict(
                    name="lrelu_pnorm_fwd", route="cuda",
                    source="latentfusion_tpu_torch/csrc/lrelu_pnorm.cu",
                    replaces="latentfusion_tpu/ops/pallas_lrelu_pnorm.py:87",
                    max_abs_err=float((y - y_ref).abs().max()), ms=ms,
                    plain_ms=plain, bound_ms=b, bound_by=by, library_ms=None)
            del x, y, inv, y_ref, inv_ref
    torch.cuda.empty_cache()
    return records


def load_views(path: Path, device):
    """A committed reference object as an Observation (16 views)."""
    from latentfusion_tpu_torch.camera import Camera
    from latentfusion_tpu_torch.observation import Observation

    with np.load(path) as z:
        arrays = {k: z[k] for k in ("color", "depth", "mask", "intrinsic", "extrinsic")}
    h, w = arrays["color"].shape[-2:]
    camera = Camera(arrays["intrinsic"], arrays["extrinsic"], width=w, height=h,
                    device=device)
    return Observation(arrays["color"], arrays["depth"], arrays["mask"], camera)


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

    fused_sample, lrelu_pnorm = kernels
    counts = {}
    for name, path in objects:
        obs = load_views(path, model.device)
        cams = hypothesis_cameras(obs, model.input_size, model.camera_dist,
                                  torch.Generator(device=model.device).manual_seed(seed))
        fused_sample.LAUNCHES = lrelu_pnorm.LAUNCHES = 0
        z = model.build_latent_object(obs)
        y, _ = model.render_latent_object(z, cams, return_latent=False)
        torch.cuda.synchronize()
        counts[name] = {"K1": fused_sample.LAUNCHES, "K2": lrelu_pnorm.LAUNCHES}
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
        render_ms = time_ms(lambda: model.render_latent_object(
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
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
    objects = [(f"o{i}", FRAMES / f"refs_o{i}.npz") for i in (0, 1)]
    t_start = time.perf_counter()

    say("== phase 1/4: device and kernel build")
    smi, build_s = phase_device(_build)
    say(f"   device: {torch.cuda.get_device_name(0)}; kernels built in {build_s:.2f} s")

    say("== phase 2/4: kernels against their plain versions")
    records = phase_kernels(fused_sample, lrelu_pnorm, args.seed)
    say(f"   kernels: {json.dumps({k: {m: v[m] for m in ('ms', 'plain_ms', 'bound_ms', 'library_ms')} for k, v in records.items()})}")

    say(f"== phase 3/4: flagship build from 16 views + render of {N_HYPOTHESES}")
    gen = torch.Generator().manual_seed(args.seed)
    model = LatentFusionModel(zoo.flagship_sculptor(generator=gen), None,
                              zoo.flagship_fuser(generator=gen), None,
                              zoo.flagship_photographer(generator=gen), None,
                              camera_dist=CAMERA_DIST)
    counts = drive_slice("flagship", model, objects, kernels, args.seed,
                         profile=True)
    del model
    torch.cuda.empty_cache()
    say(f"   flagship launches per object: {json.dumps(counts)}")

    say(f"== phase 4/4: demo family, learned weights, render of {N_HYPOTHESES}")
    state = split_state_dict(from_jax_params(load_params_npz(
        DISTILL / "encoder_distill.npz", DISTILL / "encoder_distill_keys.json")))
    model = LatentFusionModel(zoo.demo_sculptor(), state["sculptor"],
                              zoo.demo_fuser(), state["fuser"],
                              zoo.demo_photographer(), state["photographer"],
                              camera_dist=zoo.DEMO_CAMERA_DIST)
    demo_counts = drive_slice("demo", model, objects, kernels, args.seed,
                              profile=False)
    say(f"   demo launches per object: {json.dumps(demo_counts)}")

    total = time.perf_counter() - t_start
    say(f"   total {total:.1f} s on {smi}")
    for key in records:
        records[key]["launches"] = counts["o0"][key]
    say(json.dumps({"kernels": [records["K1"], records["K2"]]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
