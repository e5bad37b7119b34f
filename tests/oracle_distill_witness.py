"""Run the JAX package's oracle-distillation tool on the CPU on its committed
checkpoint, to settle which coarse search made
``artifacts/oracle_distill/pose_eval.json``, and compute the tool's
sharpness curve on that checkpoint in fp32 and in bf16.

    python tests/oracle_distill_witness.py --out DIR [--configs quick slow]
        [--targets 2] [--coarse-only] [--curves]

Each config copies ``distilled.npz`` and its keys into ``DIR/<config>`` and
runs ``tools/train_oracle_distill.py --cpu --skip-train --eval-targets N
--coarse-config <config>`` there, unchanged. JAX's random draws are the same
on every backend, so the config whose coarse rows lie nearest the record's
is the one the record was made with; each config prints one line starting
``WITNESS`` with its rows and its distance to the record's.
``--coarse-only`` stops the tool's refinement (``run_tool_coarse_only``:
its bf16 refinement takes hours on a CPU), which leaves the coarse rows as
they are. ``--curves``
computes the 13-point curve of ``--sharpness-probe`` (the tool's probe, in
this process) in fp32 and in bf16, writes both to
``tests/oracle_distill_sharpness.json`` with their largest difference, and
prints how far the CPU's bf16 curve lies from the record's curve.
"""
import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
RECORD = ROOT / "artifacts" / "oracle_distill"
CURVES = ROOT / "tests" / "oracle_distill_sharpness.json"
METRICS = ("add_s", "rotation_dist", "translation_dist")
ANGLES = tuple(float(a) for a in np.linspace(0.0, 0.6, 13))  # the tool's probe
sys.path.insert(0, str(ROOT))


def _tool():
    spec = importlib.util.spec_from_file_location("_jax_train_oracle_distill",
                                                  ROOT / "tools" / "train_oracle_distill.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def coarse_distance(rows, record_rows) -> float:
    """The summed absolute difference of the coarse metrics, target by target."""
    return sum(abs(r["coarse"][k] - q["coarse"][k])
               for r, q in zip(rows, record_rows) for k in METRICS)


def run_tool_coarse_only(argv) -> None:
    """The JAX tool's ``main`` with ``argv``, its refinement returning the
    coarse cameras it is given (``refined`` then repeats ``coarse``): on
    this CPU a bf16 refinement of 16 for 150 steps takes hours, and the
    coarse rows, computed before it, are what the witness reads."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from latentfusion_tpu.pose import estimation

    tool = _tool()
    estimation.GradientPoseEstimator.estimate = (
        lambda self, z_obj, target, camera=None, **kwargs: camera[:self.ranking_size])
    sys.argv = ["train_oracle_distill.py", *argv]
    tool.main()


def run_config(out: Path, config: str, targets: int, coarse_only: bool = False) -> dict:
    work = out / config
    work.mkdir(parents=True, exist_ok=True)
    for name in ("distilled.npz", "distilled_keys.json"):
        shutil.copy(RECORD / name, work / name)
    env = dict(os.environ, LATENTFUSION_TPU_CACHE=str(out / "xla_cache"),
               JAX_PLATFORMS="cpu")
    argv = ["--cpu", "--skip-train", "--out", str(work), "--eval-targets", str(targets),
            "--coarse-config", config]
    cmd = ([sys.executable, __file__, "--out", str(out), "--tool-coarse-only", *argv]
           if coarse_only else
           [sys.executable, str(ROOT / "tools" / "train_oracle_distill.py"), *argv])
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, env=env, cwd=ROOT)
    rows = json.loads((work / "pose_eval.json").read_text())["targets"]
    record = json.loads((RECORD / "pose_eval.json").read_text())["targets"][:targets]
    return {"config": config, "targets": targets, "refined_is_coarse": coarse_only,
            "coarse": [{k: round(r["coarse"][k], 6) for k in METRICS} for r in rows],
            "refined": [{k: round(r["refined"][k], 6) for k in METRICS} for r in rows],
            "record_coarse": [{k: round(r["coarse"][k], 6) for k in METRICS} for r in record],
            "coarse_distance": round(coarse_distance(rows, record), 6),
            "seconds": round(time.perf_counter() - t0, 1)}


def sharpness_curves(angles=ANGLES, names=("float32", "bfloat16")) -> dict:
    """The tool's ``--sharpness-probe`` on the committed checkpoint, in each
    compute dtype of ``names``: the fine estimator's score at a rotation of
    each of ``angles`` about y, against the target at the identity."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from latentfusion_tpu import dtypes, testing
    from latentfusion_tpu.pose import estimation
    from latentfusion_tpu.recon import models
    from latentfusion_tpu.recon.inference import LatentFusionModel

    tool = _tool()
    photographer = models.Photographer(
        in_size=tool.LATENT_SIZE, image_config=tool.PHOTOGRAPHER_IMAGE_CONFIG,
        camera_config=tool.PHOTOGRAPHER_CAMERA_CONFIG, object_config=None,
        projection_type="factor", predict_color=False, predict_depth=True,
        predict_mask=True, cube_size=1.0, scale_mode="nearest")
    params = load_distilled(photographer, tool)
    model = LatentFusionModel(sculptor=None, sculptor_params={}, fuser=None, fuser_params={},
                              photographer=photographer,
                              photographer_params=params["photographer"],
                              camera_dist=tool.CAMERA_DIST)
    model.input_size = tool.INPUT_SIZE
    fine = estimation.GradientPoseEstimator(
        model=model, ranking_size=8, loss_weights={"depth": 1.0, "ov_depth": 0.3},
        learning_rate=0.01, num_samples=16, num_iters=150, converge_threshold=1e-6,
        converge_patience=25, optimizer="adam")
    oracle = testing.EllipsoidOracleModel(input_size=tool.INPUT_SIZE,
                                          camera_dist=tool.CAMERA_DIST, axes=tool.AXES)
    probe_cam = testing.make_camera(1, z=tool.CAMERA_DIST, f=615.0, width=640, height=480)
    target = jax.jit(oracle.make_observation)(probe_cam)
    curves = {}
    for name in names:
        dtypes.set_compute_dtype(name)
        curve = []
        for ang in angles:
            q = np.concatenate([[np.cos(ang / 2)],
                                np.sin(ang / 2) * np.asarray([0.0, 1.0, 0.0])]).astype(np.float32)
            cam = testing.make_camera(1, z=tool.CAMERA_DIST, f=615.0, width=640, height=480,
                                      quats=jnp.asarray(q)[None])
            loss, _ = fine._score_hypotheses(params["z_obj"], target, cam)
            curve.append(float(loss[0]))
        curves[name] = curve
    dtypes.set_compute_dtype("float32")
    return curves


def load_distilled(photographer, tool, path=RECORD / "distilled.npz"):
    """The tool's ``--skip-train`` load: the flat npz unflattened against
    the structure of its template {photographer, z_obj}."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    cam0 = tool_cameras(tool, jax.random.PRNGKey(1), 2)
    z0 = jnp.zeros((2, tool.LATENT_CHANNELS) + (tool.LATENT_SIZE,) * 3)
    # The tree's structure only: eval_shape traces the init without running it.
    template = {"photographer": jax.eval_shape(photographer.init, jax.random.PRNGKey(0), z0,
                                               cam0),
                "z_obj": jnp.zeros((1, 1, tool.LATENT_CHANNELS) + (tool.LATENT_SIZE,) * 3)}
    data = np.load(path)
    leaves = [jnp.asarray(data[str(i)]) for i in range(len(data.files))]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(template), leaves)


def tool_cameras(tool, key, n, zoomed=True):
    """The tool's ``random_full_cameras`` (zoomed: ``random_zoomed_cameras``)."""
    import jax
    import jax.numpy as jnp

    from latentfusion_tpu import three, zoo
    from latentfusion_tpu.camera import Camera
    from latentfusion_tpu.three import quaternion as quat

    k1, k2 = jax.random.split(key)
    quats = quat.random(k1, n)
    trans = jnp.asarray([0.0, 0.0, tool.CAMERA_DIST]) + jax.random.normal(
        k2, (n, 3)) * jnp.asarray([0.1, 0.1, 0.25])
    template = zoo.canonical_camera(1, tool.INPUT_SIZE, camera_dist=tool.CAMERA_DIST)
    cam = Camera(jnp.broadcast_to(template.intrinsic, (n, *template.intrinsic.shape[1:])),
                 three.to_extrinsic_matrix(trans, quats), z_span=template.z_span,
                 width=template.width, height=template.height)
    return cam.zoom(None, tool.INPUT_SIZE, tool.CAMERA_DIST) if zoomed else cam


def write_curves() -> dict:
    t0 = time.perf_counter()
    curves = sharpness_curves()
    record = [p["loss"] for p in
              json.loads((RECORD / "pose_eval.json").read_text())["sharpness_curve"]]
    spread = max(abs(a - b) for a, b in zip(curves["bfloat16"], curves["float32"]))
    rec = {"angles_rad": ANGLES, "float32": curves["float32"], "bfloat16": curves["bfloat16"],
           "bf16_fp32_spread": spread,
           "record_tpu": record,
           "cpu_bf16_vs_record": max(abs(a - b) for a, b in zip(curves["bfloat16"], record)),
           "argmin_rad": {k: ANGLES[min(range(13), key=v.__getitem__)]
                          for k, v in (("float32", curves["float32"]),
                                       ("bfloat16", curves["bfloat16"]),
                                       ("record_tpu", record))},
           "seconds": round(time.perf_counter() - t0, 1)}
    CURVES.write_text(json.dumps(rec, indent=1) + "\n")
    return rec


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--configs", nargs="*", default=[], choices=["quick", "slow"])
    parser.add_argument("--targets", type=int, default=2)
    parser.add_argument("--curves", action="store_true")
    parser.add_argument("--coarse-only", action="store_true",
                        help="skip the tool's refinement (run_tool_coarse_only)")
    parser.add_argument("--tool-coarse-only", nargs=argparse.REMAINDER,
                        help="internal: run the tool with these arguments, coarse only")
    args = parser.parse_args(argv)
    if args.tool_coarse_only is not None:
        run_tool_coarse_only(args.tool_coarse_only)
        return
    args.out.mkdir(parents=True, exist_ok=True)
    for config in args.configs:
        rec = run_config(args.out, config, args.targets, args.coarse_only)
        (args.out / f"witness_{config}.json").write_text(json.dumps(rec, indent=1))
        print("WITNESS", json.dumps(rec), flush=True)
    if args.curves:
        print("WITNESS", json.dumps(write_curves()), flush=True)


if __name__ == "__main__":
    main()
