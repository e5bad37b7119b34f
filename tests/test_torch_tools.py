"""The port's measurement tools held against the JAX package's on the CPU, at
the tiny family's widths with the JAX weights carried across
(``recon.checkpoint.from_jax_params``):

- ``profile_decode``'s four functions against JAX's, built as
  ``tools/profile_decode.py:60-100`` builds them, on the tool's inputs
  (``profile_refinement.target_setup``) drawn from JAX's keys;
- ``profile_refinement``'s and ``profile_cem``'s inputs (target camera,
  latent, target observation, initial cameras) fed JAX's draws, and their
  estimators' arguments, against the JAX tools'; and a traced estimate of
  each read back by ``top_ops`` (the estimates themselves are held by
  ``tests/test_torch_pose.py``);
- ``bench_sampler``'s loops (``fwd`` and ``fwd+bwd`` with respect to the
  grid) on every backend, against the same loops over JAX's
  ``grid_sample_3d_fused`` (interpret mode), in fp32;
- ``bench_fuser``'s fold against JAX's ``GRUFuser``, scanned and unrolled;
- ``bench_loader``'s JSON lines, whose keys are the JAX tool's.

The random draws cannot share JAX's stream, so JAX's are injected
(``inject``: ``torch.rand`` and ``torch.randn`` return JAX's arrays in
order).

Tolerances: 1e-5 relative for the sampler's loops (the same arithmetic in
another order), 2e-4 for geometry (renders and cameras), 5e-4 for networks
(depth, the pose loss, the fold) relative to the largest magnitude, and
2e-4 for each camera leaf's gradient relative to its largest entry.
"""
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))

from test_torch_slice import close_rel, to_state  # noqa: E402

from latentfusion_tpu import testing as jtesting  # noqa: E402
from latentfusion_tpu import transforms as jtransforms  # noqa: E402
from latentfusion_tpu import zoo as jzoo  # noqa: E402
from latentfusion_tpu.ops.pallas_fused_sample import grid_sample_3d_fused  # noqa: E402
from latentfusion_tpu.pose import estimation as jest  # noqa: E402
from latentfusion_tpu.pose import utils as jpu  # noqa: E402
from latentfusion_tpu.recon import fusion as jfusion  # noqa: E402
from latentfusion_tpu.recon import models as jmodels  # noqa: E402
from latentfusion_tpu.recon.inference import LatentFusionModel as JModel  # noqa: E402

from latentfusion_tpu_torch import (bench_fuser, bench_sampler, profile_cem,  # noqa: E402
                                    profile_decode, profile_refinement, zoo)
from latentfusion_tpu_torch.pose import estimation  # noqa: E402
from latentfusion_tpu_torch.pose import utils as tpu  # noqa: E402
from latentfusion_tpu_torch.recon.inference import LatentFusionModel as TModel  # noqa: E402
from latentfusion_tpu_torch.utils import profiling  # noqa: E402

LOOP_TOL = 1e-5
GEOM_TOL = 2e-4
NET_TOL = 5e-4
GRAD_TOL = 2e-4
N, DIST, LATENT = 4, 1.5, (4, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def models():
    """The tiny family on both sides with the JAX Photographer's weights."""
    ph = jzoo.tiny_photographer()
    params = jax.jit(ph.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8, 8)),
                              jzoo.canonical_camera(1, 16))
    jm = JModel(jzoo.tiny_sculptor(), None, jzoo.tiny_fuser(), None, ph, params,
                camera_dist=DIST)
    tm = TModel(zoo.tiny_sculptor(device="cpu"), None, zoo.tiny_fuser(device="cpu"), None,
                zoo.tiny_photographer(device="cpu"), to_state(params), camera_dist=DIST,
                device="cpu")
    return jm, tm


def jax_setup(input_size, n):
    """The JAX tools' setup (``tools/profile_decode.py:31-48``) at
    ``input_size`` with the tiny latent, and the draws behind it."""
    cam0 = jzoo.canonical_camera(1, input_size, camera_dist=DIST, key=jax.random.PRNGKey(3))
    z_obj = jax.random.normal(jax.random.PRNGKey(0), (1, 1, LATENT[0], *[LATENT[1]] * 3)) * 0.1
    oracle = jtesting.EllipsoidOracleModel(input_size=input_size, camera_dist=DIST)
    out = {"cam0": cam0, "z_obj": z_obj, "target_obs": jax.jit(oracle.make_observation)(cam0)}
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    uniform = [jax.random.uniform(jax.random.PRNGKey(3), (1, 3))]
    normal = [jax.random.normal(jax.random.PRNGKey(0), z_obj.shape)]
    if n:
        out["init_cam"] = jpu.sample_cameras_with_estimate(n, cam0, key=jax.random.PRNGKey(1))
        out["zoom_cam"] = out["init_cam"].zoom(None, input_size, DIST)
        normal += [jax.random.normal(k1, (n, 3)), jax.random.normal(k2, (n, 3))]
    return out, uniform, normal


def inject(monkeypatch, uniform, normal):
    """``torch.rand`` and ``torch.randn`` return JAX's draws in order, each
    checked against the shape asked for."""
    streams = {"rand": iter(uniform), "randn": iter(normal)}

    def fake(name):
        def draw(*shape, generator=None, device=None, **kwargs):
            value = np.asarray(next(streams[name]), np.float32)
            want = tuple(shape[0]) if len(shape) == 1 and isinstance(
                shape[0], (tuple, list)) else tuple(shape)
            assert value.shape == want, (name, value.shape, want)
            return torch.from_numpy(value.copy())
        return draw

    for name in streams:
        monkeypatch.setattr(torch, name, fake(name))


def check_setup(got, want):
    close_rel(got["cam0"].extrinsic, want["cam0"].extrinsic, GEOM_TOL)
    close_rel(got["z_obj"], want["z_obj"], 1e-6)
    for key in ("depth", "mask"):
        close_rel(getattr(got["target_obs"], key), getattr(want["target_obs"], key), GEOM_TOL)
    assert float(got["target_obs"].mask.sum()) > 100
    if "init_cam" in want:
        close_rel(got["init_cam"].extrinsic, want["init_cam"].extrinsic, GEOM_TOL)
        close_rel(got["init_cam"].viewport, want["init_cam"].viewport, GEOM_TOL)


# ------------------------------------------------------------ the profilers
@pytest.fixture(scope="module")
def decode_inputs(models):
    jm, tm = models
    want, uniform, normal = jax_setup(jm.input_size, N)
    with pytest.MonkeyPatch.context() as mp:
        inject(mp, uniform, normal)
        got = profile_decode.zoom_setup(tm, N, LATENT)
    return want, got


def test_profile_decode_setup_matches_jax(decode_inputs):
    want, got = decode_inputs
    check_setup(got, want)
    close_rel(got["zoom_cam"].viewport, want["zoom_cam"].viewport, GEOM_TOL)


def test_profile_decode_functions_match_jax(models, decode_inputs):
    """``tools/profile_decode.py:60-100``'s four functions, the port's on
    its own (JAX-drawn) inputs."""
    jm, tm = models
    want, got = decode_inputs
    photographer, params = jm.photographer, jm.photographer_params
    zoom_cam = want["zoom_cam"]

    def jdecode_fwd(p, zo, c):
        y, _, _ = jmodels.decode(photographer, p, zo, c)
        return y["depth"]

    def jo2c_only(zo, c):
        return jtransforms.object_to_camera(jnp.broadcast_to(zo[0], (c.length, *zo.shape[2:])), c)

    def jdecode_loss(p, zo, c, obs):
        y, zl, _ = jmodels.decode(photographer, p, zo, c, return_latent=True)
        z_depth = c.denormalize_depth(y["depth"].squeeze(0))
        ld = jest.default_pose_loss(obs, z_depth, y["mask_logits"].squeeze(0), c)
        return sum(v.sum() for v in ld.values())

    def jdecode_loss_grad(p, zo, params_cam, obs):
        def f(pc):
            c = zoom_cam.replace(**pc)
            y, _, _ = jmodels.decode(photographer, p, zo, c)
            z_depth = c.denormalize_depth(y["depth"].squeeze(0))
            ld = jest.default_pose_loss(obs, z_depth, y["mask_logits"].squeeze(0), c)
            return sum(v.mean() for v in ld.values())

        return jax.grad(f)(params_cam)

    z, obs = want["z_obj"], want["target_obs"]
    ph = tm.photographer
    tz, tcam, tobs = got["z_obj"], got["zoom_cam"], got["target_obs"]
    depth = profile_decode.decode_fwd(ph, tz, tcam)
    close_rel(depth, jax.jit(jdecode_fwd)(params, z, zoom_cam), NET_TOL)
    close_rel(profile_decode.o2c_only(tz, tcam), jax.jit(jo2c_only)(z, zoom_cam), NET_TOL)
    loss = profile_decode.decode_loss(ph, tz, tcam, tobs)
    want_loss = float(jax.jit(jdecode_loss)(params, z, zoom_cam, obs))
    assert abs(float(loss) - want_loss) <= NET_TOL * max(abs(want_loss), 1.0)
    grads = profile_decode.decode_loss_grad(
        ph, tz, tpu.camera_params(tcam, optimize_viewport=True), tobs, tcam)
    want_grads = jax.jit(jdecode_loss_grad)(
        params, z, jpu.camera_params(zoom_cam, optimize_viewport=True), obs)
    assert set(grads) == set(want_grads) == {"log_quaternion", "translation", "viewport"}
    for key, g in grads.items():
        ref = np.asarray(want_grads[key])
        assert np.abs(ref).max() > 0, key
        assert np.abs(g.numpy() - ref).max() <= GRAD_TOL * np.abs(ref).max(), key
    assert profile_decode.report("decode fwd", profile_decode.decode_fwd, ph, tz, tcam) > 0


@pytest.mark.parametrize("n", [N, 0], ids=["refinement", "cem"])
def test_profiler_setups_match_jax(models, monkeypatch, n):
    """``profile_refinement``'s inputs (``n`` hypotheses) and
    ``profile_cem``'s (none), fed JAX's draws."""
    jm, tm = models
    want, uniform, normal = jax_setup(jm.input_size, n)
    inject(monkeypatch, uniform, normal)
    got = profile_refinement.target_setup(tm, n, LATENT)
    assert ("init_cam" in got) == bool(n)
    check_setup(got, want)


def test_profiler_estimators_match_jax(models):
    """The estimators' arguments, as ``tools/profile_refinement.py:94-99``
    and ``tools/profile_cem.py:61-64`` pass them."""
    jm, tm = models
    iters, samples = 20, 128
    jfine = jest.GradientPoseEstimator(
        model=jm, ranking_size=8, loss_weights={"depth": 1.0, "ov_depth": 0.3},
        learning_rate=0.01, num_samples=8, num_iters=iters, converge_threshold=-1.0,
        converge_patience=iters + 1, optimizer="adam")
    tfine = estimation.GradientPoseEstimator(
        model=tm, **profile_refinement.estimator_kwargs(8, iters))
    jcem = jest.CrossEntropyPoseEstimator(
        model=jm, ranking_size=16, loss_weights={"depth": 1.0}, num_samples=samples,
        num_iters=10, num_elites=48, num_gmm_components=6, learning_rate=0.75,
        sample_flipped=True)
    tcem = estimation.CrossEntropyPoseEstimator(
        model=tm, **profile_cem.estimator_kwargs(samples, 10))
    for j, p, names in ((jfine, tfine, ("learning_rate", "num_samples", "num_iters",
                                        "converge_threshold", "converge_patience",
                                        "optimizer")),
                        (jcem, tcem, ("num_samples", "num_iters", "num_elites",
                                      "num_gmm_components", "learning_rate",
                                      "sample_flipped", "translation_std",
                                      "quaternion_std"))):
        for name in ("ranking_size", *names):
            assert getattr(p, name) == getattr(j, name), name
        assert dict(p.loss_weights) == dict(j.loss_weights)


@pytest.mark.parametrize("tool", ["refinement", "cem"])
def test_profilers_trace_an_estimate(models, tmp_path, capsys, tool):
    """The tools' traced call on the CPU, at 2 iterations: the trace is
    written and ``top_ops`` reads the host's ops back."""
    _, tm = models
    inputs = profile_refinement.target_setup(tm, N, LATENT)
    if tool == "refinement":
        est = estimation.GradientPoseEstimator(
            model=tm, **profile_refinement.estimator_kwargs(N, 2))

        def run():
            est.estimate(inputs["z_obj"], inputs["target_obs"], camera=inputs["init_cam"])
    else:
        est = estimation.CrossEntropyPoseEstimator(
            model=tm, **profile_cem.estimator_kwargs(16, 2))

        def run():
            est.estimate(inputs["z_obj"], inputs["target_obs"],
                         generator=torch.Generator().manual_seed(6))

    warm = []
    prof = profile_refinement.trace_call(run, lambda: warm.append(1), tmp_path, "cpu")
    assert warm == [1] and profiling.newest_trace(tmp_path) is not None
    durations = profiling.top_ops(tmp_path, k=5, device="cpu")
    assert "aten::grid_sampler_3d" not in durations
    assert sum(durations.values()) > 0
    assert set(profiling.op_totals(prof, "cpu")[1]) <= set(durations)
    assert "== plane: /host:cpu" in capsys.readouterr().out


# ------------------------------------------------------------- the benches
@pytest.fixture(scope="module")
def sampler_inputs():
    rng = np.random.RandomState(0)
    vol = rng.randn(2, 8, 8, 8, 8).astype(np.float32)
    grid = rng.uniform(-1.0, 1.0, (2, 8, 8, 8, 3)).astype(np.float32)
    iters = 3
    fn = lambda v, g: grid_sample_3d_fused(v, g, padding_mode="border")  # noqa: E731

    @jax.jit
    def loop_fwd(vol, grid):
        def body(i, acc):
            return acc + fn(vol, grid + acc * 1e-9).mean()

        return jax.lax.fori_loop(0, iters, body, 0.0)

    @jax.jit
    def loop_bwd(vol, grid):
        def body(i, carry):
            g, acc = carry
            val, dg = jax.value_and_grad(lambda g: fn(vol, g).sum())(g)
            return (g - 1e-9 * dg, acc + val)

        return jax.lax.fori_loop(0, iters, body, (grid, 0.0))[1]

    want = {"fwd": float(loop_fwd(vol, grid)), "fwd+bwd": float(loop_bwd(vol, grid))}
    return vol, grid, iters, want


@pytest.mark.parametrize("mode", ["fwd", "fwd+bwd"])
@pytest.mark.parametrize("name", ["cuda", "plain", "aten"])
def test_bench_sampler_loops_match_jax(sampler_inputs, name, mode):
    vol, grid, iters, want = sampler_inputs
    loop = {"fwd": bench_sampler.loop_fwd, "fwd+bwd": bench_sampler.loop_bwd}[mode]
    got = float(loop(bench_sampler.backend(name), torch.from_numpy(vol),
                     torch.from_numpy(grid), iters))
    assert abs(got - want[mode]) <= LOOP_TOL * abs(want[mode])


def test_bench_sampler_main_on_cpu(capsys):
    with pytest.raises(ValueError, match="unknown backend 'matmul'"):
        bench_sampler.backend("matmul")
    assert bench_sampler.backend("pallas") is bench_sampler.backend("fused") is \
        bench_sampler.backend("cuda")
    assert bench_sampler.backend("gather") is bench_sampler.backend("plain")
    results = bench_sampler.main(["--cpu", "--n", "2", "--c", "4", "--size", "4",
                                  "--iters", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6 and lines[0].startswith("cuda    fwd    : ")
    assert lines[1].endswith(" TFLOP/s dense-matmul-equivalent)")
    assert set(results) == {f"{b} {m}" for b in ("cuda", "plain", "aten")
                            for m in ("fwd", "fwd+bwd")}
    for mode in ("fwd", "fwd+bwd"):
        cuda, plain = results[f"cuda {mode}"]["acc"], results[f"plain {mode}"]["acc"]
        assert cuda == plain  # both the plain twins on the CPU


@pytest.mark.parametrize("scan_views", [True, False], ids=["scan", "unroll"])
@pytest.mark.parametrize("views", [2, 3])
def test_bench_fuser_fold_matches_jax(views, scan_views):
    rng = np.random.RandomState(views)
    z = rng.randn(1, views, 4, 8, 8, 8).astype(np.float32)
    jf = jfusion.GRUFuser(in_channels=4, scan_views=scan_views)
    key = jax.random.PRNGKey(0)
    params = jf.init(key, jnp.zeros((1, 2, 4, 8, 8, 8)), [], [], jzoo.canonical_camera(2, 16))
    want = jf.apply(params, jnp.asarray(z), [], [], jzoo.canonical_camera(views, 16))[0]
    fuser = bench_fuser.make_fuser(4, "cpu")
    fuser.load_state_dict(to_state(params))
    got = bench_fuser.fold(fuser, torch.from_numpy(z))
    assert got.shape == (1, 1, 4, 8, 8, 8)
    close_rel(got, want, NET_TOL)


def test_bench_fuser_main_on_cpu(capsys):
    results = bench_fuser.main(["--cpu", "--channels", "2", "--size", "4", "--iters", "2"])
    assert sorted(results) == [8, 16, 24]
    lines = capsys.readouterr().out.splitlines()
    assert [line[:12] for line in lines] == ["V= 8 unroll:", "V=16 unroll:", "V=24 unroll:"]
    assert all(" first call " in line and " fold " in line and line.endswith(" ms")
               for line in lines)


def test_bench_loader_keys_match_jax(tmp_path):
    """The port's tool in a fresh interpreter (its loader forks a worker)
    at 64x48, 1 + 1 views, 1 worker, batch 1; JAX's functions inline."""
    argv = ["--width", "64", "--height", "48", "--in-views", "1", "--out-views", "1",
            "--workers", "1", "--batch", "1", "--verts", "200"]
    out = subprocess.run([sys.executable, "-m", "latentfusion_tpu_torch.bench_loader", *argv],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    got = [json.loads(line) for line in out.stdout.splitlines() if line.startswith("{")]
    sys.path.insert(0, str(ROOT / "tools"))
    import bench_loader as jbench
    from latentfusion_tpu.data.synthetic import SyntheticDataset, make_procedural_blobs

    paths = make_procedural_blobs(tmp_path, 4, 200)
    ds = SyntheticDataset(paths, num_input_views=1, num_output_views=1, width=64, height=48,
                          random_materials=True)
    ds.worker_init_fn(0)
    want = [jbench.bench_rasterizer(paths, 64, 48, iters=2), jbench.bench_dataset(ds, 1),
            jbench.bench_loader(ds, 0, None, 1, n_batches=1)]
    assert [set(r) for r in got] == [set(r) for r in want]
    assert [r["stage"] for r in got] == ["rasterizer", "dataset_inline", "loader"]
    assert got[2]["workers"] == 1 and got[2]["transport"] == "f32"
