"""The port's parallel layer (``latentfusion_tpu_torch/parallel``) held
against the JAX package's (``latentfusion_tpu/parallel``) on the CPU.

The pure pieces (``fsdp_spec``, ``tp_spec``, ``batch_slice``) are compared
case by case. The multi-rank paths run once, in one gloo group of 2 ranks
spawned as separate processes (``tests/torch_parallel_ranks.py``, a
``file://`` rendezvous under the test's temporary directory), against
JAX's 2-device mesh (conftest's virtual devices): the hypothesis-sharded
gradient, CEM and Metropolis estimators and ``estimate_batch``, the
tensor-parallel decode, the data-parallel and FSDP training steps, the
data-parallel GAN step against JAX's on its mesh and against one process,
and ``train_reconstruct``
with ``--data-parallel``. The stochastic estimators take JAX's draws: the
port's unsharded loop runs once here with them (``test_torch_pose.py``'s
and ``test_torch_pose_batch.py``'s draw classes), recording what it was
handed, and the ranks replay the record. Tolerances are
``tests/test_parallel.py``'s (loss history 1e-5, poses 1e-4, decode 1e-5,
the FSDP loss 1e-5 relative), and the training steps'
``tests/test_torch_train.py``'s (gradients within 5e-4 or 3x the port's
noise floor, parameters 5e-4).

Budget: about 2.5 minutes on one worker (JAX's mesh estimators compile
their loops; the ranks take about 30 s).
"""
import contextlib
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from latentfusion_tpu import parallel as jparallel
from latentfusion_tpu import pggan as jpggan
from latentfusion_tpu import testing as jtesting
from latentfusion_tpu.camera import Camera as JCamera
from latentfusion_tpu.observation import Observation as JObservation
from latentfusion_tpu.pose import estimation as jest
from latentfusion_tpu.pose import utils as jpu
from latentfusion_tpu.recon import models as jmodels
from latentfusion_tpu.train import step as jstep

from latentfusion_tpu_torch import parallel as tparallel
from latentfusion_tpu_torch import testing as ttesting
from latentfusion_tpu_torch.pggan import MultiScaleDiscriminator
from latentfusion_tpu_torch.pose import estimation as tpe
from latentfusion_tpu_torch.recon import utils as tutils
from latentfusion_tpu_torch.train import step as tstep

from test_data import make_cube_obj
from test_torch_gan import assert_jax_process_batch_well_posed, jax_noise_keys
from test_torch_pose import JaxCemDraws
from test_torch_pose_batch import JaxCemBatchDraws, JaxMetropolisDraws, t, t_camera, t_observation
from test_torch_train import (CAMERA_DIST, CONFIG, NET_TOL, capture, close_rel, grad_tolerance,
                              grads_of, keyed, orientations, port_models, raw_batch,
                              rel_errs)
from test_torch_trainer import TINY
from torch_parallel_ranks import camera_fields, target_quadratic

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
RANK_TIMEOUT_S = 600
LOSS_TOL, POSE_TOL, DECODE_TOL = 1e-5, 1e-4, 1e-5  # tests/test_parallel.py


class Recorder:
    """Wraps a draws object: hands out its draws and keeps them, in order,
    for the ranks' ``Replay``."""

    def __init__(self, draws):
        self.draws, self.record = draws, []

    def __getattr__(self, name):
        fn = getattr(self.draws, name)

        def call(*args, **kwargs):
            value = fn(*args, **kwargs)
            self.record.append((name, value))
            return value
        return call


def jax_camera_fields(cam):
    return {k: np.asarray(getattr(cam, k)) for k in ("translation", "log_quaternion",
                                                     "viewport")}


def run_ranks(folder: Path, inputs: dict) -> list:
    """Write ``inputs``, run the ranks, return each rank's output."""
    torch.save(inputs, folder / "inputs.pt")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_parallel_ranks.py"),
                               str(folder), str(r), str(WORLD)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    outs = [torch.load(folder / f"rank{r}.pt", weights_only=False)
            if (folder / f"rank{r}.pt").exists() else {} for r in range(WORLD)]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "error" not in out, (r, out.get("error"), logs[r][-4000:])
    return outs


# ------------------------------------------------------------------ inputs
def estimator_inputs(inputs: dict, refs: dict) -> None:
    """tests/test_parallel.py's estimator cases: JAX on its 2-device mesh
    (``refs``) and the port's inputs, with JAX's draws recorded."""
    oracle, toracle = jtesting.EllipsoidOracleModel(), ttesting.EllipsoidOracleModel(device="cpu")
    mesh = jparallel.make_mesh(WORLD, axis_name=jparallel.HYPOTHESIS_AXIS)
    gt1 = jtesting.make_camera(1, key=jax.random.PRNGKey(7))
    gt2 = jtesting.make_camera(1, key=jax.random.PRNGKey(8))
    obs = oracle.make_observation(gt1)
    both = JObservation.collate([obs, oracle.make_observation(gt2)])
    inputs["target"], inputs["targets"] = t_observation(obs), t_observation(both)
    z2 = jnp.zeros((2, 1, 1, 1, 1, 1))
    tz2 = torch.zeros(2, 1, 1, 1, 1, 1)

    cams = jpu.sample_cameras_with_estimate(8, gt1, key=jax.random.PRNGKey(0))
    hyp = JCamera.cat([cams, jpu.sample_cameras_with_estimate(8, gt2, key=jax.random.PRNGKey(1))])
    kws = {"gradient": dict(ranking_size=8, loss_weights={"depth": 1.0, "ov_depth": 0.3},
                            learning_rate=0.01, num_samples=8, num_iters=3,
                            converge_threshold=1e-6, converge_patience=10, optimizer="adam",
                            track_stats=True),
           # ov_depth: the smooth loss's viewport term (every leaf takes a gradient).
           "gradient_batch": dict(ranking_size=4, loss_weights={"depth": 1.0, "ov_depth": 0.3},
                                  learning_rate=0.01, num_samples=8, num_iters=3,
                                  converge_threshold=1e-6, converge_patience=10,
                                  optimizer="adam", track_stats=True)}
    inputs["gradient"] = {"kwargs": kws["gradient"], "cameras": t_camera(cams)}
    inputs["gradient_batch"] = {"kwargs": kws["gradient_batch"], "cameras": t_camera(hyp)}
    for label, kw in kws.items():
        jax_est = jest.GradientPoseEstimator(model=oracle, mesh=mesh, **kw)
        jax_est.loss_func = target_quadratic
        est = tpe.GradientPoseEstimator(model=toracle, **kw)
        if label == "gradient":
            out, stats = jax_est.estimate(None, obs, camera=cams)
            refs["gradient smooth"] = {**jax_camera_fields(out),
                                       "loss_history": np.asarray(stats["loss_history"])}
            out, stats = est.estimate(None, inputs["target"], camera=t_camera(cams))
            refs["gradient default"] = {**camera_fields(out),
                                        "loss_history": stats["loss_history"]}
        else:
            outs, stats = jax_est.estimate_batch(z2, both, cameras=hyp)
            refs["gradient_batch smooth"] = {
                "cameras": [jax_camera_fields(c) for c in outs],
                "loss_history": np.asarray(stats["loss_history"])}
            outs, stats = est.estimate_batch(tz2, inputs["targets"], cameras=t_camera(hyp))
            refs["gradient_batch default"] = {"cameras": [camera_fields(c) for c in outs],
                                              "loss_history": stats["loss_history"]}
    ours, _ = tpe.GradientPoseEstimator(
        model=toracle, **dict(kws["gradient"], num_iters=1)).estimate(
            None, inputs["target"], camera=t_camera(cams)[:7])
    refs["gradient_uneven"] = camera_fields(ours)

    kw = dict(ranking_size=8, loss_weights={"depth": 1.0}, num_samples=16, num_iters=2,
              num_elites=8, num_gmm_components=2, learning_rate=0.9, sample_flipped=False)
    key = jax.random.PRNGKey(3)
    init = jpu.sample_cameras_with_estimate(2 * 16, jest.PoseEstimator.initial_pose(obs),
                                            key=jax.random.PRNGKey(11))
    refs["cem"] = jax_camera_fields(jest.CrossEntropyPoseEstimator(
        model=oracle, mesh=mesh, **kw).estimate(None, obs, key=key, cameras=init))
    rec = Recorder(JaxCemDraws(key, 2))
    tpe.CrossEntropyPoseEstimator(model=toracle, **kw).estimate(
        None, inputs["target"], cameras=t_camera(init), draws=rec)
    inputs["cem"] = {"kwargs": kw, "cameras": t_camera(init), "draws": rec.record}

    kw = dict(ranking_size=4, loss_weights={"depth": 1.0}, num_samples=8, num_iters=2,
              num_elites=4, num_gmm_components=2, learning_rate=0.9, sample_flipped=False)
    refs["cem_batch"] = [jax_camera_fields(c) for c in jest.CrossEntropyPoseEstimator(
        model=oracle, mesh=mesh, **kw).estimate_batch(z2, both, key=key)]
    rec = Recorder(JaxCemBatchDraws(key, 2, 2))
    tpe.CrossEntropyPoseEstimator(model=toracle, **kw).estimate_batch(
        tz2, inputs["targets"], draws=rec)
    inputs["cem_batch"] = {"kwargs": kw, "draws": rec.record}

    kw = dict(ranking_size=4, loss_weights={"depth": 1.0}, num_samples=8, num_iters=3)
    refs["metropolis_batch"] = [jax_camera_fields(c) for c in jest.MetropolisPoseEstimator(
        model=oracle, mesh=mesh, **kw).estimate_batch(z2, both, key=key)]
    rec = Recorder(JaxMetropolisDraws(key))
    tpe.MetropolisPoseEstimator(model=toracle, **kw).estimate_batch(
        tz2, inputs["targets"], draws=rec)
    inputs["metropolis_batch"] = {"kwargs": kw, "draws": rec.record}


def tp_inputs(inputs: dict, refs: dict) -> None:
    """tests/test_parallel.py's tensor-parallel decode on a 2-device model
    mesh."""
    from latentfusion_tpu import zoo as jzoo

    photographer = jzoo.tiny_photographer()
    key = jax.random.PRNGKey(0)
    cam = jtesting.make_camera(2, z=1.5, f=64, width=64, height=48,
                               key=jax.random.PRNGKey(1)).zoom(None, 16, 1.5)
    params = photographer.init(key, jnp.zeros((2, 4, 8, 8, 8)), cam)
    z_obj = jax.random.normal(key, (1, 1, 4, 8, 8, 8))
    mesh = jparallel.make_mesh(WORLD, axis_name=jparallel.MODEL_AXIS)
    p_sh = jparallel.tp_shardings(params, mesh, min_leaf_size=2)
    params_tp = jax.tree_util.tree_map(jax.device_put, params, p_sh)

    def decode(p, zo, c):
        y, _, _ = jmodels.decode(photographer, p, zo, c)
        return y["depth"], y["mask"]

    with mesh:
        depth, mask = jax.jit(decode)(params_tp, jparallel.replicate(z_obj, mesh),
                                      jparallel.replicate(cam, mesh))
    refs["tp"] = {"depth": np.asarray(depth), "mask": np.asarray(mask)}
    state = {k: torch.from_numpy(v) for k, v in keyed(params).items()}
    inputs["tp"] = {"state": state, "z_obj": t(z_obj), "camera": t_camera(cam)}


def train_inputs(inputs: dict, refs: dict, tiny) -> None:
    """The plain step (two microbatches) on JAX's data mesh and on its 1 x 2
    ``data x fsdp`` mesh with every leaf of 2 or more elements sharded,
    JAX's gradients captured; the port's noise floor of the same step."""
    (sc, fu, ph), params = tiny
    batch, batch_np = raw_batch(14, b=4)
    key = jax.random.PRNGKey(4)
    from latentfusion_tpu.recon import utils as jutils
    from latentfusion_tpu.three import quaternion as jquat

    jproc = jutils.process_batch(batch_np, 1.0, CAMERA_DIST, 16, key=key)
    tproc = tutils.process_batch(batch, 1.0, CAMERA_DIST, 16,
                                 rotation=torch.from_numpy(np.array(jquat.random(key, 1))))
    jproc = {"in": jproc["in"], "out_gt": jproc["out_gt"]}
    tproc = {"in": tproc["in"], "out_gt": tproc["out_gt"]}
    config = {"g_depth_recon_loss_type": "hard_smooth_l1", "g_depth_recon_loss_k": 100}
    for label in ("dp", "fsdp"):
        opt = capture(jstep.make_optimizer("adam", 1e-3))
        state = jstep.init_train_state(params, opt)
        if label == "dp":
            mesh = jparallel.make_mesh(WORLD)
            state_sh = None
            state = jparallel.replicate(state, mesh)
        else:
            mesh = jparallel.make_mesh_2d(1, WORLD)
            state_sh = jparallel.fsdp_shardings(state, mesh, min_leaf_size=2)
            state = jax.tree_util.tree_map(jax.device_put, state, state_sh)
        step = jstep.make_train_step(sc, fu, ph, opt, config, num_microbatches=2,
                                     state_shardings=state_sh)
        with mesh:
            jstate, jloss, jaux = step(state, jparallel.shard_batch(jproc, mesh), key)
        refs[label] = {"loss": float(jloss), "aux": {k: float(v) for k, v in jaux.items()},
                       "grads": keyed(jstate.opt_state[1]), "params": keyed(jstate.params)}

    def port_step(context):
        mods = port_models(params)
        state = tstep.init_train_state(mods, tstep.make_optimizer("adam", 1e-3))
        step = tstep.make_train_step(mods["sculptor"], mods["fuser"], mods["photographer"],
                                     config, num_microbatches=2)
        with context(mods):
            step(state, tproc)
        return mods

    import contextlib

    one = port_step(lambda mods: contextlib.nullcontext())
    refs["grad_tol"] = grad_tolerance(port_step, grads_of(one))
    state = {name: {k: v.detach().clone() for k, v in m.state_dict().items()}
             for name, m in port_models(params).items()}
    inputs["train"] = {"state": state, "config": config, "microbatches": 2, "batch": tproc}


RECON_CONFIG = dict(CONFIG, discriminator_input_depth=True, discriminator_input_mask=True)
D_CONFIG, D_SCALES = (4, 8), 2


def recon_inputs(inputs: dict, refs: dict, tiny) -> None:
    """The GAN step (make_recon_train_step with the discriminator, instance
    noise at weight 1): on 4 objects in two microbatches in one process,
    the reference of its data-parallel run (``recon``); and JAX's on its
    2-device data mesh (``recon_jax``), on 2 objects in one microbatch (on
    4, JAX's jitted ``process_batch`` parts from its eager one by whole
    pixels: ``test_torch_gan.assert_jax_process_batch_well_posed``), the
    port taking JAX's orientations and instance-noise draws, recorded here
    for the ranks."""
    (sc, fu, ph), params = tiny
    state = {name: {k: v.detach().clone() for k, v in m.state_dict().items()}
             for name, m in port_models(params).items()}
    common = {"state": state, "config": RECON_CONFIG, "d_config": D_CONFIG,
              "d_scales": D_SCALES, "seed": 6}

    def port_step(disc, batch, microbatches, rotations=None, draws_from=None):
        mods = port_models(params)
        tstate = tstep.init_gan_train_state(mods, tstep.make_optimizer("adam", 1e-3), disc,
                                            tstep.make_optimizer("adam", 1e-3), device="cpu")
        step = tstep.make_recon_train_step(mods["sculptor"], mods["fuser"], mods["photographer"],
                                           disc, RECON_CONFIG, num_microbatches=microbatches)
        with (mock.patch.object(tstep, "_normal", draws_from) if draws_from
              else contextlib.nullcontext()):
            _, scalars = step(tstate, batch, torch.Generator().manual_seed(6), rotations,
                              input_noise_weight=1.0)
        return {"scalars": {k: float(v) for k, v in scalars.items()}, "params": {
            f"{name}.{k}": v.detach().clone() for name, m in {**mods, "disc": disc}.items()
            for k, v in m.state_dict().items()}}

    batch, _ = raw_batch(15, b=4)
    disc = MultiScaleDiscriminator(2, D_CONFIG, D_SCALES, device="cpu",
                                   generator=torch.Generator().manual_seed(5))
    disc_state = {k: v.detach().clone() for k, v in disc.state_dict().items()}
    refs["recon"] = port_step(disc, batch, 2)
    refs["recon_disc_start"] = disc_state
    refs["recon_cancelled"] = {f"disc.{k}" for k in disc.cancelled_parameters()}
    inputs["recon"] = {**common, "disc_state": disc_state, "batch": batch, "microbatches": 2}

    batch, batch_np = raw_batch(15, b=2)
    key = jax.random.PRNGKey(6)
    assert_jax_process_batch_well_posed(batch_np, key, 1)
    jd = jpggan.MultiScaleDiscriminator(2, D_CONFIG, D_SCALES)
    d_params = jd.init(jax.random.PRNGKey(5), jnp.zeros((2, 2, 16, 16)))
    opt, d_opt = jstep.make_optimizer("adam", 1e-3), jstep.make_optimizer("adam", 1e-3)
    jax_step = jstep.make_recon_train_step(sc, fu, ph, opt, jd, d_opt, config=RECON_CONFIG)
    mesh = jparallel.make_mesh(WORLD)
    jstate = jparallel.replicate(jstep.init_gan_train_state(params, opt, d_params, d_opt), mesh)
    with mesh:
        jstate, jscalars = jax_step(jstate, jparallel.shard_batch(batch_np, mesh), key, 1.0)
    refs["recon_jax"] = {"scalars": {k: float(v) for k, v in jscalars.items()}, "params": {
        **keyed(jstate.params), **{f"disc.{k}": v for k, v in keyed(jstate.d_params).items()}}}
    disc = MultiScaleDiscriminator(2, D_CONFIG, D_SCALES, device="cpu")
    disc.load_state_dict({k: torch.from_numpy(v) for k, v in keyed(d_params).items()})
    refs["recon_jax_disc_start"] = {k: v.detach().clone() for k, v in disc.state_dict().items()}
    noise_keys, draws = jax_noise_keys(key, 1, False, True), []

    def normal(shape, generator, device):
        draws.append(torch.from_numpy(np.array(jax.random.normal(noise_keys[len(draws)],
                                                                 tuple(shape)))))
        return draws[-1]

    rotations = [torch.from_numpy(np.array(q)) for q in orientations(key, 1)]
    inputs["recon_jax"] = {**common, "disc_state": refs["recon_jax_disc_start"],
                           "batch": batch, "microbatches": 1, "rotations": rotations}
    port_step(disc, batch, 1, rotations, normal)  # records the draws
    inputs["recon_jax"]["draws"] = draws


@pytest.fixture(scope="module")
def tiny():
    from latentfusion_tpu import zoo as jzoo

    sc, fu, ph = jzoo.tiny_sculptor(), jzoo.tiny_fuser(), jzoo.tiny_photographer()
    params = jzoo.init_recon_params(jax.random.PRNGKey(0), sc, fu, ph, batch=1, views=2)
    return (sc, fu, ph), params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, tiny):
    """(JAX's references, each rank's output)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        folder = tmp_path_factory.mktemp("ranks")
        inputs, refs = {}, {}
        estimator_inputs(inputs, refs)
        tp_inputs(inputs, refs)
        train_inputs(inputs, refs, tiny)
        recon_inputs(inputs, refs, tiny)
        meshes = folder / "meshes"
        meshes.mkdir()
        make_cube_obj(meshes)
        inputs["tool_argv"] = [*TINY, "--batch-size", "2", "--dataset-path", str(meshes),
                               "--save-dir", str(folder / "runs"), "--data-parallel",
                               "--device", "cpu"]
        refs["tool_dir"] = folder / "runs"
        return refs, run_ranks(folder, inputs)
    finally:
        torch.set_num_threads(prev)


def close_abs(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               atol=tol, rtol=0)


def assert_pose(ours, ref, tol=POSE_TOL):
    close_abs(ours["translation"], ref["translation"], tol)
    close_abs(ours["log_quaternion"], ref["log_quaternion"], tol)


# ------------------------------------------------------------- pure specs
SPEC_CASES = [((3, 3, 8, 16), 4, 1), ((3, 5, 7), 4, 1), ((8,), 4, 4096), ((), 4, 1),
              ((256, 512, 3, 3), 2, 4096), ((64, 3), 2, 4096), ((6, 10, 4), 2, 1),
              ((2, 64, 1, 1), 2, 2), ((5, 8, 3, 3), 2, 2), ((4,), 2, 2)]


@pytest.mark.parametrize("shape,n,min_leaf", SPEC_CASES)
def test_fsdp_and_tp_specs_match_jax(shape, n, min_leaf):
    """Each spec is JAX's ``PartitionSpec`` as a tuple, case by case."""
    assert tparallel.fsdp_spec(shape, n, min_leaf_size=min_leaf) == tuple(
        jparallel.fsdp_spec(shape, n, min_leaf_size=min_leaf))
    assert tparallel.tp_spec(shape, n, min_leaf_size=min_leaf) == tuple(
        jparallel.tp_spec(shape, n, min_leaf_size=min_leaf))
    spec = tparallel.fsdp_spec(shape, n, min_leaf_size=min_leaf)
    assert tparallel.fsdp_dim(shape, n, min_leaf) == (spec.index("fsdp") if spec else 0)


def test_batch_slice_takes_each_microbatch_part():
    """Rank r's slice of a global batch: its part of each microbatch, so
    its local microbatch i is its part of global microbatch i."""
    assert tparallel.batch_slice(8, 0, 2, 2).tolist() == [0, 1, 4, 5]
    assert tparallel.batch_slice(8, 1, 2, 2).tolist() == [2, 3, 6, 7]
    assert tparallel.batch_slice(8, 1, 2).tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError):
        tparallel.batch_slice(6, 0, 2, 2)


def test_meshes_refuse_too_few_or_too_many_ranks(tmp_path, monkeypatch):
    """No group, or a group of another size than asked: make_mesh and
    make_mesh_2d raise, as JAX's do on too few devices; init_distributed
    raises outside torchrun and keeps the backend the device names."""
    with pytest.raises(RuntimeError, match="init_distributed"):
        tparallel.make_mesh(2, device="cpu")
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        tparallel.init_distributed("cpu")
    assert tparallel.backend_for("cpu") == "gloo" and tparallel.backend_for("cuda") == "nccl"
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdv'}", rank=0,
                            world_size=1)
    try:
        assert tparallel.init_distributed("cpu")[:2] == (0, 1)
        with pytest.raises(RuntimeError, match="not nccl"):
            tparallel.init_distributed("cpu", backend="nccl")
        with pytest.raises(RuntimeError, match="degraded"):
            tparallel.make_mesh(2, device="cpu")
        with pytest.raises(RuntimeError, match="degraded"):
            tparallel.make_mesh_2d(2, 1, "cpu")
        mesh = tparallel.make_mesh(1, tparallel.HYPOTHESIS_AXIS, "cpu")
        assert mesh.mesh_dim_names == ("hypothesis",)
        x = torch.arange(6.0).reshape(3, 2)
        assert torch.equal(tparallel.all_gather(x, mesh), x[None])
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- estimators
def test_ranks_return_the_same_bits(ranks):
    """Every rank returns the same estimates, decode and parameters."""
    _, outs = ranks
    a, b = outs

    def same(x, y):
        if isinstance(x, dict):
            assert set(x) == set(y)
            for k in x:
                same(x[k], y[k])
        elif isinstance(x, (list, tuple)):
            for u, v in zip(x, y):
                same(u, v)
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y)

    for key in ("gradient smooth", "gradient default", "gradient_batch smooth",
                "gradient_batch default", "cem", "cem_batch", "metropolis_batch", "tp", "recon",
                "recon_jax"):
        same(a[key], b[key])
    for key in ("dp", "fsdp"):
        same(a[key]["params"], b[key]["params"])
    same(a["tool"]["params"], b["tool"]["params"])


@pytest.mark.parametrize("label", ["gradient", "gradient_batch"])
def test_sharded_refinement_matches_jax(ranks, label):
    """Refinement (one object; two objects in ``estimate_batch``) of
    hypotheses sharded over 2 ranks with a smooth loss of the pose against
    each target's camera, against JAX's loop on its 2-device mesh: the loss
    history and each ranked pose. The default loss's gradient jumps with
    the renders' last bits in both packages, so over several steps its
    loops part between packages (``test_torch_pose_batch.py``): it is held
    to the port's unsharded loop below."""
    refs, outs = ranks
    ours, ref = outs[0][f"{label} smooth"], refs[f"{label} smooth"]
    close_abs(ours["loss_history"], ref["loss_history"], LOSS_TOL)
    for o, r in zip(ours.get("cameras", [ours]), ref.get("cameras", [ref])):
        assert_pose(o, r)


@pytest.mark.parametrize("label", ["gradient", "gradient_batch"])
def test_sharded_refinement_matches_unsharded(ranks, label):
    """tests/test_parallel.py's refinement cases (the default loss) at 2
    ranks against the port's unsharded loop, at its tolerances."""
    refs, outs = ranks
    ours, ref = outs[0][f"{label} default"], refs[f"{label} default"]
    close_abs(ours["loss_history"], ref["loss_history"], LOSS_TOL)
    for o, r in zip(ours.get("cameras", [ours]), ref.get("cameras", [ref])):
        assert_pose(o, r)


def test_sharded_cem_matches_jax(ranks):
    refs, outs = ranks
    assert_pose(outs[0]["cem"], refs["cem"])


def test_sharded_cem_estimate_batch_matches_jax(ranks):
    refs, outs = ranks
    for ours, ref in zip(outs[0]["cem_batch"], refs["cem_batch"]):
        assert_pose(ours, ref)


def test_sharded_metropolis_estimate_batch_matches_jax(ranks):
    refs, outs = ranks
    for ours, ref in zip(outs[0]["metropolis_batch"], refs["metropolis_batch"]):
        assert_pose(ours, ref)


def test_hypotheses_the_ranks_do_not_divide_are_scored_whole(ranks):
    """7 hypotheses over 2 ranks: every rank scores all of them, and the
    estimate is the one-process estimate's."""
    refs, outs = ranks
    for out in outs:
        for k in ("translation", "log_quaternion"):
            assert torch.equal(out["gradient_uneven"][k], refs["gradient_uneven"][k])


# ---------------------------------------------------------------- decode
def test_tensor_parallel_decode_matches_jax(ranks):
    refs, outs = ranks
    assert outs[0]["tp_cut"] > 0, "no convolution cut"
    assert all(torch.equal(o["replicated"], torch.zeros(3)) for o in outs)  # rank 0's
    for k in ("depth", "mask"):
        close_abs(outs[0]["tp"][k], refs["tp"][k], DECODE_TOL)
        # Each rank convolves at the whole layer's shape: the unsharded bits.
        assert torch.equal(outs[0]["tp"][k], outs[0]["tp_whole"][k]), k


# -------------------------------------------------------------- training
@pytest.mark.parametrize("label", ["dp", "fsdp"])
def test_sharded_train_step_matches_jax(ranks, label):
    """The plain step at 2 ranks (data parallel; FSDP over a 1 x 2 mesh with
    leaves of 2 or more elements sharded) against JAX's step on its mesh:
    loss, terms, every gradient, every parameter after the step."""
    refs, outs = ranks
    ours, ref = outs[0][label], refs[label]
    if label == "fsdp":
        assert ours["sharded"] > 0, "no parameter leaf actually sharded"
        assert ours["dims_ok"], "a parameter is not sharded on fsdp_shardings' dim"
        np.testing.assert_allclose(float(ours["loss"]), ref["loss"], rtol=LOSS_TOL)
    close_rel(ours["loss"], ref["loss"], NET_TOL)
    for k in ref["aux"]:
        close_rel(ours["aux"][k], ref["aux"][k], NET_TOL)
    grads = {k: v.numpy() for k, v in ours["grads"].items()}
    assert set(grads) == set(ref["grads"])
    errs = rel_errs(grads, ref["grads"])
    assert max(errs.values()) <= refs["grad_tol"], sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    for k, v in ref["params"].items():
        close_rel(ours["params"][k], v, NET_TOL)


def assert_gan_step(refs, outs, label):
    """The rank's ``label`` step against the reference of that name: the
    losses and every parameter after the step; the discriminator's
    cancelled biases moved by at most the learning rate (rounding noise
    under Adam's sign-like step, tests/test_torch_gan.py)."""
    ours, ref = outs[0][label], refs[label]
    assert set(ref["scalars"]) == set(ours["scalars"])
    assert set(ref["params"]) == set(ours["params"])
    for k, v in ref["scalars"].items():
        close_rel(float(ours["scalars"][k]), v, NET_TOL)
    start = {f"disc.{k}": v for k, v in refs[f"{label}_disc_start"].items()}
    for k, v in ref["params"].items():
        if k in refs["recon_cancelled"]:
            assert float((ours["params"][k] - start[k]).abs().max()) <= 1e-3 * (1 + 1e-3), k
        else:
            close_rel(ours["params"][k], v, NET_TOL)


def test_data_parallel_gan_step_matches_one_process(ranks):
    """make_recon_train_step with the discriminator, 2 microbatches and
    instance noise, at 2 ranks against one process on the global batch:
    the losses and every parameter after the step (the noise is the global
    draw, the minibatch statistic the global batch's)."""
    refs, outs = ranks
    assert_gan_step(refs, outs, "recon")


def test_data_parallel_gan_step_matches_jax(ranks):
    """The data-parallel GAN step (2 objects, one a rank) against JAX's on
    its 2-device data mesh, where GSPMD makes the minibatch statistic and
    the loss means the global batch's: the losses and every parameter after
    the step."""
    refs, outs = ranks
    assert_gan_step(refs, outs, "recon_jax")


def test_train_reconstruct_data_parallel_rank0_writes(ranks):
    """train_reconstruct --data-parallel at 2 gloo ranks, one step of a
    global batch of 2: both ranks end on the same parameters (above), and
    rank 0 alone writes its checkpoints."""
    refs, outs = ranks
    assert outs[0]["tool"]["step"] == outs[1]["tool"]["step"] == 1
    assert outs[0]["tool"]["writes"] and not outs[1]["tool"]["writes"]
    written = sorted(p.name for p in refs["tool_dir"].rglob("ckpt-*.npz.pkl"))
    assert written == sorted({Path(p).name for p in outs[0]["tool"]["writes"]})
