"""The port's trainer (``latentfusion_tpu_torch/train/{trainer,args,logging}.py``,
``train_reconstruct.py``) held against the JAX package's on the CPU, tiny
architectures of ``tests/test_train.py``'s argv.

The parsers, the run name, the checkpoint-args merge, the camera distance,
the meters and the learning-rate schedules are compared exactly. One
``ReconTrainer.run_iteration`` on a JAX-made batch with JAX's weights and
JAX's random orientation injected: scalars and parameters within
``tests/test_torch_train.py``'s gates (5e-4 of the largest value). A port
run resumed from a JAX-written checkpoint holds ``from_jax_params`` of its
parameters bit for bit; the port's exported ``.pth`` renders the same views
(5e-4) through both packages' ``from_checkpoint``. The JAX tool's three
known faults (ROADMAP Queue 3) are shown in both packages.
"""
import argparse
import pickle
import shlex
import sys
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import optax
import pytest
import torch

from latentfusion_tpu.recon.inference import LatentFusionModel as JModel
from latentfusion_tpu.train import args as jargs
from latentfusion_tpu.train import logging as jlogging
from latentfusion_tpu.train import step as jstep
from latentfusion_tpu.train import trainer as jtrainer

from latentfusion_tpu_torch import dtypes as tdtypes
from latentfusion_tpu_torch import train_ibr as ttrain_ibr
from latentfusion_tpu_torch import train_reconstruct as ttrain
from latentfusion_tpu_torch import utils as tutils
from latentfusion_tpu_torch.recon.checkpoint import flatten_params, from_jax_params
from latentfusion_tpu_torch.recon.inference import LatentFusionModel as TModel
from latentfusion_tpu_torch.train import args as targs
from latentfusion_tpu_torch.train import logging as tlogging
from latentfusion_tpu_torch.train import step as tstep
from latentfusion_tpu_torch.train import trainer as ttrainer

from test_data import make_cube_obj
from test_torch_slice import run_both, tiny_views
from test_torch_train import (CONFIG, NET_TOL, assert_params_match, close_rel, orientations,
                              port_models, raw_batch, tiny_family)  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import train_ibr as jtrain_ibr  # noqa: E402
import train_reconstruct as jtrain  # noqa: E402

TRAIN_SH = ROOT / "tools" / "train.sh"
TINY = [
    "--dataset-type", "paths", "--base-name", "smoke", "--input-size", "16",
    "--render-width", "64", "--render-height", "48", "--batch-size", "1",
    "--batches-per-epoch", "1", "--num-epochs", "1", "--num-workers", "0",
    "--num-input-views", "2", "--num-output-views", "2",
    "--sculptor-image-config", "4,D,8:8", "--sculptor-camera-config", "4,4",
    "--sculptor-object-config", "4,4", "--photographer-object-config", "none",
    "--photographer-camera-config", "4,4", "--photographer-image-config",
    "4,D,8:8,U,8,U,4", "--fuser-type", "gru", "--no-discriminator", "--predict-depth",
    "--predict-mask", "--generator-input-mask", "--random-orientation",
    "--save-interval", "-1"]


@pytest.fixture(autouse=True)
def _policy_and_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    tdtypes.set_compute_dtype(torch.float32)
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    root = tmp_path_factory.mktemp("meshes")
    make_cube_obj(root)
    return root


def tiny_argv(meshes, save_dir, *extra):
    return [*TINY, "--dataset-path", str(meshes), "--save-dir", str(save_dir), *extra]


def train_sh_flags():
    """tools/train.sh's arguments, its variables filled in."""
    text = TRAIN_SH.read_text().split('train_reconstruct.py" \\', 1)[1]
    text = (text.replace('"$SHAPENET_PATH"', "/data/shapenet")
            .replace('"$TEXTURES_PATH"', "/data/coco").replace('"$SAVE_DIR"', "/runs"))
    return shlex.split(text.replace("\\\n", " "))


def port_vars(namespace):
    out = vars(namespace)
    assert out.pop("device") == "cuda"
    return out


# ---------------------------------------------------------------- parsers
@pytest.mark.parametrize("which", ["train.sh", "defaults"])
def test_train_reconstruct_parser_matches_jax(which):
    argv = (train_sh_flags() if which == "train.sh"
            else ["--save-dir", "/runs", "--base-name", "b"])
    assert port_vars(ttrain.get_args(argv)) == vars(jtrain.get_args(argv))
    if which == "train.sh":
        assert "--use-amp" in argv and ttrain.get_args(argv).use_amp


def test_train_ibr_parser_matches_jax():
    for argv in (["--save-dir", "/r", "--base-name", "b", "--recon-checkpoint", "m.pth"],
                 ["--save-dir", "/r", "--base-name", "b", "--recon-checkpoint", "m.pth",
                  "--ibr-type", "blend", "--generator-config", "4,D,8:8,U,4",
                  "--discriminator-config", "4,8", "--train-recon",
                  "--g-color-recon-loss-k-milestones", "3,5"]):
        assert port_vars(ttrain_ibr.get_args(argv)) == vars(jtrain_ibr.get_args(argv))


def test_names_args_merge_and_camera_dist_match_jax(tmp_path):
    args = ttrain.get_args(train_sh_flags())
    jax_args = jtrain.get_args(train_sh_flags())
    assert ttrain.generate_name("shapenet,256", args) == jtrain.generate_name(
        "shapenet,256", jax_args)
    for a in (args, jax_args):
        a.no_discriminator, a.predict_color, a.fuser_type = False, True, "pool:max"
    assert ttrain.generate_name("x", args) == jtrain.generate_name("x", jax_args)
    for camera_dist in (None, 2.5):
        for w, h, cube in ((640, 480, 1.0), (64, 48, 0.7), (256, 192, 1.3)):
            ns = argparse.Namespace(camera_dist=camera_dist, render_width=w,
                                    render_height=h, cube_size=cube)
            assert targs.auto_camera_dist(ns) == pytest.approx(jargs.auto_camera_dist(ns),
                                                               rel=1e-12)

    live = tmp_path / "data"
    live.mkdir()
    old = tmp_path / "old"
    old.mkdir()
    for ckpt_args, override in (({"dataset_path": "/nonexistent/shapenet", "batch_size": 8,
                                  "num_epochs": 99, "scale_mode": "nearest"}, ""),
                                ({"dataset_path": str(old), "batch_size": 8}, "batch-size"),
                                ({"dataset_path": str(old), "seed": None}, "")):
        merged = []
        for load, parse in ((ttrain.load_checkpoint_args, ttrain.get_args),
                            (jtrain.load_checkpoint_args, jtrain.get_args)):
            a = parse(["--save-dir", "/r", "--base-name", "b", "--dataset-path", str(live),
                       "--resume", "x"])
            merged.append({k: v for k, v in vars(load(dict(ckpt_args), a, override)).items()
                           if k != "device"})
        assert merged[0] == merged[1]


# ------------------------------------------------------------------ meters
def test_metric_logger_matches_jax():
    rng = np.random.RandomState(0)
    loggers = (tlogging.MetricLogger(scalar_interval=3),
               jlogging.MetricLogger(scalar_interval=3))
    summaries = ([], [])
    for epoch in range(2):
        for _ in range(25):
            scalars = {"loss/a": np.float32(rng.randn()), "loss/b": np.float32(rng.rand())}
            for i, lg in enumerate(loggers):
                lg.put_scalars(scalars if i else {k: torch.tensor(v) for k, v in
                                                  scalars.items()})
                lg.put_scalar("time/x", 0.5)
                lg.step()
        for i, lg in enumerate(loggers):
            summaries[i].append(lg.epoch_summary())
    assert summaries[0] == summaries[1]
    t, j = loggers
    assert {k: m.mean for k, m in t.moving_meters.items()} == {
        k: m.mean for k, m in j.moving_meters.items()}
    assert t.global_step == j.global_step == 50
    assert [t.is_it_time_yet(k) for k in t.intervals] == [j.is_it_time_yet(k) for k in j.intervals]


def test_lr_schedules_match_optax():
    for init, bounds in ((0.00075, {100 * 4: 0.5, 30 * 4: 0.5}), (1e-3, {0: 0.1, 5: 0.5}),
                         (1e-3, {})):
        ours = tutils.piecewise_constant_schedule(init, bounds)
        ref = optax.piecewise_constant_schedule(init, bounds or None)
        for step in range(0, 450):
            assert ours(step) == pytest.approx(float(ref(step)), rel=1e-6), step
    ours = tutils.cosine_decay_schedule(1e-3, 50, alpha=0.01)
    ref = optax.cosine_decay_schedule(1e-3, 50, alpha=0.01)
    for step in range(0, 60):
        assert ours(step) == pytest.approx(float(ref(step)), rel=1e-5), step


# --------------------------------------------------------------- iteration
def test_run_iteration_matches_jax(tiny_family, tmp_path):
    """One iteration of each trainer on the same raw batch and weights: the
    port's step given JAX's orientation; the scalars and the parameters
    after Adam within the train gates, the learning rate the schedule's."""
    (sc, fu, ph), params = tiny_family
    batch, batch_np = raw_batch(10)
    schedule = optax.piecewise_constant_schedule(1e-3, {1: 0.5})
    opt = optax.adam(schedule, b1=0.0, b2=0.99)
    jt = jtrainer.ReconTrainer(
        name="j", save_dir=tmp_path, loader=None, batches_per_epoch=1, sculptor=sc,
        fuser=fu, photographer=ph, g_optimizer=opt,
        state=jstep.init_gan_train_state(params, opt),
        step_fn=jstep.make_recon_train_step(sc, fu, ph, opt, config=CONFIG), seed=3)
    key, sub = jax.random.split(jax.random.PRNGKey(3))
    rotations = [torch.from_numpy(np.array(q)) for q in orientations(sub, 1)]
    mods = port_models(params)
    step = tstep.make_recon_train_step(mods["sculptor"], mods["fuser"], mods["photographer"],
                                       config=CONFIG)
    tt = ttrainer.ReconTrainer(
        name="t", save_dir=tmp_path, loader=None, batches_per_epoch=1, **mods,
        state=tstep.init_train_state(mods, tstep.make_optimizer("adam", 1.0)),
        step_fn=lambda state, b, rng, input_noise_weight: step(
            state, b, rng, rotations, input_noise_weight),
        module_args={}, lr_schedule=tutils.piecewise_constant_schedule(1e-3, {1: 0.5}),
        seed=3)
    jt.run_iteration(batch_np)
    tt.run_iteration(batch)
    assert tt.state.optimizer.param_groups[0]["lr"] == 1e-3 and tt.state.step == 1
    for k in ("loss/generator/depth", "loss/generator/mask", "loss/generator/total"):
        close_rel(tt.plotter.epoch_meters[k].mean, jt.plotter.epoch_meters[k].mean, NET_TOL)
    assert set(tt.plotter.epoch_meters) == set(jt.plotter.epoch_meters)
    assert_params_match(mods, jt.state.params)


# ---------------------------------------------------------------- the CLI
def test_cli_smoke_resume_and_branch(meshes, tmp_path):
    """tests/test_train.py's and tests/test_resume.py's runs on the port: an
    epoch of 2 batches (params.json, the initial, best and latest
    checkpoints), then a resumed branch with wrong architecture flags given:
    the checkpoint's win, the CLI keeps the overridden flag."""
    runs = tmp_path / "runs"
    trainer = ttrain.main(tiny_argv(meshes, runs, "--device", "cpu",
                                    "--batches-per-epoch", "2"))
    (run,) = list(runs.iterdir())
    names = sorted(p.name for p in run.glob("ckpt-*.pkl"))
    assert names == ["ckpt-best-loss_generator_total.npz.pkl", "ckpt-epoch-latest.npz.pkl",
                     "ckpt-initial.npz.pkl"]
    assert (run / "params.json").exists() and trainer.state.step == 2
    latest = run / "ckpt-epoch-latest.npz.pkl"
    resumed = ttrain.main(tiny_argv(meshes, runs, "--device", "cpu", "--resume", str(latest),
                                    "--branch", "--branch-name", "forked", "--override",
                                    "batches-per-epoch", "--batches-per-epoch", "3",
                                    "--scale-mode", "nearest"))
    assert sorted(p.name for p in runs.iterdir())[1].startswith("smoke-forked")
    assert resumed.batches_per_epoch == 3 and resumed.state.step == 3
    assert resumed.kwargs["scale_mode"] == "bilinear"  # the checkpoint's
    ckpt = ttrainer.load_checkpoint(latest)
    assert ckpt["modules"]["fuser"]["type"] == "GRUFuser" and ckpt["epoch"] == 0


def test_moved_dataset_path_rewrite(tmp_path):
    live = tmp_path / "data"
    live.mkdir()
    args = argparse.Namespace(dataset_path=live, background_path=None,
                              depth_background_path=None, texture_path=None,
                              batch_size=1, resume="x", branch=False, branch_name=None,
                              override="", save_dir=None, num_epochs=1)
    out = ttrain.load_checkpoint_args({"dataset_path": "/nonexistent/shapenet",
                                       "batch_size": 8}, args, override="")
    assert out.dataset_path == live and out.batch_size == 8
    old = tmp_path / "old"
    old.mkdir()
    out = ttrain.load_checkpoint_args({"dataset_path": str(old)}, args, override="")
    assert str(out.dataset_path) == str(old)


def test_fsdp_and_use_amp_flags(meshes, tmp_path):
    with pytest.raises(SystemExit, match="does not divide 1 devices"):
        ttrain.main(tiny_argv(meshes, tmp_path, "--device", "cpu", "--fsdp", "2"))
    seen = []
    run_iteration = ttrainer.ReconTrainer.run_iteration

    def spy(self, *args, **kwargs):
        seen.append(tdtypes.get_compute_dtype())
        return run_iteration(self, *args, **kwargs)

    with mock.patch.object(ttrainer.ReconTrainer, "run_iteration", spy):
        trainer = ttrain.main(tiny_argv(meshes, tmp_path, "--device", "cpu", "--use-amp",
                                        "--data-parallel"))
    # The iterations ran in bf16; main leaves the caller's fp32 policy as it was.
    assert seen and set(seen) == {torch.bfloat16}
    assert tdtypes.get_compute_dtype() == torch.float32
    assert np.isfinite(trainer.plotter.moving_meters["loss/generator/total"].mean)


@pytest.fixture(scope="module")
def jax_run(meshes, tmp_path_factory):
    """The JAX tool's run on the tiny argv: its epoch-latest checkpoint."""
    runs = tmp_path_factory.mktemp("jax_runs")
    jtrain.main(tiny_argv(meshes, runs))
    return next(runs.iterdir()) / "ckpt-epoch-latest.npz.pkl"


def test_resume_from_jax_checkpoint_is_bit_exact(meshes, jax_run, tmp_path):
    """The port resumes from the JAX trainer's pickle (no epoch run): each
    module holds from_jax_params of JAX's parameters, bit for bit; and the
    port's own checkpoint of them holds JAX's trees, bit for bit."""
    payload = jtrainer.load_checkpoint(jax_run)
    trainer = ttrain.main(tiny_argv(meshes, tmp_path, "--device", "cpu", "--resume",
                                    str(jax_run), "--num-epochs", "0"))
    for name in ("sculptor", "fuser", "photographer"):
        ref = from_jax_params(flatten_params(payload["modules"][name]["params"]))
        state = getattr(trainer, name).state_dict()
        assert set(state) == set(ref)
        for k, v in ref.items():
            assert torch.equal(state[k], v), (name, k)
    ours = ttrainer.load_checkpoint(trainer.save_dir / "ckpt-initial.npz.pkl")
    for name in ("sculptor", "fuser", "photographer"):
        a = flatten_params(ours["modules"][name]["params"])
        b = flatten_params(payload["modules"][name]["params"])
        assert list(a) == list(b)
        assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)
        assert ours["modules"][name]["args"] == payload["modules"][name]["args"]


def test_exported_pth_renders_alike_in_both_packages(meshes, tmp_path):
    trainer = ttrain.main(tiny_argv(meshes, tmp_path, "--device", "cpu"))
    path = tmp_path / "model.pth"
    trainer.export_torch_checkpoint(path)
    jm = JModel.from_checkpoint(path)
    tm = TModel.from_checkpoint(path, device="cpu")
    assert jm.camera_dist == tm.camera_dist == trainer.camera_dist
    run_both(jm, tm, tiny_views(np.random.RandomState(4)), 6, np.random.RandomState(5))


# ------------------------------------------------------------ the faults
def test_batch_groups_take_one_step_an_iteration_in_both(meshes, tmp_path):
    """ROADMAP Queue 3 item 11: with --batch-groups 2 an epoch of 1 batch runs
    2 iterations, each an optimizer step of batch 1 (not one step of 2), in
    both packages; the LR milestones count those steps, so they land at half
    the epochs."""
    argv = tiny_argv(meshes, tmp_path / "t", "--batch-groups", "2",
                     "--generator-lr-milestones", "1", "--num-epochs", "2")
    trainer = ttrain.main([*argv, "--device", "cpu"])
    assert trainer.state.step == 4
    assert trainer.lr_schedule(2) == 0.0005  # milestone epoch 1 x 1 batch = step 1
    calls = []
    real = jstep.make_recon_train_step

    def counting(*a, **kw):
        step = real(*a, **kw)

        def run(state, *rest):
            state, scalars = step(state, *rest)
            calls.append(int(state.step))
            return state, scalars
        return run

    jstep.make_recon_train_step = counting
    try:
        jtrain.main([a.replace(str(tmp_path / "t"), str(tmp_path / "j")) for a in argv])
    finally:
        jstep.make_recon_train_step = real
    assert calls == [1, 2, 3, 4]


def test_depth_k_milestones_are_not_read_in_both(meshes, jax_run, tmp_path):
    """ROADMAP Queue 3 item 12: --g-depth-recon-loss-k-milestones parses
    and changes nothing: the same flags with and without it train to the
    same parameters, in each package (JAX's run without it is the
    ``jax_run`` fixture's)."""
    def port_params(extra, where):
        trainer = ttrain.main(tiny_argv(meshes, tmp_path / where, "--device", "cpu", *extra))
        return {k: v.clone() for k, v in trainer.sculptor.state_dict().items()}

    milestones = ("--g-depth-recon-loss-k-milestones", "0")
    a, b = port_params((), "t1"), port_params(milestones, "t2")
    assert all(torch.equal(a[k], b[k]) for k in a)
    runs = tmp_path / "j"
    jtrain.main(tiny_argv(meshes, runs, *milestones))
    jb = jtrainer.load_checkpoint(next(runs.iterdir()) / "ckpt-epoch-latest.npz.pkl")
    fa = flatten_params(jtrainer.load_checkpoint(jax_run)["modules"]["sculptor"]["params"])
    fb = flatten_params(jb["modules"]["sculptor"]["params"])
    assert all(np.array_equal(fa[k], fb[k]) for k in fa)
    assert jtrain.get_args(tiny_argv(meshes, "/r", *milestones)).g_depth_recon_loss_k_milestones == [0]


def test_resume_restores_parameters_only_in_both(meshes, jax_run, tmp_path):
    """ROADMAP Queue 3 item 13: a resumed run starts at epoch 0 with a fresh
    optimizer (its step count from 0) in both packages; only the parameters
    come from the checkpoint."""
    payload = jtrainer.load_checkpoint(jax_run)
    assert payload["epoch"] == 0 and "opt_state" not in payload
    trainer = ttrain.main(tiny_argv(meshes, tmp_path / "t", "--device", "cpu", "--resume",
                                    str(jax_run)))
    assert trainer.epoch == 0 and trainer.state.step == 1
    assert ttrainer.load_checkpoint(trainer.save_dir / "ckpt-initial.npz.pkl")["epoch"] == 0
    steps = []
    real = jstep.make_recon_train_step

    def counting(*a, **kw):
        step = real(*a, **kw)

        def run(state, *rest):
            steps.append(int(state.step))
            return step(state, *rest)
        return run

    jstep.make_recon_train_step = counting
    try:
        jtrain.main(tiny_argv(meshes, tmp_path / "j", "--resume", str(jax_run)))
    finally:
        jstep.make_recon_train_step = real
    assert steps == [0]
    (run,) = list((tmp_path / "j").iterdir())
    with open(run / "ckpt-initial.npz.pkl", "rb") as f:
        assert pickle.load(f)["epoch"] == 0
