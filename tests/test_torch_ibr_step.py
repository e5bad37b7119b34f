"""The port's IBR generator step (``latentfusion_tpu_torch/train/ibr_step.py``)
and ``train_ibr.py`` held against the JAX package's on the CPU, tiny family.

The step on the same raw batch and weights, for each ``ibr_type``
(``regress``, ``blend``, ``blend_flow``), without and with the multi-scale
discriminator, and with it and ``train_recon`` (the reconstruction modules
trained too; every gradient of the step then in play): the loss terms
within 5e-4 of the largest, every gradient JAX's optimizer was given
(generator, the reconstruction modules with ``train_recon``,
discriminator) at 5e-4 or 3x the port's own noise floor (the gate of
``tests/test_torch_train.py``; the discriminator's biases before instance
norm are rounding noise in both packages and are held to be small, as
``tests/test_torch_gan.py`` does). The floor perturbs every convolution of
the forward, the frozen reconstruction modules' too: the two packages'
forwards part in the last bits there as well, and with the discriminator
the generator's gradient moves by up to 0.7 % with them (the
discriminator's instance norms over masked, mostly flat images). The
instance noise's weight is 0, so the
step draws nothing that matters. Then the ``train_ibr`` CLI on the tiny
argv of ``tests/test_train_ibr.py``; and a port-trained IBR ``.pth`` in
``render_ibr``, which refuses it in both packages (1 + 6V training inputs
against 1 + 5V at inference, ROADMAP Queue 3 item 8).
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from latentfusion_tpu import pggan as jpggan
from latentfusion_tpu.modules import unet as junet
from latentfusion_tpu.recon.inference import LatentFusionModel as JModel
from latentfusion_tpu.train import ibr_step as jibr
from latentfusion_tpu.train import step as jstep

from latentfusion_tpu_torch import pggan as tpggan
from latentfusion_tpu_torch import testing as ttesting
from latentfusion_tpu_torch import train_ibr as ttrain_ibr
from latentfusion_tpu_torch.modules.unet import UNet2d
from latentfusion_tpu_torch.recon.inference import LatentFusionModel as TModel
from latentfusion_tpu_torch.train import ibr_step as tibr
from latentfusion_tpu_torch.train import step as tstep

from test_data import make_cube_obj
from test_torch_train import (CAMERA_DIST, FLOOR_EPS, FLOOR_FACTOR, NET_TOL, capture,
                              close_rel, grads_of, keyed, port_models, raw_batch, rel_errs,
                              tiny_family)  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from test_train_ibr import make_tiny_recon_pth  # noqa: E402

GEN_CONFIG = ((4, "D", 8), (8, "U", 4))
D_CONFIG, D_SCALES = (4, 8), 2
VIEWS_IN = VIEWS_OUT = 2
NOISE_TOL = 1e-3  # a cancelled discriminator bias's gradient against the largest


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def ibr_config(ibr_type, train_recon):
    return {"num_input_views": VIEWS_IN, "num_output_views": VIEWS_OUT, "batch_size": 2,
            "ibr_type": ibr_type, "camera_dist": CAMERA_DIST, "cube_size": 1.0,
            "train_recon": train_recon, "flow_size": 5, "g_color_recon_loss_k": 100,
            "g_color_recon_loss_type": "l1"}


@pytest.mark.parametrize("disc, train_recon", [(False, False), (True, False), (True, True)],
                         ids=["no_disc", "disc", "disc_train_recon"])
@pytest.mark.parametrize("ibr_type", ["regress", "blend", "blend_flow"])
def test_ibr_step_matches_jax(tiny_family, ibr_type, disc, train_recon):
    (sc, fu, ph), recon_params = tiny_family
    batch, batch_np = raw_batch(10)
    in_ch = tibr.generator_in_channels(VIEWS_IN)
    out_ch = tibr.generator_out_channels(ibr_type, VIEWS_IN)
    assert (in_ch, out_ch) == (jibr.generator_in_channels(VIEWS_IN),
                               jibr.generator_out_channels(ibr_type, VIEWS_IN))
    jgen = junet.UNet2d(in_channels=in_ch, out_channels=out_ch, block_config=GEN_CONFIG)
    gen_params = jgen.init(jax.random.PRNGKey(3), jnp.zeros((1, in_ch, 16, 16)))
    jd = d_params = d_opt = None
    if disc:
        jd = jpggan.MultiScaleDiscriminator(3, D_CONFIG, D_SCALES)
        d_params = jd.init(jax.random.PRNGKey(4), jnp.zeros((2, 3, 16, 16)))
        d_opt = capture(jstep.make_optimizer("adam", 1e-3))
    opt = capture(jstep.make_optimizer("adam", 1e-3))
    config = ibr_config(ibr_type, train_recon)
    params = {"generator": gen_params, "recon": recon_params}
    jax_step = jibr.make_ibr_train_step(sc, fu, ph, jgen, opt, jd, d_opt, config)
    jstate = jibr.IBRTrainState(params, opt.init(params), d_params,
                                d_opt.init(d_params) if d_opt else None, jnp.asarray(0))
    jstate, jscalars = jax_step(jstate, batch_np, jax.random.PRNGKey(5), 0.0)

    def fresh():
        recon = port_models(recon_params)
        gen = UNet2d(in_ch, out_ch, GEN_CONFIG)
        gen.load_state_dict({k: torch.from_numpy(v) for k, v in keyed(gen_params).items()})
        d = None
        if disc:
            d = tpggan.MultiScaleDiscriminator(3, D_CONFIG, D_SCALES, device="cpu")
            d.load_state_dict({k: torch.from_numpy(v) for k, v in keyed(d_params).items()})
        trained = {"generator": gen, **(recon if train_recon else {})}
        if not train_recon:
            for m in recon.values():
                m.requires_grad_(False)
        state = tstep.init_gan_train_state(
            trained, tstep.make_optimizer("adam", 1e-3), d,
            tstep.make_optimizer("adam", 1e-3) if disc else None, device="cpu")
        step = tibr.make_ibr_train_step(recon["sculptor"], recon["fuser"],
                                        recon["photographer"], gen, d, config)
        return trained, d, state, step, [gen, *recon.values(), *([d] if disc else [])]

    def run(step, state):
        return step(state, batch, torch.Generator().manual_seed(0), 0.0)

    trained, d, state, step, _ = fresh()
    state, tscalars = run(step, state)
    assert set(tscalars) == set(jscalars) and state.step == 1
    for k in jscalars:
        close_rel(tscalars[k], jscalars[k], NET_TOL)

    ours = grads_of(trained)
    theirs = {f"generator.{k}": v for k, v in keyed(jstate.opt_state[1]["generator"]).items()}
    if train_recon:
        theirs.update(keyed(jstate.opt_state[1]["recon"]))
    cancelled = set()
    if disc:
        ours.update(grads_of({"discriminator": d}))
        theirs.update({f"discriminator.{k}": v
                       for k, v in keyed(jstate.d_opt_state[1]).items()})
        cancelled = {f"discriminator.{k}" for k in d.cancelled_parameters()}
    assert set(ours) == set(theirs)
    largest = max(float(np.abs(v).max()) for v in ours.values())
    for k in cancelled:
        assert float(np.abs(ours[k]).max()) <= NOISE_TOL * largest, k
    ref = {k: v for k, v in ours.items() if k not in cancelled}
    floors = []
    for eps in FLOOR_EPS:
        for draw in range(3):
            f_trained, f_d, f_state, f_step, f_all = fresh()
            with ttesting.convs_perturbed(nn.ModuleList(f_all), eps, draw):
                run(f_step, f_state)
            moved = grads_of(f_trained)
            if f_d is not None:
                moved.update(grads_of({"discriminator": f_d}))
            floors.append(max(rel_errs({k: moved[k] for k in ref}, ref).values()))
    tol = max(NET_TOL, FLOOR_FACTOR * max(floors))
    errs = rel_errs(ref, {k: theirs[k] for k in ref})
    assert max(errs.values()) <= tol, (tol, sorted(errs.items(), key=lambda kv: -kv[1])[:3])


@pytest.fixture(scope="module")
def ibr_run(tmp_path_factory):
    """train_ibr on the tiny argv of tests/test_train_ibr.py (with the
    discriminator): the trainer and its exported .pth."""
    root = tmp_path_factory.mktemp("ibr")
    recon_pth = make_tiny_recon_pth(root)
    (root / "meshes").mkdir()
    make_cube_obj(root / "meshes")
    trainer = ttrain_ibr.main([
        "--dataset-type", "paths", "--dataset-path", str(root / "meshes"),
        "--save-dir", str(root / "runs"), "--base-name", "smoke",
        "--recon-checkpoint", str(recon_pth), "--input-size", "16",
        "--render-width", "64", "--render-height", "48", "--batch-size", "1",
        "--batches-per-epoch", "2", "--num-epochs", "1", "--num-workers", "0",
        "--num-input-views", "2", "--num-output-views", "2",
        "--generator-config", "8,D,16:16,U,8", "--ibr-type", "blend_flow",
        "--discriminator-config", "4,8", "--discriminator-scales", "2",
        "--save-interval", "-1", "--device", "cpu"])
    pth = root / "ibr.pth"
    trainer.export_torch_checkpoint(pth)
    return trainer, pth


def test_train_ibr_cli_smoke(ibr_run):
    trainer, pth = ibr_run
    assert trainer.save_dir.name == "ibr-smoke,type=blend_flow"
    assert sorted(p.name for p in trainer.save_dir.glob("ckpt-*.pkl")) == [
        "ckpt-best-loss_generator_total.npz.pkl", "ckpt-epoch-latest.npz.pkl",
        "ckpt-initial.npz.pkl"]
    assert trainer.state.step == 2
    scalars = {k: m.mean for k, m in trainer.plotter.moving_meters.items()}
    assert {"loss/generator/recon/color", "loss/generator/recon/gan",
            "loss/generator/total", "loss/discriminator/total"} <= set(scalars)
    assert all(np.isfinite(v) for v in scalars.values())
    gen = torch.load(pth, weights_only=False)["modules"]["generator"]
    assert gen["args"]["in_channels"] == 13
    assert gen["args"]["out_channels"] == (2, 2, 2)


def test_trained_generator_refused_by_render_ibr_in_both(ibr_run):
    """Both packages load the port's IBR .pth, and both refuse it in
    render_ibr: it was trained on 1 + 6V = 13 inputs, render_ibr gives 1 +
    5V = 11 (ROADMAP Queue 3 item 8)."""
    _, pth = ibr_run
    tm = TModel.from_checkpoint(pth, device="cpu")
    jm = JModel.from_checkpoint(pth)
    assert tm.generator is not None and jm.generator is not None
    rng = np.random.RandomState(0)
    from test_torch_slice import tiny_views
    from latentfusion_tpu.camera import Camera as JCamera
    from latentfusion_tpu.observation import Observation as JObservation
    from latentfusion_tpu_torch.camera import Camera as TCamera
    from latentfusion_tpu_torch.observation import Observation as TObservation

    views = tiny_views(rng, n=2)
    args = (views["color"], views["depth"], views["mask"])
    tobs = TObservation(*args, TCamera(views["intrinsic"], views["extrinsic"], width=64,
                                       height=48, device="cpu"))
    jobs = JObservation(*args, JCamera(views["intrinsic"], views["extrinsic"], width=64,
                                       height=48))
    z_t = tm.build_latent_object(tobs)
    with pytest.raises(RuntimeError, match="channels"):
        tm.render_ibr(z_t, tobs, tobs.camera[:1].zoom(None, 16, tm.camera_dist))
    # JAX's refusal shows while tracing (the generator's first convolution),
    # whatever the latent's values.
    cam_j = jobs.camera[:1].zoom(None, 16, jm.camera_dist)
    with pytest.raises(Exception):
        jax.jit(lambda z: jm.render_ibr(z, jobs, cam_j))(jnp.asarray(z_t.numpy()))
