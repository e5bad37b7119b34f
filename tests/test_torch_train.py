"""The port's training slice held against the JAX package on the CPU: the
losses, the reconstruction helpers and ``process_batch``, and the training
steps (``make_recon_train_step`` without a discriminator, and the plain
``make_train_step``) on the tiny family from the same weights and batch.

Tolerances (fp32): 1e-5 for ops and helpers; 2e-4 for geometry (cameras
and zoomed views, which pass through trig and divisions of quantities near
600); 5e-4 for networks, losses and parameters (relative to their largest
magnitude). Gradients are compared relative to their parameter's largest
gradient, at 5e-4 or, where it is larger, 3x the port's own noise floor:
the largest relative change of its gradient when every convolution's
output is multiplied by (1 + eps N(0, 1)), eps 1e-7 and 4e-7, three draws
each (the gate chip_smoke.py puts on the refinement gradient). The
training gradient moves between discrete values with the activations' last
bits (leaky-ReLU kinks, PixelNorm of near-zero activations, the top-k
boundary), in both packages: JAX's own gradient moves by up to 4.6e-4 when
the renders are multiplied by (1 + 1e-7 N(0, 1)).

The random orientation of each microbatch is JAX's draw, given to the port
as ``rotations`` (the two frameworks' random streams differ).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from latentfusion_tpu import losses as jlosses
from latentfusion_tpu import zoo as jzoo
from latentfusion_tpu.recon import utils as jutils
from latentfusion_tpu.three import quaternion as jquat
from latentfusion_tpu.train import step as jstep

from latentfusion_tpu_torch import losses as tlosses
from latentfusion_tpu_torch import testing as ttesting
from latentfusion_tpu_torch import zoo as tzoo
from latentfusion_tpu_torch.recon import utils as tutils
from latentfusion_tpu_torch.recon.checkpoint import from_jax_params
from latentfusion_tpu_torch.train import step as tstep

OPS_TOL = 1e-5
GEOM_TOL = 2e-4
NET_TOL = 5e-4
FLOOR_EPS = (1e-7, 4e-7)
FLOOR_FACTOR = 3.0
CAMERA_DIST = 3.0  # frames the oracle's objects in a 16^2 zoom of 64x48 views
CONFIG = {"camera_dist": CAMERA_DIST, "random_orientation": True,
          "g_depth_recon_loss_k": 100}  # below the 256 pixels: top-k selects


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=0)


def close_rel(a, b, tol, floor=1.0):
    """max |a - b| within ``tol`` of the larger of max |b| and ``floor``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err = np.abs(a - b).max()
    assert err <= tol * max(float(np.abs(b).max()), floor), err


def keyed(tree):
    """A JAX tree as the port's state_dict names -> numpy arrays."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {k: v.numpy() for k, v in from_jax_params(
        {jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves}).items()}


def raw_batch(seed, b=2, v_in=2, v_out=2, width=64, height=48):
    """A raw oracle batch, as torch (CPU) and numpy."""
    batch = ttesting.render_training_batch(torch.Generator().manual_seed(seed), b,
                                           v_in, v_out, width, height, device="cpu")
    as_np = {k: {kk: vv.numpy() for kk, vv in v.items()} for k, v in batch.items()}
    return batch, as_np


# ------------------------------------------------------------------ losses
@pytest.mark.parametrize("reduction", ["mean", "sum", None])
def test_losses_match_jax(rng, reduction):
    x = rng.randn(3, 2, 6, 5).astype(np.float32)
    y = rng.randn(3, 2, 6, 5).astype(np.float32) * 1.5
    p = rng.rand(3, 2, 6, 5).astype(np.float32)
    p[0, 0, 0, 0] = 0.0  # clipped (at 1, fp32 1 - 1e-12 rounds to 1: NaN on both sides)
    m = (rng.rand(3, 2, 6, 5) > 0.5).astype(np.float32)
    tx, ty, tp, tm = (torch.from_numpy(a) for a in (x, y, p, m))
    pairs = [
        (tlosses.l1_loss(tx, ty, reduction), jlosses.l1_loss(x, y, reduction)),
        (tlosses.smooth_l1_loss(tx, ty, reduction), jlosses.smooth_l1_loss(x, y, reduction)),
        (tlosses.smooth_l1_loss(tx, ty, reduction, beta=0.5),
         jlosses.smooth_l1_loss(x, y, reduction, beta=0.5)),
        (tlosses.binary_cross_entropy_loss(tp, tm, reduction),
         jlosses.binary_cross_entropy_loss(p, m, reduction)),
        (tlosses.beta_prior_loss(tp, 0.01, 0.01, reduction),
         jlosses.beta_prior_loss(p, 0.01, 0.01, reduction)),
        (tlosses.beta_prior_loss(tp, 2.0, 0.5, reduction),
         jlosses.beta_prior_loss(p, 2.0, 0.5, reduction)),
        (tlosses.reduce_loss(tx, reduction), jlosses.reduce_loss(x, reduction)),
    ]
    for ours, ref in pairs:
        close_rel(ours, ref, OPS_TOL)
    with pytest.raises(ValueError):
        tlosses.reduce_loss(tx, "max")


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("k", [7, 30, 1000])
def test_hard_pixel_loss_matches_jax(rng, reduction, k):
    """Top-k over the folded (B, V, C, H, W) pixels: k below the 30 pixels
    of each image selects, k above them takes all."""
    x = rng.randn(2, 3, 2, 6, 5).astype(np.float32)
    y = rng.randn(2, 3, 2, 6, 5).astype(np.float32)
    for base_t, base_j in ((tlosses.l1_loss, jlosses.l1_loss),
                           (tlosses.smooth_l1_loss, jlosses.smooth_l1_loss)):
        ours = tlosses.hard_pixel_loss(base_t, torch.from_numpy(x), torch.from_numpy(y),
                                       k, reduction)
        close_rel(ours, jlosses.hard_pixel_loss(base_j, x, y, k, reduction), OPS_TOL)
    if k < 30:
        everything = tlosses.hard_pixel_loss(tlosses.l1_loss, torch.from_numpy(x),
                                             torch.from_numpy(y), 30)
        assert float(tlosses.hard_pixel_loss(tlosses.l1_loss, torch.from_numpy(x),
                                             torch.from_numpy(y), k)) > float(everything)


# ------------------------------------------------------- recon utilities
def test_recon_helpers_match_jax(rng):
    for args in ((615.0, 480, 0.866, 0.1), (61.5, 48, 0.5, 1.5)):
        assert abs(tutils.optimal_camera_dist(*args) - jutils.optimal_camera_dist(*args)) < 1e-9
    x = torch.zeros(2, 3, 4, 5, 6)
    close(tutils.get_normalized_voxel_coords(x),
          jutils.get_normalized_voxel_coords(jnp.zeros((2, 3, 4, 5, 6))), OPS_TOL)
    close(tutils.get_normalized_voxel_depth(x),
          jutils.get_normalized_voxel_depth(jnp.zeros((2, 3, 4, 5, 6))), OPS_TOL)
    close(tutils.get_normalized_pixel_coords(torch.zeros(2, 3, 5, 7)),
          jutils.get_normalized_pixel_coords(jnp.zeros((2, 3, 5, 7))), OPS_TOL)
    depth = rng.uniform(-1, 1, (2, 1, 5, 7)).astype(np.float32)
    mask = (rng.rand(2, 1, 5, 7) > 0.5).astype(np.float32)
    close(tutils.mask_normalized_depth(torch.from_numpy(depth), torch.from_numpy(mask)),
          jutils.mask_normalized_depth(depth, mask), OPS_TOL)


def test_training_batch_layout():
    batch, _ = raw_batch(0, b=2, v_in=3, v_out=2)
    assert set(batch) == {"in", "in_gt", "out_gt"}
    for name, v in (("in", 3), ("in_gt", 3), ("out_gt", 2)):
        g = batch[name]
        assert g["render"].shape == (2, v, 3, 48, 64)
        assert g["mask"].shape == g["depth"].shape == (2, v, 48, 64)
        assert g["extrinsic"].shape == (2, v, 4, 4) and g["intrinsic"].shape == (2, v, 3, 4)
        hit = g["mask"] > 0
        assert 0 < float(hit.float().mean()) < 0.9
        assert bool((g["depth"][hit] > 1.0).all()) and bool((g["depth"][~hit] == 0).all())
    assert torch.equal(batch["in"]["render"], batch["in_gt"]["render"])
    again, _ = raw_batch(0, b=2, v_in=3, v_out=2)
    assert torch.equal(again["out_gt"]["depth"], batch["out_gt"]["depth"])


def test_process_batch_matches_jax():
    """A raw oracle batch of 2 objects x 2 views at 64x48, zoomed to 16^2
    with JAX's random orientation injected."""
    batch, batch_np = raw_batch(1)
    key = jax.random.PRNGKey(3)
    ref = jutils.process_batch(batch_np, 1.0, CAMERA_DIST, 16, key=key)
    ours = tutils.process_batch(batch, 1.0, CAMERA_DIST, 16,
                                rotation=torch.from_numpy(np.array(jquat.random(key, 1))))
    assert set(ours) == set(ref)
    for group in ref:
        for field in ("intrinsic", "viewport", "log_quaternion", "translation"):
            close_rel(getattr(ours[group]["camera"], field),
                      getattr(ref[group]["camera"], field), GEOM_TOL)
        for k in ("image", "mask", "depth"):
            close(ours[group][k], ref[group][k], GEOM_TOL)
    assert float(ours["out_gt"]["mask"].mean()) > 0.05
    with pytest.raises(ValueError, match="generator or a rotation"):
        tutils.process_batch(batch, 1.0, CAMERA_DIST, 16)
    plain = tutils.process_batch(batch, 1.0, CAMERA_DIST, 16, random_orientation=False)
    ref = jutils.process_batch(batch_np, 1.0, CAMERA_DIST, 16, random_orientation=False)
    close(plain["in"]["image"], ref["in"]["image"], GEOM_TOL)


# ---------------------------------------------------------- training step
def capture(optimizer):
    """``optimizer`` whose state also keeps the last gradient it was given
    and the update it made, so a jitted JAX step hands both back."""
    def init(params):
        zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
        return optimizer.init(params), zeros, zeros

    def update(grads, state, params=None):
        updates, inner = optimizer.update(grads, state[0], params)
        return updates, (inner, grads, updates)

    return optax.GradientTransformation(init, update)


def port_models(params, family="tiny"):
    """The port's modules of ``family`` (CPU) carrying JAX's parameters."""
    state = {"sculptor": keyed(params["sculptor"]), "fuser": keyed(params["fuser"]),
             "photographer": keyed(params["photographer"])}
    mods = {"sculptor": getattr(tzoo, f"{family}_sculptor")(device="cpu"),
            "fuser": getattr(tzoo, f"{family}_fuser")(device="cpu"),
            "photographer": getattr(tzoo, f"{family}_photographer")(device="cpu")}
    for name, module in mods.items():
        module.load_state_dict({k: torch.from_numpy(v) for k, v in state[name].items()})
    return mods


def grads_of(mods):
    return {f"{name}.{pname}": p.grad.numpy().copy()
            for name, module in mods.items() for pname, p in module.named_parameters()}


def rel_errs(ours, ref):
    return {k: float(np.abs(ours[k] - ref[k]).max()) / max(float(np.abs(ref[k]).max()), 1e-30)
            for k in ref}


def grad_tolerance(run_first_step, grads):
    """max(NET_TOL, FLOOR_FACTOR x the largest of the 6 floor draws):
    ``run_first_step()`` runs the step on fresh modules and returns them."""
    floors = []
    for eps in FLOOR_EPS:
        for draw in range(3):
            mods = run_first_step(
                lambda m: ttesting.convs_perturbed(nn.ModuleList(m.values()), eps, draw))
            floors.append(max(rel_errs(grads_of(mods), grads).values()))
    return max(NET_TOL, FLOOR_FACTOR * max(floors))


def assert_grads_match(mods, jax_grads, tol):
    ref = keyed(jax_grads)
    assert set(grads_of(mods)) == set(ref)
    errs = rel_errs(grads_of(mods), ref)
    assert max(errs.values()) <= tol, (tol, sorted(errs.items(), key=lambda kv: -kv[1])[:3])


def assert_params_match(mods, jax_params, tol=NET_TOL):
    ref = keyed(jax_params)
    for name, module in mods.items():
        for pname, p in module.named_parameters():
            close_rel(p.detach(), ref[f"{name}.{pname}"], tol)


def assert_optimizer_matches(jax_grads, jax_updates, tol=NET_TOL):
    """The port's optimizer, given JAX's gradient of each step, makes JAX's
    update, relative to each parameter's largest update. The parameters
    start at 0 (Adam's update does not read them), so each step's update is
    read without the rounding of large weights. End to end the updates are
    not comparable: with b1 = 0 Adam's first update is lr * sign(g), which
    flips on the gradient elements smaller than the gradient's tolerance."""
    grads = [keyed(g) for g in jax_grads]
    names = sorted(grads[0])
    params = [torch.zeros(grads[0][k].shape, requires_grad=True) for k in names]
    optimizer = tstep.make_optimizer("adam", 1e-3)(params)
    for g, u in zip(grads, (keyed(u) for u in jax_updates)):
        before = [p.detach().clone() for p in params]
        for p, k in zip(params, names):
            p.grad = torch.from_numpy(g[k])
        optimizer.step()
        for p, p0, k in zip(params, before, names):
            close_rel(p.detach() - p0, u[k], tol, floor=1e-30)


def orientations(key, num_microbatches):
    """The random orientation JAX's step draws for each microbatch."""
    if num_microbatches == 1:
        return [jquat.random(key, 1)]
    return [jquat.random(k, 1) for k in jax.random.split(key, num_microbatches)]


def run_recon_steps(family, params, jax_mods, config, num_microbatches, batches,
                    keys):
    """The JAX recon step and the port's from the same parameters, over
    ``batches`` with ``keys``: loss terms of each step, every gradient of
    step 1, every parameter after each step."""
    sc, fu, ph = jax_mods
    opt = capture(jstep.make_optimizer("adam", 1e-3))
    jax_step = jstep.make_recon_train_step(sc, fu, ph, opt, config=config,
                                           num_microbatches=num_microbatches)
    jstate = jstep.init_gan_train_state(params, opt)

    def port():
        mods = port_models(params, family)
        state = tstep.init_train_state(mods, tstep.make_optimizer("adam", 1e-3))
        return mods, state, tstep.make_recon_train_step(
            mods["sculptor"], mods["fuser"], mods["photographer"], config=config,
            num_microbatches=num_microbatches)

    mods, tstate, port_step = port()
    assert all(m.training for m in mods.values())
    jax_grads, jax_updates = [], []
    for i, ((batch, batch_np), key) in enumerate(zip(batches, keys)):
        jstate, jscalars = jax_step(jstate, batch_np, key)
        jax_grads.append(jstate.opt_state[1])
        jax_updates.append(jstate.opt_state[2])
        rotations = [torch.from_numpy(np.array(q))
                     for q in orientations(key, num_microbatches)]
        tstate, tscalars = port_step(tstate, batch, rotations=rotations)
        assert tstate.step == i + 1 and set(tscalars) == set(jscalars)
        for k in jscalars:
            close_rel(tscalars[k], jscalars[k], NET_TOL)
        if i == 0:
            def first_step(context):
                fresh, state, step = port()
                with context(fresh):
                    step(state, batch, rotations=rotations)
                return fresh

            tol = grad_tolerance(first_step, grads_of(mods))
            assert_grads_match(mods, jstate.opt_state[1], tol)
        assert_params_match(mods, jstate.params)
    assert_optimizer_matches(jax_grads, jax_updates)
    return tscalars


@pytest.fixture(scope="module")
def tiny_family():
    sc, fu, ph = jzoo.tiny_sculptor(), jzoo.tiny_fuser(), jzoo.tiny_photographer()
    params = jzoo.init_recon_params(jax.random.PRNGKey(0), sc, fu, ph, batch=1, views=2)
    return (sc, fu, ph), params


@pytest.mark.parametrize("num_microbatches", [1, 2])
def test_recon_train_step_matches_jax(tiny_family, num_microbatches):
    """Two steps of make_recon_train_step (no discriminator, hard smooth-L1
    depth over the top 100 of 256 pixels, mask BCE of the logits, Adam
    (0, 0.99)) on 2 objects x (2 in, 2 out) views; the second step runs
    Adam from its moments."""
    jax_mods, params = tiny_family
    batches = [raw_batch(10), raw_batch(11)]
    keys = [jax.random.PRNGKey(20), jax.random.PRNGKey(21)]
    scalars = run_recon_steps("tiny", params, jax_mods, CONFIG, num_microbatches,
                              batches, keys)
    assert set(scalars) == {"loss/generator/depth", "loss/generator/mask",
                            "loss/generator/total"}


def test_recon_train_step_beta_prior_and_refusals(tiny_family):
    """The mask beta prior term, one step; and the options that are not
    ported raise rather than being dropped."""
    jax_mods, params = tiny_family
    config = dict(CONFIG, g_mask_beta_loss_weight=0.5)
    scalars = run_recon_steps("tiny", params, jax_mods, config, 1, [raw_batch(12)],
                              [jax.random.PRNGKey(22)])
    assert "loss/generator/mask_beta" in scalars
    mods = port_models(params)
    args = (mods["sculptor"], mods["fuser"], mods["photographer"])
    with pytest.raises(NotImplementedError, match="discriminator.*Queue 1"):
        tstep.make_recon_train_step(*args, discriminator=object())
    for option in ("reconstruct_input", "generator_input_depth", "remat"):
        with pytest.raises(NotImplementedError, match=f"{option}.*Queue 1"):
            tstep.make_recon_train_step(*args, config={option: True})
    with pytest.raises(NotImplementedError, match="rmsprop"):
        tstep.make_optimizer("rmsprop")


def test_recon_train_step_draws_orientation_from_generator(tiny_family):
    """Without injected rotations each microbatch draws its own from the
    generator: the same seed repeats the step, the loss is finite."""
    _, params = tiny_family
    batch, _ = raw_batch(13)
    losses = []
    for _ in range(2):
        mods = port_models(params)
        state = tstep.init_train_state(mods, tstep.make_optimizer("adam", 1e-3))
        step = tstep.make_recon_train_step(mods["sculptor"], mods["fuser"],
                                           mods["photographer"], config=CONFIG,
                                           num_microbatches=2)
        _, scalars = step(state, batch, torch.Generator().manual_seed(5))
        losses.append(float(scalars["loss/generator/total"]))
    assert np.isfinite(losses[0]) and losses[0] == losses[1]


CUDNN_FLAGS = ("deterministic", "enabled", "benchmark", "allow_tf32")


@pytest.mark.parametrize("flags", [(False, True, False, True), (True, False, True, False)],
                         ids=["torch_defaults", "all_flipped"])
def test_recon_train_step_selects_deterministic_cudnn_and_restores_flags(tiny_family,
                                                                         flags):
    """Each microbatch's forward and backward run with cuDNN's deterministic
    algorithms selected and its other flags as the caller set them; after
    the step, and after a step that raises, the flags are as the caller
    left them."""
    _, params = tiny_family
    batch, _ = raw_batch(14)
    rotations = [torch.tensor([[1.0, 0.0, 0.0, 0.0]])] * 2
    mods = port_models(params)
    state = tstep.init_train_state(mods, tstep.make_optimizer("sgd", 0.0))
    step = tstep.make_recon_train_step(mods["sculptor"], mods["fuser"], mods["photographer"],
                                       config=CONFIG, num_microbatches=2)
    seen = []
    forward = mods["photographer"].forward

    def spy(*args, **kwargs):
        seen.append(tuple(getattr(torch.backends.cudnn, k) for k in CUDNN_FLAGS))
        return forward(*args, **kwargs)

    prev = {k: getattr(torch.backends.cudnn, k) for k in CUDNN_FLAGS}
    try:
        for k, v in zip(CUDNN_FLAGS, flags):
            setattr(torch.backends.cudnn, k, v)
        mods["photographer"].forward = spy
        _, scalars = step(state, batch, rotations=rotations)
        after = tuple(getattr(torch.backends.cudnn, k) for k in CUDNN_FLAGS)
        mods["photographer"].forward = lambda *a, **kw: 1 / 0
        with pytest.raises(ZeroDivisionError):
            step(state, batch, rotations=rotations)
        after_raise = tuple(getattr(torch.backends.cudnn, k) for k in CUDNN_FLAGS)
    finally:
        for k, v in prev.items():
            setattr(torch.backends.cudnn, k, v)
    assert seen == [(True, *flags[1:])] * 2
    assert np.isfinite(float(scalars["loss/generator/total"]))
    assert after == after_raise == flags


def test_train_step_matches_jax(tiny_family):
    """The plain generator step (make_train_step) on a processed batch, two
    microbatches: loss, loss terms, every gradient and every parameter."""
    (sc, fu, ph), params = tiny_family
    batch, batch_np = raw_batch(14)
    key = jax.random.PRNGKey(4)
    jproc = jutils.process_batch(batch_np, 1.0, CAMERA_DIST, 16, key=key)
    tproc = tutils.process_batch(batch, 1.0, CAMERA_DIST, 16,
                                 rotation=torch.from_numpy(np.array(jquat.random(key, 1))))
    jproc = {"in": jproc["in"], "out_gt": jproc["out_gt"]}
    tproc = {"in": tproc["in"], "out_gt": tproc["out_gt"]}
    config = {"g_depth_recon_loss_type": "hard_smooth_l1", "g_depth_recon_loss_k": 100}
    opt = capture(jstep.make_optimizer("adam", 1e-3))
    jstate, jloss, jaux = jstep.make_train_step(sc, fu, ph, opt, config, num_microbatches=2)(
        jstep.init_train_state(params, opt), jproc, key)

    def port_step(context=lambda mods: contextlib.nullcontext()):
        mods = port_models(params)
        state = tstep.init_train_state(mods, tstep.make_optimizer("adam", 1e-3))
        step = tstep.make_train_step(mods["sculptor"], mods["fuser"], mods["photographer"],
                                     config, num_microbatches=2)
        with context(mods):
            return (mods, *step(state, tproc))

    mods, _, tloss, taux = port_step()
    close_rel(tloss, jloss, NET_TOL)
    assert set(taux) == set(jaux) == {"depth", "mask"}
    for k in jaux:
        close_rel(taux[k], jaux[k], NET_TOL)
    tol = grad_tolerance(lambda context: port_step(context)[0], grads_of(mods))
    assert_grads_match(mods, jstate.opt_state[1], tol)
    assert_params_match(mods, jstate.params)
    assert_optimizer_matches([jstate.opt_state[1]], [jstate.opt_state[2]])


@pytest.mark.slow
def test_recon_train_step_at_flagship_width_matches_jax():
    """One step of the flagship family (256^2 input, 256-channel 16^3
    latent) against JAX on the CPU: 1 object x (2 in, 2 out) views of
    640x480, the published loss settings."""
    sc, fu, ph = jzoo.flagship_sculptor(), jzoo.flagship_fuser(), jzoo.flagship_photographer()
    params = jzoo.init_recon_params(jax.random.PRNGKey(1), sc, fu, ph, batch=1, views=2)
    config = {"camera_dist": tutils.optimal_camera_dist(615.0, 480, 3 ** 0.5 / 2, 0.1),
              "random_orientation": True}
    run_recon_steps("flagship", params, (sc, fu, ph), config, 1,
                    [raw_batch(15, b=1, width=640, height=480)],
                    [jax.random.PRNGKey(23)])
