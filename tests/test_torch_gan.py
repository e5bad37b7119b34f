"""The port's GAN training step and its options held against the JAX
package on the CPU: the discriminator (minibatch statistics, instance norm,
the multi-scale mask resize), the LSGAN losses, optax's RMSprop, and
``make_recon_train_step`` with the multi-scale discriminator,
``reconstruct_input``, ``generator_input_depth``, ``predict_color`` and
``remat`` on the tiny family from the same weights and batches.

Tolerances as in ``test_torch_train.py``: 1e-5 for ops, 5e-4 for networks,
losses and parameters (relative to their largest magnitude), gradients at
5e-4 or 3x the port's own noise floor. The two frameworks' random streams
differ, so each microbatch's random orientation is JAX's (``rotations``)
and its depth noise and instance noise are JAX's draws, fed to the port's
``_normal`` in the order the JAX step draws them.

The conv biases of the discriminator's blocks with instance norm do not
reach its output (``cancelled_parameters``): their gradient is rounding
noise in both packages (below 3e-7 against 0.3-4 for the other biases), so
they are held to be noise, and after Adam's sign-like step to have moved by
at most the learning rate, and are left out of the gradient's relative
comparison and of its noise floor.
"""
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from latentfusion_tpu import losses as jlosses
from latentfusion_tpu import pggan as jpggan
from latentfusion_tpu import zoo as jzoo
from latentfusion_tpu.recon import fusion as jfusion
from latentfusion_tpu.recon import models as jmodels
from latentfusion_tpu.train import step as jstep

from latentfusion_tpu_torch import losses as tlosses
from latentfusion_tpu_torch import pggan as tpggan
from latentfusion_tpu_torch.recon import fusion as tfusion
from latentfusion_tpu_torch.recon import models as tmodels
from latentfusion_tpu_torch.train import step as tstep

from test_torch_train import (CAMERA_DIST, CONFIG, FLOOR_EPS, FLOOR_FACTOR, NET_TOL, OPS_TOL,
                              assert_grads_match, assert_params_match, capture, close_rel,
                              grad_tolerance, grads_of, keyed, orientations, raw_batch,
                              rel_errs)
from latentfusion_tpu_torch import testing as ttesting

D_CONFIG = (4, 8)  # two blocks: 16^2 -> 8^2 -> 7^2 -> a 6^2 patch map
D_SCALES = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tiny_kwargs(input_depth=False, predict_color=False):
    """The tiny family's Sculptor and Photographer arguments."""
    sc = dict(in_size=16, image_config=((4, "D", 8), (8,)), camera_config=(4, 4),
              object_config=(4, 4), projection_type="factor", cube_size=1.0,
              input_depth=input_depth)
    ph = dict(in_size=8, image_config=((4, "D", 8), (8, "U", 8, "U", 4)),
              camera_config=(4, 4), object_config=None, projection_type="factor",
              predict_color=predict_color, predict_depth=True, predict_mask=True,
              cube_size=1.0)
    return sc, ph


def init_blend(fuser, key, size=8, channels=4):
    """A Blend fuser's parameters: its init needs the camera intermediates
    that ``init_recon_params`` does not pass."""
    z = jnp.zeros((1, 2, channels, size, size, size))
    return fuser.init(key, z, [z], [], jzoo.canonical_camera(2, 16))


def make_pair(fuser_type="pool:max", input_depth=False, predict_color=False,
              d_channels=None, block_config=((4, "D", 4), (4, "U", 4)), seed=0):
    """JAX modules with initialised parameters, and a factory of the port's
    modules (CPU) carrying them: ({name: module}, discriminator or None)."""
    sc_kw, ph_kw = tiny_kwargs(input_depth, predict_color)
    jsc, jph = jmodels.Sculptor(**sc_kw), jmodels.Photographer(**ph_kw)
    jfu = jfusion.get_fuser(fuser_type, 4, 1.0, block_config=block_config)
    params = jzoo.init_recon_params(jax.random.PRNGKey(seed), jsc,
                                    jfusion.PoolFuser() if fuser_type == "blend" else jfu,
                                    jph, batch=1, views=2)
    if fuser_type == "blend":
        params["fuser"] = init_blend(jfu, jax.random.PRNGKey(seed + 2))
    jd = d_params = None
    if d_channels:
        jd = jpggan.MultiScaleDiscriminator(d_channels, D_CONFIG, D_SCALES)
        d_params = jd.init(jax.random.PRNGKey(seed + 1), jnp.zeros((2, d_channels, 16, 16)))

    def port():
        mods = {"sculptor": tmodels.Sculptor(**sc_kw),
                "fuser": tfusion.get_fuser(fuser_type, 4, 1.0, block_config=block_config,
                                           device="cpu"),
                "photographer": tmodels.Photographer(**ph_kw)}
        for name, module in mods.items():
            module.load_state_dict({k: torch.from_numpy(v)
                                    for k, v in keyed(params[name]).items()})
        disc = None
        if d_channels:
            disc = tpggan.MultiScaleDiscriminator(d_channels, D_CONFIG, D_SCALES, device="cpu")
            disc.load_state_dict({k: torch.from_numpy(v) for k, v in keyed(d_params).items()})
        return mods, disc

    return (jsc, jfu, jph, jd), params, d_params, port


def jax_noise_keys(key, num_microbatches, depth, disc):
    """The keys of the JAX step's normal draws, in the order it draws them:
    per microbatch the depth noise, then the real and the fake images'
    instance noise."""
    keys = list(jax.random.split(key, num_microbatches)) if num_microbatches > 1 else [key]
    out = []
    for k in keys:
        if depth:
            k, sub = jax.random.split(k)
            out.append(sub)
        if disc:
            k, k1, k2 = jax.random.split(k, 3)
            out += [k1, k2]
    return out


def jax_draws(keys):
    """Patch the port's ``_normal`` to return JAX's draws from ``keys`` in
    order, of the shape asked for."""
    it = iter(keys)

    def normal(shape, generator, device):
        return torch.from_numpy(np.array(jax.random.normal(next(it), tuple(shape))))

    return mock.patch.object(tstep, "_normal", normal)


def assert_jax_process_batch_well_posed(batch_np, key, num_microbatches):
    """JAX's jitted ``process_batch`` (the step's) agrees with its eager one
    on each microbatch. Where a zoomed crop corner lands within an ulp of
    an integer the two truncate it differently and part by whole pixels
    (ROADMAP Queue 3); the port follows the eager one to the last bit
    (``test_torch_train.py``), so a step is compared only where JAX agrees
    with itself."""
    from latentfusion_tpu.recon import utils as jutils

    keys = list(jax.random.split(key, num_microbatches)) if num_microbatches > 1 else [key]
    size = len(batch_np["in"]["mask"]) // num_microbatches
    for i, k in enumerate(keys):
        mb = jax.tree_util.tree_map(lambda x: x[i * size:(i + 1) * size], batch_np)
        eager = jutils.process_batch(mb, 1.0, CAMERA_DIST, 16, key=k)
        jitted = jax.jit(lambda b, kk: jutils.process_batch(b, 1.0, CAMERA_DIST, 16, key=kk))(mb, k)
        for group in eager:
            err = float(np.abs(np.asarray(jitted[group]["mask"])
                               - np.asarray(eager[group]["mask"])).max())
            assert err == 0.0, (group, i)


def run_gan_steps(pair, config, num_microbatches, batches, keys, optimizer="adam",
                  noise_weight=1.0):
    """The JAX recon step and the port's from the same parameters over
    ``batches``: every scalar of each step, every generator and
    discriminator gradient of step 1 (at 5e-4 or 3x the port's noise
    floor), every parameter after each step. Returns the last scalars."""
    (jsc, jfu, jph, jd), params, d_params, port = pair
    opt = capture(jstep.make_optimizer(optimizer, 1e-3))
    d_opt = capture(jstep.make_optimizer("adam", 1e-3)) if jd is not None else None
    jax_step = jstep.make_recon_train_step(jsc, jfu, jph, opt, jd, d_opt, config=config,
                                           num_microbatches=num_microbatches)
    jstate = jstep.init_gan_train_state(params, opt, d_params, d_opt)
    depth, disc = config.get("generator_input_depth", False), jd is not None

    def fresh():
        mods, d = port()
        state = tstep.init_gan_train_state(
            mods, tstep.make_optimizer(optimizer, 1e-3), d,
            tstep.make_optimizer("adam", 1e-3) if d is not None else None, device="cpu")
        step = tstep.make_recon_train_step(mods["sculptor"], mods["fuser"],
                                           mods["photographer"], d, config=config,
                                           num_microbatches=num_microbatches)
        return mods, d, state, step

    mods, d, tstate, port_step = fresh()
    gen = torch.Generator().manual_seed(0)
    for i, ((batch, batch_np), key) in enumerate(zip(batches, keys)):
        assert_jax_process_batch_well_posed(batch_np, key, num_microbatches)
        jstate, jscalars = jax_step(jstate, batch_np, key, noise_weight)
        rotations = [torch.from_numpy(np.array(q))
                     for q in orientations(key, num_microbatches)]
        noise_keys = jax_noise_keys(key, num_microbatches, depth, disc)

        def run(step, state):
            with jax_draws(noise_keys):
                return step(state, batch, gen, rotations, noise_weight)

        tstate, tscalars = run(port_step, tstate)
        assert tstate.step == i + 1 and set(tscalars) == set(jscalars)
        for k in jscalars:
            close_rel(tscalars[k], jscalars[k], NET_TOL)
        if i == 0:
            ref_g = grads_of(mods)
            ref_d = grads_of({"discriminator": d}) if d is not None else {}
            cancelled = ({f"discriminator.{k}" for k in d.cancelled_parameters()}
                         if d is not None else set())
            floors = []
            for eps in FLOOR_EPS:
                for draw in range(3):
                    fmods, fd, fstate, fstep = fresh()
                    nets = nn.ModuleList([*fmods.values(), *([fd] if fd is not None else [])])
                    with ttesting.convs_perturbed(nets, eps, draw):
                        run(fstep, fstate)
                    moved = rel_errs(grads_of(fmods), ref_g)
                    if fd is not None:
                        moved.update(rel_errs(grads_of({"discriminator": fd}),
                                              {k: v for k, v in ref_d.items()
                                               if k not in cancelled}))
                    floors.append(max(moved.values()))
            tol = max(NET_TOL, FLOOR_FACTOR * max(floors))
            theirs = keyed(jstate.opt_state[1])
            if d is not None:
                theirs.update({f"discriminator.{k}": v
                               for k, v in keyed(jstate.d_opt_state[1]).items()})
            ours = {**ref_g, **ref_d}
            assert set(ours) == set(theirs)
            errs = rel_errs(ours, {k: v for k, v in theirs.items() if k not in cancelled})
            assert max(errs.values()) <= tol, (tol, sorted(errs.items(), key=lambda kv: -kv[1])[:3])
            largest = max((float(np.abs(v).max()) for k, v in ref_d.items()), default=0.0)
            for k in cancelled:
                assert max(np.abs(ours[k]).max(), np.abs(theirs[k]).max()) <= 1e-5 * largest, k
        ref = keyed(jstate.params)
        for name, module in mods.items():
            for pname, p in module.named_parameters():
                close_rel(p.detach(), ref[f"{name}.{pname}"], NET_TOL)
        if d is not None:
            ref, start = keyed(jstate.d_params), keyed(d_params)
            for pname, p in d.named_parameters():
                if pname in d.cancelled_parameters():
                    # Rounding noise moves it by up to the learning rate a step.
                    assert float((p.detach() - torch.from_numpy(start[pname])).abs().max()) \
                        <= 1e-3 * (i + 1) * (1 + 1e-3), pname
                else:
                    close_rel(p.detach(), ref[pname], NET_TOL)
    return tscalars


# ------------------------------------------------------------ discriminator
def test_minibatch_stats_and_instance_norm_match_jax(rng):
    x = rng.randn(3, 4, 5, 6).astype(np.float32) * 2 + 1
    close_rel(tpggan.minibatch_mean_variance(torch.from_numpy(x)),
              jpggan.discriminator.minibatch_mean_variance(x), OPS_TOL)
    close_rel(tpggan.instance_norm_2d(torch.from_numpy(x)),
              jpggan.discriminator.instance_norm_2d(x), OPS_TOL)


@pytest.mark.parametrize("mask_dims", [None, 3, 4])
def test_multiscale_discriminator_matches_jax(rng, mask_dims):
    """Three scales of a (4, 8) stack on 33x31 inputs (odd sizes: the
    bilinear halving and the nearest mask halving floor them)."""
    x = rng.randn(3, 5, 33, 31).astype(np.float32)
    mask = None if mask_dims is None else (rng.rand(3, 33, 31) > 0.4).astype(np.float32)
    if mask_dims == 4:
        mask = mask[:, None]
    jd = jpggan.MultiScaleDiscriminator(5, D_CONFIG, 3)
    params = jd.init(jax.random.PRNGKey(3), jnp.asarray(x))
    td = tpggan.MultiScaleDiscriminator(5, D_CONFIG, 3, device="cpu")
    td.load_state_dict({k: torch.from_numpy(v) for k, v in keyed(params).items()})
    ys_j = jd.apply(params, jnp.asarray(x), None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        ys_t = td(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    assert len(ys_t) == 3
    for y_t, y_j in zip(ys_t, ys_j):
        close_rel(y_t, y_j, NET_TOL)


def test_discriminator_weights_from_generator_and_device():
    g = torch.Generator().manual_seed(1)
    a = tpggan.MultiScaleDiscriminator(3, D_CONFIG, 2, device="cpu", generator=g)
    b = tpggan.MultiScaleDiscriminator(3, D_CONFIG, 2, device="cpu",
                                       generator=torch.Generator().manual_seed(1))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    assert float(a.discriminators[1].blocks[0].conv.module.weight.detach().std()) > 0.5


def test_leaky_relu_slope_at_zero_matches_jax(rng):
    """A masked-out pixel through a zero bias sits exactly at 0, where
    ``jax.nn.leaky_relu``'s derivative is 1 (``F.leaky_relu``'s is the
    slope): an InputBlock's and a discriminator block's gradients on inputs
    half of zeros, zero biases."""
    from latentfusion_tpu.modules import blocks as jblocks
    from latentfusion_tpu_torch.modules import blocks as tblocks

    x = rng.randn(2, 3, 8, 8).astype(np.float32)
    x[:, :, :4] = 0.0
    for jm, tm in ((jblocks.InputBlock(3, 4), tblocks.InputBlock(3, 4)),
                   (jpggan.discriminator.DiscriminatorBlock(3, 4, padding=1),
                    tpggan.DiscriminatorBlock(3, 4, padding=1))):
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
        r = rng.randn(*jm.apply(params, jnp.asarray(x)).shape).astype(np.float32)
        want = keyed(jax.grad(lambda p: jnp.sum(jm.apply(p, jnp.asarray(x)) * r))(params))
        tm.load_state_dict({k: torch.from_numpy(v) for k, v in keyed(params).items()})
        (tm(torch.from_numpy(x)) * torch.from_numpy(r)).sum().backward()
        for name, p in tm.named_parameters():
            close_rel(p.grad, want[name], NET_TOL)


@pytest.mark.parametrize("reduction", ["mean", "sum", None])
def test_lsgan_losses_match_jax(rng, reduction):
    xs = [rng.randn(4, 1, 6, 6).astype(np.float32), rng.randn(4, 1, 2, 2).astype(np.float32)]
    for target in (0, 1):
        close_rel(tlosses.lsgan_loss(torch.from_numpy(xs[0]), target, reduction),
                  jlosses.lsgan_loss(xs[0], target, reduction), OPS_TOL)
        if reduction is not None:
            close_rel(tlosses.multiscale_lsgan_loss([torch.from_numpy(x) for x in xs],
                                                    target, reduction),
                      jlosses.multiscale_lsgan_loss(xs, target, reduction), OPS_TOL)


def test_rmsprop_is_optax_update(rng):
    """Given the same gradients three steps running, the port's RMSprop
    makes optax's updates (decay 0.9, eps inside the square root, second
    moment from 0), which torch's RMSprop does not."""
    import optax

    shape = (5, 7)
    grads = [rng.randn(*shape).astype(np.float32) * s for s in (1.0, 1e-3, 1e-5)]
    p = torch.zeros(shape, requires_grad=True)
    opt = tstep.make_optimizer("rmsprop", 1e-3)([p])
    tx = optax.rmsprop(1e-3)
    state, jp = tx.init(jnp.zeros(shape)), jnp.zeros(shape)
    for g in grads:
        p.grad = torch.from_numpy(g)
        opt.step()
        updates, state = tx.update(jnp.asarray(g), state)
        jp = optax.apply_updates(jp, updates)
        close_rel(p.detach(), jp, OPS_TOL, floor=1e-30)
    torch_rms = torch.zeros(shape, requires_grad=True)
    other = torch.optim.RMSprop([torch_rms], lr=1e-3)
    torch_rms.grad = torch.from_numpy(grads[0])
    other.step()
    assert float((torch_rms.detach() - p.detach()).abs().max()) > 1e-3


# --------------------------------------------------------------- GAN step
def d_config(**extra):
    return dict(CONFIG, discriminator_input_color=True, discriminator_input_depth=True,
                discriminator_input_mask=True, g_mask_beta_loss_weight=1.0,
                g_color_recon_loss_k=100, **extra)


def test_gan_step_matches_jax():
    """The training tool's defaults at the tiny width: the pool:max fuser,
    the multi-scale discriminator on color, depth and mask, color, depth and
    mask predicted (color L1 top 100, the mask beta prior), instance noise
    at weight 1, Adam (0, 0.99) for both; two steps, the second from the
    moments of the first (two microbatches:
    ``test_gan_step_input_depth_reconstruct_input_rmsprop_matches_jax``)."""
    pair = make_pair("pool:max", predict_color=True, d_channels=5)
    scalars = run_gan_steps(pair, d_config(), 1, [raw_batch(31), raw_batch(32)],
                            [jax.random.PRNGKey(40), jax.random.PRNGKey(41)])
    assert {"loss/generator/gan", "loss/generator/color", "loss/discriminator/real",
            "loss/discriminator/fake", "loss/discriminator/total"} <= set(scalars)


def test_gan_step_input_depth_reconstruct_input_rmsprop_matches_jax():
    """The GAN step in two microbatches with the noisy depth input, the
    input views reconstructed too, the discriminator on color only, the
    color loss on the predicted mask's crop, RMSprop for the generator and
    Adam for the discriminator."""
    pair = make_pair("gru", input_depth=True, predict_color=True, d_channels=3, seed=2)
    config = dict(CONFIG, discriminator_input_color=True, generator_input_depth=True,
                  reconstruct_input=True, crop_predicted_mask=True, g_color_recon_loss_type="l1")
    scalars = run_gan_steps(pair, config, 2, [raw_batch(33)], [jax.random.PRNGKey(42)],
                            optimizer="rmsprop", noise_weight=0.5)
    assert "loss/generator/color" in scalars


def test_plain_train_step_with_color_matches_jax():
    """``make_train_step`` (the step on a processed batch) with a
    Photographer that predicts color: the color L1 against the masked
    image and every loss term, every gradient (at 5e-4 or 3x the port's
    noise floor) and every parameter after one SGD step."""
    from latentfusion_tpu.recon import utils as jutils
    from latentfusion_tpu.three import quaternion as jquat
    from latentfusion_tpu_torch.recon import utils as tutils

    (jsc, jfu, jph, _), params, _, port = make_pair("gru", predict_color=True, seed=4)
    batch, batch_np = raw_batch(36)
    key = jax.random.PRNGKey(5)
    assert_jax_process_batch_well_posed(batch_np, key, 1)
    jproc = jutils.process_batch(batch_np, 1.0, CAMERA_DIST, 16, key=key)
    tproc = tutils.process_batch(batch, 1.0, CAMERA_DIST, 16,
                                 rotation=torch.from_numpy(np.array(jquat.random(key, 1))))
    config = {"g_color_recon_loss_type": "l1"}
    opt = capture(jstep.make_optimizer("sgd", 1e-3))
    jstate, jloss, jaux = jstep.make_train_step(jsc, jfu, jph, opt, config)(
        jstep.init_train_state(params, opt), {"in": jproc["in"], "out_gt": jproc["out_gt"]}, key)

    def port_step(context=lambda mods: contextlib.nullcontext()):
        mods, _ = port()
        state = tstep.init_train_state(mods, tstep.make_optimizer("sgd", 1e-3))
        step = tstep.make_train_step(mods["sculptor"], mods["fuser"], mods["photographer"],
                                     config)
        with context(mods):
            return (mods, *step(state, {"in": tproc["in"], "out_gt": tproc["out_gt"]}))

    mods, _, tloss, taux = port_step()
    close_rel(tloss, jloss, NET_TOL)
    assert set(taux) == set(jaux) == {"depth", "mask", "color"}
    for k in jaux:
        close_rel(taux[k], jaux[k], NET_TOL)
    tol = grad_tolerance(lambda context: port_step(context)[0], grads_of(mods))
    assert_grads_match(mods, jstate.opt_state[1], tol)
    assert_params_match(mods, jstate.params)


def test_gan_step_without_input_flag_raises_in_both():
    """With the discriminator on and no discriminator input flag (the
    training tool's bare defaults size it to one channel), the JAX step
    concatenates an empty list and fails; the port refuses it when made."""
    (jsc, jfu, jph, jd), params, d_params, port = make_pair("pool:max", d_channels=1)
    opt, d_opt = jstep.make_optimizer("adam"), jstep.make_optimizer("adam")
    step = jstep.make_recon_train_step(jsc, jfu, jph, opt, jd, d_opt, config=dict(CONFIG))
    state = jstep.init_gan_train_state(params, opt, d_params, d_opt)
    with pytest.raises(ValueError, match="at least one array"):
        step(state, raw_batch(33)[1], jax.random.PRNGKey(0), 1.0)
    mods, d = port()
    with pytest.raises(ValueError, match="discriminator reads no input"):
        tstep.make_recon_train_step(mods["sculptor"], mods["fuser"], mods["photographer"], d,
                                    config=dict(CONFIG))


def test_remat_gives_the_same_bits():
    """The GAN step with ``remat`` (encode and decode recomputed in the
    backward) gives the no-remat step's loss and gradient bits, two
    microbatches, the Blend fuser and the noisy depth input."""
    pair = make_pair("blend", input_depth=True, predict_color=True, d_channels=5, seed=3)
    port = pair[3]
    batch, _ = raw_batch(34)
    q = torch.tensor([[0.9, 0.1, -0.3, 0.3]])
    rotations = [q / q.norm()] * 2
    out = []
    for remat in (False, True):
        mods, d = port()
        state = tstep.init_gan_train_state(mods, tstep.make_optimizer("sgd", 0.0), d,
                                           tstep.make_optimizer("sgd", 0.0), device="cpu")
        step = tstep.make_recon_train_step(mods["sculptor"], mods["fuser"], mods["photographer"],
                                           d, config=d_config(generator_input_depth=True,
                                                              remat=remat),
                                           num_microbatches=2)
        _, scalars = step(state, batch, torch.Generator().manual_seed(7), rotations, 1.0)
        out.append((scalars, {**grads_of(mods), **grads_of({"discriminator": d})}))
    (s0, g0), (s1, g1) = out
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert set(g0) == set(g1) and all(np.array_equal(g0[k], g1[k]) for k in g0)
    assert np.isfinite(float(s0["loss/generator/total"]))


def test_gan_state_draws_and_cpu_device():
    """``init_gan_train_state`` puts the modules and the discriminator on
    the device asked for, in train mode, and the step's noise draws come
    from the generator: the same seed repeats the step."""
    _, _, _, port = make_pair("pool:mean", d_channels=2)
    batch, _ = raw_batch(35)
    losses = []
    for _ in range(2):
        mods, d = port()
        state = tstep.init_gan_train_state(mods, tstep.make_optimizer("adam"), d,
                                           tstep.make_optimizer("adam"), device="cpu")
        assert d.training and state.d_optimizer is not None
        step = tstep.make_recon_train_step(mods["sculptor"], mods["fuser"], mods["photographer"],
                                           d, config=dict(CONFIG, discriminator_input_depth=True,
                                                          discriminator_input_mask=True))
        _, scalars = step(state, batch, torch.Generator().manual_seed(3), input_noise_weight=1.0)
        losses.append(float(scalars["loss/discriminator/total"]))
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    mods, d = port()
    step = tstep.make_recon_train_step(mods["sculptor"], mods["fuser"], mods["photographer"], d,
                                       config=dict(CONFIG, discriminator_input_mask=True))
    state = tstep.init_gan_train_state(mods, tstep.make_optimizer("adam"), d,
                                       tstep.make_optimizer("adam"), device="cpu")
    with pytest.raises(ValueError, match="torch.Generator"):
        step(state, batch, rotations=[torch.tensor([[1.0, 0.0, 0.0, 0.0]])])
