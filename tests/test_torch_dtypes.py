"""The bf16 compute policy (``latentfusion_tpu_torch/dtypes.py``, the JAX
package's ``dtypes.py``) held against the JAX package's on the CPU.

Under bf16 the equalized convolutions compute in bf16 with fp32
parameters and K1-fwd reads its volume and stores its samples in bf16, in
both packages; K2 takes bf16 activations, computes in fp32 and stores
bf16; the rest follows the activations' dtype.

One op at a time, the port's bf16 output is held to JAX's bit for bit on
at least ``BITS_EQUAL`` of its elements and within one bf16 ulp of its
largest value on the rest: an equalized conv against JAX's eager conv (under ``jax.jit`` XLA may
skip the roundings between fused ops), K2-fwd against JAX's Pallas K2 in
interpret mode, and K1-fwd against JAX's fp32 sampler of the bf16-rounded
volume, rounded once. JAX's own bf16 K1 also rounds its tap weights to
bf16 (they are MXU operands); the port's kernels keep them in fp32, so
K1-fwd is held to JAX's bf16 sampler only within ``SPREAD_FACTOR`` times
JAX's own bf16-vs-fp32 spread. The same op computed in fp32 and rounded at
the end fails the bit bound; each case asserts that too.

A whole network is held on the demo family with the learned weights of
``artifacts/encoder_distill/encoder_distill.npz``, where JAX's bf16
forward parts from its fp32 forward by 0.06-0.7 % (mean absolute
difference over mean magnitude, per output). The port's bf16 forward is
within ``SPREAD_FACTOR`` times that spread of JAX's bf16 forward, is at
least half that spread away from its own fp32 forward (a port that ran in
fp32 and cast its latent at the end is a fifth of it away), and its latent is nearer
JAX's bf16 latent than JAX's fp32 one. One ``make_recon_train_step`` loss
on the same weights: each term nearer JAX's bf16 loss than JAX's fp32
loss, within ``BF16_MATCH_TOL`` of JAX's bf16 loss (relative to the total;
measured 2.7e-4), and every bf16-vs-fp32 spread within ``BF16_LOSS_TOL``,
the bound chip_smoke.py phase 13 holds the recipe's fp32 and bf16 losses
to.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentfusion_tpu import dtypes as jdtypes
from latentfusion_tpu import transforms as jtransforms
from latentfusion_tpu import zoo as jzoo
from latentfusion_tpu.camera import Camera as JCamera
from latentfusion_tpu.modules.equalized import EqualizedConv as JEqualizedConv
from latentfusion_tpu.ops.pallas_lrelu_pnorm import lrelu_pixel_norm_pallas
from latentfusion_tpu.recon import models as jmodels
from latentfusion_tpu.recon import utils as jutils
from latentfusion_tpu.train import step as jstep

from latentfusion_tpu_torch import dtypes as tdtypes
from latentfusion_tpu_torch import transforms
from latentfusion_tpu_torch.camera import Camera
from latentfusion_tpu_torch.modules.equalized import EqualizedConv
from latentfusion_tpu_torch.ops import lrelu_pnorm
from latentfusion_tpu_torch.recon import models as tmodels
from latentfusion_tpu_torch.recon import utils as tutils
from latentfusion_tpu_torch.train import step as tstep

from test_torch_slice import random_extrinsics
from test_torch_train import CONFIG, port_models, raw_batch

DISTILL = Path(__file__).resolve().parents[1] / "artifacts" / "encoder_distill"
BF16_LOSS_TOL = 1e-2
BF16_MATCH_TOL = 1e-3
SPREAD_FACTOR = 1.5
BITS_EQUAL = 0.99
NET_TOL = 5e-4
BF16_ULP = 2.0 ** -7
OUTPUTS = ("depth", "mask", "depth_logits", "mask_logits")
# The outputs that read the network's bf16 roundings directly (depth and
# mask pass through fp32 squashing that shrinks them).
BF16_OUTPUTS = ("latent", "depth_logits", "mask_logits")
DEMO_CONFIG = dict(CONFIG, camera_dist=jzoo.DEMO_CAMERA_DIST, random_orientation=False,
                   generator_input_depth=True, generator_input_mask=True, depth_noise_std=0.0)


@pytest.fixture(autouse=True)
def fp32_policy():
    """Every test starts and ends with both packages in fp32 (workers share
    processes)."""
    jdtypes.set_compute_dtype("float32")
    tdtypes.set_compute_dtype(torch.float32)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    jdtypes.set_compute_dtype("float32")
    tdtypes.set_compute_dtype(torch.float32)
    torch.set_num_threads(prev)


def policy(name):
    jdtypes.set_compute_dtype(name)
    tdtypes.set_compute_dtype(name)


@pytest.fixture(scope="module")
def demo():
    """The demo family's JAX modules and the learned parameters."""
    sc, fu, ph = jzoo.demo_sculptor(), jzoo.demo_fuser(), jzoo.demo_photographer()
    template = jax.eval_shape(
        lambda k: jzoo.init_recon_params(k, sc, fu, ph, batch=1, views=2),
        jax.random.PRNGKey(0))
    return (sc, fu, ph), jzoo.load_params_npz(DISTILL / "encoder_distill.npz", template)


def rel(a, b) -> float:
    """Mean absolute difference over the mean magnitude of ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).mean()) / max(float(np.abs(b).mean()), 1e-30)


def jax_forward(mods, params, batch_np):
    sc, fu, ph = mods
    proc = jutils.process_batch(batch_np, 1.0, jzoo.DEMO_CAMERA_DIST, jzoo.DEMO_INPUT_SIZE,
                                random_orientation=False)
    z, _ = jmodels.encode(sc, params["sculptor"], fu, params["fuser"], proc["in"]["camera"],
                          proc["in"]["image"], proc["in"]["depth"], proc["in"]["mask"])
    y, _, _ = jmodels.decode(ph, params["photographer"], z, proc["out_gt"]["camera"],
                             interpret=True)
    return {"latent": z.astype(jnp.float32), **{k: y[k].astype(jnp.float32) for k in OUTPUTS}}


def port_forward(params, batch):
    mods = port_models(params, "demo")
    proc = tutils.process_batch(batch, 1.0, jzoo.DEMO_CAMERA_DIST, jzoo.DEMO_INPUT_SIZE,
                                random_orientation=False)
    with torch.no_grad():
        z = tmodels.encode(mods["sculptor"], mods["fuser"], proc["in"]["camera"],
                           proc["in"]["image"], proc["in"]["depth"], proc["in"]["mask"])
        y, _, _ = tmodels.decode(mods["photographer"], z, proc["out_gt"]["camera"])
    return {"latent": z, **{k: y[k] for k in OUTPUTS}}


def test_bf16_forward_within_jax_spread(demo):
    """Sculptor encode + GRU fold + Photographer decode of 1 object x (4 in,
    2 out) views, demo family, learned weights."""
    mods, params = demo
    batch, batch_np = raw_batch(10, b=1, v_in=4, v_out=2)
    out, latent_dtype = {}, {}
    for name in ("float32", "bfloat16"):
        policy(name)
        # JAX's forward jitted, as its training step runs it (a new function
        # each time, so the policy is read at trace time).
        jax_out = jax.jit(lambda p, b: jax_forward(mods, p, b))(params, batch_np)
        port_out = port_forward(params, batch)
        latent_dtype[name] = port_out["latent"].dtype
        out[name] = ({k: np.asarray(v) for k, v in jax_out.items()},
                     {k: v.float().numpy() for k, v in port_out.items()})
    (j32, t32), (j16, t16) = out["float32"], out["bfloat16"]
    assert latent_dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for k in ("latent", *OUTPUTS):
        assert rel(t32[k], j32[k]) <= NET_TOL, k
        spread = rel(j16[k], j32[k])
        assert 0 < spread < 0.01, (k, spread)
        assert rel(t16[k], j16[k]) <= SPREAD_FACTOR * spread, (k, spread)
    for k in BF16_OUTPUTS:
        assert rel(t16[k], t32[k]) >= 0.5 * rel(j16[k], j32[k]), k
    assert rel(t16["latent"], j16["latent"]) <= 0.75 * rel(t16["latent"], j32["latent"])


@pytest.mark.parametrize("seed", [10])
def test_bf16_train_step_loss_matches_jax(demo, seed):
    """One make_recon_train_step (hard smooth-L1 depth, mask BCE) of 1
    object x (4 in, 2 out) views under bf16 in both packages, demo family,
    learned weights, no random draws (no orientation, no depth noise)."""
    (sc, fu, ph), params = demo
    batch, batch_np = raw_batch(seed, b=1, v_in=4, v_out=2)
    key = jax.random.PRNGKey(seed + 10)
    losses = {}
    for name in ("float32", "bfloat16"):
        policy(name)
        opt = jstep.make_optimizer("adam", 1e-3)
        jax_step = jstep.make_recon_train_step(sc, fu, ph, opt, config=DEMO_CONFIG)
        _, jscalars = jax_step(jstep.init_gan_train_state(params, opt), batch_np, key)
        mods = port_models(params, "demo")
        state = tstep.init_train_state(mods, tstep.make_optimizer("sgd", 0.0))
        step = tstep.make_recon_train_step(mods["sculptor"], mods["fuser"],
                                           mods["photographer"], config=DEMO_CONFIG)
        _, tscalars = step(state, batch, torch.Generator().manual_seed(seed))
        losses[name] = ({k: float(v) for k, v in jscalars.items()},
                        {k: float(v) for k, v in tscalars.items()})
    (j32, t32), (j16, t16) = losses["float32"], losses["bfloat16"]
    total = j32["loss/generator/total"]
    assert set(t16) == set(j16)
    for k in j16:
        assert abs(t32[k] - j32[k]) <= NET_TOL * total, k
        assert np.isfinite(t16[k])
        assert abs(t16[k] - j16[k]) <= BF16_MATCH_TOL * total, k
        assert abs(t16[k] - j16[k]) <= 0.75 * abs(t16[k] - j32[k]), k
        assert abs(j16[k] - j32[k]) <= BF16_LOSS_TOL * total, k
        assert abs(t16[k] - t32[k]) <= BF16_LOSS_TOL * total, k


def _conv_case(ndim, cin, cout, k, shape):
    def run(rng):
        w = rng.randn(cout, cin, *(k,) * ndim).astype(np.float32)
        b = (0.3 * rng.randn(cout)).astype(np.float32)
        x = rng.randn(*shape).astype(np.float32)
        jconv = JEqualizedConv(cin, cout, k, ndim=ndim, padding=k // 2)
        variables = {"params": {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}}
        conv = EqualizedConv(cin, cout, k, ndim=ndim, padding=k // 2)
        with torch.no_grad():
            conv.module.weight.copy_(torch.from_numpy(w))
            conv.bias.copy_(torch.from_numpy(b))

        def port(dtype):
            tdtypes.set_compute_dtype(dtype)
            with torch.no_grad():
                return conv(torch.from_numpy(x))

        # Eager: each op rounds to bf16 as it is written.
        jax_bf16 = jconv.apply(variables, jnp.asarray(x))
        return port, np.asarray(jax_bf16.astype(jnp.float32)), None
    return run


def _k2_case(rng):
    x = torch.from_numpy(rng.randn(2, 128, 8, 16).astype(np.float32))
    xb = jnp.asarray(x.bfloat16().float().numpy()).astype(jnp.bfloat16)
    y = lrelu_pixel_norm_pallas(jnp.moveaxis(xb, 1, -1), 0.2, 1e-8, interpret=True)

    def port(dtype):
        return lrelu_pnorm.lrelu_pixel_norm(x.to(dtype), 0.2, 1e-8)
    return port, np.moveaxis(np.asarray(y.astype(jnp.float32)), -1, 1), None


def _k1_case(fn):
    def run(rng):
        vol = rng.randn(2, 128, 16, 16, 16).astype(np.float32)
        K = np.tile(np.array([[300, 0, 64], [0, 300, 64], [0, 0, 1]], np.float32)[None],
                    (2, 1, 1))
        ext = random_extrinsics(rng, 2, jzoo.DEMO_CAMERA_DIST, jitter=0.03)
        jcam = JCamera(K, ext, width=128, height=128)
        cam = Camera(K, ext, width=128, height=128, device="cpu")
        spread = {}
        for name in ("bfloat16", "float32"):
            jdtypes.set_compute_dtype(name)
            spread[name] = np.asarray(getattr(jtransforms, fn)(jnp.asarray(vol), jcam),
                                      np.float32)
        # K1's stores: JAX's fp32 sampler on the bf16 volume, rounded once.
        rounded = torch.from_numpy(vol).bfloat16().float().numpy()
        ref = torch.from_numpy(np.array(getattr(jtransforms, fn)(
            jnp.asarray(rounded), jcam))).bfloat16().float().numpy()

        def port(dtype):
            tdtypes.set_compute_dtype(dtype)
            return getattr(transforms, fn)(torch.from_numpy(vol), cam)
        return port, ref, spread
    return run


OP_CASES = {
    "conv2d 3x3": _conv_case(2, 64, 96, 3, (2, 64, 32, 32)),
    "conv3d 3x3": _conv_case(3, 128, 128, 3, (2, 128, 16, 16, 16)),
    "conv2d 1x1": _conv_case(2, 5, 32, 1, (2, 5, 64, 64)),
    "K2-fwd": _k2_case,
    "K1-fwd camera_to_object": _k1_case("camera_to_object"),
    "K1-fwd object_to_camera": _k1_case("object_to_camera"),
}


@pytest.mark.parametrize("op", list(OP_CASES))
def test_bf16_ops_match_jax_bits(op):
    """The port's op under bf16 gives JAX's bf16 bits on at least
    BITS_EQUAL of its elements and is within one bf16 ulp of the largest
    value on the rest; the op in fp32 rounded at the end does not."""
    policy("bfloat16")
    port, ref, spread = OP_CASES[op](np.random.RandomState(0))
    y16 = port(torch.bfloat16)
    assert y16.dtype == torch.bfloat16
    y16 = y16.float().numpy()
    y32 = port(torch.float32)
    assert y32.dtype == torch.float32
    cast = y32.bfloat16().float().numpy()
    assert np.mean(y16 == ref) >= BITS_EQUAL, np.mean(y16 == ref)
    assert np.abs(y16 - ref).max() <= BF16_ULP * np.abs(ref).max(), op
    assert np.mean(cast == ref) < BITS_EQUAL, np.mean(cast == ref)
    if spread is not None:
        jax_spread = rel(spread["bfloat16"], spread["float32"])
        assert rel(y16, spread["bfloat16"]) <= SPREAD_FACTOR * jax_spread


def test_k1_and_equalized_outputs_follow_the_policy():
    """K1-fwd (through the volume transforms) and an equalized conv give
    bf16 under bf16, fp32 otherwise; parameters stay fp32; a conv's bf16
    output is the fp32 conv of the bf16-rounded input and weight, rounded
    (the He constant rounded first, as JAX's)."""
    g = torch.Generator().manual_seed(0)
    vol = torch.randn(1, 3, 4, 4, 4, generator=g)
    cam = Camera(torch.tensor([[[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]]]),
                 torch.tensor([[[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 1.5], [0, 0, 0, 1]]]),
                 width=16, height=16, device="cpu")
    conv = EqualizedConv(3, 5, 3, ndim=2, padding=1)
    conv.reset_parameters(g)
    with torch.no_grad():
        conv.bias.normal_(generator=g)
    x = torch.randn(2, 3, 6, 6, generator=g)
    assert transforms.object_to_camera(vol, cam).dtype == torch.float32
    y32 = conv(x)
    assert y32.dtype == torch.float32
    policy("bfloat16")
    sampled = transforms.object_to_camera(vol, cam)
    assert sampled.dtype == torch.bfloat16
    with transforms.volume_sample_backend("torch"):
        assert transforms.object_to_camera(vol, cam).dtype == torch.bfloat16
    y16 = conv(x)
    assert y16.dtype == torch.bfloat16 and conv.module.weight.dtype == torch.float32
    xb, wb = x.bfloat16().float(), conv.module.weight.bfloat16().float()
    ref = torch.nn.functional.conv2d(xb, wb, padding=1).bfloat16()
    ref = (ref * torch.tensor(conv.scale, dtype=torch.bfloat16)) + conv.bias.bfloat16()[:, None, None]
    torch.testing.assert_close(y16, ref, rtol=0, atol=0)
    policy("float32")
    torch.testing.assert_close(conv(x), y32, rtol=0, atol=0)
    with pytest.raises(ValueError):
        tdtypes.set_compute_dtype(torch.float16)
