"""The port's NN modules held against the JAX package's flax modules with
the same weights, carried across by ``from_jax_params`` (CPU, fp32).

Tolerance: 5e-4 for networks (stacks of convolutions whose sums run in
another order), and exact equality for the block-config parsing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentfusion_tpu import zoo as jzoo
from latentfusion_tpu.modules import blocks as jblocks
from latentfusion_tpu.modules import gru as jgru
from latentfusion_tpu.modules import projection as jproj
from latentfusion_tpu.modules import unet as junet
from latentfusion_tpu.modules.equalized import EqualizedConv as JEqualizedConv
from latentfusion_tpu.recon import fusion as jfusion
from latentfusion_tpu.utils import parse_block_config as j_parse_block_config

from latentfusion_tpu_torch import modules as tmodules
from latentfusion_tpu_torch import zoo as tzoo
from latentfusion_tpu_torch.modules import blocks as tblocks
from latentfusion_tpu_torch.modules import gru as tgru
from latentfusion_tpu_torch.modules import projection as tproj
from latentfusion_tpu_torch.modules import unet as tunet
from latentfusion_tpu_torch.modules.equalized import EqualizedConv as TEqualizedConv
from latentfusion_tpu_torch.recon import fusion as tfusion
from latentfusion_tpu_torch.recon.checkpoint import from_jax_params
from latentfusion_tpu_torch.utils import parse_block_config as t_parse_block_config

NET_TOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def to_state(params):
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return from_jax_params({jax.tree_util.keystr(p): np.asarray(v)
                            for p, v in leaves})


def random_params(params, rng):
    """Replace every leaf (zero biases included) with N(0, 0.5) draws, so
    that biases are exercised too."""
    return jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.randn(*v.shape).astype(np.float32) * 0.5), params)


def check_module(jmod, tmod, inputs, rng, tol=NET_TOL):
    """Init ``jmod``, randomize its weights, load them into ``tmod`` and
    compare the outputs on ``inputs``."""
    params = random_params(jmod.init(jax.random.PRNGKey(0),
                                     *[jnp.asarray(x) for x in inputs]), rng)
    tmod.load_state_dict(to_state(params))
    tmod.eval()
    y_j = jmod.apply(params, *[jnp.asarray(x) for x in inputs])
    with torch.no_grad():
        y_t = tmod(*[torch.from_numpy(x) for x in inputs])
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=tol, rtol=tol)


@pytest.mark.parametrize("s", ["64,D,128,D,196,D,256:512,U,512,U,256",
                               "4,D,8:8", "32,I,64", "none", "", "16,32,64"])
def test_parse_block_config_matches(s):
    assert t_parse_block_config(s) == j_parse_block_config(s)


@pytest.mark.parametrize("kwargs", [
    dict(config=(64, "D", 128, "D", 256), ndim=2, scale_factor=0.5),
    dict(config=(16, 32, "U", 64), ndim=3, scale_factor=2.0, in_views=4),
    dict(config=(512, "U", 512, "U", 256, "I", 128), ndim=2, scale_factor=2.0,
         skip_connections=True, skip_connect_end=2),
])
def test_create_block_defs_matches(kwargs):
    assert tblocks.create_block_defs(**kwargs) == jblocks.create_block_defs(**kwargs)


@pytest.mark.parametrize("ndim,padding", [(2, 1), (3, 0)])
def test_equalized_conv_matches(rng, ndim, padding):
    x = rng.randn(2, 5, *([6] * ndim)).astype(np.float32)
    check_module(JEqualizedConv(5, 7, 3, ndim=ndim, padding=padding),
                 TEqualizedConv(5, 7, 3, ndim=ndim, padding=padding), [x], rng)


@pytest.mark.parametrize("ndim,scale,mode", [(2, 0.5, "bilinear"),
                                             (3, 2.0, "trilinear"),
                                             (3, 2.0, "nearest")])
def test_block_matches(rng, ndim, scale, mode):
    x = rng.randn(2, 6, *([4] * ndim)).astype(np.float32)
    kw = dict(in_channels=6, out_channels=196 if ndim == 2 else 8, ndim=ndim,
              scale_factor=scale, scale_mode=mode)
    check_module(jblocks.Block(**kw), tblocks.Block(**kw), [x], rng)


def test_lrelu_pixel_norm_backends_agree(rng):
    x = torch.from_numpy(rng.randn(2, 196, 3, 3).astype(np.float32))
    with tmodules.lrelu_pnorm_backend("torch"):
        y_torch = tmodules.lrelu_pixel_norm(x, 0.2)
    np.testing.assert_array_equal(tmodules.lrelu_pixel_norm(x, 0.2).numpy(),
                                  y_torch.numpy())
    with pytest.raises(ValueError):
        tmodules.set_lrelu_pnorm_backend("xla")


@pytest.mark.parametrize("in_channels,out_channels", [(3, None), (None, 2),
                                                      (4, (3, 1, 1))])
def test_unet_matches(rng, in_channels, out_channels):
    """Input block, skip concatenations and heads; with heads, the last
    resize runs below them (the deferred final scale)."""
    config = ((4, "D", 8, "D", 8), (8, "U", 8, "U", 4))
    c = in_channels or 4
    x = rng.randn(2, c, 16, 16).astype(np.float32)
    check_module(junet.UNet2d(in_channels, out_channels, config),
                 tunet.BaseUNet(in_channels, out_channels, config), [x], rng)


def test_unet_skip_final_scale(rng):
    config = ((4, "D", 8), (8, "U", 8, "U", 4))
    x = rng.randn(2, 4, 8, 8).astype(np.float32)
    jm = junet.UNet2d(None, None, config)
    params = random_params(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    tm = tunet.BaseUNet(None, None, config)
    tm.load_state_dict(to_state(params))
    y_j = jm.apply(params, jnp.asarray(x), skip_final_scale=True)
    with torch.no_grad():
        y_t = tm(torch.from_numpy(x), skip_final_scale=True)
    assert tm.final_scale == (2.0, "bilinear")
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=NET_TOL, rtol=NET_TOL)


@pytest.mark.parametrize("name", ["TileProjection2d3d", "FactorProjection2d3d"])
def test_projection_2d3d_matches(rng, name):
    x = rng.randn(2, 6, 4, 4).astype(np.float32)
    check_module(getattr(jproj, name)(6, 3, 4), getattr(tproj, name)(6, 3, 4),
                 [x], rng)


def test_projection_3d2d_matches(rng):
    x = rng.randn(2, 3, 4, 5, 5).astype(np.float32)
    check_module(jproj.FactorProjection3d2d(3, 6, 4),
                 tproj.FactorProjection3d2d(3, 6, 4), [x], rng)


def test_conv_gru_cell_matches(rng):
    x = rng.randn(2, 7, 4, 4, 4).astype(np.float32)
    h = rng.randn(2, 4, 4, 4, 4).astype(np.float32)
    check_module(jgru.ConvGRUCell(7, 4), tgru.ConvGRUCell(7, 4), [x, h], rng)


def test_gru_fuser_matches(rng):
    z = rng.randn(1, 3, 4, 4, 4, 4).astype(np.float32)
    jf = jfusion.GRUFuser(in_channels=4)
    params = random_params(jf.init(jax.random.PRNGKey(0), jnp.asarray(z), [], [],
                                   None), rng)
    tf = tfusion.GRUFuser(in_channels=4)
    tf.load_state_dict(to_state(params))
    y_j, _ = jf.apply(params, jnp.asarray(z), [], [], None)
    with torch.no_grad():
        y_t, extra = tf(torch.from_numpy(z), [], [], None)
    assert extra == {}
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=NET_TOL, rtol=NET_TOL)


@pytest.mark.parametrize("family", ["tiny", "demo"])
def test_zoo_state_dict_matches_jax_params(family):
    """A zoo family's port modules have exactly the parameters (names and
    shapes) of the JAX family, read from its traced init."""
    sc, fu, ph = (getattr(jzoo, f"{family}_{part}")()
                  for part in ("sculptor", "fuser", "photographer"))
    shapes = jax.eval_shape(lambda k: jzoo.init_recon_params(k, sc, fu, ph),
                            jax.random.PRNGKey(0))
    for part in ("sculptor", "fuser", "photographer"):
        expected = {k: tuple(v.shape) for k, v in to_state(
            jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes[part])).items()}
        module = getattr(tzoo, f"{family}_{part}")(device="cpu")
        assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == expected
