"""The port's fusers and the modules they use held against the JAX package
on the CPU: ``pool_tensor``, every fuser type of ``get_fuser`` (Pool with
each pool type, Concat, Blend, GRU, LSTM), ``ConvLSTMCell``, ``UNet3d``,
``PreActivationBasicBlock``, and the build of a latent object through
``LatentFusionModel.from_checkpoint`` with each fuser. Also the Sculptor's
camera intermediates: computed only for a fuser that reads them, the
latent the same bits either way.

Tolerances: 1e-5 for ops (pooling), 5e-4 for networks relative to their
largest magnitude.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentfusion_tpu import three as jthree
from latentfusion_tpu import zoo as jzoo
from latentfusion_tpu.camera import Camera as JCamera
from latentfusion_tpu.modules import blocks as jblocks
from latentfusion_tpu.modules import lstm as jlstm
from latentfusion_tpu.modules import unet as junet
from latentfusion_tpu.recon import fusion as jfusion
from latentfusion_tpu.recon.checkpoint import export_torch_state_dict
from latentfusion_tpu.recon.inference import LatentFusionModel as JModel

from latentfusion_tpu_torch import transforms
from latentfusion_tpu_torch.augment import gan_normalize
from latentfusion_tpu_torch.camera import Camera as TCamera
from latentfusion_tpu_torch.modules import blocks as tblocks
from latentfusion_tpu_torch.modules import lstm as tlstm
from latentfusion_tpu_torch.modules import unet as tunet
from latentfusion_tpu_torch.recon import fusion as tfusion
from latentfusion_tpu_torch.recon import models as tmodels
from latentfusion_tpu_torch.recon.inference import LatentFusionModel as TModel

from test_torch_modules import check_module, random_params
from test_torch_slice import close_rel, tiny_views, to_state

OPS_TOL = 1e-5
NET_TOL = 5e-4
BLEND_CONFIG = ((4, "D", 4), (4, "U", 4))
FUSER_TYPES = ["pool:max", "pool:abs_max", "pool:mean", "pool:median", "concat",
               "blend", "gru", "lstm"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def jax_fuser_params(fuser, key, views=2, channels=4, size=8):
    """A JAX fuser's initialised parameters ({} for Pool and Concat); the
    Blend fuser's init reads a camera intermediate."""
    z = jnp.zeros((1, views, channels, size, size, size))
    cam = jzoo.canonical_camera(views, 16)
    if isinstance(fuser, (jfusion.PoolFuser, jfusion.ConcatFuser)):
        return {}
    return fuser.init(key, z, [z], [], cam)


def cameras(rng, n):
    """n full-frame cameras about 1.5 from the object, on both sides."""
    q = rng.randn(n, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = np.tile(np.float32([[0.0, 0.0, 1.5]]), (n, 1)) + 0.02 * rng.randn(n, 3).astype(np.float32)
    ext = np.array(jthree.to_extrinsic_matrix(jnp.asarray(t), jnp.asarray(q)))
    K = np.tile(np.float32([[64, 0, 32], [0, 64, 24], [0, 0, 1]])[None], (n, 1, 1))
    jcam = JCamera(K, ext, width=64, height=48).zoom(None, 16, 1.5)
    tcam = TCamera(K, ext, width=64, height=48, device="cpu").zoom(None, 16, 1.5)
    return jcam, tcam


# ---------------------------------------------------------------- pooling
@pytest.mark.parametrize("pool_type", ["max", "abs_max", "mean", "median"])
@pytest.mark.parametrize("views", [3, 4])
def test_pool_tensor_matches_jax(rng, pool_type, views):
    """Even and odd view counts (numpy's median averages the middle two)."""
    x = rng.randn(2, views, 3, 4, 4).astype(np.float32)
    got = tfusion.pool_tensor(torch.from_numpy(x), pool_type, dim=1)
    close_rel(got.numpy(), np.asarray(jfusion.pool_tensor(jnp.asarray(x), pool_type, axis=1)),
              OPS_TOL)
    assert got.shape == (2, 1, 3, 4, 4)
    with pytest.raises(ValueError, match="pool_type"):
        tfusion.pool_tensor(torch.from_numpy(x), "min")
    with pytest.raises(ValueError, match="pool_type"):
        tfusion.PoolFuser("min")


# ------------------------------------------------------------ the modules
def test_conv_lstm_cell_matches(rng):
    x = rng.randn(2, 7, 4, 4, 4).astype(np.float32)
    h = rng.randn(2, 4, 4, 4, 4).astype(np.float32)
    c = rng.randn(2, 4, 4, 4, 4).astype(np.float32)
    jm, tm = jlstm.ConvLSTMCell(7, 4), tlstm.ConvLSTMCell(7, 4)
    params = random_params(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                   (jnp.asarray(h), jnp.asarray(c))), rng)
    tm.load_state_dict(to_state(params))
    want = jm.apply(params, jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), (torch.from_numpy(h), torch.from_numpy(c)))
    for g, w in zip(got, want):
        close_rel(g.numpy(), np.asarray(w), NET_TOL)


@pytest.mark.parametrize("config", [BLEND_CONFIG, ((4, "D", 4, "D", 8), (8, "U", 4, "U", 4)),
                                    ((4, "D", 4), (4,))],
                         ids=["blend", "two_levels", "no_up"])
def test_unet3d_matches(rng, config):
    x = rng.randn(2, 5, 8, 8, 8).astype(np.float32)
    check_module(junet.UNet3d(5, 1, config), tunet.UNet3d(5, 1, config), [x], rng)


@pytest.mark.parametrize("ndim", [2, 3])
def test_preactivation_basic_block_matches(rng, ndim):
    x = rng.randn(2, 3, *([8] * ndim)).astype(np.float32)
    mode = "bilinear" if ndim == 2 else "trilinear"
    check_module(jblocks.PreActivationBasicBlock(3, 5, ndim=ndim, scale_mode=mode),
                 tblocks.PreActivationBasicBlock(3, 5, ndim=ndim, scale_mode=mode), [x], rng)


# ---------------------------------------------------------------- fusers
@pytest.mark.parametrize("fuser_type", FUSER_TYPES)
def test_fuser_matches_jax(rng, fuser_type):
    """Each fuser of ``get_fuser`` on 3 views (B = 1) with random weights and
    the Sculptor-like camera intermediates; the Blend weights too."""
    jcam, tcam = cameras(rng, 3)
    z = rng.randn(1, 3, 4, 8, 8, 8).astype(np.float32)
    z_cam = rng.randn(1, 3, 4, 8, 8, 8).astype(np.float32)
    jf = jfusion.get_fuser(fuser_type, 4, 1.0, block_config=BLEND_CONFIG)
    params = jax_fuser_params(jf, jax.random.PRNGKey(1), views=3)
    params = random_params(params, rng) if params else params
    tf = tfusion.get_fuser(fuser_type, 4, 1.0, block_config=BLEND_CONFIG, device="cpu")
    tf.load_state_dict(to_state(params) if params else {})
    want, want_extra = jf.apply(params, jnp.asarray(z), [jnp.asarray(z_cam)], [], jcam)
    with torch.no_grad():
        got, extra = tf(torch.from_numpy(z), [torch.from_numpy(z_cam)], [], tcam)
    assert set(extra) == set(want_extra)
    close_rel(got.numpy(), np.asarray(want), NET_TOL)
    for k in want_extra:
        close_rel(extra[k].numpy(), np.asarray(want_extra[k]), NET_TOL)
    assert got.shape == ((1, 1, 12, 8, 8, 8) if fuser_type == "concat" else (1, 1, 4, 8, 8, 8))


def test_get_fuser_types_weights_and_refusals():
    g = torch.Generator().manual_seed(0)
    a = tfusion.get_fuser("lstm", 4, 1.0, device="cpu", generator=g)
    b = tfusion.get_fuser("lstm", 4, 1.0, device="cpu", generator=torch.Generator().manual_seed(0))
    assert torch.equal(a.lstm.conv.module.weight, b.lstm.conv.module.weight)
    assert isinstance(tfusion.get_fuser("pool:median", 4, 1.0, device="cpu"), tfusion.PoolFuser)
    with pytest.raises(ValueError, match="Unknown fuser type"):
        tfusion.get_fuser("attention", 4, 1.0, device="cpu")
    with pytest.raises(ValueError, match="Unknown fuser type"):
        tfusion.fuser_from_checkpoint_args("AttentionFuser", {})
    assert sorted(tfusion.FUSER_TYPES) == sorted(
        ["PoolFuser", "ConcatFuser", "BlendFuser", "GRUFuser", "LSTMFuser"])


def test_blend_width_constraint_fails_in_both(rng):
    """The Blend U-Net takes the Sculptor's output width + 1 channels but is
    given its last camera block's width + 1: with the training tool's
    default architecture (camera 128, object 256) the two differ and the
    JAX fuser fails, as the port's does."""
    jcam, tcam = cameras(rng, 2)
    z = jnp.zeros((1, 2, 8, 8, 8, 8))
    z_cam = jnp.zeros((1, 2, 4, 8, 8, 8))
    jf = jfusion.get_fuser("blend", 8, 1.0, block_config=BLEND_CONFIG)
    with pytest.raises(Exception, match="feature dimension"):
        jf.init(jax.random.PRNGKey(0), z, [z_cam], [], jcam)
    tf = tfusion.get_fuser("blend", 8, 1.0, block_config=BLEND_CONFIG, device="cpu")
    with pytest.raises(RuntimeError, match="channels"):
        tf(torch.zeros(1, 2, 8, 8, 8, 8), [torch.zeros(1, 2, 4, 8, 8, 8)], [], tcam)


# -------------------------------------------------- the camera intermediates
def test_build_maps_camera_intermediates_only_for_a_reader(rng):
    """A Sculptor with two camera blocks: with the GRU fuser the build
    samples one volume (the last block's output, mapped to object space)
    and its latent is the same bits as the build that maps both
    intermediates (the parent's, 3 samples); with the Blend fuser it maps
    both, the last one reused, plus the Blend weights: 3 samples."""
    sc = tmodels.Sculptor(in_size=16, image_config=((4, "D", 8), (8,)),
                          camera_config=(4, 4, 4), object_config=(4, 4),
                          projection_type="factor")
    jcam, tcam = cameras(rng, 3)
    color = torch.from_numpy(rng.rand(1, 3, 3, 16, 16).astype(np.float32))
    mask = torch.from_numpy((rng.rand(1, 3, 1, 16, 16) > 0.5).astype(np.float32))
    calls = []
    sample = transforms._volume_sample

    def spy(volume, grid, padding_mode):
        calls.append(tuple(volume.shape))
        return sample(volume, grid, padding_mode)

    gru = tfusion.get_fuser("gru", 4, 1.0, device="cpu", generator=torch.Generator().manual_seed(1))
    blend = tfusion.get_fuser("blend", 4, 1.0, block_config=BLEND_CONFIG, device="cpu",
                              generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), mock.patch.object(transforms, "_volume_sample", spy):
        z_gru = tmodels.encode(sc, gru, tcam, color, None, mask)
        assert calls == [(3, 4, 8, 8, 8)]
        calls.clear()
        tmodels.encode(sc, blend, tcam, color, None, mask)
        assert calls == [(3, 4, 8, 8, 8)] * 2 + [(3, 1, 8, 8, 8)]
        calls.clear()
        x = torch.cat((color[0], gan_normalize(mask[0])), dim=1)
        z, z_cam_mid, z_obj_mid = sc(x, tcam, camera_intermediates=True)
        assert len(calls) == 2 and len(z_cam_mid) == 2 and len(z_obj_mid) == 1
    z_parent, _ = gru(z[None], [v[None] for v in z_cam_mid], [v[None] for v in z_obj_mid], tcam)
    assert torch.equal(z_gru, z_parent.detach())


# ------------------------------------------------------- from_checkpoint
FUSER_ENTRIES = {
    "pool:max": {"type": "PoolFuser", "args": {"pool_type": "max"}},
    "pool:median": {"type": "PoolFuser", "args": {"pool_type": "median"}},
    "concat": {"type": "ConcatFuser", "args": {}},
    "blend": {"type": "BlendFuser", "args": {"block_config": [[4, "D", 4], [4, "U", 4]],
                                             "in_channels": 4, "cube_size": 1.0}},
    "lstm": {"type": "LSTMFuser", "args": {"in_channels": 4, "cube_size": 1.0}},
}


@pytest.mark.parametrize("fuser_type", sorted(FUSER_ENTRIES))
def test_from_checkpoint_with_each_fuser_matches_jax(rng, tmp_path, fuser_type):
    """A reference-format checkpoint whose fuser is not the GRU: the port
    loads it and builds the latent object the JAX model builds."""
    sc, ph = jzoo.tiny_sculptor(), jzoo.tiny_photographer()
    fu = jfusion.get_fuser(fuser_type, 4, 1.0, block_config=BLEND_CONFIG)
    params = jzoo.init_recon_params(jax.random.PRNGKey(0), sc, jzoo.tiny_fuser(), ph)
    params["fuser"] = jax_fuser_params(fu, jax.random.PRNGKey(3))
    if params["fuser"]:
        params["fuser"] = random_params(params["fuser"], rng)

    def state_dict(p):
        return {k: torch.from_numpy(np.array(v)) for k, v in export_torch_state_dict(p).items()}

    fuser_entry = dict(FUSER_ENTRIES[fuser_type])
    if params["fuser"]:
        fuser_entry["state_dict"] = state_dict(params["fuser"])
    modules = {"sculptor": {"args": sc.checkpoint_args(), "state_dict": state_dict(params["sculptor"])},
               "photographer": {"args": ph.checkpoint_args(),
                                "state_dict": state_dict(params["photographer"])},
               "fuser": fuser_entry}
    path = tmp_path / "checkpoint.pth"
    torch.save({"name": "tiny", "epoch": 0, "args": {"camera_dist": 1.5}, "modules": modules},
               path)
    tm = TModel.from_checkpoint(path, device="cpu")
    assert type(tm.fuser).__name__ == FUSER_ENTRIES[fuser_type]["type"]
    jm = JModel.from_checkpoint(path)
    # The render does not read the fuser (test_torch_slice.py holds it): the
    # latent of the build is compared.
    from latentfusion_tpu.observation import Observation as JObservation
    from latentfusion_tpu_torch.observation import Observation as TObservation

    views = tiny_views(rng, n=3)
    args = (views["color"], views["depth"], views["mask"])
    z_j = jm.build_latent_object(JObservation(*args, JCamera(
        views["intrinsic"], views["extrinsic"], width=64, height=48)))
    z_t = tm.build_latent_object(TObservation(*args, TCamera(
        views["intrinsic"], views["extrinsic"], width=64, height=48, device="cpu")))
    assert z_t.shape == ((1, 1, 12, 8, 8, 8) if fuser_type == "concat" else (1, 1, 4, 8, 8, 8))
    close_rel(z_t.numpy(), np.asarray(z_j))
