"""The Photographer's options held against the JAX package on the CPU: the
occlusion module (its logits, the expected depth ``z_depth``, with its
U-Net at the camera volume's resolution and below it, where the nearest
resize matters) and skip connections, forward and parameter gradients,
with random weights; and the constraints of both, which the JAX package
fails on.

JAX's Photographer with skip connections raises for every configuration:
its camera blocks are sized by ``create_block_defs(...,
skip_connect_start=True)``, which reads True as 1, so camera block 0 gets
no skip width, while its forward concatenates a skip at every camera
block. The port sizes camera block 0 for its skip; the tests hold it to
JAX's forward with ``create_block_defs`` patched (in the test only) to
start the camera blocks' skips at 0.

Tolerance 5e-4 for networks and their gradients, relative to the largest
magnitude of each.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentfusion_tpu.recon import models as jmodels

from latentfusion_tpu_torch.recon import models as tmodels

from test_torch_fusion import cameras
from test_torch_modules import random_params
from test_torch_slice import close_rel, to_state

NET_TOL = 5e-4
IMAGE_CONFIG = ((4, "D", 8), (8, "U", 8, "U", 4))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def photographer_kwargs(**extra):
    return dict(in_size=8, image_config=IMAGE_CONFIG, camera_config=(4, 4),
                object_config=(4, 4), projection_type="factor", predict_color=True,
                predict_depth=True, predict_mask=True, cube_size=1.0, **extra)


def camera_skips_from_zero():
    """``create_block_defs`` of JAX's models module, with the camera
    blocks' skips starting at block 0 (what its forward concatenates)."""
    original = jmodels.create_block_defs

    def patched(*args, **kwargs):
        if kwargs.get("skip_connect_start") is True:
            kwargs["skip_connect_start"] = 0
        return original(*args, **kwargs)

    return mock.patch.object(jmodels, "create_block_defs", patched)


def run_pair(rng, kwargs, inputs, tcam, jcam, patch=None):
    """Both Photographers with the same random weights on ``inputs`` (z_obj
    first, then the intermediates): the JAX outputs, the port's, and the
    gradients of sum(logits * r) with respect to each side's weights."""
    patch = patch or mock.MagicMock()
    jph, tph = jmodels.Photographer(**kwargs), tmodels.Photographer(**kwargs)
    j_in = [jnp.asarray(x) if not isinstance(x, list) else [jnp.asarray(v) for v in x]
            for x in inputs]
    t_in = [torch.from_numpy(x) if not isinstance(x, list) else [torch.from_numpy(v) for v in x]
            for x in inputs]
    with patch:
        params = random_params(jph.init(jax.random.PRNGKey(0), j_in[0], jcam, *j_in[1:]), rng)
        y_j, _, depth_j = jph.apply(params, j_in[0], jcam, *j_in[1:])
        r = rng.randn(*y_j.shape).astype(np.float32)
        grads_j = jax.grad(lambda p: jnp.sum(jph.apply(p, j_in[0], jcam, *j_in[1:])[0] * r))(params)
    tph.load_state_dict(to_state(params))
    y_t, z_t, depth_t = tph(t_in[0], tcam, *t_in[1:])
    (y_t * torch.from_numpy(r)).sum().backward()
    ref = to_state(grads_j)
    for name, p in tph.named_parameters():
        close_rel(p.grad.numpy(), ref[name].numpy())
    close_rel(y_t.detach().numpy(), np.asarray(y_j))
    return tph, params, depth_t, depth_j


@pytest.mark.parametrize("occlusion_config", [((4, "D", 4), (4, "U", 4)), ((4, "D", 4), (4,))],
                         ids=["same_size", "half_size"])
def test_occlusion_module_matches_jax(rng, occlusion_config):
    """Logits, z_depth and the weights' gradients; at half size the depth
    weights come from the U-Net's 4^3 output and the volume is weighted by
    their nearest resize to 8^3."""
    jcam, tcam = cameras(rng, 2)
    z = rng.randn(2, 4, 8, 8, 8).astype(np.float32)
    tph, _, depth_t, depth_j = run_pair(rng, photographer_kwargs(occlusion_config=occlusion_config),
                                        [z], tcam, jcam)
    assert tph.occlusion_module is not None
    size = 8 if occlusion_config[1] != (4,) else 4
    assert depth_t.shape == (2, 1, size, size)
    close_rel(depth_t.detach().numpy(), np.asarray(depth_j))
    assert float(depth_t.abs().max()) <= 1.0


def test_decode_returns_z_depth(rng):
    """``decode`` of a shared latent at 3 cameras returns the occlusion
    module's depth as JAX's does, and None without the module."""
    jcam, tcam = cameras(rng, 3)
    kwargs = photographer_kwargs(occlusion_config=((4, "D", 4), (4, "U", 4)))
    jph, tph = jmodels.Photographer(**kwargs), tmodels.Photographer(**kwargs)
    z = rng.randn(1, 1, 4, 8, 8, 8).astype(np.float32)
    params = random_params(jph.init(jax.random.PRNGKey(2), jnp.asarray(z[0]), jcam), rng)
    tph.load_state_dict(to_state(params))
    y_j, lat_j, depth_j = jmodels.decode(jph, params, jnp.asarray(z), jcam, return_latent=True)
    with torch.no_grad():
        y_t, lat_t, depth_t = tmodels.decode(tph, torch.from_numpy(z), tcam, return_latent=True)
    for k in y_j:
        close_rel(y_t[k].numpy(), np.asarray(y_j[k]))
    close_rel(lat_t.numpy(), np.asarray(lat_j))
    close_rel(depth_t.numpy(), np.asarray(depth_j))
    plain = tmodels.Photographer(**photographer_kwargs())
    with torch.no_grad():
        assert tmodels.decode(plain, torch.from_numpy(z), tcam)[2] is None


def test_occlusion_without_object_config_fails_in_both():
    """The occlusion module is sized by object_config[-1] + 1: without an
    object config (the flagship architecture) JAX fails on None[-1]; the
    port says why."""
    kwargs = photographer_kwargs(occlusion_config=((4, "D", 4), (4, "U", 4)))
    kwargs["object_config"] = None
    jph = jmodels.Photographer(**kwargs)
    with pytest.raises(TypeError, match="not subscriptable"):
        jph.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8, 8)), cameras(
            np.random.RandomState(0), 1)[0])
    with pytest.raises(ValueError, match="object_config"):
        tmodels.Photographer(**kwargs)


def skip_inputs(rng, n):
    z = rng.randn(n, 4, 8, 8, 8).astype(np.float32)
    z_cam_mid = [rng.randn(n, 4, 8, 8, 8).astype(np.float32) for _ in range(2)]
    z_obj_mid = [rng.randn(n, 4, 8, 8, 8).astype(np.float32) for _ in range(2)]
    return z, z_cam_mid, z_obj_mid


@pytest.mark.parametrize("shared", [False, True], ids=["per_view", "shared_latent"])
def test_skip_connections_match_jax(rng, shared):
    """Two object and two camera blocks, each after the first object block
    and every camera block concatenating the Sculptor-like intermediates of
    the 2 views (the camera ones mapped back to camera space); a shared
    latent (B' = 1) is repeated to the views first. Forward and every
    weight's gradient."""
    jcam, tcam = cameras(rng, 2)
    z, z_cam_mid, z_obj_mid = skip_inputs(rng, 2)
    if shared:
        z = z[:1]
    kwargs = photographer_kwargs(skip_connections=True)
    kwargs.update(camera_config=(4, 4, 4), object_config=(4, 4, 4))
    tph, _, _, _ = run_pair(rng, kwargs, [z, z_cam_mid, z_obj_mid], tcam, jcam,
                            patch=camera_skips_from_zero())
    assert tph.camera_blocks[0].conv1.module.in_channels == 8
    with pytest.raises(ValueError, match="intermediates required"):
        tph(torch.from_numpy(z), tcam)


def test_skip_connections_raise_in_jax():
    """Unpatched, JAX's camera block 0 is built for 4 channels and given 8."""
    rng = np.random.RandomState(1)
    jcam, _ = cameras(rng, 2)
    z, z_cam_mid, z_obj_mid = skip_inputs(rng, 2)
    kwargs = photographer_kwargs(skip_connections=True)
    kwargs.update(camera_config=(4, 4, 4), object_config=(4, 4, 4))
    jph = jmodels.Photographer(**kwargs)
    with pytest.raises(ValueError, match="feature dimension"):
        jph.init(jax.random.PRNGKey(0), jnp.asarray(z), jcam,
                 [jnp.asarray(v) for v in z_cam_mid], [jnp.asarray(v) for v in z_obj_mid])
