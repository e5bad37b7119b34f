"""The port's remaining pose losses held against the JAX package on the CPU:
the mask losses (``mask_centroid``, ``mask_contour``, ``shape_loss``,
``contour_loss``), ``functional.py``, and the VGG16 perceptual loss with
the same random weights on both sides.

Tolerances (fp32): 1e-5 for the mask losses and functions, 5e-4 for the
network, relative to the reference's largest magnitude or to 1 where that
is smaller.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentfusion_tpu import functional as jF
from latentfusion_tpu.modules import vgg as jvgg
from latentfusion_tpu.pose import utils as jpu

from latentfusion_tpu_torch import functional as tF
from latentfusion_tpu_torch import losses as tlosses
from latentfusion_tpu_torch.modules import vgg as tvgg
from latentfusion_tpu_torch.pose import utils as tpu

OPS_TOL = 1e-5
NET_TOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def close_rel(a, b, tol):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(float(np.abs(b).max()), 1.0)


def masks(rng, n, h, w, soft):
    """Blobby masks: a random ellipse per item, hard or blurred to soft."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.zeros((n, 1, h, w), np.float32)
    for i in range(n):
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        ry, rx = rng.uniform(0.15, 0.35) * h, rng.uniform(0.15, 0.35) * w
        r = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        out[i, 0] = 1.0 / (1.0 + np.exp(8.0 * (r - 1.0))) if soft else (r < 1.0)
    return out


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("n,h,w", [(3, 24, 32), (1, 17, 9)])
def test_mask_centroid_and_contour_match_jax(rng, soft, n, h, w):
    m = masks(rng, n, h, w, soft)
    close_rel(tpu.mask_centroid(torch.from_numpy(m)), jpu.mask_centroid(jnp.asarray(m)),
              OPS_TOL)
    got = tpu.mask_contour(torch.from_numpy(m)).numpy()
    ref = np.asarray(jpu.mask_contour(jnp.asarray(m)))
    assert got.dtype == ref.dtype == np.bool_
    np.testing.assert_array_equal(got, ref)
    assert got.any()


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("target_n", [1, 3])
def test_shape_and_contour_losses_match_jax(rng, soft, target_n):
    inp = masks(rng, 3, 24, 32, soft)
    tgt = masks(rng, target_n, 24, 32, soft)
    got = tpu.shape_loss(torch.from_numpy(inp), torch.from_numpy(tgt))
    ref = jpu.shape_loss(jnp.asarray(inp), jnp.asarray(tgt))
    assert tuple(got.shape) == ref.shape == (3, 24, 32)
    close_rel(got, ref, OPS_TOL)
    if target_n == 3:
        got = tpu.contour_loss(torch.from_numpy(inp), torch.from_numpy(tgt))
        ref = jpu.contour_loss(jnp.asarray(inp), jnp.asarray(tgt))
        close_rel(got, ref, OPS_TOL)
        assert float(got.abs().sum()) > 0


def test_functional_matches_jax(rng):
    x = rng.randn(2, 3, 5, 4).astype(np.float32)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    for fn in ("normalize", "denormalize"):
        for arr in (x, x[0]):
            close_rel(getattr(tF, fn)(torch.from_numpy(arr), mean, std),
                      getattr(jF, fn)(jnp.asarray(arr), mean, std), OPS_TOL)
    with pytest.raises(ValueError):
        tF.normalize(torch.zeros(3, 4), mean, std)
    close_rel(tF.unit_normalize(torch.from_numpy(x), 1), jF.unit_normalize(jnp.asarray(x), 1),
              OPS_TOL)
    for axis in (0, 1, 3):
        np.testing.assert_array_equal(tF.absolute_max_pool(torch.from_numpy(x), axis).numpy(),
                                      np.asarray(jF.absolute_max_pool(jnp.asarray(x), axis)))
    layers = [("a", lambda v: v * 2), ("b", lambda v: v + 1), ("c", lambda v: v ** 2)]
    got = tF.extract_features(layers, torch.from_numpy(x), ["c", "a"])
    ref = jF.extract_features(layers, jnp.asarray(x), ["c", "a"])
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        close_rel(g, r, OPS_TOL)


@pytest.fixture(scope="module")
def vggs():
    """The port's VGG16 features with weights drawn from a seeded generator,
    and the JAX module's parameters from its state_dict, which has
    torchvision's keys."""
    tv = tvgg.VGG16Features(device="cpu", generator=torch.Generator().manual_seed(0))
    params = jvgg.params_from_torchvision_state_dict(tv.state_dict())
    return tv, params


def test_vgg_state_dict_has_torchvision_keys(vggs):
    tv, params = vggs
    convs = [i for i, (kind, _) in enumerate(tvgg.VGG16_LAYOUT[:28]) if kind == "conv"]
    assert list(tv.state_dict()) == [f"features.{i}.{p}" for i in convs
                                     for p in ("weight", "bias")]
    assert len(params["params"]) == 2 * len(convs)
    # A torchvision state_dict (deeper layers and the classifier too) loads.
    full = dict(tv.state_dict())
    full["features.28.weight"] = torch.zeros(512, 512, 3, 3)
    full["classifier.0.weight"] = torch.zeros(4096, 25088)
    other = tvgg.VGG16Features(device="cpu", generator=torch.Generator().manual_seed(1))
    other.load_torchvision_state_dict(full)
    for k, v in tv.state_dict().items():
        assert torch.equal(other.state_dict()[k], v)


def test_extract_features_matches_jax(vggs, rng):
    tv, params = vggs
    x = rng.randn(2, 3, 32, 32).astype(np.float32)
    ref = jvgg.VGG16Features().apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = tv(torch.from_numpy(x))
        layers = tF.extract_features(tv.features.named_children(), torch.from_numpy(x),
                                     [str(i) for i in tvgg.DEFAULT_LAYERS])
    assert len(got) == len(ref) == len(layers) == 5
    for g, l_, r in zip(got, layers, ref):
        assert tuple(g.shape) == r.shape
        close_rel(g, r, NET_TOL)
        assert torch.equal(g, l_)


def test_perceptual_loss_matches_jax(vggs, rng):
    tv, params = vggs
    x1 = rng.rand(2, 3, 32, 32).astype(np.float32)
    x2 = rng.rand(2, 3, 32, 32).astype(np.float32)
    ref = jvgg.build_perceptual_loss(params)(jnp.asarray(x1), jnp.asarray(x2))
    with torch.no_grad():
        got = tpu.get_perceptual_loss(tv)(torch.from_numpy(x1), torch.from_numpy(x2))
        loaded = tpu.get_perceptual_loss(torch_state_dict=tv.state_dict(), device="cpu")(
            torch.from_numpy(x1), torch.from_numpy(x2))
    assert tuple(got.shape) == ref.shape == (2,)
    close_rel(got, ref, NET_TOL)
    assert torch.equal(loaded, got)
    mean = tlosses.PerceptualLoss(tv, tvgg.DEFAULT_LAYER_WEIGHTS)(
        torch.from_numpy(x1), torch.from_numpy(x2))
    assert torch.allclose(mean, got.mean())
    with pytest.raises(ValueError):
        tpu.get_perceptual_loss()
