"""The port's augmentations (``latentfusion_tpu_torch/augment``) held against
the JAX package's, which use OpenCV, on the CPU.

The port has no OpenCV: ``augment/cv_compat.py`` rebuilds the operations
the augmentations use. Held bit for bit: the 8-bit RGB -> HSV -> RGB
conversions over every color (H in 0..179), ``color_jitter``, the noises,
the crops and flips, the elliptical kernels, the morphology (erode,
dilate, open, close), the translations, cuts and additions of masks, and
the nearest-neighbour rotation, each under a shared ``random`` and
``np.random`` seed. Held to OpenCV's edge: the filled ellipses, where
every pixel that differs from OpenCV's lies within one pixel of OpenCV's
edge (its 3x3 neighbourhood, outside the image counted as empty, holds both
values), and so the ellipse corruption and the mask chain that draws them
(within one pixel of the edge of an ellipse drawn); with OpenCV's fill put
in, those chains bit for bit. ``motion_blur`` within
MOTION_BLUR_TOL of OpenCV's (float32 sums in another order).
"""
import random

import cv2
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from latentfusion_tpu import augment as jaug
from latentfusion_tpu.augment import masks as jmasks
from latentfusion_tpu.augment import tensors as jtensors

from latentfusion_tpu_torch import augment as taug
from latentfusion_tpu_torch.augment import cv_compat
from latentfusion_tpu_torch.augment import masks as tmasks
from latentfusion_tpu_torch.augment import tensors as ttensors

MOTION_BLUR_TOL = 1e-6  # absolute, on images in [0, 1]
CHUNK = 1 << 21  # colors per conversion batch (bounds the test's memory)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def seeded(fn, seed, *args, **kwargs):
    random.seed(seed)
    np.random.seed(seed)
    return fn(*args, **kwargs)


def same_draws(jax_fn, port_fn, seed, *args, **kwargs):
    """Both functions under the same ``random`` and ``np.random`` seed, and
    whether they drew the same numbers (the states after them agree)."""
    a = seeded(jax_fn, seed, *args, **kwargs)
    state = (random.getstate(), np.random.get_state()[1].copy())
    b = seeded(port_fn, seed, *args, **kwargs)
    assert random.getstate() == state[0]
    assert np.array_equal(np.random.get_state()[1], state[1])
    return a, b


def edge_band(ref: np.ndarray) -> np.ndarray:
    """Pixels whose 3x3 neighbourhood in ``ref`` (outside the image empty)
    holds both values."""
    padded = np.pad(ref.astype(np.uint8), 1)
    k = np.ones((3, 3), np.uint8)
    grown = cv2.dilate(padded, k)[1:-1, 1:-1]
    shrunk = cv2.erode(padded, k, borderValue=0)[1:-1, 1:-1]
    return grown != shrunk


def assert_within_edge(mine, ref):
    flips = np.asarray(mine).astype(bool) != np.asarray(ref).astype(bool)
    far = flips & ~edge_band(np.asarray(ref).astype(bool))
    assert not far.any(), f"{flips.sum()} flips, {far.sum()} off the edge"
    return int(flips.sum())


def random_masks(rng, n=6, shape=(48, 64)):
    out = []
    for _ in range(n):
        m = np.zeros(shape, bool)
        y0, x0 = rng.randint(0, shape[0] // 2), rng.randint(0, shape[1] // 2)
        m[y0:y0 + rng.randint(8, shape[0] // 2), x0:x0 + rng.randint(8, shape[1] // 2)] = True
        m &= rng.rand(*shape) > 0.15
        m[rng.randint(shape[0]), :] |= True
        out.append(m)
    return out


# --------------------------------------------------------------- color spaces
def test_rgb_to_hsv_matches_opencv_on_every_color():
    for start in range(0, 1 << 24, CHUNK):
        c = np.arange(start, start + CHUNK, dtype=np.uint32)
        rgb = np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], -1).astype(np.uint8)
        rgb = rgb.reshape(-1, 1024, 3)
        assert np.array_equal(cv_compat.rgb_to_hsv(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))


def test_hsv_to_rgb_matches_opencv_on_every_color():
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, 3)
    for start in range(0, len(hsv), CHUNK):
        part = hsv[start:start + CHUNK].reshape(-1, 256, 3)
        assert np.array_equal(cv_compat.hsv_to_rgb(part), cv2.cvtColor(part, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_color_jitter_matches_jax(seed):
    rng = np.random.RandomState(seed)
    image = rng.rand(48, 64, 3).astype(np.float32)
    image[:16] = rng.rand(3)  # a flat region
    a, b = same_draws(jaug.color_jitter, taug.color_jitter, seed, image)
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_noises_match_jax():
    rng = np.random.RandomState(4)
    image = rng.rand(48, 64, 3).astype(np.float32)
    depth = rng.rand(48, 64).astype(np.float32) * (rng.rand(48, 64) > 0.4)
    for seed in range(3):
        a, b = same_draws(jaug.add_noise, taug.add_noise, seed, image, 0.05)
        assert np.array_equal(a, b)
        a, b = same_draws(jaug.add_depth_noise, taug.add_depth_noise, seed, depth, 0.1)
        assert np.array_equal(a, b)


def test_motion_blur_matches_jax():
    rng = np.random.RandomState(5)
    image = rng.rand(48, 64, 3).astype(np.float32)
    for seed in range(12):
        a, b = same_draws(jaug.motion_blur, taug.motion_blur, seed, image)
        assert np.abs(a - b).max() <= MOTION_BLUR_TOL


def test_normalizations_match_jax():
    x = np.random.RandomState(6).rand(2, 3, 8, 10).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(taug.imagenet_normalize(t).numpy(),
                               np.asarray(jaug.imagenet_normalize(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(taug.imagenet_denormalize(t).numpy(),
                               np.asarray(jaug.imagenet_denormalize(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_array_equal(taug.gan_denormalize(taug.gan_normalize(t)).numpy(),
                                  np.asarray(jaug.gan_denormalize(jaug.gan_normalize(
                                      jnp.asarray(x)))))


# ---------------------------------------------------------------- tensors
def test_tensor_crops_and_flips_match_jax():
    rng = np.random.RandomState(7)
    chw = rng.rand(3, 30, 40).astype(np.float32)
    hw = rng.rand(30, 40).astype(np.float32)
    cases = [(jtensors.TensorRandomCrop((48, 64), pad_if_needed=True),
              ttensors.TensorRandomCrop((48, 64), pad_if_needed=True)),
             (jtensors.TensorRandomCrop(16), ttensors.TensorRandomCrop(16)),
             (jtensors.TensorCenterCrop((10, 12)), ttensors.TensorCenterCrop((10, 12))),
             (jtensors.TensorRandomHorizontalFlip(), ttensors.TensorRandomHorizontalFlip()),
             (jtensors.TensorRandomVerticalFlip(), ttensors.TensorRandomVerticalFlip())]
    for seed in range(4):
        for jt, tt in cases:
            for x in (chw, hw):
                a, b = same_draws(jt, tt, seed, x)
                assert np.array_equal(a, b)
    compose = ttensors.Compose([cases[3][1], cases[4][1]])
    a, b = same_draws(jtensors.Compose([cases[3][0], cases[4][0]]), compose, 0, chw)
    assert np.array_equal(a, b)


# ------------------------------------------------------------------ masks
@pytest.mark.parametrize("size", [1, 3, 5, 7, 9, 11, 15])
def test_ellipse_kernel_matches_opencv(size):
    ref = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size)).astype(bool)
    assert np.array_equal(cv_compat.ellipse_kernel(size), ref)


@pytest.mark.parametrize("op", ["erode", "dilate", "open", "close"])
def test_morphology_matches_opencv(op):
    flag = {"erode": cv2.MORPH_ERODE, "dilate": cv2.MORPH_DILATE,
            "open": cv2.MORPH_OPEN, "close": cv2.MORPH_CLOSE}[op]
    for m in random_masks(np.random.RandomState(8)):
        for k in (3, 5, 9):
            kernel = cv_compat.ellipse_kernel(k)
            ref = cv2.morphologyEx(m.astype(np.uint8), flag, kernel.astype(np.uint8))
            assert np.array_equal(cv_compat.MORPH_OPS[op](m, kernel), ref.astype(bool))


EXACT_TRANSFORMS = ["RandomMorphologicalTransform", "RandomTranslation", "RandomRotation",
                    "RandomAdd", "RandomCut"]


@pytest.mark.parametrize("name", EXACT_TRANSFORMS)
def test_mask_transform_matches_jax(name):
    for i, m in enumerate(random_masks(np.random.RandomState(9))):
        a, b = same_draws(getattr(jmasks, name)(), getattr(tmasks, name)(), i, m)
        assert np.array_equal(a, b), name
        a, b = same_draws(getattr(jmasks, name)(), getattr(tmasks, name)(), i, m[None])
        assert np.array_equal(a, b) and b.shape == (1, *m.shape)


def test_rotation_matrix_matches_opencv():
    rng = np.random.RandomState(10)
    for _ in range(20):
        center = (rng.uniform(0, 64), rng.uniform(0, 48))
        angle = rng.uniform(-180, 180)
        assert np.array_equal(cv_compat.rotation_matrix_2d(center, angle, 1.0),
                              cv2.getRotationMatrix2D(center, angle, 1.0))


def test_filled_ellipses_within_one_pixel_of_opencv():
    rng = np.random.RandomState(11)
    flips = 0
    for _ in range(200):
        ref = np.zeros((48, 64), np.uint8)
        mine = ref.copy()
        center = (rng.randint(0, 64), rng.randint(0, 48))
        axes = (rng.randint(1, 30), rng.randint(1, 30))
        angle = rng.uniform(0, 180)
        cv2.ellipse(ref, center, axes, angle, 0, 360, 1, -1)
        cv_compat.fill_ellipse(mine, center, axes, angle, 1)
        flips += assert_within_edge(mine, ref)
    assert flips < 0.01 * 200 * 48 * 64


def test_random_ellipses_and_chain_within_one_pixel_of_jax(monkeypatch):
    """Every pixel where the port's ellipses or mask chain differ from JAX's
    lies within one pixel of the edge of one of the ellipses drawn (as
    OpenCV fills it on an empty image)."""
    drawn = []
    fill = cv_compat.fill_ellipse

    def recorded(img, center, axes, angle, value):
        drawn.append((center, axes, angle))
        return fill(img, center, axes, angle, value)

    monkeypatch.setattr(cv_compat, "fill_ellipse", recorded)
    for i, m in enumerate(random_masks(np.random.RandomState(12), n=12)):
        for jax_fn, port_fn in ((jmasks.RandomEllipses(), tmasks.RandomEllipses()),
                                (jmasks.default_mask_corruption(),
                                 tmasks.default_mask_corruption())):
            drawn.clear()
            a, b = same_draws(jax_fn, port_fn, i, m)
            edges = np.zeros(m.shape, bool)
            for center, axes, angle in drawn:
                region = np.zeros(m.shape, np.uint8)
                cv2.ellipse(region, center, axes, angle, 0, 360, 1, -1)
                edges |= edge_band(region)
            flips = a != b
            assert not (flips & ~edges).any(), (i, int(flips.sum()))


def test_ellipses_and_chain_match_jax_with_opencv_fill(monkeypatch):
    """With OpenCV's fill put in for ``fill_ellipse`` the port's ellipses
    and the whole corruption chain give JAX's bits: the fill, held to
    OpenCV's edge above, is the only difference (overlapping ellipses can
    carry an edge flip inside a later one's)."""
    def opencv_fill(img, center, axes, angle, value):
        return cv2.ellipse(img, center, axes, angle, 0, 360, value, -1)

    monkeypatch.setattr(cv_compat, "fill_ellipse", opencv_fill)
    for i, m in enumerate(random_masks(np.random.RandomState(12), n=12)):
        a, b = same_draws(jmasks.RandomEllipses(), tmasks.RandomEllipses(), i, m)
        assert np.array_equal(a, b)
        a, b = same_draws(jmasks.default_mask_corruption(), tmasks.default_mask_corruption(),
                          i, m)
        assert np.array_equal(a, b)
