"""The port's images for inspection held against the JAX package's on the
CPU: ``colorize_tensor`` and ``colorize_depth`` (JAX's call matplotlib's
viridis; the port carries its table) within 1e-6, ``make_grid`` (JAX's
resizes with cv2) at and off ``output_size``, ``cv_compat.resize_linear``
and ``resize_nearest`` against cv2 on odd sizes up and down, and
``overlay_mask``."""
import cv2
import numpy as np
import pytest
import torch

from latentfusion_tpu import visualization as jviz
from latentfusion_tpu.pose import plotting as jplotting

from latentfusion_tpu_torch import visualization as tviz
from latentfusion_tpu_torch.augment import cv_compat
from latentfusion_tpu_torch.pose import plotting as tplotting

TOL = 1e-6  # float32 images in [0, 1]: a few ulps


def test_viridis_table_is_matplotlibs():
    import matplotlib

    np.testing.assert_array_equal(tviz.VIRIDIS, matplotlib.colormaps["viridis"].colors)


@pytest.mark.parametrize("shape", [(2, 1, 17, 23), (3, 9, 11), (1, 2, 1, 5, 7)])
def test_colorize_tensor_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.random(shape).astype(np.float32)
    x.reshape(-1)[0] = x.max()  # a value normalised to exactly 1
    got = tviz.colorize_tensor(x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, jviz.colorize_tensor(x), atol=TOL, rtol=0)
    np.testing.assert_allclose(tviz.colorize_tensor(x, vmin=0.2, vmax=0.7),
                               jviz.colorize_tensor(x, vmin=0.2, vmax=0.7), atol=TOL, rtol=0)
    np.testing.assert_allclose(tviz.colorize_tensor(torch.from_numpy(x)),
                               jviz.colorize_tensor(x), atol=TOL, rtol=0)


@pytest.mark.parametrize("shape", [(2, 1, 16, 20), (1, 3, 1, 8, 9)])
def test_colorize_depth_matches_jax(shape):
    rng = np.random.default_rng(1)
    d = rng.uniform(1.0, 2.0, shape).astype(np.float32)
    d[..., :3, :] = 0.0
    np.testing.assert_allclose(tviz.colorize_depth(d), jviz.colorize_depth(d), atol=TOL, rtol=0)


@pytest.mark.parametrize("output_size", [None, 160, 17])
def test_make_grid_matches_jax(output_size):
    rng = np.random.default_rng(2)
    groups = [rng.random((5, 3, 24, 30)).astype(np.float32), None,
              rng.random((3, 1, 24, 30)).astype(np.float32),
              rng.random((2, 24, 30)).astype(np.float32),
              rng.random((1, 2, 3, 12, 14)).astype(np.float32) * 1.5]
    got = tviz.make_grid(groups, row_size=4, output_size=output_size, stride=1)
    want = jviz.make_grid(groups, row_size=4, output_size=output_size, stride=1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert tviz.make_grid([None]).shape == jviz.make_grid([None]).shape


SIZES = [(37, 53), (96, 128), (7, 5), (480, 640)]
DSIZES = [(160, 160), (13, 29), (101, 77), (3, 1), (641, 479)]


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("channels", [0, 1, 3])
def test_resize_linear_matches_cv2(hw, channels):
    rng = np.random.default_rng(3)
    shape = hw + ((channels,) if channels else ())
    img = rng.random(shape, dtype=np.float32)
    for dsize in DSIZES + [(hw[1] * 2, hw[0] * 2), (hw[1] // 2 or 1, hw[0] // 2 or 1),
                           (hw[1], hw[0])]:
        want = cv2.resize(img, dsize)
        got = cv_compat.resize_linear(img, dsize)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0, err_msg=str(dsize))


@pytest.mark.parametrize("hw", SIZES)
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, bool])
def test_resize_nearest_matches_cv2(hw, dtype):
    rng = np.random.default_rng(4)
    img = (rng.random(hw + (3,)) * 200).astype(dtype)
    mask = (rng.random(hw) * 900).astype(dtype)
    for dsize in DSIZES + [(int(hw[1] * 0.2) or 1, int(hw[0] * 0.2) or 1)]:
        for src in (img, mask):
            cv_src = src.astype(np.uint8) if dtype is bool else src
            want = cv2.resize(cv_src, dsize, interpolation=cv2.INTER_NEAREST)
            got = cv_compat.resize_nearest(src, dsize)
            np.testing.assert_array_equal(got.astype(want.dtype), want, err_msg=str(dsize))


@pytest.mark.parametrize("layout", ["chw", "hwc"])
def test_overlay_mask_matches_jax(layout):
    rng = np.random.default_rng(5)
    color = rng.random((3, 12, 16)).astype(np.float32)
    if layout == "hwc":
        color = color.transpose(1, 2, 0)
    mask = rng.random((12, 16)) > 0.5
    for kwargs in ({}, {"alpha": 0.3, "channel": 2}):
        np.testing.assert_array_equal(tplotting.overlay_mask(color, mask, **kwargs),
                                      jplotting.overlay_mask(color, mask, **kwargs))
