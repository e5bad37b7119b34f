"""The port's ``Camera`` and ``Observation`` methods and its PNG codec held
against the JAX package on the CPU, on the same seeded numpy inputs.

Tolerances: 1e-6 for fp32 geometry of unit-sized values and for resampled
images in [0, 1]; 2e-4 (the JAX suite's geometry tolerance) for metric
coordinates of a few units back-projected through a camera. ``save`` and
``load`` go across the packages: each package loads the other's directory,
and both give the same arrays, bit for bit; the camera comes back through
``mat_to_quat`` and is held at 1e-6.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentfusion_tpu import three as jthree
from latentfusion_tpu.camera import Camera as JCamera
from latentfusion_tpu.camera import bbox_to_grid as j_bbox_to_grid
from latentfusion_tpu.camera import bboxes_to_grid as j_bboxes_to_grid
from latentfusion_tpu.observation import Observation as JObservation

from latentfusion_tpu_torch import png
from latentfusion_tpu_torch.camera import Camera as TCamera
from latentfusion_tpu_torch.camera import bbox_to_grid as t_bbox_to_grid
from latentfusion_tpu_torch.camera import bboxes_to_grid as t_bboxes_to_grid
from latentfusion_tpu_torch.observation import Observation as TObservation

GEOM_TOL = 1e-6
METRIC_TOL = 2e-4
H, W = 48, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, tol=GEOM_TOL):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, atol=tol, rtol=0)


def camera_args(rng, n=3):
    q = rng.randn(n, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    trans = np.array([0.0, 0.0, 1.5], np.float32) + 0.05 * rng.randn(n, 3).astype(np.float32)
    ext = np.array(jthree.to_extrinsic_matrix(jnp.asarray(trans), jnp.asarray(q)))
    K = np.tile(np.array([[64.0, 0, W / 2], [0, 64.0, H / 2], [0, 0, 1]], np.float32),
                (n, 1, 1))
    corner = rng.uniform(5, 15, (n, 2)).astype(np.float32)
    viewport = np.concatenate((corner, corner + rng.uniform(20, 30, (n, 2))), 1)
    return K, ext, viewport.astype(np.float32)


def both_cameras(rng, n=3, viewport=True):
    K, ext, vp = camera_args(rng, n)
    vp = vp if viewport else None
    return (JCamera(K, ext, z_span=0.4, viewport=vp, width=W, height=H),
            TCamera(K, ext, z_span=0.4, viewport=vp, width=W, height=H, device="cpu"))


def observations(rng, n=3):
    jc, tc = both_cameras(rng, n, viewport=False)
    mask = np.zeros((n, 1, H, W), np.float32)
    mask[:, :, 12:36, 18:46] = 1.0
    args = (rng.rand(n, 3, H, W).astype(np.float32),
            ((1.4 + 0.2 * rng.rand(n, 1, H, W)) * mask).astype(np.float32), mask)
    return JObservation(*args, jc), TObservation(*args, tc)


# ----------------------------------------------------------------- camera
def test_bbox_grids(rng):
    boxes = rng.uniform(-5, 60, (4, 4)).astype(np.float32)
    close(t_bbox_to_grid(t(boxes[0]), (H, W), (9, 11)),
          j_bbox_to_grid(jnp.asarray(boxes[0]), (H, W), (9, 11)))
    close(t_bboxes_to_grid(t(boxes), (H, W), (9, 11)),
          j_bboxes_to_grid(jnp.asarray(boxes), (H, W), (9, 11)))


def test_camera_properties(rng):
    jc, tc = both_cameras(rng)
    for name in ("viewport_centroid", "fov_u", "fov_v", "cam_to_obj"):
        close(getattr(tc, name), getattr(jc, name))
    for got, want in zip(tc.z_bounds, jc.z_bounds):
        close(got, want)


def test_with_extrinsic(rng):
    jc, tc = both_cameras(rng)
    _, ext, _ = camera_args(rng)
    for e in (ext, ext[0]):
        j, c = jc.with_extrinsic(jnp.asarray(e)), tc.with_extrinsic(t(e))
        close(c.log_quaternion, j.log_quaternion)
        close(c.translation, j.translation)
        close(c.viewport, j.viewport)


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_crop_to_viewport(rng, mode):
    jc, tc = both_cameras(rng)
    image = rng.rand(3, 2, H, W).astype(np.float32)
    close(tc.crop_to_viewport(t(image), 16, mode),
          jc.crop_to_viewport(jnp.asarray(image), 16, mode))


def test_depth_coords(rng):
    jc, tc = both_cameras(rng)
    depth = (1.3 + 0.4 * rng.rand(3, 1, 12, 16)).astype(np.float32)
    for name in ("depth_camera_coords", "depth_object_coords"):
        for got, want in zip(getattr(tc, name)(t(depth)),
                             getattr(jc, name)(jnp.asarray(depth))):
            close(got, want, METRIC_TOL)


def test_split_vcat_clone(rng):
    jc, tc = both_cameras(rng, 6)
    for sections in (2, [1, 3, 2]):
        for got, want in zip(tc.split(sections), jc.split(sections)):
            close(got.translation, want.translation)
            close(got.viewport, want.viewport)
    parts_t, parts_j = tc.split([4, 2]), jc.split([4, 2])
    got = TCamera.vcat(parts_t, batch_size=2)
    want = JCamera.vcat(parts_j, batch_size=2)
    for name in ("intrinsic", "viewport", "log_quaternion", "translation"):
        close(getattr(got, name), getattr(want, name))
    leaf = tc.translation.clone().requires_grad_(True)
    cam = tc.replace(translation=leaf)
    assert not cam.detach().translation.requires_grad
    cloned = tc.clone()
    cloned.translation[0, 0] = 99.0
    assert float(tc.translation[0, 0]) != 99.0


def test_kwargs_round_trip(rng):
    jc, tc = both_cameras(rng)
    got = {k: (v.numpy() if torch.is_tensor(v) else v) for k, v in tc.to_kwargs().items()}
    want = jc.to_kwargs()
    assert set(got) == set(want)
    for k in got:
        close(got[k], want[k])
    as_lists = {k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in got.items()}
    back_t = TCamera.from_kwargs(as_lists, device="cpu")
    back_j = JCamera.from_kwargs(as_lists)
    close(back_t.log_quaternion, back_j.log_quaternion)
    close(back_t.translation, back_j.translation)
    close(back_t.extrinsic, tc.extrinsic)


# ------------------------------------------------------------ observation
def _assert_same_arrays(a, b):
    for k in ("color", "depth", "mask"):
        x = getattr(a, k)
        x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
        y = getattr(b, k)
        y = y.numpy() if torch.is_tensor(y) else np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), k
    for k in ("intrinsic", "viewport", "log_quaternion", "translation"):
        close(getattr(a.camera, k), getattr(b.camera, k))
    assert a.meta == b.meta


@pytest.mark.parametrize("frames", [None, 1, [2, 0]])
def test_save_load_across_packages(rng, tmp_path, frames):
    jobs, tobs = observations(rng)
    tobs.save(tmp_path / "port")
    jobs.save(tmp_path / "jax")
    assert (json.loads((tmp_path / "port" / "cameras.json").read_text()).keys()
            == json.loads((tmp_path / "jax" / "cameras.json").read_text()).keys())
    for d in ("port", "jax"):
        got = TObservation.load(tmp_path / d, frames=frames, device="cpu")
        want = JObservation.load(tmp_path / d, frames=frames)
        _assert_same_arrays(got, want)
    # Quantisation: truncated 8-bit color, truncated millimetres, mask > 0.5.
    got = TObservation.load(tmp_path / "port", device="cpu")
    color = tobs.color.numpy()
    np.testing.assert_array_equal(
        got.color.numpy(), (255.0 * color).astype(np.uint8).astype(np.float32) / 255.0)
    np.testing.assert_array_equal(
        got.depth.numpy(),
        (1000.0 * tobs.depth.numpy()).astype(np.uint16).astype(np.float32) / 1000.0)
    np.testing.assert_array_equal(got.mask.numpy(), (tobs.mask.numpy() > 0.5).astype(np.float32))


def test_observation_geometry(rng):
    jobs, tobs = observations(rng)
    zoomed_t, zoomed_j = tobs.zoom(1.5, 16), jobs.zoom(1.5, 16)
    for a, b in ((zoomed_t.uncrop(), zoomed_j.uncrop()),
                 (zoomed_t.normalize().denormalize(), zoomed_j.normalize().denormalize())):
        for k in ("color", "depth", "mask"):
            close(getattr(a, k), getattr(b, k))
        assert a.meta == b.meta
    cam_t, cam_j = tobs.estimate_camera(), jobs.estimate_camera()
    close(cam_t.translation, cam_j.translation, METRIC_TOL)
    close(cam_t.log_quaternion, cam_j.log_quaternion)
    est_t, est_j = tobs.zoom_estimate(1.5, 16), jobs.zoom_estimate(1.5, 16)
    close(est_t.camera.viewport, est_j.camera.viewport, METRIC_TOL)
    close(est_t.depth, est_j.depth)


@pytest.mark.parametrize("frame", ["object", "camera"])
@pytest.mark.parametrize("return_colors, segment", [(False, True), (True, True),
                                                    (True, False), (False, False)])
def test_pointcloud(rng, frame, return_colors, segment):
    jobs, tobs = observations(rng, 2)
    got = tobs.pointcloud(frame, return_colors, segment)
    want = jobs.pointcloud(frame, return_colors, segment)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.dtype == torch.bool:
            assert np.array_equal(g.numpy(), np.asarray(w))
        else:
            close(g, w, METRIC_TOL)


def test_dilate_clone_to_list(rng):
    jobs, tobs = observations(rng)
    got, want = tobs.dilate(5), jobs.dilate(5)
    for k in ("color", "depth", "mask"):
        close(getattr(got, k), getattr(want, k))
    frames = tobs.to_list()
    assert [len(f) for f in frames] == [1, 1, 1]
    close(frames[2].color, tobs.color[2:3])
    cloned = tobs.clone()
    cloned.color[0, 0, 0, 0] = 7.0
    assert float(tobs.color[0, 0, 0, 0]) != 7.0


# -------------------------------------------------------------- png codec
IMAGES = {
    "rgb8": lambda rng: rng.randint(0, 256, (9, 13, 3)).astype(np.uint8),
    "grey8": lambda rng: rng.randint(0, 256, (7, 5)).astype(np.uint8),
    "grey16": lambda rng: rng.randint(0, 65536, (6, 11)).astype(np.uint16),
}


@pytest.mark.parametrize("kind", sorted(IMAGES))
@pytest.mark.parametrize("filter_type", range(5), ids=png.FILTERS)
def test_png_codec_filters(rng, tmp_path, kind, filter_type):
    """Every filter type round trips, and imageio reads what the codec
    writes."""
    import imageio.v2 as imageio

    image = IMAGES[kind](rng)
    path = tmp_path / "x.png"
    png.write_png(path, image, filter_type=filter_type)
    got = png.read_png(path)
    assert got.dtype == image.dtype and np.array_equal(got, image)
    theirs = imageio.imread(path)
    assert theirs.dtype == image.dtype and np.array_equal(theirs, image)


@pytest.mark.parametrize("kind", ["rgb8", "grey8", "grey16", "rgba8", "smooth"])
def test_png_reads_imageio(rng, tmp_path, kind):
    """What imageio writes (its encoder picks a filter for each row)."""
    import imageio.v2 as imageio

    if kind == "rgba8":
        image = rng.randint(0, 256, (10, 12, 4)).astype(np.uint8)
    elif kind == "smooth":
        yy, xx = np.mgrid[0:40, 0:60]
        image = np.stack([xx * 4, yy * 6, (xx * yy) % 256], -1).astype(np.uint8)
    else:
        image = IMAGES[kind](rng)
    path = tmp_path / "x.png"
    imageio.imsave(path, image)
    got = png.read_png(path)
    assert got.dtype == image.dtype and np.array_equal(got, image)
