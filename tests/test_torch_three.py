"""The port's ``three/`` geometry, ``utils`` scheduler and ``imutils`` mask
functions held against the JAX package on the CPU, on the same seeded numpy
inputs.

Tolerance: 1e-6 absolute for fp32 geometry of unit-sized values
(rotations, quaternions, rays, bounds of N(0, 1) points), 1e-5 absolute
where N(0, 1) translations or products of several such values reach a few
units. The random samplers cannot share
JAX's PRNG stream, so JAX's draws are injected: ``torch.rand`` and
``torch.randn`` hand out, in order, the arrays that the JAX function draws
from its split keys (``draws``). Their loops are also held by their
properties: every ray in its segment, every pair of disk-sampled
quaternions at least the minimum angle apart.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentfusion_tpu import imutils as jimutils
from latentfusion_tpu import three as jthree
from latentfusion_tpu.three import orientation as jorient
from latentfusion_tpu.three import quaternion as jquat
from latentfusion_tpu.utils import MultiStepMilestoneScheduler as JScheduler

from latentfusion_tpu_torch import imutils as timutils
from latentfusion_tpu_torch import three as tthree
from latentfusion_tpu_torch.three import orientation as torient
from latentfusion_tpu_torch.three import quaternion as tquat
from latentfusion_tpu_torch.utils import MultiStepMilestoneScheduler as TScheduler

GEOM_TOL = 1e-6


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


def unit_quats(rng, n):
    q = rng.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def extrinsics(rng, n):
    trans = rng.randn(n, 3).astype(np.float32)
    return np.array(jthree.to_extrinsic_matrix(jnp.asarray(trans),
                                               jnp.asarray(unit_quats(rng, n))))


@pytest.fixture
def draws(monkeypatch):
    """Inject JAX's draws: ``draws(uniform=iter, normal=iter)`` makes
    ``torch.rand`` and ``torch.randn`` return the iterators' next arrays."""

    def install(uniform=(), normal=()):
        streams = {"rand": iter(uniform), "randn": iter(normal)}

        def fake(name):
            def draw(*shape, generator=None, device=None, **kwargs):
                value = np.asarray(next(streams[name]), np.float32)
                want = tuple(shape[0]) if len(shape) == 1 and isinstance(
                    shape[0], (tuple, list)) else tuple(shape)
                assert value.shape == want, (name, value.shape, want)
                return torch.from_numpy(value.copy())
            return draw

        monkeypatch.setattr(torch, "rand", fake("rand"))
        monkeypatch.setattr(torch, "randn", fake("randn"))

    return install


def split_stream(key, draw):
    """JAX's loop draws: ``key, sub = split(key)`` then ``draw(sub)``, forever."""
    while True:
        key, sub = jax.random.split(key)
        yield draw(sub)


# ------------------------------------------------------------------- core
def test_core_points_and_grids(rng):
    points = rng.randn(50, 3).astype(np.float32)
    for name in ("points_bound", "points_radius", "points_diameter",
                 "points_centroid", "points_bounding_size"):
        close(getattr(tthree, name)(t(points)), getattr(jthree, name)(jnp.asarray(points)))
    grid = rng.randn(2, 3, 4, 5, 3).astype(np.float32)
    transform = extrinsics(rng, 2)
    close(tthree.transform_coord_grid(t(grid), t(transform)),
          jthree.transform_coord_grid(jnp.asarray(grid), jnp.asarray(transform)), 1e-5)
    close(tthree.grid_to_coords(t(grid)), jthree.grid_to_coords(jnp.asarray(grid)))
    with pytest.raises(ValueError):
        tthree.transform_coord_grid(t(grid), t(transform[:1]))
    theta, phi = rng.rand(7).astype(np.float32), rng.rand(7).astype(np.float32)
    close(tthree.spherical_to_cartesian(t(theta), t(phi), 2.0),
          jthree.spherical_to_cartesian(jnp.asarray(theta), jnp.asarray(phi), 2.0))


def test_uniform_with_jax_draws(draws):
    key = jax.random.PRNGKey(3)
    draws(uniform=[jax.random.uniform(key, (9,))])
    close(tthree.uniform(9, -2.0, 3.0, torch.Generator()),
          jthree.uniform(key, 9, -2.0, 3.0))


# -------------------------------------------------------------- batchview
def test_batchview(rng):
    a = rng.randn(2, 3, 4, 5).astype(np.float32)
    b = rng.randn(2, 3, 5, 2).astype(np.float32)
    close(tthree.bvmm(t(a), t(b)), jthree.bvmm(jnp.asarray(a), jnp.asarray(b)), 1e-5)
    with pytest.raises(ValueError):
        tthree.bvmm(t(a), t(b[:1]))
    x, y = rng.randn(2 * 3, 4).astype(np.float32), rng.randn(2 * 2, 4).astype(np.float32)
    cat = tthree.vcat([t(x), t(y)], batch_size=2)
    close(cat, jthree.vcat([jnp.asarray(x), jnp.asarray(y)], batch_size=2))
    for got, want in zip(tthree.vsplit(cat, [3, 2]),
                         jthree.vsplit(jnp.asarray(cat.numpy()), [3, 2])):
        close(got, want)


# ------------------------------------------------------------- quaternion
def test_quaternion_rotate_and_spherical(rng):
    q, v = unit_quats(rng, 6), rng.randn(6, 3).astype(np.float32)
    close(tquat.rotate_vector(t(q), t(v)), jquat.rotate_vector(jnp.asarray(q), jnp.asarray(v)))
    close(tquat.rotate_vector(t(q[:1]), t(v)),
          jquat.rotate_vector(jnp.asarray(q[:1]), jnp.asarray(v)))
    theta, phi = rng.rand(5).astype(np.float32), rng.rand(5).astype(np.float32)
    close(tquat.from_spherical(t(theta), t(phi), 1.5),
          jquat.from_spherical(jnp.asarray(theta), jnp.asarray(phi), 1.5))


@pytest.mark.parametrize("batched", [True, False])
def test_qdelta_and_perturb_with_jax_draws(draws, rng, batched):
    key = jax.random.PRNGKey(11)
    q = unit_quats(rng, 5) if batched else unit_quats(rng, 1)[0]
    n = 5 if batched else 1
    draws(normal=[jax.random.normal(key, (n, 3))] * 2)
    close(tquat.qdelta(n, 0.3, torch.Generator()), jquat.qdelta(key, n, 0.3))
    close(tquat.perturb(t(q), 0.3, torch.Generator()), jquat.perturb(key, jnp.asarray(q), 0.3))


# ------------------------------------------------------------------ rigid
def test_rigid(rng):
    ext = extrinsics(rng, 4)
    mats = rng.randn(4, 3, 3).astype(np.float32)
    close(tthree.matrix_3x3_to_4x4(t(mats)), jthree.matrix_3x3_to_4x4(jnp.asarray(mats)))
    close(tthree.matrix_3x3_to_4x4(t(mats[0])), jthree.matrix_3x3_to_4x4(jnp.asarray(mats[0])))
    for got, want in zip(tthree.decompose(t(ext)), jthree.decompose(jnp.asarray(ext))):
        close(got, want)
    for x in (ext, ext[0]):
        close(tthree.inverse_transform(t(x)), jthree.inverse_transform(jnp.asarray(x)), 1e-5)
        close(tthree.extrinsic_to_position(t(x)),
              jthree.extrinsic_to_position(jnp.asarray(x)), 1e-5)
    offset = rng.randn(3).astype(np.float32)
    close(tthree.translate_matrix(t(ext), t(offset)),
          jthree.translate_matrix(jnp.asarray(ext), jnp.asarray(offset)), 1e-5)
    close(tthree.scale_matrix(t(ext), 1.7), jthree.scale_matrix(jnp.asarray(ext), 1.7), 1e-5)
    close(tthree.extrinsic_to_quat(t(ext)), jthree.extrinsic_to_quat(jnp.asarray(ext)))


def test_random_translation_with_jax_draws(draws):
    key = jax.random.PRNGKey(5)
    draws(uniform=[jax.random.uniform(k, (6,)) for k in jax.random.split(key, 3)])
    bounds = ((-0.1, 0.1), (-0.2, 0.3), (1.0, 2.0))
    close(tthree.random_translation(6, *bounds, torch.Generator()),
          jthree.random_translation(key, 6, *bounds))


# ------------------------------------------------------------ orientation
def test_spiral_orbit():
    """The angles run to c pi; XLA's linspace may round a value one float32
    step apart from the port's, which the sine carries through: held at
    1e-6 plus the float32 spacing at c pi."""
    c = 8
    close(torient.spiral_orbit(20, c), jorient.spiral_orbit(20, c),
          GEOM_TOL + float(np.spacing(np.float32(c * math.pi))))


def test_sample_hemisphere_rays_with_jax_draws(draws):
    key = jax.random.PRNGKey(9)
    up = (0.3, -0.2, 1.0)
    draws(normal=[jax.random.normal(key, (40, 3))])
    rays = torient.sample_hemisphere_rays(40, up, torch.Generator())
    close(rays, jorient.sample_hemisphere_rays(key, 40, up))
    assert bool(((rays @ torch.tensor(up)) >= 0).all())


def _segment_stream(key, n):
    key, sub = jax.random.split(key)
    yield jax.random.normal(sub, (n, 3))
    yield from split_stream(key, lambda k: jax.random.normal(k, (n, 3)))


@pytest.mark.parametrize("segment", [(0.2, 0.6), (1.2, 1.4)])
def test_sample_segment_rays_with_jax_draws(draws, segment):
    """A narrow segment takes many redraws; every ray ends inside it."""
    key, n, up = jax.random.PRNGKey(2), 32, (0.0, 0.0, 1.0)
    draws(normal=_segment_stream(key, n))
    rays = torient.sample_segment_rays(n, up, *segment, torch.Generator())
    close(rays, jorient.sample_segment_rays(key, n, up, *segment))
    angles = torch.arccos(rays[:, 2].clamp(-1, 1))
    assert bool(((angles >= segment[0]) & (angles <= segment[1])).all())


def test_sample_segment_quats_with_jax_draws(draws):
    key, n, up = jax.random.PRNGKey(4), 16, (0.0, 1.0, 0.0)
    k1, k2 = jax.random.split(key)
    draws(uniform=[jax.random.uniform(k1, (n,))], normal=_segment_stream(k2, n))
    close(torient.sample_segment_quats(n, up, 0.3, 0.9, torch.Generator()),
          jorient.sample_segment_quats(key, n, up, 0.3, 0.9))


def test_disk_sample_quats_with_jax_draws(draws):
    key, n, min_angle = jax.random.PRNGKey(8), 24, 0.6
    key, sub = jax.random.split(key)
    first = [jax.random.uniform(sub, (1, 3))]
    draws(uniform=iter(first + list(_take(split_stream(
        key, lambda k: jax.random.uniform(k, (1, 3))), 4000))))
    quats = torient.disk_sample_quats(n, min_angle, torch.Generator())
    close(quats, jorient.disk_sample_quats(jax.random.PRNGKey(8), n, min_angle))
    dist = tquat.angular_distance(quats, quats)
    off = ~torch.eye(n, dtype=torch.bool)
    assert float(dist[off].min()) >= min_angle - 1e-6


def _take(stream, n):
    for _ in range(n):
        yield next(stream)


def test_disk_sample_quats_gives_up_after_max_tries():
    """Too many quaternions for the angle: after ``max_tries`` rejections
    in a row each draw is kept, so the loop ends."""
    quats = torient.disk_sample_quats(12, 3.0, torch.Generator().manual_seed(0), max_tries=4)
    assert quats.shape == (12, 4)
    assert bool(torch.isclose(torch.linalg.norm(quats, dim=1), torch.ones(12)).all())


# ------------------------------------------------------------------ stats
@pytest.mark.parametrize("n", [41, 40])
def test_stats(rng, n):
    data = rng.randn(n).astype(np.float32)
    data[:3] = (9.0, -7.0, 12.0)
    for name in ("mask_outliers_mad", "mask_outliers"):
        got = getattr(tthree.stats, name)(t(data), 2.0)
        assert np.array_equal(got.numpy(), np.asarray(getattr(jthree.stats, name)(
            jnp.asarray(data), 2.0)))
    for name in ("robust_mean", "robust_mean_mad"):
        close(getattr(tthree.stats, name)(t(data)),
              getattr(jthree.stats, name)(jnp.asarray(data)))
    table = rng.randn(n, 3).astype(np.float32)
    close(tthree.stats.mad(t(table)), jthree.stats.mad(jnp.asarray(table)))


# ------------------------------------------------------------------ utils
def _dist(center, data):
    return ((center - data) ** 2).sum(-1) ** 0.5


@pytest.mark.parametrize("ties", [False, True])
def test_farthest_points(rng, ties):
    """With ``ties`` the points sit on a grid, so distances tie exactly and
    the first-argmax and the cluster tie rule decide."""
    if ties:
        data = np.stack(np.meshgrid(np.arange(4.0), np.arange(3.0)), -1).reshape(-1, 2)
        data = data.astype(np.float32)
    else:
        data = rng.randn(30, 3).astype(np.float32)
    got = tthree.utils.farthest_points(t(data), 5, _dist, return_center_indexes=True,
                                       return_distances=True)
    want = jthree.utils.farthest_points(jnp.asarray(data), 5, _dist,
                                        return_center_indexes=True,
                                        return_distances=True)
    for g, w in zip(got, want):
        assert g.dtype == (torch.int32 if w.dtype == jnp.int32 else torch.float32)
        close(g, w)
    close(tthree.utils.farthest_points(t(data), 5, _dist),
          jthree.utils.farthest_points(jnp.asarray(data), 5, _dist))
    for g, w in zip(tthree.utils.farthest_points(t(data[:3]), 5, _dist, True),
                    jthree.utils.farthest_points(jnp.asarray(data[:3]), 5, _dist, True)):
        close(g, w)


def test_host_twins(rng):
    q, q2, trans = unit_quats(rng, 7), unit_quats(rng, 7), rng.randn(7, 3).astype(np.float32)
    close(tthree.host.quat_to_mat(q), jthree.host.quat_to_mat(q), 0)
    close(tthree.host.qmul(q, q2), jthree.host.qmul(q, q2), 0)
    close(tthree.host.to_extrinsic_matrix(trans, q),
          jthree.host.to_extrinsic_matrix(trans, q), 0)
    close(tthree.host.to_extrinsic_matrix(trans, q),
          jthree.to_extrinsic_matrix(jnp.asarray(trans), jnp.asarray(q)))


@pytest.mark.parametrize("milestones", [None, [3, 7, 7, 12]])
def test_milestone_scheduler(milestones):
    got, want = TScheduler(0.5, milestones, 0.1), JScheduler(0.5, milestones, 0.1)
    for step in range(0, 15):
        assert got.get(step) == want.get(step)


# ---------------------------------------------------------------- imutils
@pytest.mark.parametrize("kernel_size", [3, 5])
def test_morphology_and_mean_color(rng, kernel_size):
    mask = (rng.rand(2, 1, 13, 17) > 0.7).astype(np.float32)
    for name in ("dilate", "erode"):
        close(getattr(timutils, name)(t(mask), 2, kernel_size),
              getattr(jimutils, name)(jnp.asarray(mask), 2, kernel_size), 0)
    color = rng.rand(2, 3, 13, 17).astype(np.float32)
    close(timutils.mean_color(t(color), t(mask)),
          jimutils.mean_color(jnp.asarray(color), jnp.asarray(mask)))


def _two_blobs(equal: bool):
    mask = np.zeros((12, 14), np.uint8)
    mask[1:4, 8:11] = 1          # first in raster order
    mask[6:9, 2:5 if equal else 6] = 1
    mask[9, 5 if equal else 6] = 1 if not equal else 0
    mask[10, 10] = mask[11, 11] = 1   # diagonal pair: one component under 8-connectivity
    return mask


@pytest.mark.parametrize("case", ["equal", "unequal", "diagonal", "empty", "random"])
def test_largest_component(rng, case):
    """Equal areas resolve to the first component in raster order, as
    cv2's labels and argmax do; diagonal neighbours join (8-connectivity)."""
    if case == "equal":
        mask = _two_blobs(True)
    elif case == "unequal":
        mask = _two_blobs(False)
    elif case == "diagonal":
        mask = np.eye(6, dtype=np.uint8)
        mask[0, 5] = 1
    elif case == "empty":
        mask = np.zeros((5, 5), np.uint8)
    else:
        mask = (rng.rand(30, 30) > 0.55).astype(np.uint8)
    got = timutils.largest_component(mask)
    want = jimutils.largest_component(mask)
    assert got.dtype == bool and np.array_equal(got, np.asarray(want))
