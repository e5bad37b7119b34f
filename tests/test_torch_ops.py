"""The port's 3D math, camera, 2D resampling, volume transforms and the
plain versions of its kernels (K1 forward, d/dgrid and d/dvolume, K2
forward and backward), held against the JAX package on the same numpy
inputs (CPU).

Tolerances (fp32): 1e-5 for ops, 2e-4 for geometry (camera matrices, crop
boxes, pixel coordinates, which pass through trig and divisions of
quantities near 600). Gradients of the kernels are compared at 1e-5
relative to their largest magnitude (they reach about 30: C-channel sums of
tap differences scaled by size / 2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentfusion_tpu import three as jthree
from latentfusion_tpu import modules as jmodules
from latentfusion_tpu import transforms as jtransforms
from latentfusion_tpu.camera import Camera as JCamera
from latentfusion_tpu.observation import Observation as JObservation
from latentfusion_tpu.ops import affine_resample as jaffine
from latentfusion_tpu.ops.interpolate import interpolate as j_interpolate
from latentfusion_tpu.ops.grid_sample import grid_sample_2d as j_grid_sample_2d
from latentfusion_tpu.ops.pallas_fused_sample import grid_sample_3d_fused as j_fused
from latentfusion_tpu.ops.pallas_lrelu_pnorm import lrelu_pixel_norm_pallas
from latentfusion_tpu.ops.pallas_volume import grid_sample_3d_pallas
from latentfusion_tpu.three import core as jcore
from latentfusion_tpu.three import orientation as jorientation
from latentfusion_tpu.three import quaternion as jquat

from latentfusion_tpu_torch import three as tthree
from latentfusion_tpu_torch import transforms as ttransforms
from latentfusion_tpu_torch.camera import Camera as TCamera
from latentfusion_tpu_torch.observation import Observation as TObservation
from latentfusion_tpu_torch.ops import affine_resample as taffine
from latentfusion_tpu_torch.ops import fused_sample, lrelu_pnorm
from latentfusion_tpu_torch.ops.grid_sample import grid_sample_2d as t_grid_sample_2d
from latentfusion_tpu_torch.ops.interpolate import interpolate as t_interpolate
from latentfusion_tpu_torch.three import orientation as torientation
from latentfusion_tpu_torch.three import quaternion as tquat

OPS_TOL = 1e-5
GEOM_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def close(a, b, tol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=rtol)


def close_rel(a, b, tol):
    """max |a - b| within ``tol`` of the larger of max |b| and 1."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(float(np.abs(b).max()), 1.0)


def unit_quats(rng, n):
    q = rng.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def camera_arrays(rng, n, z=1.5, f=64.0, width=64, height=48):
    K = np.tile(np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                         np.float32)[None], (n, 1, 1))
    t = np.concatenate([rng.uniform(-0.05, 0.05, (n, 2)),
                        rng.uniform(z - 0.1, z + 0.1, (n, 1))], 1).astype(np.float32)
    ext = np.array(jthree.to_extrinsic_matrix(jnp.asarray(t),
                                                jnp.asarray(unit_quats(rng, n))))
    return K, ext


def both_cameras(rng, n, width=64, height=48, **kw):
    K, ext = camera_arrays(rng, n, width=width, height=height, **kw)
    return (JCamera(K, ext, width=width, height=height),
            TCamera(K, ext, width=width, height=height, device="cpu"))


# ------------------------------------------------------------------ three
def test_quaternion_functions_match(rng):
    q = unit_quats(rng, 16)
    q2 = unit_quats(rng, 16)
    tq, tq2 = torch.from_numpy(q), torch.from_numpy(q2)
    close(tquat.quat_to_mat(tq), jquat.quat_to_mat(q), OPS_TOL)
    mats = np.array(jquat.quat_to_mat(q))
    close(tquat.mat_to_quat(torch.from_numpy(mats)), jquat.mat_to_quat(mats), OPS_TOL)
    close(tquat.qmul(tq, tq2), jquat.qmul(q, q2), OPS_TOL)
    close(tquat.qlog(tq), jquat.qlog(q), OPS_TOL)
    v = rng.randn(16, 3).astype(np.float32) * 0.5
    close(tquat.qexp(torch.from_numpy(v)), jquat.qexp(v), OPS_TOL)


def test_quaternion_additions_match(rng):
    q = unit_quats(rng, 8)
    q2 = unit_quats(rng, 5)
    axis = rng.randn(8, 3).astype(np.float32)
    angle = rng.rand(8).astype(np.float32) * 3
    close(tquat.identity(3), jquat.identity(3), 0)
    close(tquat.from_axis_angle(torch.from_numpy(axis), torch.from_numpy(angle)),
          jquat.from_axis_angle(axis, angle), OPS_TOL)
    close(tquat.from_axis_angle(torch.from_numpy(axis), np.pi),
          jquat.from_axis_angle(axis, np.pi), OPS_TOL)
    close(tquat.angular_distance(torch.from_numpy(q), torch.from_numpy(q2)),
          jquat.angular_distance(q, q2), 1e-4)
    pts = rng.randn(2, 7, 3).astype(np.float32)
    mats = np.array(jthree.to_extrinsic_matrix(rng.randn(2, 3).astype(np.float32),
                                               unit_quats(rng, 2)))
    close(tthree.transform_coords(torch.from_numpy(pts), torch.from_numpy(mats)),
          jcore.transform_coords(pts, mats), OPS_TOL)
    close(tthree.transform_coords(torch.from_numpy(pts[0]), torch.from_numpy(mats[:1])),
          jcore.transform_coords(pts[0], mats[:1]), OPS_TOL)


@pytest.mark.parametrize("hemisphere", [False, True])
def test_evenly_distributed_points_match(hemisphere):
    close(torientation.evenly_distributed_points(50, hemisphere),
          jorientation.evenly_distributed_points(50, hemisphere), OPS_TOL)


@pytest.mark.parametrize("upright", [False, True])
def test_evenly_distributed_quats_match_with_the_same_draws(upright):
    """The rolled quaternions from JAX's own draw of ``down`` vectors (the
    two frameworks' random streams differ); upright ones draw nothing."""
    key = jax.random.PRNGKey(3)
    j = jorientation.evenly_distributed_quats(40, upright=upright, key=key)
    rays = torientation.evenly_distributed_points(40)
    if upright:
        t = torientation.evenly_distributed_quats(40, upright=True)
    else:
        down = torch.from_numpy(np.array(jcore.uniform_unit_vector(key, 40)))
        t = torientation.quat_from_rays(-rays, down)
    close(t, j, 1e-4)
    g = torch.Generator().manual_seed(0)
    r = torientation.evenly_distributed_quats(40, generator=g)
    close(torch.linalg.norm(r, dim=1), np.ones(40), 1e-5)


def test_rigid_functions_match(rng):
    q = unit_quats(rng, 8)
    t = rng.randn(8, 3).astype(np.float32)
    ext_j = jthree.to_extrinsic_matrix(t, q)
    ext_t = tthree.to_extrinsic_matrix(torch.from_numpy(t), torch.from_numpy(q))
    close(ext_t, ext_j, OPS_TOL)
    K = rng.randn(8, 3, 3).astype(np.float32)
    close(tthree.intrinsic_to_3x4(torch.from_numpy(K)), jthree.intrinsic_to_3x4(K), 0)


def test_random_quaternions_seeded_unit_and_uniform():
    """PRNG streams differ between frameworks, so the sampler is held to its
    properties: unit norm, reproducible from a seed, and a uniform rotation
    distribution (E[w^2] = 1/4 for each component of a Haar quaternion)."""
    g = torch.Generator().manual_seed(7)
    q = tquat.random(4096, g)
    q2 = tquat.random(4096, torch.Generator().manual_seed(7))
    assert q.shape == (4096, 4)
    close(q, q2, 0)
    close(torch.linalg.norm(q, dim=1), np.ones(4096), 1e-5)
    close((q ** 2).mean(0), np.full(4, 0.25), 0.02)


# ----------------------------------------------------------------- camera
def test_camera_pose_and_matrices_match(rng):
    jc, tc = both_cameras(rng, 6)
    close(tc.log_quaternion, jc.log_quaternion, GEOM_TOL)
    close(tc.translation, jc.translation, GEOM_TOL)
    close(tc.extrinsic, jc.extrinsic, GEOM_TOL)
    close(tc.obj_to_cam, jc.obj_to_cam, GEOM_TOL)
    close(tc.cam_to_obj, jc.cam_to_obj, GEOM_TOL)
    close(tc.position, jc.position, GEOM_TOL)
    close(tc.znear, jc.znear, GEOM_TOL)
    close(tc.zfar, jc.zfar, GEOM_TOL)
    close(tc.viewport, jc.viewport, 0)


def test_camera_edits_and_containers_match(rng):
    """translate keeps the JAX package's sign fix: the new camera centre is
    position + offset."""
    jc, tc = both_cameras(rng, 4)
    jc2, tc2 = both_cameras(rng, 2)
    off = np.array([0.1, -0.2, 0.3], np.float32)
    close(tc.translate(off).translation, jc.translate(off).translation, GEOM_TOL)
    close(tc.translate(off).position, tc.position + torch.from_numpy(off), GEOM_TOL)
    close(TCamera.cat([tc, tc2]).extrinsic, JCamera.cat([jc, jc2]).extrinsic,
          GEOM_TOL)
    close(tc.repeat(3).translation, jc.repeat(3).translation, GEOM_TOL)
    assert len(TCamera.cat([tc, tc2])) == 6 and len(tc.repeat(3)) == 12


def test_camera_replace_rotate_index_match(rng):
    jc, tc = both_cameras(rng, 4)
    q = unit_quats(rng, 4)
    close(tc.rotate(torch.from_numpy(q)).extrinsic, jc.rotate(q).extrinsic, GEOM_TOL)
    close(tc[1:3].translation, jc[1:3].translation, GEOM_TOL)
    close(tc[-1].extrinsic, jc[-1].extrinsic, GEOM_TOL)
    close(tc[2].obj_to_image, jc[2].obj_to_image, GEOM_TOL)
    t = rng.randn(4, 3).astype(np.float32)
    close(tc.replace(translation=torch.from_numpy(t)).extrinsic,
          jc.replace(translation=t).extrinsic, GEOM_TOL)
    for a, b in zip(tc.pixel_coords_uv((5, 7)), jc.pixel_coords_uv((5, 7))):
        close(a, b, GEOM_TOL)
    with pytest.raises(TypeError):
        tc.replace(extrinsic=None)


def test_camera_keeps_the_graph_of_pose_leaves(rng):
    """Constructing, replacing, zooming and rotating keep pose leaves that
    require a gradient in the graph: nothing re-wraps them."""
    _, tc = both_cameras(rng, 2)
    lq = tc.log_quaternion.clone().requires_grad_()
    t = tc.translation.clone().requires_grad_()
    vp = tc.viewport.clone().requires_grad_()
    cam = TCamera(tc.intrinsic, None, 0.5, vp, width=64, height=48,
                  log_quaternion=lq, translation=t, device="cpu")
    assert cam.log_quaternion is lq and cam.translation is t and cam.viewport is vp
    cam = cam.replace(translation=t * 1.0).rotate(tquat.identity(2))
    loss = (ttransforms.object_to_camera_grid(cam, 4).sum()
            + cam.zoom(None, 16, 1.5).viewport.sum())
    grads = torch.autograd.grad(loss, (lq, t, vp))
    assert all(float(g.abs().sum()) > 0 for g in grads)


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_camera_zoom_and_uncrop_match(rng, mode):
    jc, tc = both_cameras(rng, 3)
    image = rng.rand(3, 2, 48, 64).astype(np.float32)
    zj, jcz = jc.zoom(image, 16, 1.5, scale_mode=mode)
    zt, tcz = tc.zoom(torch.from_numpy(image), 16, 1.5, scale_mode=mode)
    close(tcz.viewport, jcz.viewport, GEOM_TOL)
    close(zt, zj, OPS_TOL)
    uj, jcu = jcz.uncrop(zj, scale_mode=mode)
    ut, tcu = tcz.uncrop(zt, scale_mode=mode)
    close(tcu.viewport, jcu.viewport, 0)
    close(ut, uj, OPS_TOL)
    close(tc.zoom(None, 16, 1.5).viewport, jc.zoom(None, 16, 1.5).viewport, GEOM_TOL)


def test_camera_coords_and_depth_window_match(rng):
    jc, tc = both_cameras(rng, 2)
    jcz, tcz = jc.zoom(None, 16, 1.5), tc.zoom(None, 16, 1.5)
    for a, b in zip(tcz.camera_coords(8), jcz.camera_coords(8)):
        close(a, b, GEOM_TOL)
    depth = (1.5 + 0.3 * rng.randn(2, 1, 16, 16)).astype(np.float32)
    nd_t = tcz.normalize_depth(torch.from_numpy(depth))
    close(nd_t, jcz.normalize_depth(depth), OPS_TOL)
    close(tcz.denormalize_depth(nd_t), jcz.denormalize_depth(np.asarray(nd_t)),
          OPS_TOL)


# ------------------------------------------------------------- 2D resample
@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_separable_resample_matches(rng, mode, padding_mode):
    image = rng.rand(2, 3, 12, 10).astype(np.float32)
    src_y = (rng.rand(2, 7) * 14 - 2).astype(np.float32)
    src_x = (rng.rand(2, 9) * 12 - 2).astype(np.float32)
    out_t = taffine.separable_resample_2d(torch.from_numpy(image),
                                          torch.from_numpy(src_y),
                                          torch.from_numpy(src_x), mode,
                                          padding_mode)
    close(out_t, jaffine.separable_resample_2d(image, src_y, src_x, mode,
                                               padding_mode), OPS_TOL)


def test_bbox_source_coords_truncate_corners(rng):
    boxes = (rng.rand(4, 4) * 100 - 20).astype(np.float32)
    for trunc in (True, False):
        ys_t, xs_t = taffine.bbox_source_coords(torch.from_numpy(boxes), 16, trunc)
        ys_j, xs_j = jaffine.bbox_source_coords(boxes, 16, trunc)
        close(ys_t, ys_j, GEOM_TOL)
        close(xs_t, xs_j, GEOM_TOL)


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_grid_sample_2d_matches(rng, mode, padding_mode):
    image = rng.randn(2, 3, 9, 11).astype(np.float32)
    grid = (rng.rand(2, 5, 6, 2) * 2.4 - 1.2).astype(np.float32)
    out_t = t_grid_sample_2d(torch.from_numpy(image), torch.from_numpy(grid),
                             mode, padding_mode)
    close(out_t, j_grid_sample_2d(image, grid, mode, padding_mode), OPS_TOL)


@pytest.mark.parametrize("shape,scale,mode", [
    ((2, 3, 8, 8), 2.0, "nearest"), ((2, 3, 8, 8), 0.5, "nearest"),
    ((2, 3, 8, 8), 2.0, "bilinear"), ((2, 3, 8, 8), 0.5, "bilinear"),
    ((1, 2, 4, 6, 8), 2.0, "trilinear"), ((1, 2, 4, 6, 8), 0.5, "nearest"),
    # The flagship decoder's 2x upsamples: 4^2 -> 8^2 at 512 channels, and
    # the 196-channel block at 32^2.
    ((2, 512, 4, 4), 2.0, "bilinear"), ((2, 196, 32, 32), 2.0, "bilinear"),
    ((1, 3, 7, 10), 1.5, "bilinear"), ((1, 2, 3, 5, 4), 1.5, "trilinear"),
])
def test_interpolate_matches(rng, shape, scale, mode):
    """Forward, and backward (autograd against ``jax.vjp``, relative to the
    largest gradient)."""
    x = rng.randn(*shape).astype(np.float32)
    x_t = torch.from_numpy(x).requires_grad_()
    y_t = t_interpolate(x_t, scale_factor=scale, mode=mode)
    y_j, vjp = jax.vjp(lambda a: j_interpolate(a, scale_factor=scale, mode=mode), x)
    close(y_t.detach(), y_j, OPS_TOL)
    g = rng.randn(*y_j.shape).astype(np.float32)
    dx_t, = torch.autograd.grad(y_t, x_t, torch.from_numpy(g))
    close_rel(dx_t, vjp(g)[0], OPS_TOL)


# ------------------------------------------------------------ observation
def test_observation_preprocessing_matches(rng):
    K, ext = camera_arrays(rng, 3)
    color = rng.rand(3, 3, 48, 64).astype(np.float32)
    depth = (1.5 + 0.05 * rng.rand(3, 1, 48, 64)).astype(np.float32)
    mask = (rng.rand(3, 1, 48, 64) > 0.5).astype(np.float32)
    jo = JObservation(color, depth, mask, JCamera(K, ext, width=64, height=48))
    to = TObservation(color, depth, mask,
                      TCamera(K, ext, width=64, height=48, device="cpu"))
    jo = jo.zoom(1.5, 16).prepare().normalize()
    to = to.zoom(1.5, 16).prepare().normalize()
    assert all(to.meta[k] for k in ("is_zoomed", "is_prepared", "is_normalized"))
    close(to.color, jo.color, OPS_TOL)
    close(to.mask, jo.mask, 0)
    close(to.depth, jo.depth, GEOM_TOL)
    d = {"color": color, "depth": depth[:, 0], "mask": mask[:, 0],
         "intrinsic": K, "extrinsic": ext}
    close(TObservation.from_dict(d, device="cpu").depth,
          JObservation.from_dict(d).depth, 0)
    both = TObservation.collate([to, to])
    assert len(both) == 6 and both.meta["is_normalized"]
    close(both.color[3:], to.color, 0)


# ------------------------------------------------------- volume transforms
@pytest.mark.parametrize("backend", ["hopper", "torch"])
def test_volume_transforms_match(rng, backend):
    """camera_to_object / object_to_camera vs JAX (gather backend): the
    grid conventions (half-range z, border padding) and a shared latent."""
    jc, tc = both_cameras(rng, 3)
    jc, tc = jc.zoom(None, 16, 1.5), tc.zoom(None, 16, 1.5)
    cam_vol = rng.randn(3, 4, 8, 8, 8).astype(np.float32)
    obj_vol = rng.randn(1, 4, 8, 8, 8).astype(np.float32)
    prev = jtransforms.get_volume_sample_backend()
    jtransforms.set_volume_sample_backend("gather")
    try:
        j_c2o = jtransforms.camera_to_object(cam_vol, jc)
        j_o2c = jtransforms.object_to_camera(obj_vol, jc)
    finally:
        jtransforms.set_volume_sample_backend(prev)
    with ttransforms.volume_sample_backend(backend):
        t_c2o = ttransforms.camera_to_object(torch.from_numpy(cam_vol), tc)
        t_o2c = ttransforms.object_to_camera(torch.from_numpy(obj_vol), tc)
    close(t_c2o, j_c2o, GEOM_TOL)
    close(t_o2c, j_o2c, GEOM_TOL)


# ------------------------------------------------------- K1 plain version
def _k1_inputs(rng, nv, n, c=16, s=(8, 8, 8), k=(8, 8, 8), spread=2.4):
    vol = rng.randn(nv, c, *s).astype(np.float32)
    grid = (rng.rand(n, *k, 3) * spread - spread / 2).astype(np.float32)
    return vol, grid


def _k1_plain(vol, grid, padding_mode):
    return fused_sample.grid_sample_3d_plain(torch.from_numpy(vol),
                                             torch.from_numpy(grid), padding_mode)


def _jax_gather(vol, grid, padding_mode):
    prev = jtransforms.get_volume_sample_backend()
    jtransforms.set_volume_sample_backend("gather")
    try:
        return jtransforms._volume_sample(jnp.asarray(vol), jnp.asarray(grid),
                                          padding_mode)
    finally:
        jtransforms.set_volume_sample_backend(prev)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("case", ["batched", "k_padding", "shared_batch1",
                                  "shared_groups"])
def test_k1_plain_matches_pallas_interpret_and_gather(rng, padding_mode, case):
    """K1's plain version vs the Pallas kernel (interpret mode) and the
    gather backend, over the cases of tests/test_fused_sample.py: both
    paddings, K not a multiple of the tile, a shared volume with batch 1
    and with groups (NV | N)."""
    nv, n, k = {"batched": (2, 2, (8, 8, 8)), "k_padding": (1, 1, (5, 7, 9)),
                "shared_batch1": (1, 4, (8, 8, 8)),
                "shared_groups": (2, 6, (4, 4, 4))}[case]
    vol, grid = _k1_inputs(rng, nv, n, k=k)
    out = _k1_plain(vol, grid, padding_mode)
    assert out.shape == (n, 16, *k)
    close(out, j_fused(jnp.asarray(vol), jnp.asarray(grid), padding_mode=padding_mode),
          OPS_TOL)
    close(out, _jax_gather(vol, grid, padding_mode), OPS_TOL)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_k1_plain_non_cubic_matches_torch_grid_sample(rng, padding_mode):
    """Axis order on a (D, H, W) = (4, 6, 5) volume, against
    F.grid_sample and the JAX gather backend."""
    vol, grid = _k1_inputs(rng, 2, 2, c=3, s=(4, 6, 5), k=(3, 5, 7))
    out = _k1_plain(vol, grid, padding_mode)
    ref = torch.nn.functional.grid_sample(
        torch.from_numpy(vol), torch.from_numpy(grid), mode="bilinear",
        padding_mode=padding_mode, align_corners=False)
    close(out, ref, OPS_TOL)
    close(out, _jax_gather(vol, grid, padding_mode), OPS_TOL)


def test_k1_plain_bf16_rounds_once(rng):
    vol, grid = _k1_inputs(rng, 1, 2)
    v = torch.from_numpy(vol).bfloat16()
    out = fused_sample.grid_sample_3d_plain(v, torch.from_numpy(grid), "border",
                                            out_dtype=torch.bfloat16)
    ref = fused_sample.grid_sample_3d_plain(v.float(), torch.from_numpy(grid),
                                            "border").bfloat16()
    assert out.dtype == torch.bfloat16
    close(out.float(), ref.float(), 0)


def test_k1_wrapper_on_cpu_is_the_plain_version(rng):
    vol, grid = _k1_inputs(rng, 1, 3)
    before = fused_sample.LAUNCHES
    out = fused_sample.grid_sample_3d_fused(torch.from_numpy(vol),
                                            torch.from_numpy(grid), "zeros")
    close(out, _k1_plain(vol, grid, "zeros"), 0)
    assert fused_sample.LAUNCHES == before
    with pytest.raises(ValueError):
        fused_sample.grid_sample_3d_fused(torch.from_numpy(vol[:, :1].repeat(2, 0)),
                                          torch.from_numpy(grid), "zeros")


# ------------------------------------------------------- K2 plain version
@pytest.mark.parametrize("shape", [(2, 196, 4, 4, 4), (4, 128, 8, 8), (3, 64, 16)])
def test_k2_plain_matches_pallas_interpret_and_jnp(rng, shape):
    """K2's plain version (channel dim 1) vs the Pallas kernel in interpret
    mode (channels last) and the jnp version, C=196 included."""
    x = rng.randn(*shape).astype(np.float32)
    y, inv = lrelu_pnorm.lrelu_pixel_norm_plain(torch.from_numpy(x), 0.2, 1e-8)
    x_cl = np.moveaxis(x, 1, -1)
    y_pallas = np.moveaxis(np.asarray(
        lrelu_pixel_norm_pallas(jnp.asarray(x_cl), 0.2, 1e-8, True)), -1, 1)
    y_jnp = jmodules._lrelu_pixel_norm_jnp(jnp.asarray(x), 0.2, 1e-8, 1)
    close(y, y_pallas, OPS_TOL)
    close(y, y_jnp, OPS_TOL)
    u = np.where(x >= 0, x, 0.2 * x)
    close(inv, 1.0 / np.sqrt((u * u).mean(1) + 1e-8), OPS_TOL, rtol=1e-5)


def test_k2_wrapper_on_cpu_is_the_plain_version(rng):
    x = torch.from_numpy(rng.randn(2, 196, 3, 3).astype(np.float32))
    before = lrelu_pnorm.LAUNCHES
    y, _ = lrelu_pnorm.lrelu_pixel_norm_fwd(x, 0.2, 1e-8)
    close(y, lrelu_pnorm.lrelu_pixel_norm_plain(x, 0.2, 1e-8)[0], 0)
    assert lrelu_pnorm.LAUNCHES == before
    yb, _ = lrelu_pnorm.lrelu_pixel_norm_fwd(x.bfloat16(), 0.2, 1e-8)
    assert yb.dtype == torch.bfloat16


# ---------------------------------------------------- K1-bwd-grid plain
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("case", ["batched", "k_padding", "shared_batch1",
                                  "shared_groups"])
def test_k1_bwd_grid_plain_matches_pallas_vjp_and_autograd(rng, padding_mode, case):
    """d/dgrid with the volume held fixed: the plain version of K1-bwd-grid
    against jax.vjp of the Pallas kernel (interpret mode) and against torch
    autograd of the plain forward, over the forward's cases."""
    nv, n, k = {"batched": (2, 2, (8, 8, 8)), "k_padding": (1, 1, (5, 7, 9)),
                "shared_batch1": (1, 4, (8, 8, 8)),
                "shared_groups": (2, 6, (4, 4, 4))}[case]
    vol, grid = _k1_inputs(rng, nv, n, k=k)
    g = rng.randn(n, 16, *k).astype(np.float32)
    out = fused_sample.grid_sample_3d_bwd_grid_plain(
        torch.from_numpy(vol), torch.from_numpy(grid), torch.from_numpy(g), padding_mode)
    assert out.shape == grid.shape and out.dtype == torch.float32
    _, vjp = jax.vjp(lambda gr: j_fused(jnp.asarray(vol), gr, padding_mode=padding_mode),
                     jnp.asarray(grid))
    close_rel(out, vjp(jnp.asarray(g))[0], OPS_TOL)
    grid_t = torch.from_numpy(grid).requires_grad_()
    fwd = fused_sample.grid_sample_3d_plain(torch.from_numpy(vol), grid_t, padding_mode)
    close_rel(out, torch.autograd.grad(fwd, grid_t, torch.from_numpy(g))[0], OPS_TOL)


# The staged K1-bwd-grid kernel's launch plan: the flagship refinement
# decode (8 hypotheses, 16^3 samples, one 256-channel 16^3 latent), K3's
# shape (4 unshared 64-channel 32^3 volumes), the demo refinement decode (16
# hypotheses, 8^3 samples of a 128-channel 8^3 latent), and small calls
# whose C is not a multiple of the 8-channel chunk.
PLAN_CASES = {"refine": ((1, 256, 16, 16, 16), 8, 4096),
              "k3": ((4, 64, 32, 32, 32), 4, 32768),
              "demo_refine": ((1, 128, 8, 8, 8), 16, 512),
              "c20_groups": ((2, 20, 5, 7, 9), 6, 120),
              "c3_narrow": ((1, 3, 38, 38, 38), 2, 512),
              "c250_refine": ((1, 250, 16, 16, 16), 8, 4096)}


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_k1_bwd_grid_plan_covers_every_channel_once(case):
    """The groups cover channels 0..C-1 once, in order, each of whole
    chunks but the last; the tiles fit a block (8 samples a thread)."""
    shape, n, k = PLAN_CASES[case]
    plan = fused_sample.bwd_grid_plan(shape, n, k)
    ranges = plan.channel_ranges(shape[1])
    assert len(ranges) == plan.groups
    covered = [ch for start, stop in ranges for ch in range(start, stop)]
    assert covered == list(range(shape[1]))
    assert all(stop - start == plan.group_channels for start, stop in ranges[:-1])
    assert plan.group_channels % plan.chunk == 0
    assert plan.chunk == (8 if shape[2] * shape[3] * shape[4] <= 7264 else 1)
    assert 1 <= plan.tile <= 4096
    tiles = shape[0] * -(-(n // shape[0] * k) // plan.tile)
    assert plan.blocks == tiles * plan.groups


@pytest.mark.parametrize("case", ["refine", "k3"])
def test_k1_bwd_grid_plan_fills_one_wave(case):
    """At the main path's shape (one volume, 32768 samples) and at K3's,
    the tiles are as long as a block holds and the channel groups fill one
    wave of the H100's 132 SMs as far as whole groups allow, with partial
    sums of at most a fifth of the bytes of g."""
    shape, n, k = PLAN_CASES[case]
    plan = fused_sample.bwd_grid_plan(shape, n, k)
    tiles = plan.blocks // plan.groups
    assert plan.tile == 4096 and tiles == n * k // 4096
    assert plan.blocks <= 132 < plan.blocks + tiles
    assert plan.groups * n * k * 3 <= 0.2 * n * shape[1] * k


@pytest.mark.parametrize("dhw", [(16, 16, 16), (32, 32, 32), (38, 38, 38), (39, 39, 39),
                                 (48, 48, 48), (8, 64, 113), (8, 64, 114), (1, 1, 58112),
                                 (1, 1, 58113)])
def test_k1_bwd_grid_per_sample_kernel_where_a_channel_exceeds_shared_memory(dhw):
    """The per-sample kernel serves exactly the volumes whose channel, 4
    bytes a voxel with the voxels rounded up to 32, exceeds the 227 KB
    (232448 bytes) of shared memory a block may use; the plan refuses
    them."""
    shape = (1, 8, *dhw)
    voxels = -(-dhw[0] * dhw[1] * dhw[2] // 32) * 32
    per_sample = voxels * 4 > 232448
    assert fused_sample.bwd_grid_kernel(shape) == ("per_sample" if per_sample else "staged")
    assert fused_sample.fwd_kernel(shape) == ("gather" if per_sample else "staged")
    if per_sample:
        with pytest.raises(ValueError, match="shared memory"):
            fused_sample.bwd_grid_plan(shape, 2, 512)
    else:
        assert fused_sample.bwd_grid_plan(shape, 2, 512).groups >= 1


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("nv,n,c,s,k", [(1, 4, 20, (8, 8, 8), (8, 8, 8)),
                                        (2, 6, 20, (5, 7, 9), (4, 5, 6)),
                                        (1, 2, 3, (38, 38, 38), (4, 4, 4))],
                         ids=["shared_c20", "groups_noncubic", "narrow_chunks"])
def test_k1_bwd_grid_plan_group_sums_match_pallas_vjp(rng, padding_mode, nv, n, c, s, k):
    """The staged kernel's arithmetic order across channels: the plain
    d/dgrid of each of the plan's channel groups, added in the plan's
    order, against jax.vjp of the Pallas kernel (interpret mode)."""
    vol, grid = _k1_inputs(rng, nv, n, c=c, s=s, k=k)
    g = rng.randn(n, c, *k).astype(np.float32)
    plan = fused_sample.bwd_grid_plan(vol.shape, n, int(np.prod(k)))
    assert plan.groups > 1
    out = None
    for start, stop in plan.channel_ranges(c):
        part = fused_sample.grid_sample_3d_bwd_grid_plain(
            torch.from_numpy(np.ascontiguousarray(vol[:, start:stop])), torch.from_numpy(grid),
            torch.from_numpy(np.ascontiguousarray(g[:, start:stop])), padding_mode)
        out = part if out is None else out + part
    _, vjp = jax.vjp(lambda gr: j_fused(jnp.asarray(vol), gr, padding_mode=padding_mode),
                     jnp.asarray(grid))
    close_rel(out, vjp(jnp.asarray(g))[0], OPS_TOL)


def test_k1_function_backward_on_cpu(rng):
    """grid_sample_3d (the autograd Function) on CPU: its gradients are the
    plain K1-bwd-grid and K1-bwd-vol, each only where asked for, and no
    kernel is counted."""
    vol, grid = _k1_inputs(rng, 1, 3, k=(4, 5, 6))
    grid_t = torch.from_numpy(grid).requires_grad_()
    counters = ("LAUNCHES", "BWD_GRID_LAUNCHES", "BWD_VOL_LAUNCHES")
    before = [getattr(fused_sample, c) for c in counters]
    out = fused_sample.grid_sample_3d(torch.from_numpy(vol), grid_t, "border")
    g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32))
    dgrid, = torch.autograd.grad(out, grid_t, g)
    close(dgrid, fused_sample.grid_sample_3d_bwd_grid_plain(
        torch.from_numpy(vol), grid_t.detach(), g, "border"), 0)
    vol_t = torch.from_numpy(vol).requires_grad_()
    out = fused_sample.grid_sample_3d(vol_t, grid_t, "zeros")
    dvol, dgrid = torch.autograd.grad(out, (vol_t, grid_t), g)
    close(dvol, fused_sample.grid_sample_3d_bwd_vol_plain(
        grid_t.detach(), g, vol.shape, "zeros"), 0)
    close(dgrid, fused_sample.grid_sample_3d_bwd_grid_plain(
        torch.from_numpy(vol), grid_t.detach(), g, "zeros"), 0)
    assert [getattr(fused_sample, c) for c in counters] == before


# ----------------------------------------------------- K1-bwd-vol plain
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("nv,n", [(1, 4), (2, 4), (3, 3)],
                         ids=["shared_batch1", "shared_groups", "unshared"])
def test_k1_bwd_vol_plain_matches_pallas_vjp_and_autograd(rng, padding_mode, nv, n):
    """d/dvolume with the grid held fixed, C=128, 8^3 volumes, grids
    reaching outside [-1, 1]: the plain K1-bwd-vol against jax.vjp of the
    Pallas kernel (interpret mode), torch autograd of the plain forward, and
    autograd of F.grid_sample on the volume repeated to N, summed over each
    volume's group. Covers NV = 1 and 1 < NV < N (the shared-volume cases
    of tests/test_fused_sample.py) and NV = N."""
    vol, grid = _k1_inputs(rng, nv, n, c=128)
    g = rng.randn(n, 128, 8, 8, 8).astype(np.float32)
    out = fused_sample.grid_sample_3d_bwd_vol_plain(
        torch.from_numpy(grid), torch.from_numpy(g), vol.shape, padding_mode)
    assert out.shape == vol.shape and out.dtype == torch.float32
    _, vjp = jax.vjp(lambda v: j_fused(v, jnp.asarray(grid), padding_mode=padding_mode),
                     jnp.asarray(vol))
    close_rel(out, vjp(jnp.asarray(g))[0], OPS_TOL)
    vol_t = torch.from_numpy(vol).requires_grad_()
    fwd = fused_sample.grid_sample_3d_plain(vol_t, torch.from_numpy(grid), padding_mode)
    close_rel(out, torch.autograd.grad(fwd, vol_t, torch.from_numpy(g))[0], OPS_TOL)
    vol_n = torch.from_numpy(vol).repeat_interleave(n // nv, 0).requires_grad_()
    fwd = torch.nn.functional.grid_sample(vol_n, torch.from_numpy(grid), mode="bilinear",
                                          padding_mode=padding_mode, align_corners=False)
    d_n, = torch.autograd.grad(fwd, vol_n, torch.from_numpy(g))
    close_rel(out, d_n.reshape(nv, n // nv, *vol.shape[1:]).sum(1), OPS_TOL)


def test_k1_bwd_vol_wrapper_on_cpu_is_the_plain_version(rng):
    vol, grid = _k1_inputs(rng, 2, 4)
    g = torch.from_numpy(rng.randn(4, 16, 8, 8, 8).astype(np.float32))
    before = fused_sample.BWD_VOL_LAUNCHES
    out = fused_sample.grid_sample_3d_bwd_vol(torch.from_numpy(grid), g, vol.shape, "border")
    close(out, fused_sample.grid_sample_3d_bwd_vol_plain(
        torch.from_numpy(grid), g, vol.shape, "border"), 0)
    assert fused_sample.BWD_VOL_LAUNCHES == before
    with pytest.raises(ValueError, match="does not match"):
        fused_sample.grid_sample_3d_bwd_vol(torch.from_numpy(grid), g[:, :8], vol.shape)
    with pytest.raises(ValueError, match="must divide"):
        fused_sample.grid_sample_3d_bwd_vol(torch.from_numpy(grid), g, (3, *vol.shape[1:]))


# ------------------------------------------- K3's shapes served by K1
K3_CASES = {
    # tests/test_pallas_volume.py:13, :22, :31 and :43, then one volume
    # over 17^3, where the JAX package leaves K1 for K3 on a TPU.
    "matches_gather": ((2, 4, 8, 8, 8), (2, 6, 6, 6), 2.4),
    "large_volume_blocks": ((1, 2, 16, 16, 16), (1, 4, 4, 4), 2.0),
    "gradients": ((1, 2, 8, 8, 8), (1, 3, 3, 3), 1.6),
    "vjp": ((2, 3, 8, 6, 10), (2, 4, 3, 5), 2.4),
    "over_17": ((1, 4, 20, 20, 20), (1, 6, 6, 6), 2.4),
}


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("case", list(K3_CASES))
def test_k1_plain_serves_k3_pallas_volume(rng, padding_mode, case):
    """K3 (the tiled sampler of ops/pallas_volume.py, interpret mode) takes
    unshared volumes (NV = N) of any size; the port serves its shapes with
    K1. The plain K1 forward, d/dgrid and d/dvolume against K3's forward
    and its jax.vjp."""
    vol_shape, grid_shape, spread = K3_CASES[case]
    vol = rng.randn(*vol_shape).astype(np.float32)
    grid = (rng.rand(*grid_shape, 3) * spread - spread / 2).astype(np.float32)
    out_j, vjp = jax.vjp(lambda v, gr: grid_sample_3d_pallas(v, gr, padding_mode),
                         jnp.asarray(vol), jnp.asarray(grid))
    g = rng.randn(*out_j.shape).astype(np.float32)
    dvol_j, dgrid_j = vjp(jnp.asarray(g))
    vol_t, grid_t, g_t = torch.from_numpy(vol), torch.from_numpy(grid), torch.from_numpy(g)
    close_rel(fused_sample.grid_sample_3d_plain(vol_t, grid_t, padding_mode), out_j, OPS_TOL)
    close_rel(fused_sample.grid_sample_3d_bwd_vol_plain(grid_t, g_t, vol.shape, padding_mode),
              dvol_j, OPS_TOL)
    close_rel(fused_sample.grid_sample_3d_bwd_grid_plain(vol_t, grid_t, g_t, padding_mode),
              dgrid_j, OPS_TOL)


# -------------------------------------------------------- K2-bwd plain
@pytest.mark.parametrize("shape", [(2, 196, 4, 4, 4), (4, 128, 8, 8), (3, 64, 16)])
def test_k2_bwd_plain_matches_pallas_and_jnp_vjp(rng, shape):
    """K2-bwd's plain version (channel dim 1) against jax.vjp of the Pallas
    kernel in interpret mode (channels last) and of the jnp custom VJP,
    C=196 included."""
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    _, inv = lrelu_pnorm.lrelu_pixel_norm_plain(torch.from_numpy(x), 0.2, 1e-8)
    dx = lrelu_pnorm.lrelu_pixel_norm_bwd_plain(torch.from_numpy(x), inv,
                                                torch.from_numpy(g), 0.2)
    _, vjp = jax.vjp(lambda v: lrelu_pixel_norm_pallas(v, 0.2, 1e-8, True),
                     jnp.asarray(np.moveaxis(x, 1, -1)))
    close_rel(dx, np.moveaxis(np.asarray(vjp(jnp.asarray(np.moveaxis(g, 1, -1)))[0]),
                              -1, 1), OPS_TOL)
    _, vjp = jax.vjp(lambda v: jmodules._lrelu_pixel_norm_jnp(v, 0.2, 1e-8, 1),
                     jnp.asarray(x))
    close_rel(dx, vjp(jnp.asarray(g))[0], OPS_TOL)


def test_k2_function_backward_on_cpu(rng):
    """lrelu_pixel_norm (the autograd Function) on CPU: the plain K2-bwd,
    equal to autograd of the plain forward, no kernel counted."""
    x = torch.from_numpy(rng.randn(2, 196, 3, 3).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.randn(2, 196, 3, 3).astype(np.float32))
    before = (lrelu_pnorm.LAUNCHES, lrelu_pnorm.BWD_LAUNCHES)
    dx, = torch.autograd.grad(lrelu_pnorm.lrelu_pixel_norm(x, 0.2, 1e-8), x, g)
    ref, = torch.autograd.grad(lrelu_pnorm.lrelu_pixel_norm_plain(x, 0.2, 1e-8)[0], x, g)
    close_rel(dx, ref, OPS_TOL)
    assert (lrelu_pnorm.LAUNCHES, lrelu_pnorm.BWD_LAUNCHES) == before
