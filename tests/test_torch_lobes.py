"""The port's multi-lobe objects (the unseen-object rig's oracle,
``latentfusion_tpu_torch/testing.py``) held against the JAX package on the
CPU: the pools, the render and its color, the camera gradient through the
render, ``MultiLobeOracleModel``; the cases of tests/test_lobe_shapes.py
on the port (all but the mesh one, which waits for ``meshutils``); and the
render at the committed reference cameras.

The ray-lobe quadratic cancels: the camera stands about 20 lobe radii away,
so b² and 4ac agree in their leading digits and the discriminant keeps few
of fp32's bits. The JAX package's own jitted and eager renders of one
camera part by up to 2.4e-4 of the largest depth. So depth, the mask's
logits and the color are held to JAX's jitted render within 3 times that
floor, measured on the same input (``floor``), and at least 1e-5 of the
largest value; the hard mask may flip only where JAX's discriminant is
within 3 floors of 0. ``lobe_shape_color`` from JAX's own depth, mask and
lobe one-hot is held at 1e-5.
"""
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from latentfusion_tpu import testing as jtesting
from latentfusion_tpu.camera import Camera as JCamera
from latentfusion_tpu.three import quaternion as jquat

from latentfusion_tpu_torch import testing as ttesting
from latentfusion_tpu_torch import unseen_eval
from latentfusion_tpu_torch.camera import Camera as TCamera
from latentfusion_tpu_torch.three import quaternion as tquat

OPS_TOL = 1e-5
GEOM_TOL = 2e-4
FLOOR_FACTOR = 3.0
SUMS_TOL = 1e-3  # a view's depth and color sums, relative; its mask count, of its pixels
FRAMES = Path(__file__).resolve().parents[1] / "artifacts" / "serving" / "frames"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(x):
    return torch.from_numpy(np.array(x))


def t_camera(jc: JCamera) -> TCamera:
    return TCamera(t(jc.intrinsic), None, jc.z_span, t(jc.viewport), width=jc.width,
                   height=jc.height, log_quaternion=t(jc.log_quaternion),
                   translation=t(jc.translation), device="cpu")


@pytest.fixture(scope="module")
def pools():
    return (jtesting.sample_lobe_shapes(0, 4, diameter=1.0, n_points=256),
            ttesting.sample_lobe_shapes(0, 4, diameter=1.0, n_points=256, device="cpu"))


def _camera(n=2, key=1, width=160, height=120):
    return jtesting.make_camera(n, z=5.78, f=615.0, width=width, height=height,
                                quats=jquat.random(jax.random.PRNGKey(key), n))


def _renders(jcam, k, pools):
    """JAX's jitted and eager renders and the port's of object ``k`` of
    the seed-0 pool, each (depth, mask, logits, one-hot, color)."""
    (jpool, _), (tpool, _) = pools
    js, ts = jtesting.index_lobe_shape(jpool, k), ttesting.index_lobe_shape(tpool, k)

    def jrender(c):
        d, m, ml, oh = jtesting.render_lobe_shape(c, js)
        return d, m, ml, oh, jtesting.lobe_shape_color(c, d, m, oh, js)

    tcam = t_camera(jcam)
    d, m, ml, oh = ttesting.render_lobe_shape(tcam, ts)
    port = (d, m, ml, oh, ttesting.lobe_shape_color(tcam, d, m, oh, ts))
    as_np = lambda xs: [np.asarray(x) for x in xs]
    return as_np(jax.jit(jrender)(jcam)), as_np(jrender(jcam)), as_np(port)


def _hold(port, jit, eager):
    """Port against JAX's jitted render, within ``FLOOR_FACTOR`` times the
    jitted-vs-eager spread and at least OPS_TOL of the largest value, on
    the pixels all three call a hit on the same lobe; the hard mask may flip
    only where JAX's discriminant is within that of 0."""
    (pd, pm, pl, po, pc), (jd, jm, jl, jo, jc), (ed, em, el, eo, ec) = port, jit, eager
    same = ((pm == jm) & (jm == em))[:, 0] & (po == jo).all(-1) & (jo == eo).all(-1)
    hit = same & (jm[:, 0] > 0)
    for name, p, j, e, where in (("depth", pd[:, 0], jd[:, 0], ed[:, 0], hit),
                                 ("logits", pl[:, 0], jl[:, 0], el[:, 0], same),
                                 ("color", pc, jc, ec, hit[:, None])):
        where = np.broadcast_to(where, p.shape)
        floor = np.abs(e - j)[where].max(initial=0.0)
        tol = max(FLOOR_FACTOR * floor, OPS_TOL * np.abs(j).max())
        err = np.abs(p - j)[where].max(initial=0.0)
        assert err <= tol, (name, err, floor)
    logit_floor = np.abs(el - jl)[same[:, None]].max(initial=0.0)
    flips = (pm != jm)[:, 0]
    assert (np.abs(jl[:, 0][flips]) <= FLOOR_FACTOR * max(logit_floor, OPS_TOL * 400)).all()
    assert flips.mean() < 1e-3


@pytest.mark.parametrize("seed", [0, 7919])
def test_pools_are_jax_bits(seed):
    jpool, jclouds = jtesting.sample_lobe_shapes(seed, 4)
    tpool, tclouds = ttesting.sample_lobe_shapes(seed, 4, device="cpu")
    assert set(tpool) == set(jpool)
    for k in jpool:
        assert tpool[k].dtype == torch.float32
        np.testing.assert_array_equal(tpool[k].numpy(), np.asarray(jpool[k]))
    assert len(tclouds) == len(jclouds)
    for a, b in zip(tclouds, jclouds):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", range(4))
def test_render_and_color_match_jax(pools, k):
    jit, eager, port = _renders(_camera(), k, pools)
    assert port[1].sum() > 100
    _hold(port, jit, eager)


def test_color_from_jax_render_matches_jax(pools):
    (jpool, _), (tpool, _) = pools
    jcam = _camera(3, key=4)
    for k in range(4):
        js, ts = jtesting.index_lobe_shape(jpool, k), ttesting.index_lobe_shape(tpool, k)
        d, m, _, oh = jax.jit(lambda c: jtesting.render_lobe_shape(c, js))(jcam)
        ref = np.asarray(jax.jit(lambda c: jtesting.lobe_shape_color(c, d, m, oh, js))(jcam))
        got = ttesting.lobe_shape_color(t_camera(jcam), t(d), t(m), t(oh), ts).numpy()
        assert np.abs(got - ref).max() <= OPS_TOL * np.abs(ref).max()


def test_zoomed_render_matches_jax(pools):
    """The oracle model's render: a zoomed 32² crop, with the mask gate."""
    (jpool, _), (tpool, _) = pools
    jcam = _camera(2, key=6, width=640, height=480).zoom(None, 32, 5.78)
    jm = jtesting.MultiLobeOracleModel(jtesting.index_lobe_shape(jpool, 3), input_size=32)
    tm = ttesting.MultiLobeOracleModel(ttesting.index_lobe_shape(tpool, 3), input_size=32,
                                       device="cpu")
    jy, jlat, _ = jax.jit(lambda c: jm.decode_latent(None, c))(jcam)
    ey, _, _ = jm.decode_latent(None, jcam)
    ty, tlat = tm.decode_latent(None, t_camera(jcam))
    assert tuple(tlat.shape) == jlat.shape and not tlat.any()
    for key in ("depth", "mask", "mask_logits"):
        assert tuple(ty[key].shape) == jy[key].shape
    jl, el, tl = (np.asarray(y["mask_logits"][0]) for y in (jy, ey, ty))
    floor = np.abs(el - jl).max()
    assert np.abs(tl - jl).max() <= max(FLOOR_FACTOR * floor, OPS_TOL * np.abs(jl).max())
    jd, ed, td = (np.asarray(y["depth"][0]) for y in (jy, ey, ty))
    same = (jd > -1) == (td > -1)
    assert (~same).mean() < 1e-2
    floor = np.abs(ed - jd)[same].max()
    assert np.abs(td - jd)[same].max() <= max(FLOOR_FACTOR * floor, OPS_TOL)
    assert np.abs(tm.compute_latent_code(None, t_camera(jcam)).numpy()).max() == 0
    assert tuple(tm.build_latent_object(None).shape) == (1, 1, 1, 1, 1, 1)


@pytest.mark.parametrize("shaded", [True, False])
def test_make_observation_matches_jax(pools, shaded):
    (jpool, _), (tpool, _) = pools
    jcam = _camera(2, key=8)
    jm = jtesting.MultiLobeOracleModel(jtesting.index_lobe_shape(jpool, 1))
    tm = ttesting.MultiLobeOracleModel(ttesting.index_lobe_shape(tpool, 1), device="cpu")
    jo = jax.jit(lambda c: jm.make_observation(c, shaded=shaded))(jcam)
    eo = jm.make_observation(jcam, shaded=shaded)
    to = tm.make_observation(t_camera(jcam), shaded=shaded)
    as_np = lambda o: [np.asarray(x) for x in (o.depth, o.mask, o.color)]
    (jd, jmask, jc), (ed, emask, ec), (td, tmask, tc) = as_np(jo), as_np(eo), as_np(to)
    assert (tmask != jmask).mean() < 1e-3
    hit = ((tmask == jmask) & (jmask == emask) & (jmask > 0))[:, 0]
    floor = np.abs(ed - jd)[:, 0][hit].max()
    assert np.abs(td - jd)[:, 0][hit].max() <= max(FLOOR_FACTOR * floor, OPS_TOL * jd.max())
    if not shaded:
        np.testing.assert_array_equal(tc, np.broadcast_to(tmask, tc.shape))


def test_camera_gradient_through_render_matches_jax(pools):
    """d/d(log-quaternion, translation) of the summed squared depth and
    squared soft mask (tests/test_lobe_shapes.py's objective) against JAX's
    jitted gradient, at 2e-4 of the largest component or within 3 times the
    jitted-vs-eager spread: the soft mask's steep logits at the lobes' rims
    carry the discriminant's cancellation into the gradient."""
    (jpool, _), (tpool, _) = pools
    js, ts = jtesting.index_lobe_shape(jpool, 1), ttesting.index_lobe_shape(tpool, 1)
    jcam = _camera(1, key=5, width=64, height=48)

    def jloss(lq, tr):
        d, _, ml, _ = jtesting.render_lobe_shape(
            jcam.replace(log_quaternion=lq, translation=tr), js)
        return (d ** 2).sum() + (jax.nn.sigmoid(ml) ** 2).sum()

    grad = jax.grad(jloss, argnums=(0, 1))
    refs = jax.jit(grad)(jcam.log_quaternion, jcam.translation)
    eager = grad(jcam.log_quaternion, jcam.translation)
    tcam = t_camera(jcam)
    lq = tcam.log_quaternion.clone().requires_grad_()
    tr = tcam.translation.clone().requires_grad_()
    d, _, ml, _ = ttesting.render_lobe_shape(tcam.replace(log_quaternion=lq, translation=tr), ts)
    ((d ** 2).sum() + (torch.sigmoid(ml) ** 2).sum()).backward()
    for got, ref, other in zip((lq.grad, tr.grad), refs, eager):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        floor = np.abs(np.asarray(other) - ref).max()
        err = np.abs(got.numpy() - ref).max()
        assert err <= max(FLOOR_FACTOR * floor, GEOM_TOL * np.abs(ref).max()), (err, floor)


# ------------------------------------------- tests/test_lobe_shapes.py's cases
def test_pool_shapes_and_diameter(pools):
    _, (stacked, clouds) = pools
    assert tuple(stacked["centers"].shape) == (4, 4, 3)
    assert tuple(stacked["rots"].shape) == (4, 4, 3, 3)
    assert len(clouds) == 4
    for pts in clouds:
        d = np.sqrt(((pts[None] - pts[:, None]) ** 2).sum(-1)).max()
        assert 0.9 < d <= 1.0 + 1e-5, d
        assert np.abs(pts.mean(0)).max() < 0.1


def test_seed_stream_prefix_invariance():
    one, clouds_one = ttesting.sample_lobe_shapes(7919, 1, n_points=256, device="cpu")
    four, clouds_four = ttesting.sample_lobe_shapes(7919, 4, n_points=256, device="cpu")
    for k in one:
        assert torch.equal(one[k][0], four[k][0])
    np.testing.assert_array_equal(clouds_one[0], clouds_four[0])


def test_disjoint_seed_streams_give_different_shapes(pools):
    _, (stacked, _) = pools
    other, _ = ttesting.sample_lobe_shapes(7919, 4, diameter=1.0, n_points=256, device="cpu")
    assert not torch.allclose(stacked["axes"], other["axes"], atol=1e-3)


def test_render_depth_matches_surface_cloud(pools):
    """Hit pixels back-projected through the camera rays land on the union's
    surface; the soft mask agrees in sign with the hard one on clear
    pixels; every hit pixel belongs to a lobe."""
    _, (stacked, clouds) = pools
    shape = ttesting.index_lobe_shape(stacked, 2)
    cam = ttesting.make_camera(1, z=5.78, f=615.0, width=160, height=120,
                               quats=tquat.random(1, torch.Generator().manual_seed(1)),
                               device="cpu")
    depth, mask, mask_logits, onehot = ttesting.render_lobe_shape(cam, shape)
    assert float(mask.sum()) > 50
    o_obj, d_obj = ttesting._rays(cam, (cam.height, cam.width))
    hit = mask[:, 0] > 0.5
    pts = (o_obj + d_obj * depth[:, 0][..., None])[hit].numpy()
    dists = np.sqrt(((pts[:, None, :] - clouds[2][None]) ** 2).sum(-1)).min(1)
    assert float(np.quantile(dists, 0.95)) < 0.12, float(dists.max())
    ml = mask_logits[:, 0]
    assert float((ml[hit] > 0).float().mean()) > 0.99
    assert float((ml[~hit] < 0).float().mean()) > 0.9
    assert bool((onehot.sum(-1)[hit] >= 1.0 - 1e-5).all())


def test_color_shading_is_pose_covariant(pools):
    _, (stacked, _) = pools
    shape = ttesting.index_lobe_shape(stacked, 0)
    q = tquat.random(1, torch.Generator().manual_seed(3))

    def render():
        cam = ttesting.make_camera(1, z=5.78, f=615.0, width=64, height=48, quats=q,
                                   device="cpu")
        d, m, _, oh = ttesting.render_lobe_shape(cam, shape)
        return ttesting.lobe_shape_color(cam, d, m, oh, shape)

    a, b = render(), render()
    torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0 + 1e-5
    assert float(a.std()) > 0.01


def test_pose_gradients_flow(pools):
    _, (stacked, _) = pools
    shape = ttesting.index_lobe_shape(stacked, 1)
    cam = ttesting.make_camera(1, z=5.78, f=615.0, width=64, height=48,
                               quats=tquat.random(1, torch.Generator().manual_seed(5)),
                               device="cpu")
    lq = cam.log_quaternion.clone().requires_grad_()
    d, _, ml, _ = ttesting.render_lobe_shape(cam.replace(log_quaternion=lq), shape)
    ((d ** 2).sum() + (torch.sigmoid(ml) ** 2).sum()).backward()
    assert bool(torch.isfinite(lq.grad).all()) and float(lq.grad.abs().sum()) > 0


# ------------------------------------------------ the committed reference views
@pytest.mark.parametrize("obj", [0, 1])
def test_render_at_committed_cameras(obj):
    """Held-out object ``obj`` of pool seed 7919 at the 16 committed
    reference cameras, view by view: each view's sums of depth and color
    within 1e-3 and its mask's count within 0.1 % of the view's pixels of
    the JAX package's fp32 render's, recorded in ``unseen_cameras.json``
    (``SUMS_TOL``; one rim pixel that flips moves a view's depth sum by
    about 2e-4, and up to 2 do: 3.5e-4 measured). The
    committed renders (``refs_o*.npz``) were made by the JAX package on the
    TPU, whose reduced-precision products move the grazing rays: against
    them the hard mask agrees on all but 0.1 % of the 16 views' pixels
    (JAX's own fp32 render parts from them on 0.058 % of object 0's and
    0.054 % of object 1's)."""
    import json

    sums = json.loads(unseen_eval.CAMERAS.read_text())["sums"][f"o{obj}"]
    pool, _ = ttesting.sample_lobe_shapes(7919, 2, device="cpu")
    shape = ttesting.index_lobe_shape(pool, obj)
    ref_cams, _ = unseen_eval.load_cameras(device="cpu")
    with np.load(FRAMES / f"refs_o{obj}.npz") as z:
        np.testing.assert_array_equal(ref_cams.intrinsic.numpy(), z["intrinsic"])
        # The recorded rotations are rounded to bf16; a camera keeps the
        # nearest rotation (by way of its quaternion), as the JAX one does.
        np.testing.assert_allclose(ref_cams.extrinsic.numpy(), z["extrinsic"], atol=2 ** -7)
        frame_mask = z["mask"]
    pixels, flipped = 640 * 480, 0.0
    for v in range(len(ref_cams)):
        obs = ttesting.lobe_observation(shape, ref_cams[v])
        for key in ("depth", "mask", "color"):
            got = float(getattr(obs, key).double().sum())
            ref = sums["jax_float32"][key][v]
            tol = SUMS_TOL * (pixels if key == "mask" else abs(ref))
            assert abs(got - ref) <= tol, (v, key, got, ref)
        flipped += float((obs.mask[0, 0].numpy() != frame_mask[v, 0]).sum())
    assert flipped <= 1e-3 * pixels * len(ref_cams), flipped
