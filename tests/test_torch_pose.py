"""The port's pose estimation held against the JAX package on the CPU: the
analytic ellipsoid oracle, the losses, ranking, plateau schedule, initial
pose, GMM, metrics, hypothesis sampling, config loading, the refinement
loop, and the camera gradient through the tiny network; then pose recovery
on the oracle by the port alone.

Tolerances (fp32): 1e-5 for ops and exact where the arithmetic is the same;
2e-4 for geometry (renders and cameras pass through trig and divisions of
quantities near 600); 5e-4 for networks. Comparisons are relative to the
reference's largest magnitude, or to 1 where that is smaller.
"""
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentfusion_tpu import testing as jtesting
from latentfusion_tpu import zoo as jzoo
from latentfusion_tpu.camera import Camera as JCamera
from latentfusion_tpu.observation import Observation as JObservation
from latentfusion_tpu.pose import estimation as jest
from latentfusion_tpu.pose import gmm as jgmm
from latentfusion_tpu.pose import initialization as jinit
from latentfusion_tpu.pose import metrics as jmetrics
from latentfusion_tpu.pose import utils as jpu
from latentfusion_tpu.recon.inference import LatentFusionModel as JModel
from latentfusion_tpu.three import orientation as jorientation
from latentfusion_tpu.three import quaternion as jquat

from latentfusion_tpu_torch import testing as ttesting
from latentfusion_tpu_torch import zoo as tzoo
from latentfusion_tpu_torch.camera import Camera as TCamera
from latentfusion_tpu_torch.observation import Observation as TObservation
from latentfusion_tpu_torch.pose import estimation as tpe
from latentfusion_tpu_torch.pose import gmm as tgmm
from latentfusion_tpu_torch.pose import initialization as tinit
from latentfusion_tpu_torch.pose import metrics as tmetrics
from latentfusion_tpu_torch.pose import utils as tpu
from latentfusion_tpu_torch.recon.checkpoint import from_jax_params
from latentfusion_tpu_torch.recon.inference import LatentFusionModel as TModel
from latentfusion_tpu_torch.three import orientation as torientation
from latentfusion_tpu_torch.three import quaternion as tquat

OPS_TOL = 1e-5
GEOM_TOL = 2e-4
NET_TOL = 5e-4
AXES = (0.15, 0.25, 0.35)
CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.toml"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def close_rel(a, b, tol):
    """max |a - b| within ``tol`` of the larger of max |b| and 1."""
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(float(np.abs(b).max()), 1.0)


def t(x):
    return torch.from_numpy(np.array(x))


def t_camera(jc: JCamera) -> TCamera:
    """The port's camera with the JAX camera's leaves."""
    return TCamera(t(jc.intrinsic), None, jc.z_span, t(jc.viewport),
                   width=jc.width, height=jc.height,
                   log_quaternion=t(jc.log_quaternion),
                   translation=t(jc.translation), device="cpu")


def t_observation(jo: JObservation) -> TObservation:
    return TObservation(t(jo.color), t(jo.depth), t(jo.mask), t_camera(jo.camera))


@pytest.fixture(scope="module")
def oracles():
    return (jtesting.EllipsoidOracleModel(axes=AXES),
            ttesting.EllipsoidOracleModel(axes=AXES, device="cpu"))


@pytest.fixture(scope="module")
def gt_setup(oracles):
    """A ground-truth camera and its oracle target on both sides."""
    jor, tor = oracles
    jgt = jtesting.make_camera(1, quats=jquat.random(jax.random.PRNGKey(7), 1))
    return jgt, jor.make_observation(jgt), tor.make_observation(t_camera(jgt))


def perturbed(jgt, n, key, t_std=0.02, q_std=0.05):
    return jpu.perturb_camera(jax.random.PRNGKey(key), JCamera.cat([jgt] * n),
                              t_std, q_std)


# ----------------------------------------------------------------- oracle
@pytest.mark.parametrize("shaded", [False, True])
def test_oracle_observation_matches_jax(gt_setup, oracles, shaded):
    jgt, _, _ = gt_setup
    jcams = perturbed(jgt, 3, 11, 0.05, 0.5)
    jo = oracles[0].make_observation(jcams, shaded=shaded)
    to = oracles[1].make_observation(t_camera(jcams), shaded=shaded)
    # A pixel whose ray grazes the silhouette (discriminant within rounding
    # of 0) may fall on either side; none does at these poses.
    close_rel(to.mask, jo.mask, 0)
    close_rel(to.depth, jo.depth, GEOM_TOL)
    # The shaded texture is sin(9 * (x + y + z)) of the hit point; at rays
    # that graze the silhouette the hit point moves fast (the depths there
    # agree to 6e-5), so the color is held to 1e-3.
    close_rel(to.color, jo.color, 1e-3)
    assert 0.005 < float(to.mask.mean()) < 0.6


def test_oracle_decode_matches_jax(gt_setup, oracles):
    """The zoomed renders. Their discriminant b² - 4ac cancels: its terms
    reach 1e5, so fp32 rounding leaves about 1e-2 in it, 4 in the mask
    logits (held relative to their largest magnitude, 5e5). Depth and mask
    are held outside the silhouette band |disc| < 0.05, where that error
    moves the soft mask and the sqrt's slope is steep; the band is small."""
    jgt, _, _ = gt_setup
    jcams = perturbed(jgt, 4, 12, 0.05, 0.5).zoom(None, 64, oracles[0].camera_dist)
    yj, _, _ = oracles[0].decode_latent(None, jcams)
    yt, zt = oracles[1].decode_latent(None, t_camera(jcams))
    assert zt.shape == (1, 4, 1)
    close_rel(yt["mask_logits"], yj["mask_logits"], GEOM_TOL)
    band = (yt["mask_logits"].abs() < 400).numpy()
    assert band.mean() < 0.02
    for key in ("depth", "mask"):
        close_rel(np.where(band, 0, yt[key].numpy()), np.where(band, 0, yj[key]), GEOM_TOL)


# ------------------------------------------------------------------ losses
def test_default_pose_loss_matches_jax(rng, gt_setup):
    jgt, jtarget, ttarget = gt_setup
    jcams = perturbed(jgt, 5, 13).zoom(None, 64, 3.90625)
    depth = (3.9 + 0.2 * rng.rand(5, 1, 64, 64)).astype(np.float32)
    logits = (4 * rng.randn(5, 1, 64, 64)).astype(np.float32)
    # Pixels with no depth inside the mask are invalid; make a few.
    tdepth = ttarget.depth.clone()
    tdepth[..., 100:104, 150:170] = 0
    jtarget = JObservation(jtarget.color, np.asarray(tdepth), jtarget.mask, jtarget.camera)
    ttarget = TObservation(ttarget.color, tdepth, ttarget.mask, ttarget.camera)
    lj = jest.default_pose_loss(jtarget, depth, logits, jcams)
    lt = tpe.default_pose_loss(ttarget, t(depth), t(logits), t_camera(jcams))
    assert set(lt) == {"depth", "ov_depth", "iou", "mask"}
    for key in lt:
        close_rel(lt[key], lj[key], GEOM_TOL)
    w = {"depth": 1.0, "ov_depth": 0.3, "iou": 0.0}
    assert set(tpe.weigh_losses(lt, w)) == {"depth", "ov_depth"}
    close_rel(tpe.weigh_losses(lt, w)["ov_depth"], jest.weigh_losses(lj, w)["ov_depth"],
              GEOM_TOL)


def test_mask_losses_match_jax(rng):
    a = rng.rand(4, 1, 9, 11).astype(np.float32)
    b = (rng.rand(4, 1, 9, 11) > 0.5).astype(np.float32)
    close_rel(tpu.iou_loss(t(a), t(b)), jpu.iou_loss(a, b), OPS_TOL)
    close_rel(tpu.reduce_loss_mask(t(a), t(b)), jpu.reduce_loss_mask(a, b), OPS_TOL)
    invalid = rng.rand(4, 1, 9, 11) > 0.7
    close_rel(tpu.zero_invalid_pixels(t(a), t(invalid)),
              jpu.zero_invalid_pixels(a, invalid), 0)


# ---------------------------------------------------------------- ranking
def test_ranking_updates_match_jax_exactly(rng):
    k, n = 4, 6
    rj, rt = jest.init_ranking(k), tpe.init_ranking(k)
    for step in range(3):
        losses = rng.rand(n).astype(np.float32)
        lq = rng.randn(n, 3).astype(np.float32)
        tr = rng.randn(n, 3).astype(np.float32)
        vp = rng.rand(n, 4).astype(np.float32)
        jc = JCamera(np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1)), None, 0.5, vp,
                     log_quaternion=lq, translation=tr)
        rj, dj = jest.update_ranking(rj, losses, jc, step)
        rt, dt = tpe.update_ranking(rt, t(losses), t_camera(jc), step)
        for a, b in zip(rt, rj):
            close_rel(a, b, 0)
        close_rel(dt, dj, 0)
    b = 2
    rj, rt = jest.init_ranking_batch(b, k), tpe.init_ranking_batch(b, k)
    for step in range(3):
        args = [rng.rand(b, n), rng.randn(b, n, 3), rng.randn(b, n, 3), rng.rand(b, n, 4)]
        args = [a.astype(np.float32) for a in args]
        rj, dj = jest.update_ranking_batch(rj, *args, step)
        rt, dt = tpe.update_ranking_batch(rt, *map(t, args), step)
        for x, y in zip(rt, rj):
            close_rel(x, y, 0)
        close_rel(dt, dj, 0)


def test_plateau_lr_update_matches_jax_exactly(rng):
    n = 5
    lr_j = lr_t = np.full(n, 0.01, np.float32)
    best_j = best_t = np.full(n, np.inf, np.float32)
    bad_j = np.zeros(n, np.int32)
    lr_t, best_t, bad_t = t(lr_t), t(best_t), torch.zeros(n, dtype=torch.int64)
    for _ in range(40):
        loss = (1.0 + 0.01 * rng.randn(n)).astype(np.float32)
        kw = dict(threshold=1e-3, patience=3, factor=0.5)
        lr_j, best_j, bad_j = jest.plateau_lr_update(loss, lr_j, best_j, bad_j, **kw)
        lr_t, best_t, bad_t = tpe.plateau_lr_update(t(loss), lr_t, best_t, bad_t, **kw)
        close_rel(lr_t, lr_j, 0)
        close_rel(best_t, best_j, 0)
        close_rel(bad_t, bad_j, 0)
    assert float(lr_t.min()) < 0.01


# ------------------------------------------------------ init, GMM, metrics
def test_initial_pose_matches_jax(gt_setup):
    jgt, jtarget, ttarget = gt_setup
    cj = jest.PoseEstimator.initial_pose(jtarget)
    ct = tpe.PoseEstimator.initial_pose(ttarget)
    close_rel(ct.translation, cj.translation, GEOM_TOL)
    close_rel(ct.log_quaternion, cj.log_quaternion, 0)
    close_rel(tinit.masks_to_viewports(ttarget.mask), jinit.masks_to_viewports(jtarget.mask), 0)
    assert float(torch.linalg.norm(ct.translation - t(jgt.translation))) < 0.3


def test_gmm_fit_from_jax_initial_means_and_blend(rng):
    """EM from the initial means JAX draws (the two frameworks' random
    streams differ), with elite weights, and the blend of two fits."""
    centres = rng.randn(3, 6).astype(np.float32) * 2
    data = (centres[rng.randint(0, 3, 90)] + 0.1 * rng.randn(90, 6)).astype(np.float32)
    weights = (rng.rand(90) < 0.6).astype(np.float32)
    key = jax.random.PRNGKey(5)
    gj = jgmm.fit(key, jnp.asarray(data), 4, sample_weights=jnp.asarray(weights))
    sw = jnp.asarray(weights) / jnp.maximum(jnp.asarray(weights).sum(), 1e-12)
    idx = np.asarray(jax.random.choice(key, 90, (4,), replace=False, p=sw))
    # The port's fits are batched over a leading axis of mixtures.
    gt_ = tgmm.fit(t(data)[None], 4, sample_weights=t(weights)[None],
                   init_means=t(data[idx])[None])
    for a, b in zip(gt_, gj):
        close_rel(a[0], b, 1e-4)
    g0 = tgmm.fit(t(data)[None], 4, torch.Generator().manual_seed(0))
    assert g0.means.shape == (1, 4, 6) and abs(float(g0.weights.sum()) - 1) < 1e-5
    bj = jgmm.blend(gj, gj, 0.75)
    bt = tgmm.blend(gt_, gt_, 0.75)
    for a, b in zip(bt, bj):
        close_rel(a[0], b, 1e-4)
    draws = tgmm.sample(bt, 5000, torch.Generator().manual_seed(1))
    close_rel(draws[0].mean(0), (bt.weights[0, :, None] * bt.means[0]).sum(0), 0.05)


def test_camera_metrics_match_jax(gt_setup):
    jgt, _, _ = gt_setup
    jev = perturbed(jgt, 1, 14, 0.05, 0.3)
    points = np.asarray(jorientation.evenly_distributed_points(200)) * np.asarray(AXES)
    mj = jmetrics.camera_metrics(jgt, jev, jnp.asarray(points, jnp.float32), 1.0)
    points = points.astype(np.float32)
    mt = tmetrics.camera_metrics(t_camera(jgt), t_camera(jev), t(points), 1.0)
    assert set(mt) == set(mj)
    for key in mj:
        close_rel(mt[key], mj[key], GEOM_TOL)
    both = tmetrics.camera_metrics(t_camera(JCamera.cat([jgt, jgt])),
                                   t_camera(JCamera.cat([jev, jgt])), t(points), 1.0)
    assert len(both) == 2 and both[1]["add"] < 1e-5


# --------------------------------------------------- hypothesis sampling
def test_sample_cameras_and_flips_match_jax(gt_setup):
    """Hypotheses around an estimate from the quaternions JAX draws, and
    the 180-degree flips about each object axis."""
    jgt, _, _ = gt_setup
    key = jax.random.PRNGKey(9)
    jcams = jpu.sample_cameras_with_estimate(12, jgt, key=key)
    quats = jorientation.evenly_distributed_quats(12, key=jax.random.split(key)[1])
    tcams = tpu.cameras_with_estimate(t_camera(jgt), t(quats), t(jgt.translation).expand(12, 3))
    close_rel(tcams.extrinsic, jcams.extrinsic, GEOM_TOL)
    close_rel(tcams.viewport, jcams.viewport, 0)
    close_rel(tcams.intrinsic, jcams.intrinsic, 0)
    for axis in ((0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (1.0, 0.0, 0.0)):
        close_rel(tpu.flip_camera(tcams, axis).extrinsic,
                  jpu.flip_camera(jcams, axis).extrinsic, GEOM_TOL)
    drawn = tpu.sample_cameras_with_estimate(12, t_camera(jgt), torch.Generator().manual_seed(0))
    assert len(drawn) == 12
    close_rel(drawn.translation, t(jgt.translation).expand(12, 3), 0)


@pytest.mark.parametrize("config", CONFIGS, ids=lambda p: p.stem)
def test_load_from_config_matches_jax(config, oracles):
    ej = jest.load_from_config(config, oracles[0])
    et = tpe.load_from_config(config, oracles[1])
    assert type(et).__name__ == type(ej).__name__
    names = {"ranking_size", "loss_weights"}
    if isinstance(ej, jest.CrossEntropyPoseEstimator):
        names |= {"num_samples", "num_elites", "num_iters", "num_gmm_components",
                  "learning_rate", "sample_flipped", "init_upright",
                  "init_hemisphere", "translation_std", "quaternion_std",
                  "gmm_em_iters"}
        assert et._elite_table() == [int(v) for v in np.asarray(ej._elite_table())]
    else:
        names |= {"learning_rate", "num_samples", "num_iters", "optimizer",
                  "lr_reduce_patience", "lr_reduce_threshold", "lr_reduce_factor",
                  "converge_threshold", "converge_patience"}
        assert set(et.loss_schedules) == set(ej.loss_schedules)
    for name in names:
        assert getattr(et, name) == getattr(ej, name), name


# --------------------------------------------------------- the refinement
def _refiners(oracles, **kw):
    args = dict(ranking_size=4, loss_weights={"depth": 1.0, "ov_depth": 0.3},
                learning_rate=0.01, num_samples=4, converge_threshold=1e-6,
                optimizer="adam", track_stats=True)
    args.update(kw)
    return (jest.GradientPoseEstimator(model=oracles[0], **args),
            tpe.GradientPoseEstimator(model=oracles[1], **args))


def _pose_quadratic(lib, lq0, t0, vp0):
    """A loss of the pose alone, smooth, for holding the refinement loop to
    JAX over many steps (see test_refinement_loop_matches_jax)."""
    def loss(target, z_depth, z_mask_logits, cam, **_):
        return {"depth": ((cam.log_quaternion - lq0) ** 2).sum(-1)
                + ((cam.translation - t0) ** 2).sum(-1),
                "ov_depth": 1e-4 * ((cam.viewport - vp0) ** 2).sum(-1)}
    return loss


def _loop_pair(gt_setup, oracles, **kw):
    jgt, _, _ = gt_setup
    lq0, t0, vp0 = (np.asarray(x) for x in (
        jgt.log_quaternion, jgt.translation, jgt.zoom(None, 64, 3.90625).viewport))
    rj, rt = _refiners(oracles, **kw)
    rj.loss_func = _pose_quadratic(jnp, lq0, t0, vp0)
    rt.loss_func = _pose_quadratic(torch, t(lq0), t(t0), t(vp0))
    return rj, rt


@pytest.mark.parametrize("optimizer", ["adam", "adamw", "sgd", "adagrad"])
def test_refinement_loop_matches_jax(gt_setup, oracles, optimizer):
    """The loop from the same initial cameras, for 20 steps, with a smooth
    loss of the pose: loss history, step count and ranking (losses, poses,
    viewports, the step each was found at), the plateau schedule halving
    the learning rate on the way. With the default loss the trajectories
    part after a step or two: its L1 depth residuals, uncropped by nearest
    neighbour, make the gradient jump (a 1e-7 relative change of one
    translation moves a gradient component by 30 %), and Adam's first steps
    are about sign(g). That loss's first step is held to JAX below."""
    jgt, jtarget, ttarget = gt_setup
    init = perturbed(jgt, 4, 2, 0.03, 0.1)
    rj, rt = _loop_pair(gt_setup, oracles, optimizer=optimizer, num_iters=20,
                        converge_patience=50, lr_reduce_patience=2,
                        lr_reduce_threshold=0.05,
                        learning_rate=0.01 if optimizer != "sgd" else 0.2)
    bj, sj = rj.estimate(None, jtarget, camera=init)
    bt, st = rt.estimate(None, ttarget, camera=t_camera(init))
    assert st["num_steps"] == int(sj["num_steps"]) == 20
    close_rel(st["loss_history"], sj["loss_history"], GEOM_TOL)
    assert float(st["loss_history"][-1]) < 0.5 * float(st["loss_history"][0])
    for field in ("translation", "log_quaternion", "viewport"):
        close_rel(getattr(bt, field), getattr(bj, field), GEOM_TOL)


def test_refinement_first_step_on_default_loss_matches_jax(gt_setup, oracles):
    jgt, jtarget, ttarget = gt_setup
    init = perturbed(jgt, 4, 2, 0.01, 0.05)
    rj, rt = _refiners(oracles, num_iters=1, converge_patience=50)
    bj, sj = rj.estimate(None, jtarget, camera=init)
    bt, st = rt.estimate(None, ttarget, camera=t_camera(init))
    close_rel(st["loss_history"], sj["loss_history"], GEOM_TOL)
    close_rel(bt.translation, bj.translation, GEOM_TOL)
    close_rel(bt.log_quaternion, bj.log_quaternion, GEOM_TOL)


def test_refinement_stops_at_convergence_like_jax(gt_setup, oracles):
    jgt, jtarget, ttarget = gt_setup
    init = JCamera.cat([jgt, jgt])
    rj, rt = _refiners(oracles, learning_rate=0.0, num_samples=2, num_iters=100,
                       converge_patience=3, ranking_size=2)
    _, sj = rj.estimate(None, jtarget, camera=init)
    best, st = rt.estimate(None, ttarget, camera=t_camera(init))
    assert st["num_steps"] == int(sj["num_steps"]) < 100
    assert len(best) == 2


CUDNN_FLAGS = ("deterministic", "enabled", "benchmark", "allow_tf32")


@pytest.mark.parametrize("flags", [(False, True, False, True), (True, False, True, False),
                                   (False, False, False, False)],
                         ids=["torch_defaults", "all_flipped", "all_off"])
def test_loss_and_grads_selects_deterministic_cudnn_and_restores_flags(gt_setup, oracles,
                                                                       flags):
    """The refinement step's forward and backward run with cuDNN's
    deterministic algorithms selected and its other flags as the caller set
    them (TF32 is not switched on, cuDNN not off); afterwards, and after a
    step that raises, torch.backends.cudnn's flags are as the caller left
    them."""
    jgt, _, ttarget = gt_setup
    _, rt = _refiners(oracles, num_iters=1, converge_patience=50)
    loss_func, seen = rt.loss_func, []

    def spy(*args, **kwargs):
        seen.append(tuple(getattr(torch.backends.cudnn, k) for k in CUDNN_FLAGS))
        return loss_func(*args, **kwargs)

    cam = t_camera(perturbed(jgt, 4, 2, 0.01, 0.05)).zoom(None, rt.model.input_size,
                                                           rt.model.camera_dist)
    prev = {k: getattr(torch.backends.cudnn, k) for k in CUDNN_FLAGS}
    try:
        for k, v in zip(CUDNN_FLAGS, flags):
            setattr(torch.backends.cudnn, k, v)
        rt.loss_func = spy
        _, grads = rt.loss_and_grads(None, ttarget, cam)
        after = tuple(getattr(torch.backends.cudnn, k) for k in CUDNN_FLAGS)
        rt.loss_func = lambda *a, **kw: 1 / 0
        with pytest.raises(ZeroDivisionError):
            rt.loss_and_grads(None, ttarget, cam)
        after_raise = tuple(getattr(torch.backends.cudnn, k) for k in CUDNN_FLAGS)
    finally:
        for k, v in prev.items():
            setattr(torch.backends.cudnn, k, v)
    assert seen == [(True, *flags[1:])]
    assert set(grads) == {"log_quaternion", "translation", "viewport"}
    assert after == after_raise == flags


def _to_state(params):
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return from_jax_params({jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves})


def test_camera_gradient_through_tiny_network_matches_jax(rng):
    """One refinement step's loss gradient with respect to log_quaternion,
    translation and viewport, through the tiny Photographer: jax.grad
    against torch autograd (K1-bwd-grid and K2-bwd plain versions)."""
    ph = jzoo.tiny_photographer()
    params = jax.jit(ph.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8, 8, 8)),
                              jzoo.canonical_camera(1, 16))
    jm = JModel(jzoo.tiny_sculptor(), None, jzoo.tiny_fuser(), None, ph, params,
                camera_dist=1.5)
    tm = TModel(tzoo.tiny_sculptor(device="cpu"), None, tzoo.tiny_fuser(device="cpu"),
                None, tzoo.tiny_photographer(device="cpu"), _to_state(params),
                camera_dist=1.5, device="cpu")
    z = rng.randn(1, 1, 4, 8, 8, 8).astype(np.float32)
    K = np.array([[64, 0, 32], [0, 64, 24], [0, 0, 1]], np.float32)
    q = rng.randn(4, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    trans = np.array([0.02, -0.01, 1.5], np.float32) + 0.02 * rng.randn(4, 3).astype(np.float32)
    from latentfusion_tpu import three as jthree

    ext = np.asarray(jthree.to_extrinsic_matrix(jnp.asarray(trans), jnp.asarray(q)))
    jcam = JCamera(np.tile(K, (4, 1, 1)), ext, width=64, height=48).zoom(None, 16, 1.5)
    mask = np.zeros((1, 1, 48, 64), np.float32)
    mask[..., 14:34, 22:42] = 1
    depth = ((1.45 + 0.1 * rng.rand(1, 1, 48, 64)) * mask).astype(np.float32)
    jtarget = JObservation(np.repeat(mask, 3, 1), depth, mask,
                           JCamera(K, ext[:1], width=64, height=48))
    weights = {"depth": 1.0, "ov_depth": 0.3}
    rj = jest.GradientPoseEstimator(model=jm, ranking_size=4, loss_weights=weights,
                                    learning_rate=0.01, num_samples=4, num_iters=1,
                                    converge_threshold=1e-6, converge_patience=10)

    def loss(p):
        cam = jcam.replace(**p)
        zd, _, zl, _ = rj._render_zoomed(jnp.asarray(z), cam)
        ld = jest.default_pose_loss(jtarget, zd, zl, cam)
        return sum(jest.weigh_losses(ld, weights).values()).sum() / 4

    gj = jax.jit(jax.grad(loss))(jpu.camera_params(jcam, optimize_viewport=True))
    rt = tpe.GradientPoseEstimator(model=tm, ranking_size=4, loss_weights=weights,
                                     learning_rate=0.01, num_samples=4, num_iters=1,
                                     converge_threshold=1e-6, converge_patience=10)
    _, gt_ = rt.loss_and_grads(t(z), t_observation(jtarget), t_camera(jcam))
    assert set(gt_) == {"log_quaternion", "translation", "viewport"}
    for key, g in gt_.items():
        ref = np.asarray(gj[key])
        assert float(np.abs(ref).max()) > 0, key
        # Relative to the leaf's largest gradient, which is well below 1.
        assert np.abs(g.numpy() - ref).max() <= NET_TOL * np.abs(ref).max(), key


# ------------------------------------------- the learned demo network
RIG_AXES = (0.21, 0.36, 0.5)  # tools/train_encoder_distill.py's accuracy rig
DISTILL = Path(__file__).resolve().parents[1] / "artifacts" / "encoder_distill"


@pytest.fixture(scope="module")
def rig():
    """tools/train_encoder_distill.py's accuracy rig on both sides: the demo
    family with the learned weights of encoder_distill.npz, the latent of
    16 shaded oracle views (PRNGKey(7)), and its target 3 (PRNGKey(55)),
    whose refinement drifts in translation."""
    from latentfusion_tpu_torch.recon.checkpoint import load_params_npz, split_state_dict

    sc, fu, ph = jzoo.demo_sculptor(), jzoo.demo_fuser(), jzoo.demo_photographer()
    template = jax.eval_shape(
        lambda k: jzoo.init_recon_params(k, sc, fu, ph, batch=1, views=2),
        jax.random.PRNGKey(0))
    params = jzoo.load_params_npz(DISTILL / "encoder_distill.npz", template)
    jm = JModel(sc, params["sculptor"], fu, params["fuser"], ph,
                params["photographer"], camera_dist=jzoo.DEMO_CAMERA_DIST)
    state = split_state_dict(from_jax_params(load_params_npz(
        DISTILL / "encoder_distill.npz", DISTILL / "encoder_distill_keys.json")))
    tm = TModel(tzoo.demo_sculptor(device="cpu"), state["sculptor"],
                tzoo.demo_fuser(device="cpu"), state["fuser"],
                tzoo.demo_photographer(device="cpu"), state["photographer"],
                camera_dist=tzoo.DEMO_CAMERA_DIST, device="cpu")
    oracle = jtesting.EllipsoidOracleModel(jzoo.DEMO_INPUT_SIZE, jzoo.DEMO_CAMERA_DIST,
                                           RIG_AXES)
    ref = jzoo.random_view_cameras(jax.random.PRNGKey(7), 16, jzoo.DEMO_INPUT_SIZE,
                                   jzoo.DEMO_CAMERA_DIST)
    # Jitted, as the rig renders them (eager JAX differs in the last bits).
    ref_obs = jax.jit(lambda c: oracle.make_observation(c, shaded=True))(ref)
    key = jax.random.PRNGKey(55)
    for _ in range(4):
        key, k1, k2 = jax.random.split(key, 3)
    gt = jtesting.make_camera(1, z=jzoo.DEMO_CAMERA_DIST, f=615.0, width=640,
                              height=480, quats=jquat.random(k1, 1))
    target = jax.jit(oracle.make_observation)(gt)
    return dict(jm=jm, tm=tm, jz=jm.build_latent_object(ref_obs),
                tz=tm.build_latent_object(t_observation(ref_obs)), gt=gt, cem_key=k2,
                jtarget=target, ttarget=t_observation(target))


def _rig_refiners(rig, **kw):
    args = dict(ranking_size=8, loss_weights={"depth": 1.0, "ov_depth": 0.3},
                learning_rate=0.01, num_samples=16, num_iters=150,
                converge_threshold=1e-6, converge_patience=25, optimizer="adam",
                track_stats=True)
    args.update(kw)
    return (jest.GradientPoseEstimator(model=rig["jm"], **args),
            tpe.GradientPoseEstimator(model=rig["tm"], **args))


def test_refinement_through_learned_demo_network_matches_jax(rig):
    """Five refinement steps of 4 hypotheses around the rig's target 3
    through the learned demo network, default losses, from the same
    cameras: loss history and refined poses. With the learned weights the
    two fp32 trajectories stay together (unlike the random tiny network's,
    see test_refinement_loop_matches_jax)."""
    close_rel(rig["tz"], np.asarray(rig["jz"]), NET_TOL)
    init = perturbed(rig["gt"], 4, 3, 0.05, 0.2)
    rj, rt = _rig_refiners(rig, num_samples=4, ranking_size=4, num_iters=5)
    bj, sj = rj.estimate(rig["jz"], rig["jtarget"], camera=init)
    bt, st = rt.estimate(rig["tz"], rig["ttarget"], camera=t_camera(init))
    assert st["num_steps"] == int(sj["num_steps"]) == 5
    close_rel(st["loss_history"], sj["loss_history"], NET_TOL)
    for field in ("translation", "log_quaternion", "viewport"):
        close_rel(getattr(bt, field), getattr(bj, field), NET_TOL)


@pytest.mark.slow
def test_rig_target_refinement_from_jax_coarse_poses_matches_jax(rig):
    """The rig's target 3 end to end as tools/train_encoder_distill.py runs
    it: JAX's CEM (key from PRNGKey(55)), then 150 refinement steps of its
    top 16 in JAX and in the port. The refined best poses agree within 1 %
    of the object's diameter in ADD-S and 2 % in translation (two fp32
    loops part slowly over 150 steps), so where the refinement drifts in
    translation from these coarse poses it does so in both packages. About
    22 minutes on 8 CPU cores, most of it JAX's refinement."""
    coarse = jest.CrossEntropyPoseEstimator(
        model=rig["jm"], num_gmm_components=6, sample_flipped=True, num_samples=128,
        num_iters=10, num_elites=48, learning_rate=0.75, loss_weights={"depth": 1.0},
        ranking_size=16)
    cams = coarse.estimate(rig["jz"], rig["jtarget"], key=rig["cem_key"])
    rj, rt = _rig_refiners(rig)
    bj, _ = rj.estimate(rig["jz"], rig["jtarget"], camera=cams[:16])
    bt, st = rt.estimate(rig["tz"], rig["ttarget"], camera=t_camera(cams[:16]))
    points = (np.asarray(jorientation.evenly_distributed_points(512))
              * np.asarray(RIG_AXES, np.float32))
    keys = ("add_s", "rotation_dist", "translation_dist")
    mj = jmetrics.camera_metrics(rig["gt"], bj[0], jnp.asarray(points), scale_to_meters=1.0)
    mt = tmetrics.camera_metrics(t_camera(rig["gt"]), bt[0], t(points), 1.0)
    mc = jmetrics.camera_metrics(rig["gt"], cams[0], jnp.asarray(points), scale_to_meters=1.0)
    print("coarse", {k: float(mc[k]) for k in keys}, "refined JAX",
          {k: float(mj[k]) for k in keys}, "port", {k: float(mt[k]) for k in keys},
          "steps", st["num_steps"])
    assert abs(float(mt["add_s"]) - float(mj["add_s"])) <= 0.01 * 2 * max(RIG_AXES)
    assert abs(float(mt["translation_dist"]) - float(mj["translation_dist"])) <= 0.02


# ------------------------------------------------------------- recovery
def test_refinement_reduces_pose_error(gt_setup, oracles):
    """As tests/test_pose.py asserts for JAX: from a perturbed pose the
    best-ranked hypothesis's translation tightens and its rotation stays in
    the basin."""
    jgt, _, ttarget = gt_setup
    gt = t_camera(jgt)
    g = torch.Generator().manual_seed(1)
    init = gt.with_quaternion(tquat.qmul(
        tquat.qexp(0.075 * torch.randn(1, 3, generator=g)), gt.quaternion))
    init = init.replace(translation=gt.translation + torch.tensor([[0.02, -0.02, 0.04]]))
    init = tpu.perturb_camera(TCamera.cat([init] * 4), 0.005, 0.02, g)
    _, rt = _refiners(oracles, num_iters=60, converge_patience=60)
    best, _ = rt.estimate(None, ttarget, camera=init)
    t_err_init = float(torch.linalg.norm(init.translation - gt.translation, dim=-1).min())
    t_err = float(torch.linalg.norm(best.translation[0] - gt.translation[0]))
    rot_err = float(tquat.angular_distance(best.quaternion[:1], gt.quaternion)[0, 0])
    assert t_err < t_err_init
    assert rot_err < 0.15


def test_cem_finds_orientation(gt_setup, oracles):
    """As tests/test_pose.py asserts for JAX: the coarse search lands near
    the ground truth up to the ellipsoid's 180-degree flips."""
    jgt, _, ttarget = gt_setup
    gt = t_camera(jgt)
    est = tpe.CrossEntropyPoseEstimator(
        model=oracles[1], ranking_size=8, loss_weights={"depth": 1.0}, num_samples=64,
        num_elites=24, num_iters=6, num_gmm_components=3, learning_rate=0.9,
        sample_flipped=True)
    best = est.estimate(None, ttarget, generator=torch.Generator().manual_seed(0))
    assert len(best) == 8
    gt_quats = [gt.quaternion] + [tpu.flip_camera(gt, axis).quaternion for axis in
                                  ((1.0, 0, 0), (0, 1.0, 0), (0, 0, 1.0))]
    rot_err = min(float(tquat.angular_distance(best.quaternion, q)[:, 0].min())
                  for q in gt_quats)
    assert float(torch.linalg.norm(best.translation[0] - gt.translation[0])) < 0.25
    assert rot_err < 0.8
    # The latent term runs (the oracle's latents are zeros, so it is a
    # constant 1 on every hypothesis).
    latent = tpe.CrossEntropyPoseEstimator(
        model=oracles[1], ranking_size=8, loss_weights={"latent": 1.0},
        num_samples=8, num_elites=4, num_iters=2, num_gmm_components=2,
        learning_rate=0.9).estimate(None, ttarget)
    assert len(latent) == 8 and bool(torch.isfinite(latent.translation).all())


class JaxCemDraws:
    """The random draws of JAX's CEM loop (``run`` in
    latentfusion_tpu/pose/estimation.py), for the port's ``draws``: the key
    splits into the first fit's key and the loop's; each iteration splits
    the loop key into (key, k_samp, k_fit); k_samp splits into the GMM
    sample's key (component choice, unit normals) and the translation and
    rotation noise keys; each fit draws its initial means by weight without
    replacement."""

    def __init__(self, key, n_components):
        self.fit_key, self.key = jax.random.split(key)
        self.n_components = n_components

    def init_index(self, weights):
        """weights (1, N), the port's batched layout for one object."""
        n = weights.shape[1]
        return t(jax.random.choice(self.fit_key, n, (self.n_components,),
                                   replace=n < self.n_components,
                                   p=jnp.asarray(weights[0].numpy())))[None]

    def sample(self, weights, n):
        self.key, k_samp, self.fit_key = jax.random.split(self.key, 3)
        k1, k2, k3 = jax.random.split(k_samp, 3)
        k_comp, k_eps = jax.random.split(k1)
        logits = jnp.log(jnp.maximum(jnp.asarray(weights[0].numpy()), 1e-30))
        comp = jax.random.categorical(k_comp, logits, shape=(n,))
        noise = jnp.concatenate([jax.random.normal(k2, (n, 3)),
                                 jax.random.normal(k3, (n, 3))], axis=1)
        return (t(comp).long()[None], t(jax.random.normal(k_eps, (n, 6)))[None],
                t(noise)[None])


OFFSET = (0.03, -0.02, 0.01)  # object-frame centre of the off-centre ellipsoid


def moved(camera, xp):
    """``camera`` moved so that it sees the ellipsoid centred at the object
    origin as the original sees it centred at ``OFFSET``: translation
    t + R c (``xp`` is jnp or torch)."""
    rot = camera.rotation_matrix[:, :3, :3]
    return camera.replace(translation=camera.translation + rot @ xp.asarray(OFFSET))


class _OffCentre:
    """The oracle's ellipsoid with its centre at ``OFFSET``. No 180-degree
    flip about an object axis maps it onto itself, so the four flips of a
    hypothesis score apart."""

    def decode_latent(self, z_obj, camera, return_latent=True, apply_mask=False):
        depth_metric, mask, mask_logits = self._render(
            moved(camera, self._xp), self.input_size, self.axes)
        depth = self._xp.where(mask > 0.5, camera.normalize_depth(depth_metric), -1.0)
        y = {"depth": depth[None], "mask": mask[None], "mask_logits": mask_logits[None]}
        return (y, None, None) if self._xp is jnp else (y, None)


class JOffCentreOracle(_OffCentre, jtesting.EllipsoidOracleModel):
    _xp, _render = jnp, staticmethod(jtesting.render_ellipsoid)


class TOffCentreOracle(_OffCentre, ttesting.EllipsoidOracleModel):
    _xp, _render = torch, staticmethod(ttesting.render_ellipsoid)


@pytest.mark.parametrize("components,iters,lr,flipped", [
    (3, 6, 0.9, False), (6, 10, 0.75, False), (3, 6, 0.9, True), (6, 7, 0.75, True)])
def test_cem_loop_with_jax_draws_matches_jax(gt_setup, oracles, components, iters, lr,
                                             flipped):
    """The whole CEM loop on the oracle with JAX's draws injected (the
    initial cameras, each fit's initial means, each iteration's samples and
    noise): the rankings and final poses agree, rank by rank. The second
    case has phase 6's components, iterations and learning rate; the last
    two its ``sample_flipped``, the fourth its components and learning rate.

    Tolerances: translation 2e-4 (geometry); log-quaternion 1e-3 (about
    2e-3 rad). Each iteration's refit (25 EM steps) amplifies fp32
    differences: in the second case the ranking's log-quaternions part by
    5.0e-6 after 2 iterations, 4.3e-5 after 6 and 6.5e-4 after 10, with the
    same hypotheses ranked in the same order (translations within 1.4e-5).

    With ``sample_flipped`` the flips of a hypothesis are exact symmetries
    of the centred ellipsoid, so their losses tie to fp32, and once the
    annealed elite boundary falls inside such a group the two loops may
    pick different elites and part. Those cases render the ellipsoid off
    centre (``OFFSET``), which breaks the symmetry, on both sides. With
    flips the refits amplify faster: at phase 6's settings the rankings'
    log-quaternions part by 5.5e-5 after 7 iterations and 7.2e-4 after 8;
    after 10, ranks 0-2, 4 and 5 agree within 4.0e-5 while ranks 3 and 6
    part by 1.7e-3 and 1.1e-2 and rank 7 holds another hypothesis (depth
    loss 8.31e-3 in the port, 7.97e-3 for JAX's, both scored by the port)."""
    jgt, jtarget, ttarget = gt_setup
    jmodel, tmodel = oracles
    if flipped:
        jmodel, tmodel = JOffCentreOracle(axes=AXES), TOffCentreOracle(axes=AXES, device="cpu")
        seen = jmodel.make_observation(moved(jgt, jnp))
        jtarget = JObservation(seen.color, seen.depth, seen.mask, jgt)
        ttarget = t_observation(jtarget)
    kw = dict(ranking_size=8, loss_weights={"depth": 1.0}, num_samples=64,
              num_elites=24, num_iters=iters, num_gmm_components=components,
              learning_rate=lr, sample_flipped=flipped)
    init = jpu.sample_cameras_with_estimate(components * 64,
                                            jest.PoseEstimator.initial_pose(jtarget),
                                            key=jax.random.PRNGKey(11))
    key = jax.random.PRNGKey(12)
    ref = jest.CrossEntropyPoseEstimator(model=jmodel, **kw).estimate(
        None, jtarget, key=key, cameras=init)
    ours = tpe.CrossEntropyPoseEstimator(model=tmodel, **kw).estimate(
        None, ttarget, cameras=t_camera(init), draws=JaxCemDraws(key, components))
    close_rel(ours.translation, ref.translation, GEOM_TOL)
    assert float((ours.log_quaternion - t(ref.log_quaternion)).abs().max()) <= 1e-3


@pytest.mark.slow
def test_oracle_end_to_end_reaches_add_s():
    """The North star's first check, as tests/test_bop_accuracy.py runs it
    in JAX: the frames of its synthetic scene (8 views of the oracle
    ellipsoid, 320x240, f = 250, quaternions of PRNGKey(11), translations
    of RandomState(0)), the 2 evaluation frames tools/evaluate_bop.py picks
    after 4 farthest-point reference views, cross_entropy_quick then
    adam_quick on the top 8: ADD-S within a tenth of the diameter (1 object
    unit) on every frame. The frames are rendered by the port's oracle at
    the scene's extrinsics, not read through the BOP file layout."""
    from latentfusion_tpu import three as jthree
    from latentfusion_tpu.three import utils as jthree_utils

    n_frames, cam_dist = 8, 3.90625
    rng = np.random.RandomState(0)
    quats = jquat.random(jax.random.PRNGKey(11), n_frames)
    ext = np.stack([np.asarray(jthree.to_extrinsic_matrix(
        np.array([[rng.uniform(-0.1, 0.1), rng.uniform(-0.1, 0.1),
                   cam_dist + rng.uniform(-0.2, 0.2)]], np.float32), quats[i:i + 1]))[0]
        for i in range(n_frames)])
    _, ref = jthree_utils.farthest_points(
        jthree.extrinsic_to_position(jnp.asarray(ext)), n_clusters=4,
        dist_func=lambda a, b: jnp.linalg.norm(a - b, axis=-1), return_center_indexes=True)
    candidates = [i for i in range(n_frames) if i not in set(np.asarray(ref).tolist())]
    frames = [candidates[int(round(x))] for x in np.linspace(0, len(candidates) - 1, 2)]

    oracle = ttesting.EllipsoidOracleModel(input_size=64, camera_dist=cam_dist,
                                           axes=AXES, device="cpu")
    configs = {c.stem: c for c in CONFIGS}
    coarse = tpe.load_from_config(configs["cross_entropy_quick"], oracle)
    fine = tpe.load_from_config(configs["adam_quick"], oracle)
    i = np.arange(200, dtype=np.float64)
    phi, theta = np.arccos(1 - 2 * (i + 0.5) / 200), np.pi * (1 + 5 ** 0.5) * i
    points = t(np.stack([np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta),
                         np.cos(phi)], 1) * np.asarray(AXES)).float()
    K = np.array([[250.0, 0, 160], [0, 250.0, 120], [0, 0, 1]], np.float32)
    for f in frames:
        gt = TCamera(K, ext[f], width=320, height=240, device="cpu")
        target = oracle.make_observation(gt)
        cams = coarse.estimate(None, target, generator=torch.Generator().manual_seed(0))
        best = fine.estimate(None, target, camera=cams[:8])
        m = tmetrics.camera_metrics(gt, best[0], points, 1.0)
        assert m["add_s"] < 0.1, (f, m)


def test_estimators_reject_several_targets(gt_setup, oracles):
    _, _, ttarget = gt_setup
    both = TObservation.collate([ttarget, ttarget])
    _, rt = _refiners(oracles, num_iters=1, converge_patience=1)
    with pytest.raises(ValueError):
        rt.estimate(None, both)
    assert math.isfinite(float(rt.estimate(None, ttarget)[0].translation[0, 2]))
