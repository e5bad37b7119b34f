"""The port's multi-object estimates, the Metropolis estimator and the latent
loss held against the JAX package on the CPU: the distances, the target's
latent code (``compute_latent_code``) through the tiny network, the latent
term of the pose loss and its camera gradient, the Metropolis rule and
loop with JAX's draws, and ``estimate_batch`` of all three estimators for
two objects, against JAX's and against the port's own single-object
estimates.

Tolerances (fp32): 1e-6 for the distances; 2e-4 for geometry (renders and
cameras pass through trig and divisions of quantities near 600); 5e-4 for
networks. Comparisons are relative to the reference's largest magnitude,
or to 1 where that is smaller. The camera gradient through the tiny network
is gated at 5e-4 or 3x the port's own noise floor, where that is larger
(tests/test_torch_train.py).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentfusion_tpu import distances as jdist
from latentfusion_tpu import testing as jtesting
from latentfusion_tpu import zoo as jzoo
from latentfusion_tpu.camera import Camera as JCamera
from latentfusion_tpu.observation import Observation as JObservation
from latentfusion_tpu.pose import estimation as jest
from latentfusion_tpu.pose import utils as jpu
from latentfusion_tpu.recon.inference import LatentFusionModel as JModel
from latentfusion_tpu.three import orientation as jorientation
from latentfusion_tpu.three import quaternion as jquat

from latentfusion_tpu_torch import distances as tdist
from latentfusion_tpu_torch import testing as ttesting
from latentfusion_tpu_torch import zoo as tzoo
from latentfusion_tpu_torch.camera import Camera as TCamera
from latentfusion_tpu_torch.observation import Observation as TObservation
from latentfusion_tpu_torch.pose import estimation as tpe
from latentfusion_tpu_torch.recon.checkpoint import from_jax_params
from latentfusion_tpu_torch.recon.inference import LatentFusionModel as TModel

GEOM_TOL = 2e-4
NET_TOL = 5e-4
FLOOR_EPS = (1e-7, 4e-7)
FLOOR_FACTOR = 3.0
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
def two_targets(oracles):
    """Two oracle targets at different poses, the second moved off the
    first's translation, on both sides."""
    gts = [jtesting.make_camera(1, quats=jquat.random(jax.random.PRNGKey(k), 1))
           for k in (7, 8)]
    gts[1] = gts[1].replace(translation=gts[1].translation + jnp.array([[0.08, -0.05, 0.15]]))
    jtargets = [oracles[0].make_observation(gt) for gt in gts]
    return gts, jtargets, [t_observation(o) for o in jtargets]


# --------------------------------------------------------------- distances
def test_distances_match_jax(rng):
    a = rng.randn(5, 7).astype(np.float32)
    b = rng.randn(5, 7).astype(np.float32)
    close_rel(tdist.cosine_distance(t(a), t(b)), jdist.cosine_distance(a, b), 1e-6)
    close_rel(tdist.cosine_distance(t(a[0]), t(b[0])), jdist.cosine_distance(a[0], b[0]), 1e-6)
    close_rel(tdist.cosine_distance(t(a), torch.zeros(5, 7)),
              jdist.cosine_distance(a, np.zeros((5, 7), np.float32)), 1e-6)
    for metric in ("cosine", "euclidean"):
        close_rel(tdist.pairwise_distance(t(a), t(b), metric),
                  jdist.pairwise_distance(a, b, metric), 1e-6)
        close_rel(tdist.distance(t(a), t(b), metric, dim=1),
                  jdist.distance(a, b, metric, axis=1), 1e-6)
    c = rng.randn(3, 7).astype(np.float32)
    for metric in ("cosine", "euclidean", "inner", "ols_coef"):
        close_rel(tdist.outer_distance(t(a), t(c), metric),
                  jdist.outer_distance(a, c, metric), 1e-5)


# ------------------------------------------------------------- latent code
def _to_state(params):
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return from_jax_params({jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves})


@pytest.fixture(scope="module")
def tiny():
    """The tiny family on both sides, a target frame (48x64) and 4 zoomed
    hypothesis cameras around it. The weights are drawn as the JAX zoo
    initialises them (every conv weight N(0, 1)), from numpy, with biases
    0.1 N(0, 1) so that they count too; flax's own init of the three
    modules takes about 15 s on the CPU."""
    sc, fu, ph = jzoo.tiny_sculptor(), jzoo.tiny_fuser(), jzoo.tiny_photographer()
    template = jax.eval_shape(
        lambda k: jzoo.init_recon_params(k, sc, fu, ph, batch=1, views=2),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(2)

    def draw(path, leaf):
        scale = 1.0 if jax.tree_util.keystr(path).endswith("['weight']") else 0.1
        return jnp.asarray((scale * rng.randn(*leaf.shape)).astype(np.float32))

    params = jax.tree_util.tree_map_with_path(draw, template)
    rng = np.random.RandomState(3)
    jm = JModel(sc, params["sculptor"], fu, params["fuser"], ph, params["photographer"],
                camera_dist=1.5)
    tm = TModel(tzoo.tiny_sculptor(device="cpu"), _to_state(params["sculptor"]),
                tzoo.tiny_fuser(device="cpu"), _to_state(params["fuser"]),
                tzoo.tiny_photographer(device="cpu"), _to_state(params["photographer"]),
                camera_dist=1.5, device="cpu")
    K = np.array([[64, 0, 32], [0, 64, 24], [0, 0, 1]], np.float32)
    q = rng.randn(5, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    trans = (np.array([0.02, -0.01, 1.5], np.float32)
             + 0.02 * rng.randn(5, 3).astype(np.float32))
    from latentfusion_tpu import three as jthree

    ext = np.asarray(jthree.to_extrinsic_matrix(jnp.asarray(trans), jnp.asarray(q)))
    jcam = JCamera(np.tile(K, (4, 1, 1)), ext[1:], width=64, height=48).zoom(None, 16, 1.5)
    mask = np.zeros((1, 1, 48, 64), np.float32)
    mask[..., 14:34, 22:42] = 1
    depth = ((1.45 + 0.1 * rng.rand(1, 1, 48, 64)) * mask).astype(np.float32)
    color = rng.rand(1, 3, 48, 64).astype(np.float32)
    jtarget = JObservation(color, depth, mask, JCamera(K, ext[:1], width=64, height=48))
    z = rng.randn(1, 1, 4, 8, 8, 8).astype(np.float32)
    return dict(jm=jm, tm=tm, jcam=jcam, jtarget=jtarget, z=z)


def test_compute_latent_code_matches_jax(tiny):
    """The target autoencoded at 4 hypothesis cameras (Sculptor encode of
    the one view at each camera, GRU fold, decode), and at one camera of a
    target of 4 frames. JAX's side is jitted (eagerly it takes 14 s)."""
    zj = np.asarray(jax.jit(tiny["jm"].compute_latent_code)(tiny["jtarget"], tiny["jcam"]))
    zt = tiny["tm"].compute_latent_code(t_observation(tiny["jtarget"]), t_camera(tiny["jcam"]))
    assert zt.shape == zj.shape and zt.shape[0] == 4
    assert float(np.abs(zj).max()) > 0
    close_rel(zt.detach(), zj, NET_TOL)
    four = TObservation.collate([t_observation(tiny["jtarget"])] * 4)
    close_rel(tiny["tm"].compute_latent_code(four, t_camera(tiny["jcam"])).detach(), zj,
              NET_TOL)


def test_latent_loss_and_camera_gradient_match_jax(tiny):
    """One refinement step with the latent term (and depth): the loss per
    hypothesis, and its gradient with respect to log_quaternion,
    translation and viewport through the render and through
    compute_latent_code, jax.grad against the port's loss_and_grads."""
    jm, tm, jcam, jtarget, z = (tiny[k] for k in ("jm", "tm", "jcam", "jtarget", "z"))
    weights = {"depth": 1.0, "latent": 0.5}
    kw = dict(ranking_size=4, loss_weights=weights, learning_rate=0.01, num_samples=4,
              num_iters=1, converge_threshold=1e-6, converge_patience=10)
    rj = jest.GradientPoseEstimator(model=jm, **kw)

    def loss(p):
        cam = jcam.replace(**p)
        zd, _, zl, zlat = rj._render_zoomed(jnp.asarray(z), cam)
        ztar = jm.compute_latent_code(jtarget, cam)
        ld = jest.default_pose_loss(jtarget, zd, zl, cam, z_pred_latent=zlat,
                                    z_target_latent=ztar)
        per = sum(jest.weigh_losses(ld, weights).values())
        return per.sum() / 4, (per, ld["latent"])

    gj, (lj, latj) = jax.jit(jax.grad(loss, has_aux=True))(
        jpu.camera_params(jcam, optimize_viewport=True))
    rt = tpe.GradientPoseEstimator(model=tm, **kw)
    tz, ttarget, tcam = t(z), t_observation(jtarget), t_camera(jcam)
    lt, gt_ = rt.loss_and_grads(tz, ttarget, tcam)
    close_rel(lt, lj, NET_TOL)
    assert 0.01 < float(np.abs(latj).max()) <= 2.0
    floors = []
    for eps in FLOOR_EPS:
        for draw in range(3):
            with ttesting.convs_perturbed(tm.sculptor, eps, draw), \
                    ttesting.convs_perturbed(tm.photographer, eps, draw + 10):
                _, gp = rt.loss_and_grads(tz, ttarget, tcam)
            floors.append(max(float((gp[k] - gt_[k]).abs().max() / gt_[k].abs().max())
                              for k in gt_))
    tol = max(NET_TOL, FLOOR_FACTOR * max(floors))
    for key, g in gt_.items():
        ref = np.asarray(gj[key])
        assert float(np.abs(ref).max()) > 0, key
        assert np.abs(g.numpy() - ref).max() <= tol * np.abs(ref).max(), (key, tol)


# -------------------------------------------------------------- metropolis
def test_metropolis_rule_matches_jax(rng):
    mean_z = np.float32(3.7)
    for step in (0, 1, 17, 299):
        close_rel(tpe.metropolis_temperature(step, torch.tensor(mean_z), 300),
                  jest.metropolis_temperature(step, jnp.asarray(mean_z), 300), 1e-6)
    prev = (rng.rand(64) * 0.2).astype(np.float32)
    loss = (rng.rand(64) * 0.2).astype(np.float32)
    u = rng.rand(64).astype(np.float32)
    for temperature in (0.02, 0.001):
        accept = tpe.metropolis_accept(t(prev), t(loss), temperature, t(u))
        np.testing.assert_array_equal(
            accept.numpy(), np.asarray(jest.metropolis_accept(prev, loss, temperature, u)))
    # The first proposal always replaces the initial error of 100.
    assert bool(tpe.metropolis_accept(torch.full((3,), 100.0), torch.ones(3), 1e-4,
                                      torch.full((3,), 0.999)).all())


class JaxMetropolisDraws:
    """The random draws of JAX's Metropolis loops (``_estimate`` and
    ``estimate_batch`` in latentfusion_tpu/pose/estimation.py), for the
    port's ``draws``: per object, the key splits into (key, sub) and the
    sunflower rotations come from sub's second half; each iteration splits
    the key into (key, k1, k2), k1 into the translation and rotation
    normals, and k2 gives the uniforms."""

    def __init__(self, key):
        self.key = key

    def hypotheses(self, n, upright, hemisphere):
        self.key, sub = jax.random.split(self.key)
        return t(jorientation.evenly_distributed_quats(
            n, hemisphere=hemisphere, upright=upright, key=jax.random.split(sub)[1]))

    def step(self, n):
        self.key, k1, k2 = jax.random.split(self.key, 3)
        ka, kb = jax.random.split(k1)
        return (t(jax.random.normal(ka, (n, 3))), t(jax.random.normal(kb, (n, 3))),
                t(jax.random.uniform(k2, (n,))))


METROPOLIS = dict(ranking_size=8, loss_weights={"depth": 1.0}, num_samples=16,
                  num_iters=8)


def _same_rankings(ours, ref):
    for o, r in zip(ours, ref):
        close_rel(o.translation, r.translation, NET_TOL)
        close_rel(o.log_quaternion, r.log_quaternion, NET_TOL)
        close_rel(o.viewport, r.viewport, GEOM_TOL)


def test_metropolis_loop_with_jax_draws_matches_jax(two_targets, oracles, monkeypatch):
    """The whole Metropolis loop on the oracle with JAX's draws injected
    (initial rotations, perturbation normals, uniforms): the rankings agree
    rank by rank within 5e-4. A planted fault in the accept rule (the
    energy difference the wrong way round) fails the comparison."""
    _, jtargets, ttargets = two_targets
    key = jax.random.PRNGKey(21)
    ref = jest.MetropolisPoseEstimator(model=oracles[0], **METROPOLIS).estimate(
        None, jtargets[0], key=key)
    est = tpe.MetropolisPoseEstimator(model=oracles[1], **METROPOLIS)
    ours = est.estimate(None, ttargets[0], draws=JaxMetropolisDraws(key))
    assert len(ours) == 8
    _same_rankings([ours], [ref])
    rule = tpe.metropolis_accept
    monkeypatch.setattr(tpe, "metropolis_accept",
                        lambda prev, loss, temp, u: rule(loss, prev, temp, u))
    faulty = est.estimate(None, ttargets[0], draws=JaxMetropolisDraws(key))
    with pytest.raises(AssertionError):
        _same_rankings([faulty], [ref])


def test_metropolis_estimate_batch_matches_jax(two_targets, oracles):
    """Two objects' chains in one loop, JAX's draws injected, against JAX's
    estimate_batch: each object's ranking, rank by rank."""
    _, jtargets, ttargets = two_targets
    key = jax.random.PRNGKey(22)
    ref = jest.MetropolisPoseEstimator(model=oracles[0], **METROPOLIS).estimate_batch(
        jnp.zeros((2, 1, 1, 1, 1, 1)), jtargets, key=key)
    ours = tpe.MetropolisPoseEstimator(model=oracles[1], **METROPOLIS).estimate_batch(
        torch.zeros(2, 1, 1, 1, 1, 1), ttargets, draws=JaxMetropolisDraws(key))
    assert len(ours) == 2 and all(len(c) == 8 for c in ours)
    _same_rankings(ours, ref)


# ---------------------------------------------------------------------- CEM
class JaxCemBatchDraws(JaxMetropolisDraws):
    """The random draws of JAX's multi-object CEM loop (``estimate_batch``
    and ``_make_batch_run``): the initial rotations as the Metropolis
    loops draw them; then the key splits into the first fits' key and the
    loop's, each fit key into one per object; each iteration splits the
    loop key into (key, k_samp, k_fit), k_samp into one per object (whose
    GMM sample and noise split as the single-object loop's) and k_fit into
    the next fits' keys."""

    def __init__(self, key, n_components, num_objects):
        super().__init__(key)
        self.n_components, self.num_objects = n_components, num_objects
        self.fit_keys = None

    def init_index(self, weights):
        if self.fit_keys is None:
            k0, self.key = jax.random.split(self.key)
            self.fit_keys = jax.random.split(k0, self.num_objects)
        n = weights.shape[1]
        return torch.stack([t(jax.random.choice(
            k, n, (self.n_components,), replace=n < self.n_components,
            p=jnp.asarray(w.numpy()))) for k, w in zip(self.fit_keys, weights)])

    def sample(self, weights, n):
        self.key, k_samp, k_fit = jax.random.split(self.key, 3)
        self.fit_keys = jax.random.split(k_fit, self.num_objects)
        out = []
        for k, w in zip(jax.random.split(k_samp, self.num_objects), weights):
            k1, k2, k3 = jax.random.split(k, 3)
            k_comp, k_eps = jax.random.split(k1)
            comp = jax.random.categorical(
                k_comp, jnp.log(jnp.maximum(jnp.asarray(w.numpy()), 1e-30)), shape=(n,))
            noise = jnp.concatenate([jax.random.normal(k2, (n, 3)),
                                     jax.random.normal(k3, (n, 3))], axis=1)
            out.append((t(comp).long(), t(jax.random.normal(k_eps, (n, 6))), t(noise)))
        return tuple(torch.stack(x) for x in zip(*out))


def test_cem_estimate_batch_with_jax_draws_matches_jax(two_targets, oracles):
    """Two objects' CEM in one loop with JAX's draws injected (initial
    rotations, each fit's initial means, each iteration's samples and
    noise), against JAX's estimate_batch: each object's ranking, rank by
    rank. Translation 2e-4, log-quaternion 1e-3 (the refits amplify fp32
    differences, tests/test_torch_pose.py)."""
    _, jtargets, ttargets = two_targets
    kw = dict(ranking_size=8, loss_weights={"depth": 1.0}, num_samples=32, num_elites=12,
              num_iters=4, num_gmm_components=3, learning_rate=0.9)
    key = jax.random.PRNGKey(23)
    ref = jest.CrossEntropyPoseEstimator(model=oracles[0], **kw).estimate_batch(
        jnp.zeros((2, 1, 1, 1, 1, 1)), jtargets, key=key)
    ours = tpe.CrossEntropyPoseEstimator(model=oracles[1], **kw).estimate_batch(
        torch.zeros(2, 1, 1, 1, 1, 1), ttargets, draws=JaxCemBatchDraws(key, 3, 2))
    assert len(ours) == 2 and all(len(c) == 8 for c in ours)
    for o, r in zip(ours, ref):
        close_rel(o.translation, r.translation, GEOM_TOL)
        assert float((o.log_quaternion - t(r.log_quaternion)).abs().max()) <= 1e-3


def test_cem_estimate_batch_flips_keep_object_blocks(two_targets, oracles):
    """With ``sample_flipped`` each object's block holds its own draws and
    their three flips; every ranked camera of object b carries object b's
    intrinsic and frame."""
    _, _, ttargets = two_targets
    est = tpe.CrossEntropyPoseEstimator(
        model=oracles[1], ranking_size=4, loss_weights={"depth": 1.0}, num_samples=16,
        num_elites=8, num_iters=2, num_gmm_components=2, learning_rate=0.9,
        sample_flipped=True)
    cams = est._params_to_camera(torch.randn(2, 4, 6), TCamera.cat(
        [o.camera for o in ttargets]))
    flipped = est._with_flips(cams, 2)
    assert len(flipped) == 16 * 2
    for b in range(2):
        block = flipped[b * 16:(b + 1) * 16]
        torch.testing.assert_close(block[:4].translation, cams[b * 4:(b + 1) * 4].translation)
        for i, axis in enumerate(((0.0, 0.0, 1.0), (0.0, 1.0, 0.0), (1.0, 0.0, 0.0))):
            ref = tpe.pu.flip_camera(cams[b * 4:(b + 1) * 4], axis)
            torch.testing.assert_close(block[4 * (i + 1):4 * (i + 2)].log_quaternion,
                                       ref.log_quaternion)
    out = est.estimate_batch(torch.zeros(2, 1, 1, 1, 1, 1), ttargets,
                             generator=torch.Generator().manual_seed(0))
    assert [len(c) for c in out] == [4, 4]


# ----------------------------------------------------------------- gradient
def _target_quadratic(target, z_depth, z_mask_logits, cam, **_):
    """A smooth loss of each hypothesis' pose against its own target frame's
    camera: the per-object alignment of the targets shows in it."""
    return {"depth": ((cam.log_quaternion - target.camera.log_quaternion) ** 2).sum(-1)
            + ((cam.translation - target.camera.translation) ** 2).sum(-1),
            "ov_depth": 1e-7 * (cam.viewport ** 2).sum(-1)}


def _init_blocks(gts):
    """4 perturbed hypotheses around each ground truth (tests/test_pose.py's
    TestGradientBatch)."""
    blocks = []
    for gt, seed in zip(gts, (11, 22)):
        pert = jquat.perturb(jax.random.PRNGKey(seed), gt.quaternion, 0.15)
        cam = gt.with_quaternion(pert).replace(
            translation=gt.translation + jnp.array([[0.02, -0.02, 0.04]]))
        blocks.append(jpu.perturb_camera(jax.random.PRNGKey(seed + 1),
                                         JCamera.cat([cam] * 4), 0.005, 0.02))
    return blocks


@pytest.mark.parametrize("loss", ["target_quadratic", "default"])
def test_gradient_estimate_batch_matches_jax_and_single(two_targets, oracles, loss):
    """Two objects refined in one loop from fixed cameras: against JAX's
    estimate_batch (loss history (num_iters, 2), each object's ranking) and
    against the port's own single-object estimate of each object. With the
    smooth loss of the pose against each object's target camera, 20 steps;
    with the default loss, whose gradient jumps with the renders' last bits,
    one step against JAX and 20 against the port's single estimates."""
    gts, jtargets, ttargets = two_targets
    inits = _init_blocks(gts)
    kw = dict(ranking_size=4, loss_weights={"depth": 1.0, "ov_depth": 0.3},
              learning_rate=0.01, num_samples=4, converge_threshold=1e-6,
              converge_patience=40, optimizer="adam", track_stats=True)
    steps = 20
    jkw = dict(kw, num_iters=steps if loss == "target_quadratic" else 1)
    rj = jest.GradientPoseEstimator(model=oracles[0], **jkw)
    rt = tpe.GradientPoseEstimator(model=oracles[1], **jkw)
    if loss == "target_quadratic":
        rj.loss_func, rt.loss_func = _target_quadratic, _target_quadratic
    ref, sj = rj.estimate_batch(jnp.zeros((2, 1, 1, 1, 1, 1)), jtargets,
                                cameras=JCamera.cat(inits))
    z = torch.zeros(2, 1, 1, 1, 1, 1)
    ours, st = rt.estimate_batch(z, ttargets, cameras=t_camera(JCamera.cat(inits)))
    assert st["loss_history"].shape == (jkw["num_iters"], 2)
    assert st["num_steps"] == int(sj["num_steps"])
    close_rel(st["loss_history"], sj["loss_history"], GEOM_TOL)
    for o, r in zip(ours, ref):
        for field in ("translation", "log_quaternion", "viewport"):
            close_rel(getattr(o, field), getattr(r, field), GEOM_TOL)

    rt = tpe.GradientPoseEstimator(model=oracles[1], **dict(kw, num_iters=steps))
    if loss == "target_quadratic":
        rt.loss_func = _target_quadratic
    ours, st = rt.estimate_batch(z, ttargets, cameras=t_camera(JCamera.cat(inits)))
    for b in range(2):
        single, ss = rt.estimate(None, ttargets[b], camera=t_camera(inits[b]))
        torch.testing.assert_close(st["loss_history"][:, b], ss["loss_history"],
                                   rtol=1e-6, atol=1e-7)
        for field in ("translation", "log_quaternion", "viewport"):
            torch.testing.assert_close(getattr(ours[b], field), getattr(single, field),
                                       rtol=1e-6, atol=1e-6)
        hist = st["loss_history"][:, b]
        assert float(hist.min()) < float(hist[0])
    # Each object's result tracks its own target.
    dist = [[float(torch.linalg.norm(ours[b].translation[0] - t(g.translation[0])))
             for g in gts] for b in range(2)]
    assert dist[0][0] < dist[0][1] and dist[1][1] < dist[1][0]


def test_batch_step_normalises_per_object(two_targets, oracles):
    """One step of two objects: each object's loss and camera gradient are
    those of its own single-object step (the loss summed over the object's
    hypotheses and divided by their count, not by the batch's)."""
    gts, _, ttargets = two_targets
    inits = [t_camera(c).zoom(None, 64, oracles[1].camera_dist) for c in _init_blocks(gts)]
    rt = tpe.GradientPoseEstimator(
        model=oracles[1], ranking_size=4, loss_weights={"depth": 1.0, "ov_depth": 0.3},
        learning_rate=0.01, num_samples=4, num_iters=1, converge_threshold=1e-6,
        converge_patience=10)
    both = TObservation.collate(ttargets)
    loss, grads = rt.loss_and_grads(torch.zeros(2, 1, 1, 1, 1, 1),
                                    tpe.repeat_frames(both, 4), TCamera.cat(inits),
                                    num_objects=2)
    for b in range(2):
        lb, gb = rt.loss_and_grads(None, ttargets[b], inits[b])
        torch.testing.assert_close(loss[4 * b:4 * (b + 1)], lb)
        for k in gb:
            torch.testing.assert_close(grads[k][4 * b:4 * (b + 1)], gb[k])


# ------------------------------------------------------------------ configs
def test_load_from_config_builds_metropolis_like_jax(oracles):
    config = {"type": "metropolis", "loss_weights": {"depth": 1.0, "latent": 0.1},
              "args": {"num_samples": 32, "num_iters": 5, "ranking_size": 4,
                       "translation_std": 0.02}}
    ej = jest.load_from_config(config, oracles[0])
    et = tpe.load_from_config(config, oracles[1], num_iters=7)
    assert isinstance(et, tpe.MetropolisPoseEstimator)
    for name in ("num_samples", "ranking_size", "translation_std", "quaternion_std",
                 "loss_weights"):
        assert getattr(et, name) == getattr(ej, name), name
    assert et.num_iters == 7
    kinds = {type(tpe.load_from_config(c, oracles[1])).__name__ for c in CONFIGS}
    assert kinds == {"CrossEntropyPoseEstimator", "GradientPoseEstimator"}
    with pytest.raises(ValueError, match="Unknown estimator"):
        tpe.load_from_config({"type": "annealing", "args": {}, "loss_weights": {}},
                             oracles[1])


def test_latent_configs_run_on_the_oracle(two_targets, oracles):
    """configs/cross_entropy_latent.toml and adam_latent.toml, cut to a few
    iterations, run on the oracle (whose latents are zeros, so the latent
    term is a constant)."""
    _, _, ttargets = two_targets
    configs = {c.stem: c for c in CONFIGS}
    coarse = tpe.load_from_config(configs["cross_entropy_latent"], oracles[1], num_iters=2,
                                  num_samples=16, num_elites=8)
    fine = tpe.load_from_config(configs["adam_latent"], oracles[1], num_iters=2,
                                num_samples=4, ranking_size=4, track_stats=True)
    cams = coarse.estimate(None, ttargets[0], generator=torch.Generator().manual_seed(0))
    best, stats = fine.estimate(None, ttargets[0], camera=cams[:4])
    assert len(best) == 4 and stats["num_steps"] == 2
    assert bool(torch.isfinite(stats["loss_history"]).all())
