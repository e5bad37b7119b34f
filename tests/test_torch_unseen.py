"""The port's held-out unseen-object evaluation
(``latentfusion_tpu_torch/unseen_eval.py``) held against the JAX package's
(``tools/unseen_eval.py``, ``tools/train_unseen_objects.py``) on the CPU:
the committed cameras against JAX's draws, ``evaluate_object`` at the tiny
family with JAX's CEM draws injected, ``main``'s artifact, the mid family
on its checkpoint (slow) and pool-128's refinement from JAX's coarse
cameras (slow).

Tolerances (fp32): 2e-4 for geometry (poses and ADD-S), 5e-4 for networks,
relative to the reference's largest magnitude or to 1 where that is
smaller.
"""
import json
import sys
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
from latentfusion_tpu.pose import metrics as jmetrics
from latentfusion_tpu.recon.inference import LatentFusionModel as JModel
from latentfusion_tpu.three import orientation as jorientation
from latentfusion_tpu.three import quaternion as jquat

from latentfusion_tpu_torch import unseen_eval
from latentfusion_tpu_torch.camera import Camera as TCamera
from latentfusion_tpu_torch.observation import Observation as TObservation
from latentfusion_tpu_torch.pose import metrics as tmetrics

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

GEOM_TOL = 2e-4
NET_TOL = 5e-4
# tests/test_unseen_objects_smoke.py's shrunken search budget.
TINY_BUDGET = {"cem_samples": 8, "cem_iters": 2, "cem_elites": 4, "refine_samples": 2,
               "refine_iters": 3}
TINY_FLAGS = ["--eval-views", "2", "--cem-samples", "8", "--cem-iters", "2",
              "--cem-elites", "4", "--refine-samples", "2", "--refine-iters", "3"]


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


def t(x):
    return torch.from_numpy(np.array(x))


def t_camera(jc: JCamera) -> TCamera:
    return TCamera(t(jc.intrinsic), None, jc.z_span, t(jc.viewport), width=jc.width,
                   height=jc.height, log_quaternion=t(jc.log_quaternion),
                   translation=t(jc.translation), device="cpu")


def t_observation(jo: JObservation) -> TObservation:
    return TObservation(t(jo.color), t(jo.depth), t(jo.mask), t_camera(jo.camera))


def j_cameras(n_views, n_targets):
    """The committed cameras as JAX cameras (as ``unseen_eval.load_cameras``
    builds the port's)."""
    rec = json.loads(unseen_eval.CAMERAS.read_text())

    def cams(part, lo, hi):
        intrinsic = np.broadcast_to(np.asarray(part["intrinsic"], np.float32), (hi - lo, 3, 4))
        return JCamera(jnp.asarray(intrinsic),
                       jnp.asarray(np.asarray(part["extrinsic"][lo:hi], np.float32)),
                       z_span=0.5, width=640, height=480)

    return (cams(rec["reference"], 0, n_views),
            [cams(rec["targets"], i, i + 1) for i in range(n_targets)])


class JaxCemDraws:
    """The random draws of JAX's single-object CEM estimate from a key
    without cameras (``run_from_obs`` in latentfusion_tpu/pose/estimation.py),
    for the port's ``draws``: the key splits into (key, sub) and the
    sunflower rotations come from sub's second half; then the key splits
    into the first fit's key and the loop's; each iteration splits the loop
    key into (key, k_samp, k_fit), k_samp into the GMM sample's key
    (component choice, unit normals) and the translation and rotation noise
    keys; each fit draws its initial means by weight without replacement."""

    def __init__(self, key, n_components):
        self.key, self.n_components = key, n_components

    def hypotheses(self, n, upright, hemisphere):
        key, sub = jax.random.split(self.key)
        self.fit_key, self.key = jax.random.split(key)
        return t(jorientation.evenly_distributed_quats(
            n, hemisphere=hemisphere, upright=upright, key=jax.random.split(sub)[1]))

    def init_index(self, weights):
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


def cem_keys(n_targets, seed=55):
    """The CEM key of each target of tools/unseen_eval.evaluate_object."""
    keys, ek = [], jax.random.PRNGKey(seed)
    for _ in range(n_targets):
        ek, _, k2 = jax.random.split(ek, 3)
        keys.append(k2)
    return keys


def save_checkpoint(params, path: Path) -> Path:
    """``params`` as tools/train_unseen_objects.py's ``save_npz`` writes
    them: leaf i as "i", the leaves' paths in ``<stem>_keys.json``."""
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(params))[0]
    np.savez(path, **{str(i): np.asarray(leaf) for i, (_, leaf) in enumerate(flat)})
    path.with_name(f"{path.stem}_keys.json").write_text(json.dumps(
        ["/".join(map(str, p)) for p, _ in flat]))
    return path


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny family with JAX's initial weights (PRNGKey(0)), in both
    packages, and its checkpoint file."""
    sc, fu, ph = jzoo.tiny_sculptor(), jzoo.tiny_fuser(), jzoo.tiny_photographer()
    params = jzoo.init_recon_params(jax.random.PRNGKey(0), sc, fu, ph, batch=1, views=2)
    path = save_checkpoint(params, tmp_path_factory.mktemp("tiny") / "unseen_objects.npz")
    jm = JModel(sc, params["sculptor"], fu, params["fuser"], ph, params["photographer"],
                camera_dist=unseen_eval.CAMERA_DIST)
    return jm, unseen_eval.build_model("tiny", path, device="cpu"), path


# --------------------------------------------------------------- the cameras
def test_committed_cameras_are_jax_draws():
    """The targets are JAX's draws (PRNGKey(55), split in three per target)
    to the bit; the reference cameras are those of the committed renders,
    which the JAX package drew from PRNGKey(7) on the TPU: its products
    there round the rotation and translation to bf16, so they are JAX's
    fp32 draws to within 2^-7 of each entry's magnitude (at least 1)."""
    rec = json.loads(unseen_eval.CAMERAS.read_text())
    ek = jax.random.PRNGKey(55)
    for extrinsic in rec["targets"]["extrinsic"]:
        ek, k1, _ = jax.random.split(ek, 3)
        gt = jtesting.make_camera(1, z=jzoo.DEMO_CAMERA_DIST, f=615.0, width=640, height=480,
                                  quats=jquat.random(k1, 1))
        np.testing.assert_array_equal(np.asarray(extrinsic, np.float32),
                                      np.asarray(gt.extrinsic)[0])
    drawn = jzoo.random_view_cameras(jax.random.PRNGKey(7), 16)
    ref = np.asarray(rec["reference"]["extrinsic"], np.float32)
    np.testing.assert_array_equal(np.asarray(rec["reference"]["intrinsic"], np.float32),
                                  np.asarray(drawn.intrinsic)[0])
    d = np.asarray(drawn.extrinsic)
    assert (np.abs(ref - d) <= 2 ** -7 * np.maximum(np.abs(d), 1.0)).all()
    for obj in (0, 1):
        with np.load(ROOT / "artifacts" / "serving" / "frames" / f"refs_o{obj}.npz") as z:
            np.testing.assert_array_equal(ref, z["extrinsic"])
            np.testing.assert_array_equal(
                np.asarray(rec["targets"]["intrinsic"], np.float32), z["intrinsic"][0])
            for key in ("depth", "mask", "color"):
                assert rec["sums"][f"o{obj}"]["frames"][key] == z[key].astype(
                    np.float64).reshape(16, -1).sum(1).tolist()


def test_committed_sums_are_jax_renders():
    """The recorded sums of the JAX package's fp32 render at the 16
    reference cameras in one jitted call, recomputed (1e-6: another CPU's
    vector width may change a sum's order)."""
    rec = json.loads(unseen_eval.CAMERAS.read_text())
    ref, _ = j_cameras(16, 0)
    pool, _ = jtesting.sample_lobe_shapes(7919, 2)
    for obj in (0, 1):
        shape = jtesting.index_lobe_shape(pool, obj)

        @jax.jit
        def render(c):
            d, m, _, oh = jtesting.render_lobe_shape(c, shape)
            return d, m, jtesting.lobe_shape_color(c, d, m, oh, shape)

        for key, x in zip(("depth", "mask", "color"), render(ref)):
            got = np.asarray(x, np.float64).reshape(16, -1).sum(1)
            want = np.asarray(rec["sums"][f"o{obj}"]["jax_float32"][key])
            assert (np.abs(got - want) <= 1e-6 * np.abs(want)).all(), (obj, key)


def test_load_cameras():
    ref, targets = unseen_eval.load_cameras(3, 2, device="cpu")
    assert len(ref) == 3 and len(targets) == 2 and len(targets[0]) == 1
    jref, jtargets = j_cameras(3, 2)
    close_rel(ref.extrinsic, np.asarray(jref.extrinsic), 1e-6)
    close_rel(targets[1].extrinsic, np.asarray(jtargets[1].extrinsic), 1e-6)
    with pytest.raises(ValueError):
        unseen_eval.load_cameras(17, 1, device="cpu")


# ---------------------------------------------------------- the evaluation
def test_evaluate_object_with_jax_draws_matches_jax(tiny):
    """Held-out object 0 at the tiny family, two reference views and two
    targets, the smoke test's budget with the latent ranking term: the
    port's rows with JAX's CEM draws injected against
    tools/unseen_eval.evaluate_object's, coarse and refined, at 2e-4."""
    import unseen_eval as jeval

    jm, tm, _ = tiny
    extra = {"latent": 0.2}
    jref_cams, jtarget_cams = j_cameras(2, 2)
    jpool, jclouds = jtesting.sample_lobe_shapes(7919, 1)
    shape = jtesting.index_lobe_shape(jpool, 0)

    def observe(c):
        d, m, _, oh = jtesting.render_lobe_shape(c, shape)
        return JObservation(jtesting.lobe_shape_color(c, d, m, oh, shape), d, m, c)

    jref = jax.jit(observe)(jref_cams)
    targets = iter(jtarget_cams)

    def make_target(_key):
        gt = next(targets)
        return gt, jax.jit(observe)(gt)

    jrows, jacc = jeval.evaluate_object(jm, jref, make_target, jclouds[0], 2, TINY_BUDGET,
                                        extra_weights=extra)
    keys = cem_keys(2)
    trows, tacc = unseen_eval.evaluate_object(
        tm, t_observation(jref),
        [(t_camera(gt), t_observation(jax.jit(observe)(gt))) for gt in jtarget_cams],
        jclouds[0], TINY_BUDGET, extra,
        draws=lambda i: JaxCemDraws(keys[i], 6))
    assert tacc == jacc
    for tr, jr in zip(trows, jrows):
        assert tr["target"] == jr["target"] and tr["add_s_01d"] == jr["add_s_01d"]
        for stage in ("coarse", "refined"):
            for key in ("add_s", "rotation_dist", "translation_dist"):
                close_rel(tr[stage][key], jr[stage][key], GEOM_TOL)


def _check_schema(rec, heldout, batch):
    assert set(rec) >= {"heldout", "train_control", "heldout_add_s_0.1d", "split",
                        "search_budget"}
    assert rec["split"]["heldout_pool_seed"] == 7919
    assert rec["split"]["train_objects"] == 2
    assert rec["search_budget"]["cem_samples"] == 8
    assert rec["search_budget"]["rank_latent_weight"] == 0.2
    assert [o["object"] for o in rec["heldout"]] == list(range(heldout))
    assert rec["batch"] is batch
    for obj in rec["heldout"] + rec["train_control"]:
        assert len(obj["targets"]) == 1
        row = obj["targets"][0]
        assert set(row) == {"target", "coarse", "refined", "add_s_01d"}
        assert set(row["refined"]) == {"add_s", "rotation_dist", "translation_dist"}
    assert 0.0 <= rec["heldout_add_s_0.1d"] <= 1.0


@pytest.mark.parametrize("batch", [False, True])
def test_main_writes_the_jax_schema(tiny, tmp_path, batch):
    """``main`` at the tiny family on the CPU writes pose_eval.json with
    tools/train_unseen_objects.py's blocks (as
    tests/test_unseen_objects_smoke.py checks them); ``--batch`` estimates
    both held-out objects' target in one ``estimate_batch``."""
    _, _, path = tiny
    heldout = 2 if batch else 1
    argv = ["--family", "tiny", "--checkpoint", str(path), "--device", "cpu",
            "--train-objects", "2", "--heldout-objects", str(heldout),
            "--eval-targets", "1", *TINY_FLAGS, "--rank-latent-weight", "0.2",
            "--out", str(tmp_path)] + (["--batch"] if batch else [])
    summary = unseen_eval.main(argv)
    rec = json.loads((tmp_path / "pose_eval.json").read_text())
    assert rec == json.loads(json.dumps(summary))
    _check_schema(rec, heldout, batch)
    if batch:
        assert len(rec["seconds_per_batch"]) == 1


def test_main_runs_on_cuda_by_default(tiny, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, path = tiny
    with pytest.raises(RuntimeError, match="device='cpu'"):
        unseen_eval.main(["--family", "tiny", "--checkpoint", str(path),
                          "--out", str(tmp_path)])


def test_build_model_refuses_unknown_family(tiny):
    with pytest.raises(ValueError, match="family"):
        unseen_eval.build_model("flagship", tiny[2], device="cpu")


# ------------------------------------------------------- learned checkpoints
def _j_model(family, path):
    make = {"demo": (jzoo.demo_sculptor, jzoo.demo_fuser, jzoo.demo_photographer),
            "mid": (jzoo.mid_sculptor, jzoo.mid_fuser, jzoo.mid_photographer)}[family]
    sc, fu, ph = (m() for m in make)
    template = jax.eval_shape(
        lambda k: jzoo.init_recon_params(k, sc, fu, ph, batch=1, views=2),
        jax.random.PRNGKey(0))
    params = jzoo.load_params_npz(path, template)
    return JModel(sc, params["sculptor"], fu, params["fuser"], ph, params["photographer"],
                  camera_dist=jzoo.DEMO_CAMERA_DIST)


@pytest.mark.slow
def test_mid_checkpoint_decode_matches_jax():
    """The mid family (the flagship's widths at 128²) on its learned
    checkpoint: the latent of held-out object 0 from 4 reference views and
    its decode at the first target camera, port against JAX in fp32, at
    5e-4."""
    path = ROOT / "artifacts" / "unseen_objects_mid" / "unseen_objects.npz"
    jm = _j_model("mid", path)
    tm = unseen_eval.build_model("mid", path, device="cpu")
    jref_cams, jtarget_cams = j_cameras(4, 1)
    jpool, _ = jtesting.sample_lobe_shapes(7919, 1)
    oracle = jtesting.MultiLobeOracleModel(jtesting.index_lobe_shape(jpool, 0))
    jref = jax.jit(oracle.make_observation)(jref_cams)
    jz = jm.build_latent_object(jref)
    tz = tm.build_latent_object(t_observation(jref))
    close_rel(tz, np.asarray(jz), NET_TOL)
    cam = jtarget_cams[0].zoom(None, jzoo.MID_INPUT_SIZE, jzoo.DEMO_CAMERA_DIST)
    jy = jm.decode_latent(jz, cam, return_latent=False)[0]
    ty, _ = tm.decode_latent(tz, t_camera(cam), return_latent=False)
    for key in ("depth", "mask_logits"):
        close_rel(ty[key], np.asarray(jy[key]), NET_TOL)


@pytest.mark.slow
def test_pool128_refinement_from_jax_coarse_poses_matches_jax():
    """The pool-128 checkpoint's held-out object 0 and its target 0 as
    tools/unseen_eval.py estimates it: JAX's CEM (key from PRNGKey(55)) at
    the published budget, then 150 refinement steps of its top 16 in JAX
    and in the port. The refined best poses agree within 1 % of the
    diameter in ADD-S and 0.02 in translation, as the demo rig's target
    (tests/test_torch_pose.py), and on the same side of 0.1d."""
    path = ROOT / "artifacts" / "unseen_objects_pool128" / "unseen_objects.npz"
    jm = _j_model("demo", path)
    tm = unseen_eval.build_model("demo", path, device="cpu")
    jref_cams, jtarget_cams = j_cameras(16, 1)
    jpool, jclouds = jtesting.sample_lobe_shapes(7919, 1)
    oracle = jtesting.MultiLobeOracleModel(jtesting.index_lobe_shape(jpool, 0))
    jref = jax.jit(oracle.make_observation)(jref_cams)
    gt = jtarget_cams[0]
    target = jax.jit(oracle.make_observation)(gt)
    jz = jm.build_latent_object(jref)
    tz = tm.build_latent_object(t_observation(jref))
    close_rel(tz, np.asarray(jz), NET_TOL)
    budget = {"cem_samples": 128, "cem_iters": 10, "cem_elites": 48, "refine_samples": 16,
              "refine_iters": 150}
    import unseen_eval as jeval

    jcoarse, jfine = jeval.build_estimators(jm, budget)
    _, tfine = unseen_eval.build_estimators(tm, budget)
    cams = jcoarse.estimate(jz, target, key=cem_keys(1)[0])
    bj = jfine.estimate(jz, target, camera=cams[:16])
    bt = tfine.estimate(tz, t_observation(target), camera=t_camera(cams[:16]))
    points = jclouds[0]
    keys = ("add_s", "rotation_dist", "translation_dist")
    mj = jmetrics.camera_metrics(gt, bj[0], jnp.asarray(points), scale_to_meters=1.0)
    mt = tmetrics.camera_metrics(t_camera(gt), bt[0], t(points), 1.0)
    mc = jmetrics.camera_metrics(gt, cams[0], jnp.asarray(points), scale_to_meters=1.0)
    print("coarse", {k: float(mc[k]) for k in keys}, "refined JAX",
          {k: float(mj[k]) for k in keys}, "port", {k: float(mt[k]) for k in keys})
    assert abs(float(mt["add_s"]) - float(mj["add_s"])) <= 0.01 * unseen_eval.DIAMETER
    assert abs(float(mt["translation_dist"]) - float(mj["translation_dist"])) <= 0.02
    assert (float(mt["add_s"]) < 0.1) == (float(mj["add_s"]) < 0.1)
