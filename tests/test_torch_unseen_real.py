"""The port's held-out evaluation on the mesh data path
(``latentfusion_tpu_torch/unseen_real.py``) held against
``tools/train_unseen_real.py``'s evaluation on the CPU.

The tool's reference and target cameras are the draws recorded in
``unseen_cameras.json``; the demo family's leaf order is the pool-128
checkpoint's keys file, which names ``unseen_real.npz``'s leaves; the
port's rasterized observations are the tool's ``rasterize_observation``'s
(replicated here with the JAX package's calls); at the tiny family and a
cut budget the port's rows with JAX's CEM draws injected are JAX's within
GEOM_TOL (2e-4, fp32). Slow: one held-out target at the full budget on
``unseen_real.npz``, refined from JAX's coarse poses in both packages.
"""
import json
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentfusion_tpu import testing as jtesting
from latentfusion_tpu import zoo as jzoo
from latentfusion_tpu.data import rendering as jrender
from latentfusion_tpu.observation import Observation as JObservation
from latentfusion_tpu.pose import metrics as jmetrics
from latentfusion_tpu.three import quaternion as jquat

from latentfusion_tpu_torch import unseen_eval, unseen_real
from latentfusion_tpu_torch.pose import metrics as tmetrics

from test_torch_unseen import (TINY_BUDGET, JaxCemDraws, cem_keys, close_rel,  # noqa: F401
                               j_cameras, t, t_camera, t_observation, tiny, _j_model)

ROOT = Path(__file__).resolve().parents[1]
TOOL = ROOT / "tools" / "train_unseen_real.py"
sys.path.insert(0, str(ROOT / "tools"))
GEOM_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def heldout_mesh(tmp_path_factory):
    """Held-out object 0 as the rig meshes it (48 x 96 a lobe)."""
    _, clouds, paths = unseen_real.pool_meshes(tmp_path_factory.mktemp("assets"), 0, 1, True)
    return paths[0], clouds[0]


def j_rasterize_observation(mesh_path, camera):
    """``rasterize_observation`` of tools/train_unseen_real.py, line for line."""
    renderer = jrender.Renderer(width=640, height=480)
    intrinsic_full = np.array([[615.0, 0, 320], [0, 615.0, 240], [0, 0, 1]], np.float32)
    obj, _ = jrender.load_object(mesh_path, recenter=False, resize=False)
    ctx = jrender.SceneContext(obj, intrinsic_full)
    colors, depths, masks = [], [], []
    ext = np.asarray(camera.extrinsic)
    for i in range(camera.length):
        q = np.asarray(jquat.mat_to_quat(jnp.asarray(ext[i, :3, :3])))
        ctx.set_pose(ext[i, :3, 3], q)
        c, d, m = renderer.render(ctx)
        colors.append(c.transpose(2, 0, 1))
        depths.append(d[None])
        masks.append(m[None])
    return JObservation(jnp.asarray(np.stack(colors)), jnp.asarray(np.stack(depths)),
                        jnp.asarray(np.stack(masks)), camera)


# --------------------------------------------------------------- the records
def test_cameras_are_the_tools_draws():
    """The tool draws its reference views with ``zoo.random_view_cameras(
    PRNGKey(7), 16)`` and each target with ``testing.make_camera`` at
    ``quat.random`` of the first key of tools/unseen_eval.py's stream: the
    draws of unseen_cameras.json (targets to the bit; references within
    the TPU's bf16 rounding of the fp32 draws, as tests/test_torch_unseen.py
    shows for the pool-128 rig)."""
    source = TOOL.read_text()
    assert "ref_cams = zoo.random_view_cameras(jax.random.PRNGKey(7),\n" \
           "                                           args.eval_views)" in source
    assert re.search(r"testing\.make_camera\(\s*1, z=CAMERA_DIST, f=615\.0, width=640, "
                     r"height=480,\s*quats=quat\.random\(k1, 1\)\)", source)
    assert "CAMERA_DIST = 5.78" in source
    rec = json.loads(unseen_eval.CAMERAS.read_text())
    ek = jax.random.PRNGKey(55)
    for extrinsic in rec["targets"]["extrinsic"]:
        ek, k1, _ = jax.random.split(ek, 3)
        gt = jtesting.make_camera(1, z=5.78, f=615.0, width=640, height=480,
                                  quats=jquat.random(k1, 1))
        np.testing.assert_array_equal(np.asarray(extrinsic, np.float32),
                                      np.asarray(gt.extrinsic)[0])
        np.testing.assert_array_equal(np.asarray(rec["targets"]["intrinsic"], np.float32),
                                      np.asarray(gt.intrinsic)[0])
    drawn = jzoo.random_view_cameras(jax.random.PRNGKey(7), 16)
    d = np.asarray(drawn.extrinsic)
    ref = np.asarray(rec["reference"]["extrinsic"], np.float32)
    assert (np.abs(ref - d) <= 2 ** -7 * np.maximum(np.abs(d), 1.0)).all()
    np.testing.assert_array_equal(np.asarray(rec["reference"]["intrinsic"], np.float32),
                                  np.asarray(drawn.intrinsic)[0])


def test_demo_leaf_order_is_the_keys_file():
    """The demo family's parameter leaves, in JAX's flattening order, are
    the lines of the pool-128 keys file, and ``unseen_real.npz`` holds one
    array of each leaf's shape in that order."""
    sc, fu, ph = jzoo.demo_sculptor(), jzoo.demo_fuser(), jzoo.demo_photographer()
    template = jax.eval_shape(lambda k: jzoo.init_recon_params(k, sc, fu, ph, batch=1, views=2),
                              jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_flatten_with_path(template)[0]
    names = ["/".join(map(str, p)) for p, _ in flat]
    assert names == json.loads(unseen_real.KEYS.read_text())
    with np.load(unseen_real.CHECKPOINT) as data:
        assert len(data.files) == len(flat)
        for i, (_, leaf) in enumerate(flat):
            assert data[str(i)].shape == leaf.shape


def test_rasterized_observations_match_the_tools(heldout_mesh):
    path, _ = heldout_mesh
    jrefs, jtargets = j_cameras(2, 1)
    for jcam in (jrefs, jtargets[0]):
        j = j_rasterize_observation(path, jcam)
        tobs = unseen_real.rasterize_observation(path, t_camera(jcam))
        assert float(tobs.mask.sum()) > 1000
        for key in ("color", "depth", "mask"):
            np.testing.assert_array_equal(getattr(tobs, key).numpy(), np.asarray(getattr(j, key)))
    views, seconds = unseen_real.rasterized_views([path], t_camera(jrefs),
                                                  [t_camera(c) for c in jtargets])
    assert len(views) == 1 and len(views[0][1]) == 1 and seconds > 0


def test_pool_meshes_are_the_tools(tmp_path):
    """The held-out meshes: ``lobe_shape_meshes`` of seed 7919 at 48 x 96,
    in the tool's directory, written once."""
    pool, clouds, paths = unseen_real.pool_meshes(tmp_path, 0, 2, True)
    assert [p.parent.name for p in paths] == ["meshes_heldout_s7919_k2"] * 2
    jpool, jclouds = jtesting.sample_lobe_shapes(7919, 2)
    want = jtesting.lobe_shape_meshes(jpool, tmp_path / "jax", lat=48, lon=96)
    assert [p.read_text() for p in paths] == [p.read_text() for p in want]
    np.testing.assert_array_equal(clouds[1], np.asarray(jclouds[1]))
    stamp = paths[0].stat().st_mtime_ns
    unseen_real.pool_meshes(tmp_path, 0, 2, True)
    assert paths[0].stat().st_mtime_ns == stamp


# ---------------------------------------------------------- the evaluation
def test_evaluate_on_rasterized_views_with_jax_draws_matches_jax(tiny, heldout_mesh):
    """Held-out object 0 rasterized at two reference views and two targets,
    the tiny family, the smoke budget with the latent ranking term at 0.2:
    the port's rows with JAX's CEM draws against tools/unseen_eval.py's
    ``evaluate_object`` on the tool's observations, at GEOM_TOL."""
    import unseen_eval as jeval

    jm, tm, _ = tiny
    path, cloud = heldout_mesh
    extra = {"latent": unseen_real.RANK_LATENT_WEIGHT}
    jrefs, jtargets = j_cameras(2, 2)
    jref = j_rasterize_observation(path, jrefs)
    it = iter(jtargets)

    def make_target(_key):
        gt = next(it)
        return gt, j_rasterize_observation(path, gt)

    jrows, jacc = jeval.evaluate_object(jm, jref, make_target, cloud, 2, TINY_BUDGET,
                                        extra_weights=extra)
    ref, targets = unseen_real.rasterized_views([path], t_camera(jrefs),
                                                [t_camera(c) for c in jtargets])[0][0]
    keys = cem_keys(2)
    trows, tacc = unseen_eval.evaluate_object(tm, ref, targets, cloud, TINY_BUDGET, extra,
                                              draws=lambda i: JaxCemDraws(keys[i], 6))
    assert tacc == jacc
    for tr, jr in zip(trows, jrows):
        assert tr["add_s_01d"] == jr["add_s_01d"]
        for stage in ("coarse", "refined"):
            for key in ("add_s", "rotation_dist", "translation_dist"):
                close_rel(tr[stage][key], jr[stage][key], GEOM_TOL)


def test_main_writes_the_tools_schema(tmp_path):
    rec = unseen_real.main(["--out", str(tmp_path), "--device", "cpu", "--heldout-objects", "1",
                            "--eval-targets", "1", "--eval-views", "1", "--cem-samples", "4",
                            "--cem-iters", "2", "--cem-elites", "2", "--refine-samples", "1",
                            "--refine-iters", "1", "--rank-latent-weight", "0"])
    assert json.loads((tmp_path / "pose_eval.json").read_text()) == json.loads(json.dumps(rec))
    assert rec["search_budget"]["cem_samples"] == 4 and rec["family"] == "demo"
    assert rec["split"]["heldout_pool_seed"] == 7919
    held = rec["rasterizer"]["heldout"]
    assert len(held) == 1 and len(held[0]["targets"]) == 1
    row = held[0]["targets"][0]
    assert set(row) == {"target", "coarse", "refined", "add_s_01d"}
    assert rec["heldout_add_s_0.1d"] == rec["rasterizer"]["heldout_add_s_0.1d"]
    assert (tmp_path / "assets" / "meshes_heldout_s7919_k1" / "lobes_0000.obj").exists()


@pytest.mark.slow
def test_unseen_real_target_from_jax_coarse_poses_matches_jax(heldout_mesh):
    """``unseen_real.npz`` on held-out object 0's target 0 at the record's
    budget: JAX's CEM (its key from PRNGKey(55)) with the latent term at
    0.2, then 150 refinement steps of its top 16 in JAX and in the port,
    fp32. The refined best poses agree within 1 % of the diameter in ADD-S
    and 0.02 in translation and fall on the same side of 0.1d, as
    pool-128's target (tests/test_torch_unseen.py)."""
    import unseen_eval as jeval

    path, cloud = heldout_mesh
    jm = _j_model("demo", unseen_real.CHECKPOINT)
    tm = unseen_eval.build_model("demo", unseen_real.CHECKPOINT, device="cpu",
                                 keys=unseen_real.KEYS)
    jrefs, jtargets = j_cameras(16, 1)
    jref = j_rasterize_observation(path, jrefs)
    gt = jtargets[0]
    target = j_rasterize_observation(path, gt)
    jz = jm.build_latent_object(jref)
    tz = tm.build_latent_object(t_observation(jref))
    close_rel(tz, np.asarray(jz), 5e-4)
    extra = {"latent": unseen_real.RANK_LATENT_WEIGHT}
    jcoarse, jfine = jeval.build_estimators(jm, unseen_real.BUDGET, extra)
    _, tfine = unseen_eval.build_estimators(tm, unseen_real.BUDGET, extra)
    cams = jcoarse.estimate(jz, target, key=cem_keys(1)[0])
    bj = jfine.estimate(jz, target, camera=cams[:16])
    bt = tfine.estimate(tz, t_observation(target), camera=t_camera(cams[:16]))
    keys = ("add_s", "rotation_dist", "translation_dist")
    mj = jmetrics.camera_metrics(gt, bj[0], jnp.asarray(cloud), scale_to_meters=1.0)
    mt = tmetrics.camera_metrics(t_camera(gt), bt[0], t(cloud), 1.0)
    mc = jmetrics.camera_metrics(gt, cams[0], jnp.asarray(cloud), scale_to_meters=1.0)
    print("coarse", {k: float(mc[k]) for k in keys}, "refined JAX",
          {k: float(mj[k]) for k in keys}, "port", {k: float(mt[k]) for k in keys})
    assert abs(float(mt["add_s"]) - float(mj["add_s"])) <= 0.01 * unseen_eval.DIAMETER
    assert abs(float(mt["translation_dist"]) - float(mj["translation_dist"])) <= 0.02
    assert (float(mt["add_s"]) < 0.1) == (float(mj["add_s"]) < 0.1)
