"""The port's real-capture datasets and point clouds held against the JAX
package on the CPU: ``BOPDataset`` and ``Observation.from_dataset`` on a
BOP scene this test writes (PNG through imageio), the KinectFusion and
triplet datasets, ``render_observation``, ``render_random_observations``
and ``sample_eval_observations`` with JAX's draws injected (``torch.rand``
and ``torch.randn`` return JAX's uniform and normal arrays in JAX's
order), and ``pointcloud``. Arrays read from files and rendered by the
rasterizer are held bit for bit; cameras and poses (fp32 products in
another order) at 1e-6 relative, and at GEOM_TOL after a rotation's
exponential map.
"""
import json
import math
import random

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentfusion_tpu import observation as jobs
from latentfusion_tpu import pointcloud as jpc
from latentfusion_tpu.camera import Camera as JCamera
from latentfusion_tpu.data import bop as jbop
from latentfusion_tpu.data import kinectfusion as jkf
from latentfusion_tpu.data import rendering as jrender
from latentfusion_tpu.data import triplet as jtriplet
from latentfusion_tpu.three import quaternion as jquat

from latentfusion_tpu_torch import observation as tobs
from latentfusion_tpu_torch import pointcloud as tpc
from latentfusion_tpu_torch import testing as ttesting
from latentfusion_tpu_torch.camera import Camera as TCamera
from latentfusion_tpu_torch.data import bop as tbop
from latentfusion_tpu_torch.data import kinectfusion as tkf
from latentfusion_tpu_torch.data import rendering as trender
from latentfusion_tpu_torch.data import triplet as ttriplet

GEOM_TOL = 2e-4
K = np.asarray([[120.0, 0, 40.0], [0, 120.0, 30.0], [0, 0, 1.0]], np.float32)
W, H = 80, 60


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def close(a, b, tol=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(float(np.abs(b).max()), 1.0)


@pytest.fixture
def draws(monkeypatch):
    """``draws(uniform=[...], normal=[...])``: ``torch.rand`` and
    ``torch.randn`` return the lists' arrays in turn."""

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


# --------------------------------------------------------------------- BOP
@pytest.fixture(scope="module")
def bop(tmp_path_factory):
    """A LINEMOD-layout scene of one object (id 1) in 3 frames, another
    object in frame 1."""
    root = tmp_path_factory.mktemp("bop") / "lm"
    scene = root / "test" / "000001"
    for d in ("depth", "mask_visib", "rgb"):
        (scene / d).mkdir(parents=True)
    (root / "models_eval").mkdir(parents=True)
    (root / "models").mkdir()
    (root / "models_eval" / "models_info.json").write_text(json.dumps({"1": {
        "diameter": 120.0, "min_x": -50, "min_y": -40, "min_z": -30,
        "size_x": 100, "size_y": 80, "size_z": 60}}))
    rng = np.random.RandomState(0)
    cams, gts = {}, {}
    for i in range(3):
        cams[str(i)] = {"cam_K": [300.0 + i, 0, 40, 0, 301.0, 30, 0, 0, 1],
                        "depth_scale": 0.1 * (i + 1)}
        q = rng.randn(4)
        R = np.asarray(jquat.quat_to_mat(jnp.asarray(q / np.linalg.norm(q), jnp.float32)))
        gts[str(i)] = [{"obj_id": 1, "cam_R_m2c": R.ravel().tolist(),
                        "cam_t_m2c": [10.0 * i, -5.0, 400.0 + 20 * i]}]
        if i == 1:
            gts[str(i)].insert(0, {"obj_id": 2, "cam_R_m2c": np.eye(3).ravel().tolist(),
                                   "cam_t_m2c": [0.0, 0.0, 300.0]})
        obj = len(gts[str(i)]) - 1
        imageio.imwrite(scene / "rgb" / f"{i:06d}.png",
                        rng.randint(0, 256, (H, W, 3)).astype(np.uint8))
        imageio.imwrite(scene / "depth" / f"{i:06d}.png",
                        rng.randint(3000, 6000, (H, W)).astype(np.uint16))
        imageio.imwrite(scene / "mask_visib" / f"{i:06d}_{obj:06d}.png",
                        (rng.rand(H, W) > 0.5).astype(np.uint8) * 255)
    (scene / "scene_camera.json").write_text(json.dumps(cams))
    (scene / "scene_gt.json").write_text(json.dumps(gts))
    return root, scene


@pytest.mark.parametrize("center_object", [False, True])
def test_bop_dataset_matches_jax(bop, center_object):
    root, scene = bop
    j = jbop.BOPDataset(root, scene, 1, center_object=center_object)
    t = tbop.BOPDataset(root, scene, 1, center_object=center_object)
    assert len(t) == len(j) == 3 and t.get_ids() == j.get_ids()
    assert t.object_scale == j.object_scale and t.scene_object_inds == j.scene_object_inds
    close(t.quaternions, j.quaternions)
    for i in range(3):
        a, b = j[i], t[i]
        assert a.keys() == b.keys()
        for key in ("color", "mask", "depth", "intrinsic"):
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        close(b["extrinsic"], a["extrinsic"])
        close(t.denormalize_extrinsic(b["extrinsic"]), j.denormalize_extrinsic(a["extrinsic"]),
              1e-5)
        np.testing.assert_array_equal(t.denormalize_intrinsic(b["intrinsic"]).numpy(),
                                      np.asarray(j.denormalize_intrinsic(a["intrinsic"])))
    np.testing.assert_array_equal(t.sample_evenly(2).numpy(), np.asarray(j.sample_evenly(2)))


def test_observation_from_dataset_matches_jax(bop):
    root, scene = bop
    j = jobs.Observation.from_dataset(jbop.BOPDataset(root, scene, 1), inds=[0, 2])
    t = tobs.Observation.from_dataset(tbop.BOPDataset(root, scene, 1), inds=[0, 2],
                                      device="cpu")
    for key in ("color", "depth", "mask"):
        np.testing.assert_array_equal(getattr(t, key).numpy(), np.asarray(getattr(j, key)))
    close(t.camera.extrinsic, j.camera.extrinsic, 1e-5)
    np.testing.assert_array_equal(t.camera.intrinsic.numpy(), np.asarray(j.camera.intrinsic))
    assert len(tobs.Observation.from_dataset(tbop.BOPDataset(root, scene, 1),
                                             device="cpu")) == 3


def test_bop_unknown_layout_raises(tmp_path):
    with pytest.raises(ValueError, match="Unknown dataset"):
        tbop.BOPDataset(tmp_path / "ycbv", tmp_path, 1)


# -------------------------------------------------------------- KinectFusion
def test_kinectfusion_matches_jax(tmp_path):
    rng = np.random.RandomState(1)
    (tmp_path / "images").mkdir()
    np.savetxt(tmp_path / "points.xyz", rng.randn(20, 3), fmt="%.6f")
    lines = []
    for i in range(3):
        pose = np.eye(4)[:3] + 0.1 * rng.randn(3, 4)
        pose[:, 3] += [0.2, -0.1, 1.5]
        lines += [str(i)] + [" ".join(f"{v:.6f}" for v in row) for row in pose]
        imageio.imwrite(tmp_path / "images" / f"{i:04d}-color.png",
                        rng.randint(0, 256, (12, 16, 3)).astype(np.uint8))
        imageio.imwrite(tmp_path / "images" / f"{i:04d}-depth.png",
                        rng.randint(500, 3000, (12, 16)).astype(np.uint16))
    (tmp_path / "poses.txt").write_text("\n".join(lines))
    (tmp_path / "intrinsics.json").write_text(json.dumps([[50.0, 0, 8], [0, 50.0, 6], [0, 0, 1]]))
    for stride in (1, 2):
        j, t = jkf.KinectFusionDataset(tmp_path, stride), tkf.KinectFusionDataset(tmp_path, stride)
        assert len(t) == len(j)
        np.testing.assert_array_equal(t.extrinsics, j.extrinsics)
        for i in range(len(t)):
            a, b = j[i], t[i]
            for key in a:
                np.testing.assert_array_equal(b[key], a[key], err_msg=key)


def test_triplet_dataset_matches_jax():
    rng = np.random.RandomState(2)
    items = [{"x": i} for i in range(12)]
    dist = rng.rand(10, 10)
    dist = dist + dist.T
    np.fill_diagonal(dist, 0)
    for easy in (0.0, 0.5):
        j = jtriplet.TripletDataset(items, range(10), dist, k=3, easy_neg_prob=easy)
        t = ttriplet.TripletDataset(items, range(10), dist, k=3, easy_neg_prob=easy)
        assert len(t) == len(j)
        for i in range(10):
            random.seed(i)
            a = j[i]
            random.seed(i)
            assert t[i] == a


# ---------------------------------------------------------------- rendering
@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    pool, _ = ttesting.sample_lobe_shapes(7919, 1, device="cpu")
    path = ttesting.lobe_shape_meshes(pool, tmp_path_factory.mktemp("lobe"), lat=12, lon=24)[0]
    jo, _ = jrender.load_object(path)
    to, _ = trender.load_object(path)
    return (jrender.Renderer(W, H), jrender.SceneContext(jo, K),
            trender.Renderer(W, H), trender.SceneContext(to, K))


def same_observation(t, j, tol=1e-6):
    for key in ("color", "depth", "mask"):
        np.testing.assert_array_equal(getattr(t, key).numpy(), np.asarray(getattr(j, key)))
    close(t.camera.extrinsic, j.camera.extrinsic, tol)
    np.testing.assert_array_equal(t.camera.intrinsic.numpy(), np.asarray(j.camera.intrinsic))
    assert t.meta["object_scale"] == j.meta["object_scale"]


def test_render_observation_matches_jax(scenes):
    jr, js, tr, ts = scenes
    for ctx in (js, ts):
        ctx.set_pose([0.02, -0.01, 3.0], [0.8, 0.2, -0.3, 0.1])
    t = tobs.render_observation(tr, ts, device="cpu")
    assert t.mask.sum() > 100
    same_observation(t, jobs.render_observation(jr, js))


def test_render_random_observations_with_jax_draws_matches_jax(scenes, draws):
    jr, js, tr, ts = scenes
    key = jax.random.PRNGKey(3)
    bounds = ((-0.05, 0.05), (-0.05, 0.05), (2.5, 3.5))
    j = jobs.render_random_observations(jr, js, 3, *bounds, disk_sample_quats=False, key=key)
    k1, k2 = jax.random.split(key)
    kx, ky, kz = jax.random.split(k1, 3)
    draws(uniform=[np.asarray(jax.random.uniform(k, (3,))) for k in (kx, ky, kz)]
          + [np.asarray(jax.random.uniform(k2, (3, 3)))])
    t = tobs.render_random_observations(tr, ts, 3, *bounds, disk_sample_quats=False,
                                        device="cpu")
    same_observation(t, j, GEOM_TOL)


def test_sample_eval_observations_with_jax_draws_matches_jax(scenes, draws):
    jr, js, tr, ts = scenes
    key = jax.random.PRNGKey(11)
    bounds = dict(x_bound=(-0.05, 0.05), y_bound=(-0.05, 0.05), z_bound=(2.8, 3.2))
    jref, jtar = jobs.sample_eval_observations(jr, js, key=key, **bounds)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    kx, ky, kz = jax.random.split(k1, 3)
    ref_quat = jquat.random(k2, 1)[0]
    normals = [np.asarray(jax.random.normal(k3, (1, 3)))]
    tar = jquat.perturb(k3, ref_quat, math.pi / 12)
    for _ in range(16):
        if float(jquat.angular_distance(tar[None], ref_quat[None])[0, 0]) < math.pi / 4:
            break
        k3, sub = jax.random.split(k3)
        normals.append(np.asarray(jax.random.normal(sub, (1, 3))))
        tar = jquat.perturb(sub, ref_quat, math.pi / 12)
    normals.append(np.asarray(jax.random.normal(k4, (3,))))
    draws(uniform=[np.asarray(jax.random.uniform(k, (1,))) for k in (kx, ky, kz)]
          + [np.asarray(jax.random.uniform(k2, (1, 3)))], normal=normals)
    tref, ttar = tobs.sample_eval_observations(tr, ts, device="cpu", **bounds)
    same_observation(tref, jref)
    same_observation(ttar, jtar, GEOM_TOL)


# -------------------------------------------------------------- point clouds
def test_pointcloud_matches_jax(tmp_path):
    rng = np.random.RandomState(4)
    pts = rng.randn(40, 3).astype(np.float32) * 0.2
    colors = rng.rand(40, 3).astype(np.float32)
    jpc.save_ply(tmp_path / "j.ply", pts, colors)
    tpc.save_ply(tmp_path / "t.ply", torch.from_numpy(pts), torch.from_numpy(colors))
    assert (tmp_path / "t.ply").read_text() == (tmp_path / "j.ply").read_text()
    np.testing.assert_array_equal(tpc.load_ply(tmp_path / "t.ply").numpy(),
                                  np.asarray(jpc.load_ply(tmp_path / "j.ply")))

    ext = np.stack([np.eye(4, dtype=np.float32)] * 2)
    ext[:, 2, 3] = [2.0, 2.5]
    ext[1, 0, 3] = 0.1
    jcam = JCamera(jnp.asarray(np.broadcast_to(K, (2, 3, 3))), jnp.asarray(ext), width=W,
                   height=H)
    tcam = TCamera(torch.from_numpy(np.broadcast_to(K, (2, 3, 3)).copy()),
                   torch.from_numpy(ext), width=W, height=H, device="cpu")
    batch = np.stack([pts, pts[::-1].copy()])
    np.testing.assert_array_equal(tpc.project_pointcloud(tcam, torch.from_numpy(batch)).numpy(),
                                  np.asarray(jpc.project_pointcloud(jcam, jnp.asarray(batch))))
    mask = (rng.rand(2, H, W) > 0.3).astype(np.float32)
    np.testing.assert_array_equal(
        tpc.compute_point_mask(tcam, torch.from_numpy(mask), torch.from_numpy(batch)).numpy(),
        np.asarray(jpc.compute_point_mask(jcam, jnp.asarray(mask), jnp.asarray(batch))))

    plane = np.concatenate([np.c_[rng.rand(60, 2), 0.001 * rng.randn(60)],
                            np.c_[rng.rand(20, 2), 0.3 + rng.rand(20)]]).astype(np.float32)
    tm, tp = tpc.segment_plane(torch.from_numpy(plane), seed=3)
    jm, jp = jpc.segment_plane(jnp.asarray(plane), seed=3)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tp, jp)
