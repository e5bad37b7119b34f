"""The port's captured-data loaders and MOPED tracking held against the JAX
package on the CPU: ``pointcloud.filter_outliers`` (scikit-learn's
isolation forest rebuilt in numpy) against sklearn's; ``RealsenseDataset``
on the committed synthetic MOPED capture and ``ColmapDataset`` on a
synthetic COLMAP export against JAX's, with the outlier filter patched to
the same mask on both sides; both trajectory formats; the committed
capture against what ``tests/make_moped_synth.py`` writes; images read by
their bytes; and ``poserbpf_comparison`` on a tiny model with JAX's random
draws injected, against ``tools/poserbpf_comparison.py``.

Tolerances: extrinsics 1e-5 (fp32 products of the same inputs); tracked
poses as the pose tests hold CEM against JAX's (``tests/test_torch_pose.py``):
translations 2e-4 relative, rotations 1e-3 rad (a warm-started frame
refines from the last one's estimate, compounding the loops' rounding)."""
import json
import sys
from pathlib import Path

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "tests"))

import make_moped_synth  # noqa: E402
import test_evaluate_bop as fake_bop  # noqa: E402
from test_torch_pose import JaxCemDraws, t  # noqa: E402
from latentfusion_tpu.data import colmap as jcolmap  # noqa: E402
from latentfusion_tpu.data import realsense as jrealsense  # noqa: E402
from latentfusion_tpu.three import orientation as jorientation  # noqa: E402

from latentfusion_tpu_torch import jpeg, pointcloud, poserbpf_comparison  # noqa: E402
from latentfusion_tpu_torch.data import colmap as tcolmap  # noqa: E402
from latentfusion_tpu_torch.data import realsense as trealsense  # noqa: E402

CAPTURE = make_moped_synth.OUT
EXT_TOL = 1e-5
GEOM_TOL = 2e-4
ROT_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ filter_outliers
def planted_cloud(seed, n=4000, share=0.05):
    rng = np.random.default_rng(seed)
    k = int(n * share)
    surface = rng.normal(size=(n - k, 3))
    surface = surface / np.linalg.norm(surface, axis=1, keepdims=True) * (0.21, 0.36, 0.5)
    direction = rng.normal(size=(k, 3))
    direction /= np.linalg.norm(direction, axis=1, keepdims=True)
    outliers = direction * rng.uniform(0.8, 1.5, (k, 1))
    return np.concatenate([surface, outliers]).astype(np.float32), k


@pytest.mark.parametrize("seed", [0, 1])
def test_filter_outliers_matches_sklearn(seed):
    """Kept sets agree on at least 98 % of the points of a cloud with 5 %
    planted outliers at the default contamination (0.05), and both remove
    every planted outlier."""
    from sklearn.ensemble import IsolationForest

    points, k = planted_cloud(seed)
    ours = pointcloud.filter_outliers(points, rng=np.random.default_rng(seed)).numpy()
    theirs = IsolationForest(n_estimators=100, contamination=0.05,
                             random_state=0).fit_predict(points) > 0
    assert ours.dtype == bool and ours.shape == (len(points),)
    assert (ours == theirs).mean() >= 0.98
    assert not ours[-k:].any() and not theirs[-k:].any()
    assert ours.sum() == theirs.sum()


def test_filter_outliers_path_lengths():
    np.testing.assert_allclose(pointcloud.average_path_length([0, 1, 2, 3, 256]),
                               [0.0, 0.0, 1.0, 2 * (np.log(2) + np.euler_gamma) - 4 / 3,
                                2 * (np.log(255) + np.euler_gamma) - 2 * 255 / 256])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pointcloud.filter_outliers(np.zeros((4, 3)), type="elliptic",
                                   rng=np.random.default_rng(0))
    with pytest.raises(ValueError):
        pointcloud.filter_outliers(np.zeros((4, 3)), type="lof", rng=np.random.default_rng(0))


# ------------------------------------------------------------------ datasets
@pytest.fixture
def same_filter(monkeypatch):
    """Both packages' datasets keep every third point and drop the rest."""
    def fixed(points, *args, **kwargs):
        return np.arange(len(points)) % 3 != 1

    monkeypatch.setattr(jrealsense, "filter_outliers", fixed)
    monkeypatch.setattr(jcolmap, "filter_outliers", fixed)
    monkeypatch.setattr(trealsense, "filter_outliers", lambda *a, **k: torch.from_numpy(fixed(*a)))
    monkeypatch.setattr(tcolmap, "filter_outliers", lambda *a, **k: torch.from_numpy(fixed(*a)))


def _same_items(tds, jds, inds):
    for i in inds:
        t_item, j_item = tds[i], jds[i]
        assert set(t_item) == set(j_item)
        for key in ("color", "mask", "depth"):
            if key in j_item:
                np.testing.assert_array_equal(t_item[key], np.asarray(j_item[key]), err_msg=key)
                assert t_item[key].dtype == np.asarray(j_item[key]).dtype
        np.testing.assert_allclose(t_item["intrinsic"], np.asarray(j_item["intrinsic"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(t_item["extrinsic"], np.asarray(j_item["extrinsic"]),
                                   atol=EXT_TOL)


@pytest.mark.parametrize("image_scale", [0.2, 0.37])
def test_realsense_dataset_matches_jax(same_filter, image_scale):
    tds = trealsense.RealsenseDataset(CAPTURE / "reference", image_scale=image_scale)
    jds = jrealsense.RealsenseDataset(CAPTURE / "reference", image_scale=image_scale)
    assert len(tds) == len(jds) == make_moped_synth.REFERENCE_VIEWS
    assert tds.get_ids() == jds.get_ids()
    np.testing.assert_array_equal(tds.points, jds.points)
    np.testing.assert_allclose(tds.centroid, jds.centroid, rtol=1e-6)
    assert abs(tds.object_scale - jds.object_scale) <= 1e-6 * jds.object_scale
    np.testing.assert_allclose(tds.quaternions.numpy(), np.asarray(jds.quaternions), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(tds.sample_evenly(5)),
                                  np.asarray(jds.sample_evenly(5)))
    _same_items(tds, jds, [0, 7, 15])
    # The evaluation capture against the reference's points.
    tev = trealsense.RealsenseDataset(CAPTURE / "evaluation", ref_points=tds.points)
    jev = jrealsense.RealsenseDataset(CAPTURE / "evaluation", ref_points=jds.points)
    assert tev.object_scale == pytest.approx(jev.object_scale, rel=1e-6)
    _same_items(tev, jev, [0, 4])


def test_realsense_without_odometry_or_registration(same_filter):
    kwargs = {"odometry_type": None, "object_scale": 2.0}
    _same_items(trealsense.RealsenseDataset(CAPTURE / "evaluation", **kwargs),
                jrealsense.RealsenseDataset(CAPTURE / "evaluation", **kwargs), [1])
    kwargs = {"use_registration": False, "center_object": False}
    tds = trealsense.RealsenseDataset(CAPTURE / "reference", **kwargs)
    jds = jrealsense.RealsenseDataset(CAPTURE / "reference", **kwargs)
    np.testing.assert_allclose(tds.points, jds.points, rtol=1e-6)
    _same_items(tds, jds, [2])
    with pytest.raises(ValueError, match="auto"):
        trealsense.RealsenseDataset(CAPTURE / "reference", odometry_type=None)


def test_committed_capture_normalises_to_the_ellipsoid():
    """The port's dataset, with its own outlier filter, recovers the
    generator's scale (10 units a metre), centre and normalised cameras."""
    rng = np.random.default_rng(make_moped_synth.SEED)
    make_moped_synth.object_points(rng)
    ref_cams = make_moped_synth.reference_cameras(rng, make_moped_synth.REFERENCE_VIEWS)
    arc = make_moped_synth.arc_cameras(rng, make_moped_synth.EVAL_FRAMES)
    tds = trealsense.RealsenseDataset(CAPTURE / "reference")
    assert len(tds.points) == 9 * make_moped_synth.OUTLIERS + 1
    assert tds.object_scale == pytest.approx(make_moped_synth.UNITS_PER_METRE, rel=1e-4)
    np.testing.assert_allclose(tds.centroid, make_moped_synth.OBJECT_CENTER, atol=1e-5)
    tev = trealsense.RealsenseDataset(CAPTURE / "evaluation", ref_points=tds.points)
    for ds, cams in ((tds, ref_cams), (tev, arc)):
        for i in range(len(ds)):
            np.testing.assert_allclose(ds[i]["extrinsic"], cams[i], atol=1e-4)


def test_committed_capture_is_what_the_generator_writes(tmp_path):
    make_moped_synth.write_all(tmp_path)
    committed = sorted(p.relative_to(CAPTURE) for p in CAPTURE.rglob("*") if p.is_file())
    written = sorted(p.relative_to(tmp_path) for p in tmp_path.rglob("*") if p.is_file())
    assert committed == written and len(committed) == 2 * 4 + 3 * 24
    for rel in committed:
        assert (CAPTURE / rel).read_bytes() == (tmp_path / rel).read_bytes(), rel
    assert sum((CAPTURE / rel).stat().st_size for rel in committed) < 2_000_000


def _write_trajectories(tmp_path, poses):
    log = []
    for i, pose in enumerate(poses):
        log.append(f"{i}\t{i}\t{i + 1}")
        log.extend("\t".join(f"{v:.8f}" for v in row) for row in np.linalg.inv(pose))
    (tmp_path / "trajectory.log").write_text("\n".join(log) + "\n")
    kf = []
    for i, pose in enumerate(poses):
        kf.append(f"frame {i}")
        kf.extend(" ".join(f"{v:.8f}" for v in row) for row in pose[:3])
    (tmp_path / "poses.txt").write_text("\n".join(kf) + "\n")


def test_trajectory_formats_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    poses = []
    for _ in range(5):
        pose = np.eye(4)
        pose[:3, :3] = make_moped_synth._quat_to_mat(rng.normal(size=4))
        pose[:3, 3] = rng.normal(size=3)
        poses.append(pose)
    _write_trajectories(tmp_path, poses)
    t_log = trealsense.read_open3d_trajectory(tmp_path / "trajectory.log")
    np.testing.assert_allclose(t_log, jrealsense.read_open3d_trajectory(
        tmp_path / "trajectory.log"), atol=1e-6)
    np.testing.assert_allclose(t_log, np.stack(poses), atol=1e-5)
    t_kf = trealsense.read_kinectfusion_trajectory(tmp_path / "poses.txt")
    np.testing.assert_array_equal(t_kf, jrealsense.read_kinectfusion_trajectory(
        tmp_path / "poses.txt"))
    assert t_kf.shape == (5, 4, 4)


def make_colmap(tmp_path, n=3):
    """A COLMAP text export of n PINHOLE views with JPEG colors and PNG masks."""
    rng = np.random.default_rng(4)
    (tmp_path / "color").mkdir()
    (tmp_path / "mask").mkdir()
    (tmp_path / "cameras.txt").write_text(
        "# Camera list\n1 PINHOLE 160 120 150.0 151.0 80.5 60.25\n")
    images = ["# Image list"]
    for i in range(n):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.normal(size=3)
        name = f"img{i:03d}.jpg"
        images.append(" ".join(map(str, [i + 1, *q.round(6), *t.round(6), 1, name])))
        images.append("10.0 20.0 -1")
        imageio.imwrite(tmp_path / "color" / name,
                        (rng.random((120, 160, 3)) * 255).astype(np.uint8))
        imageio.imwrite(tmp_path / "mask" / f"{name}.png",
                        ((rng.random((120, 160)) > 0.5) * 255).astype(np.uint8))
    (tmp_path / "images.txt").write_text("\n".join(images) + "\n")
    pts = ["# 3D point list"]
    for i in range(60):
        x = rng.normal(size=3).round(5)
        pts.append(" ".join(map(str, [i, *x, 100, 120, 140, rng.uniform(0, 3), 1, 0])))
    (tmp_path / "points3D.txt").write_text("\n".join(pts) + "\n")
    return tmp_path


class _WritableNumpy:
    """numpy whose ``asarray`` copies: JAX's ``ColmapDataset.__getitem__``
    scales ``np.asarray`` of a JAX array in place, which is read-only
    (ROADMAP.md, Queue 3)."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def asarray(x, *args, **kwargs):
        return np.array(x, *args, **kwargs)


def test_colmap_matches_jax(same_filter, tmp_path, monkeypatch):
    root = make_colmap(tmp_path)
    tds, jds = tcolmap.ColmapDataset(root), jcolmap.ColmapDataset(root)
    with pytest.raises(ValueError, match="read-only"):
        jds[0]
    monkeypatch.setattr(jcolmap, "np", _WritableNumpy())
    assert len(tds) == len(jds) == 3
    np.testing.assert_array_equal(tds.points, jds.points)
    assert tds.object_scale == pytest.approx(jds.object_scale, rel=1e-6)
    assert tds.cameras.keys() == jds.cameras.keys()
    _same_items(tds, jds, range(3))
    bad = tmp_path / "bad.txt"
    bad.write_text("1 OPENCV 10 10 1 1 1 1\n")
    with pytest.raises(ValueError, match="not supported"):
        tcolmap.parse_cameras(bad)


def test_read_image_by_its_bytes(tmp_path):
    rng = np.random.default_rng(5)
    img = (rng.random((24, 32, 3)) * 255).astype(np.uint8)
    imageio.imwrite(tmp_path / "a.jpg", img, format="JPEG")
    (tmp_path / "a_jpeg.png").write_bytes((tmp_path / "a.jpg").read_bytes())
    np.testing.assert_array_equal(trealsense.read_image(tmp_path / "a_jpeg.png"),
                                  imageio.imread(tmp_path / "a.jpg"))
    depth = (rng.random((24, 32)) * 4000).astype(np.uint16)
    imageio.imwrite(tmp_path / "d.png", depth)
    (tmp_path / "d.jpg").write_bytes((tmp_path / "d.png").read_bytes())
    np.testing.assert_array_equal(trealsense.read_image(tmp_path / "d.jpg"), depth)
    imageio.imwrite(tmp_path / "p.jpg", img, format="JPEG", progressive=True)
    with pytest.raises(jpeg.NoDecoderError, match="progressive"):
        trealsense.read_image(tmp_path / "p.jpg")
    (tmp_path / "x.png").write_bytes(b"GIF89a....")
    with pytest.raises(ValueError, match="neither"):
        trealsense.read_image(tmp_path / "x.png")


# ---------------------------------------------------------------- tracking
class JaxCemFirstDraws(JaxCemDraws):
    """JAX's CEM ``estimate`` from a key: the key splits into the loop's
    key and the hypotheses' (their rotations from the second half of its
    split), then the loop draws as ``JaxCemDraws``."""

    def __init__(self, key, n_components):
        key, self.sub = jax.random.split(key)
        super().__init__(key, n_components)

    def hypotheses(self, n, upright, hemisphere):
        return t(jorientation.evenly_distributed_quats(
            n, hemisphere=hemisphere, upright=upright, key=jax.random.split(self.sub)[1]))


def _jax_perturb(camera, translation_std, quaternion_std, generator):
    """The JAX tool's warm start: perturb_camera(PRNGKey(frame), ...); the
    port seeds the frame's generator with the frame's index."""
    key = jax.random.PRNGKey(generator.initial_seed())
    k1, k2 = jax.random.split(key)
    noise_t = torch.from_numpy(np.array(jax.random.normal(k1, tuple(camera.translation.shape))))
    noise_q = torch.from_numpy(np.array(jax.random.normal(
        k2, tuple(camera.log_quaternion.shape))))
    return camera.replace(translation=camera.translation + noise_t * translation_std,
                          log_quaternion=camera.log_quaternion + noise_q * quaternion_std)


def test_poserbpf_comparison_matches_jax(same_filter, tmp_path, monkeypatch):
    """Two tracked frames of the committed capture on the tiny family's JAX
    weights (the same ``.pth``) at a small budget: frame 0's coarse search
    fed JAX's draws (its default key), frame 1's warm start JAX's
    perturbation; the rows' keys and each frame's pose distances agree.
    (A third frame starts from the second's estimate, where the two loops'
    rounding already parts them by up to 5e-3.)"""
    import poserbpf_comparison as jtool

    ckpt = fake_bop.make_checkpoint(tmp_path)
    coarse, fine = fake_bop.write_mini_configs(tmp_path)
    argv = ["--checkpoint", str(ckpt), "--reference-scene", str(CAPTURE / "reference"),
            "--eval-scene", str(CAPTURE / "evaluation"), "--num-ref-views", "4",
            "--coarse-config", str(coarse), "--fine-config", str(fine), "--max-frames", "2"]
    monkeypatch.setattr(sys, "argv", ["poserbpf_comparison.py"] + argv
                        + ["--out", str(tmp_path / "jax")])
    jtool.main()
    monkeypatch.setattr(poserbpf_comparison, "perturb_camera", _jax_perturb)
    rows, cameras = poserbpf_comparison.main(
        argv + ["--out", str(tmp_path / "port"), "--device", "cpu"],
        first_draws=JaxCemFirstDraws(jax.random.PRNGKey(0), 2))
    j_rows = json.loads((tmp_path / "jax" / "results.json").read_text())
    assert json.loads((tmp_path / "port" / "results.json").read_text()) == rows
    assert [list(r) for r in rows] == [list(r) for r in j_rows]
    assert [r["frame"] for r in rows] == [0, 1] and len(cameras) == 2
    for r, j in zip(rows, j_rows):
        assert abs(r["translation_dist"] - j["translation_dist"]) <= GEOM_TOL * max(
            abs(j["translation_dist"]), 1.0), (r, j)
        assert abs(r["rotation_dist"] - j["rotation_dist"]) <= ROT_TOL, (r, j)


def test_poserbpf_comparison_refuses_video_and_cpu_by_default(monkeypatch, tmp_path):
    """``--video`` is taken (``videos.py``; the tracked frames are
    tests/test_torch_videos.py's): the run goes on to read the checkpoint.
    Without a GPU the tool refuses to run unless asked for the CPU."""
    argv = ["--checkpoint", "x.pth", "--reference-scene", str(CAPTURE / "reference"),
            "--eval-scene", str(CAPTURE / "evaluation")]
    with pytest.raises(FileNotFoundError, match="x.pth"):
        poserbpf_comparison.main(argv + ["--video", "--device", "cpu",
                                         "--out", str(tmp_path / "out")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        poserbpf_comparison.main(argv)
