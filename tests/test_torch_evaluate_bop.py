"""The port's BOP evaluation (``latentfusion_tpu_torch/evaluate_bop.py``,
``pose/bop.py``) held against the JAX package's (``tools/evaluate_bop.py``)
on the CPU: ``load_intrinsics``; ``select_frames`` and the reference
indices on ``tests/test_evaluate_bop.py``'s fake scene; both tools' ``main``
on that scene with the same tiny ``.pth`` (the same frame ids and JSON keys,
metrics finite in mm); the metric rows of one estimated camera scored by
both; and the ellipsoid oracle end to end through the BOP file layout
(``tests/test_bop_accuracy.py``'s scene): ADD-S within 0.1d on every
frame, as JAX reaches there (one frame in tier-1, the scene's 8 frames
less its 4 references under ``slow``).

Tolerance: metric values 2e-4 relative (fp32 geometry; the ADD family in
mm)."""
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "tests"))

import evaluate_bop as jeval  # noqa: E402
import test_bop_accuracy as bop_accuracy  # noqa: E402
import test_evaluate_bop as fake_bop  # noqa: E402
from latentfusion_tpu.camera import Camera as JCamera  # noqa: E402
from latentfusion_tpu.data.bop import BOPDataset as JBOPDataset  # noqa: E402
from latentfusion_tpu.pose import bop as jbop  # noqa: E402
from latentfusion_tpu.pose import metrics as jmetrics  # noqa: E402

from latentfusion_tpu_torch import evaluate_bop as teval  # noqa: E402
from latentfusion_tpu_torch import testing as ttesting  # noqa: E402
from latentfusion_tpu_torch.camera import Camera as TCamera  # noqa: E402
from latentfusion_tpu_torch.data.bop import BOPDataset as TBOPDataset  # noqa: E402
from latentfusion_tpu_torch.pose import bop as tbop  # noqa: E402
from latentfusion_tpu_torch.pose import metrics as tmetrics  # noqa: E402
from latentfusion_tpu_torch.recon import inference as tinference  # noqa: E402

GEOM_TOL = 2e-4



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bop")
    root, scene = fake_bop.make_fake_bop(tmp)
    coarse, fine = fake_bop.write_mini_configs(tmp)
    return root, scene, fake_bop.make_checkpoint(tmp), coarse, fine


def test_load_intrinsics_matches_jax(fake):
    _, scene, *_ = fake
    t_k, t_s = tbop.load_intrinsics(scene / "scene_camera.json")
    j_k, j_s = jbop.load_intrinsics(scene / "scene_camera.json")
    assert t_s == j_s and len(t_k) == len(j_k) == fake_bop.N_FRAMES
    for a, b in zip(t_k, j_k):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("num_frames", [0, 1, 2, 5])
def test_select_frames_matches_jax(fake, num_frames):
    root, scene, *_ = fake
    tds = TBOPDataset(root, scene, 1)
    jds = JBOPDataset(root, scene, 1)
    t_ref, j_ref = tds.sample_evenly(3), jds.sample_evenly(3)
    np.testing.assert_array_equal(np.asarray(t_ref), np.asarray(j_ref))
    assert teval.select_frames(tds, t_ref, num_frames) == jeval.select_frames(
        jds, j_ref, num_frames)
    assert tds.get_ids() == jds.get_ids()


def test_group_generators_are_distinct_streams():
    a = teval.group_generators(0, 3, "cpu")
    b = teval.group_generators(0, 3, "cpu")
    draws = [torch.rand(4, generator=g) for g in a]
    assert not torch.equal(draws[0], draws[1])
    assert torch.equal(draws[2], torch.rand(4, generator=b[2]))


@pytest.mark.parametrize("batch_frames", [1, 2])
def test_main_matches_jax_layout(fake, tmp_path, batch_frames):
    """Both tools on the fake scene with the same tiny ``.pth``: the same
    frames, rows and JSON keys; metrics finite and of sane size in mm."""
    root, scene, ckpt, coarse, fine = fake
    argv = ["--checkpoint", str(ckpt), "--dataset-path", str(root), "--scene-path", str(scene),
            "--object-id", "1", "--num-input-views", "3", "--num-frames", "2",
            "--coarse-config", str(coarse), "--fine-config", str(fine), "--top-k", "4",
            "--batch-frames", str(batch_frames)]
    t_rows, t_acc = teval.main(argv + ["--out", str(tmp_path / "t.json"), "--device", "cpu"])
    j_rows, j_acc = jeval.main(argv + ["--out", str(tmp_path / "j.json")])
    assert [r["frame"] for r in t_rows] == [r["frame"] for r in j_rows]
    assert [list(r) for r in t_rows] == [list(r) for r in j_rows]
    assert set(t_acc) == set(j_acc)
    for r in t_rows:
        for k in ("add", "add_s", "add_sym", "proj2d", "rotation_dist", "translation_dist"):
            assert np.isfinite(r[k])
        assert 0 <= r["add"] < 10 * fake_bop.DIAMETER_MM
        assert r["add_01d"] == (r["add"] < 0.1 * fake_bop.DIAMETER_MM)
    t_json = json.loads((tmp_path / "t.json").read_text())
    j_json = json.loads((tmp_path / "j.json").read_text())
    assert set(t_json) == set(j_json) and t_json["diameter"] == j_json["diameter"]
    assert t_json["object_id"] == 1 and len(t_json["frames"]) == 2


def test_metric_rows_match_jax_for_the_same_camera(fake):
    """One estimated camera (the ground truth of frame 4 turned and moved)
    scored against frame 1's ground truth by both packages, in mm."""
    root, scene, *_ = fake
    tds, jds = TBOPDataset(root, scene, 1), JBOPDataset(root, scene, 1)
    t_pts, j_pts = tds.load_pointcloud(), jds.load_pointcloud()
    np.testing.assert_allclose(t_pts.numpy(), np.asarray(j_pts), rtol=1e-6)
    gt, est = tds[1], tds[4]
    est_ext = est["extrinsic"].copy()
    est_ext[:3, 3] += (0.01, -0.02, 0.03)

    def cams(make, xp):
        return (make(xp.asarray(gt["intrinsic"])[None], xp.asarray(gt["extrinsic"])[None]),
                make(xp.asarray(gt["intrinsic"])[None], xp.asarray(est_ext)[None]))

    tg, te = cams(lambda k, e: TCamera(k, e, width=fake_bop.W, height=fake_bop.H,
                                       device="cpu"), np)
    jg, je = cams(lambda k, e: JCamera(k, e, width=fake_bop.W, height=fake_bop.H), jnp)
    scale = 1.0 / tds.object_scale
    t_m = tmetrics.camera_metrics(tg, te, t_pts, scale)
    j_m = jmetrics.camera_metrics(jg, je, j_pts, scale)
    assert list(t_m) == list(j_m)
    for k in t_m:
        assert abs(t_m[k] - j_m[k]) <= GEOM_TOL * max(abs(j_m[k]), 1.0), k


def _oracle_main(tmp_path, monkeypatch, num_frames, expected):
    root, scene = bop_accuracy.make_oracle_bop_scene(tmp_path)
    oracle = ttesting.EllipsoidOracleModel(input_size=64,
                                           camera_dist=bop_accuracy.CAM_DIST_UNITS,
                                           axes=bop_accuracy.AXES, device="cpu")
    monkeypatch.setattr(tinference.LatentFusionModel, "from_checkpoint",
                        classmethod(lambda cls, *a, **k: oracle))
    monkeypatch.setattr(teval.LatentFusionModel, "from_checkpoint",
                        classmethod(lambda cls, *a, **k: oracle))
    out = tmp_path / "results.json"
    rows, acc = teval.main(["--checkpoint", str(tmp_path / "dummy.pth"),
                            "--dataset-path", str(root), "--scene-path", str(scene),
                            "--object-id", "1", "--num-input-views", "4",
                            "--num-frames", str(num_frames), "--out", str(out),
                            "--device", "cpu"])
    assert len(rows) == expected
    assert acc["add_s_0.1d"] == 1.0, f"rows: {rows}"
    saved = json.loads(out.read_text())
    assert saved["diameter"] == bop_accuracy.MM_PER_UNIT
    assert all(r["add_s"] < 0.1 * bop_accuracy.MM_PER_UNIT for r in saved["frames"])


def test_oracle_end_to_end_one_frame(tmp_path, monkeypatch):
    _oracle_main(tmp_path, monkeypatch, 1, 1)


@pytest.mark.slow
def test_oracle_end_to_end_every_frame(tmp_path, monkeypatch):
    _oracle_main(tmp_path, monkeypatch, 0, bop_accuracy.N_FRAMES - 4)


def test_main_runs_on_cuda_by_default(fake, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root, scene, ckpt, *_ = fake
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teval.main(["--checkpoint", str(ckpt), "--dataset-path", str(root),
                    "--scene-path", str(scene), "--object-id", "1"])
