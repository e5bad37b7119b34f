"""The port's examples (``latentfusion_tpu_torch/examples``) on the CPU with
random tiny weights: the pose example prints its metric table in both data
modes, its synthetic observations equal the JAX example's given the same
rotations and light draws, and the reconstruction example's grid PNG reads
back as written."""
import random
import sys
from argparse import Namespace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
sys.path.insert(0, str(ROOT / "tests"))

import pose_estimation as jexample  # noqa: E402
import test_evaluate_bop as fake_bop  # noqa: E402
from latentfusion_tpu.three import quaternion as jquat  # noqa: E402

from latentfusion_tpu_torch import png  # noqa: E402
from latentfusion_tpu_torch.examples import pose_estimation, reconstruction  # noqa: E402

SMALL = ["--num-views", "2", "--input-size", "16", "--device", "cpu"]



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    return fake_bop.write_mini_configs(tmp_path_factory.mktemp("configs"))


def test_pose_example_synthetic(configs, capsys):
    coarse, fine = configs
    table = pose_estimation.main(SMALL + ["--coarse-config", str(coarse),
                                          "--fine-config", str(fine)])
    out = capsys.readouterr().out
    assert "RANDOM weights" in out and table in out
    assert table.splitlines()[0].split() == ["name", "rotation_dist", "translation_dist", "add",
                                             "add_s", "add_sym", "proj2d"]
    assert [line.split()[0] for line in table.splitlines()[2:5]] == ["coarse", "fine", "MEAN"]


def test_pose_example_bop(configs, tmp_path):
    coarse, fine = configs
    root, scene = fake_bop.make_fake_bop(tmp_path)
    table = pose_estimation.main(SMALL + ["--coarse-config", str(coarse), "--fine-config",
                                          str(fine), "--bop-path", str(root),
                                          "--scene-path", str(scene), "--object-id", "1"])
    assert "accuracy @ 0.10m" in table


@pytest.mark.parametrize("mesh", [False, True])
def test_synthetic_observations_match_jax(tmp_path, mesh):
    """The same rotations (JAX's draws) and light draws (the seeded
    ``random``/``numpy.random``): the same renders, bit for bit."""
    path = None
    if mesh:
        path = tmp_path / "tetra.obj"
        path.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\n"
                        "f 1 3 2\nf 1 2 4\nf 1 4 3\nf 2 3 4\n")
    args = Namespace(mesh=path, num_views=2, camera_dist=1.5, seed=3, device="cpu")
    quats = jquat.random(jax.random.PRNGKey(args.seed), args.num_views + 1)
    random.seed(args.seed)
    np.random.seed(args.seed)
    jref, jtarget, _ = jexample.synthetic_observations(args)
    tref, ttarget, obj = pose_estimation.synthetic_observations(args, quats=np.asarray(quats))
    for j, t in ((jref, tref), (jtarget, ttarget)):
        for key in ("color", "depth", "mask"):
            np.testing.assert_array_equal(getattr(t, key).numpy(), np.asarray(getattr(j, key)),
                                          err_msg=key)
        np.testing.assert_allclose(t.camera.extrinsic.numpy(), np.asarray(j.camera.extrinsic),
                                   atol=1e-6)
    assert len(tref) == args.num_views and obj.vertices.shape[1] == 3


def test_reconstruction_example_grid_round_trips(tmp_path):
    out = tmp_path / "grid.png"
    grid = reconstruction.main(SMALL + ["--out", str(out)])
    assert grid.shape[0] == 3 and grid.shape[1] in (4 * 162, 5 * 162)
    np.testing.assert_array_equal(png.read_png(out),
                                  (grid.transpose(1, 2, 0) * 255).astype(np.uint8))


def test_examples_run_on_cuda_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (pose_estimation.main, reconstruction.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--out", str(tmp_path / "g.png")] if main is reconstruction.main else [])
