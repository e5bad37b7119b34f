"""The port's pose service (``latentfusion_tpu_torch/serve.py``) on the CPU:
the npz layout read as ``tools/serve_pose.py`` reads it, every command of
the protocol through ``serve_lines`` (both kinds of bad request included),
a single estimate equal to the direct estimator calls with the same seed,
the multi-frame and multi-object estimates equal to ``estimate_batch``, and
the module run as a program."""
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from latentfusion_tpu_torch import serve
from latentfusion_tpu_torch.camera import Camera

ROOT = Path(__file__).resolve().parents[1]
COARSE = {"type": "cross_entropy", "loss_weights": {"depth": 1.0},
          "args": {"num_samples": 16, "num_iters": 2, "ranking_size": 4, "num_elites": 8,
                   "num_gmm_components": 2, "learning_rate": 0.75,
                   "sample_flipped": True}}
FINE = {"type": "gradient", "loss_weights": {"depth": 1.0, "ov_depth": 0.3},
        "args": {"optimizer": "adam", "num_iters": 3, "num_samples": 2, "ranking_size": 2,
                 "learning_rate": 0.01, "converge_threshold": 1e-6,
                 "converge_patience": 10}}
ARGS = ["--device", "cpu", "--demo-tiny", "--coarse-json", json.dumps(COARSE),
        "--fine-json", json.dumps(FINE), "--top-k", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def write_frames(path, rng, n, h=48, w=64, squeeze=False):
    """``n`` frames of a box at about 1.5 from the camera, in the
    protocol's npz layout (depth and mask (V, H, W) when ``squeeze``)."""
    from latentfusion_tpu_torch import three

    q = rng.randn(n, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    trans = np.array([0.02, -0.01, 1.5], np.float32) + 0.03 * rng.randn(n, 3).astype(np.float32)
    ext = three.to_extrinsic_matrix(torch.from_numpy(trans), torch.from_numpy(q)).numpy()
    mask = np.zeros((n, 1, h, w), np.float32)
    mask[:, :, 12:36, 20:44] = 1.0
    depth = (1.5 + 0.1 * rng.rand(n, 1, h, w)).astype(np.float32) * mask
    if squeeze:
        depth, mask = depth[:, 0], mask[:, 0]
    np.savez(path, color=rng.rand(n, 3, h, w).astype(np.float32), depth=depth, mask=mask,
             intrinsic=np.array([[64, 0, w / 2], [0, 64, h / 2], [0, 0, 1]], np.float32),
             extrinsic=ext)
    return str(path)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.RandomState(0)
    return {"refs_a": write_frames(d / "refs_a.npz", rng, 3),
            "refs_b": write_frames(d / "refs_b.npz", rng, 3, squeeze=True),
            "target_a": write_frames(d / "target_a.npz", rng, 1),
            "target_b": write_frames(d / "target_b.npz", rng, 1, squeeze=True)}


def test_observation_from_npz_matches_the_jax_service(frames):
    spec = importlib.util.spec_from_file_location("serve_pose", ROOT / "tools" / "serve_pose.py")
    jserve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jserve)
    for key in ("refs_a", "refs_b"):
        jo = jserve.observation_from_npz(frames[key])
        to = serve.observation_from_npz(frames[key], "cpu")
        for field in ("color", "depth", "mask"):
            np.testing.assert_array_equal(getattr(to, field).numpy(),
                                          np.asarray(getattr(jo, field)))
        np.testing.assert_allclose(to.camera.translation.numpy(),
                                   np.asarray(jo.camera.translation), atol=1e-6)
        np.testing.assert_allclose(to.camera.log_quaternion.numpy(),
                                   np.asarray(jo.camera.log_quaternion), atol=1e-6)
        assert to.camera.intrinsic.shape == (3, 3, 4)


def run_lines(service, requests):
    out = io.StringIO()
    lines = [r if isinstance(r, str) else json.dumps(r) for r in requests]
    stopped = serve.serve_lines(service, io.StringIO("\n".join(lines) + "\n"), out)
    return stopped, [json.loads(line) for line in out.getvalue().splitlines()]


def test_service_answers_every_command(frames):
    service = serve.PoseService.from_args(serve.parse_args(ARGS))
    assert service.model.device.type == "cpu"
    requests = [
        {"cmd": "ping", "id": 1},
        {"cmd": "register", "object": "a", "npz": frames["refs_a"], "id": 2},
        {"cmd": "register", "object": "b", "npz": frames["refs_b"], "id": 3},
        {"cmd": "estimate", "object": "a", "npz": frames["target_a"], "seed": 5, "id": 4},
        {"cmd": "estimate", "object": "a", "npz": [frames["target_a"]] * 2, "seed": 5,
         "id": 5},
        {"cmd": "estimate", "object": ["a", "b"],
         "npz": [frames["target_a"], frames["target_b"]], "seed": 6, "id": 6},
        "{not json",
        {"cmd": "fly", "id": 8},
        {"cmd": "estimate", "object": "nobody", "npz": frames["target_a"], "id": 9},
        {"cmd": "estimate", "object": ["a", "b"], "npz": frames["target_a"], "id": 10},
        {"cmd": "ping", "id": 11},
        {"cmd": "shutdown", "id": 12},
        {"cmd": "ping", "id": 13},
    ]
    stopped, resp = run_lines(service, requests)
    assert stopped
    assert len(resp) == 12  # nothing after the shutdown
    assert [r["ok"] for r in resp] == [True] * 6 + [False] * 4 + [True] * 2
    assert resp[0]["objects"] == [] and resp[10]["objects"] == ["a", "b"]
    assert resp[1]["views"] == 3 and resp[2]["views"] == 3
    assert "bad json" in resp[6]["error"] and "unknown cmd" in resp[7]["error"]
    assert "KeyError" in resp[8]["error"] and "matching npz list" in resp[9]["error"]
    assert resp[11]["shutdown"] and [r.get("id") for r in resp[7:]] == [8, 9, 10, 11, 12]

    # The single estimate is the direct coarse + fine estimate with the seed.
    target = serve.observation_from_npz(frames["target_a"], "cpu")
    z = service.latents["a"]
    coarse = service.coarse.estimate(z, target, generator=torch.Generator().manual_seed(5))
    best = service.fine.estimate(z, target, camera=coarse[:2])
    np.testing.assert_array_equal(resp[3]["extrinsic"], best.extrinsic[0].numpy())
    assert np.asarray(resp[3]["extrinsic"]).shape == (4, 4)

    # The frame list and the object list are estimate_batch's.
    targets = [target, serve.observation_from_npz(frames["target_b"], "cpu")]
    for rid, z_objs, seed, obs in ((5, [z, z], 5, [target, target]),
                                   (6, [z, service.latents["b"]], 6, targets)):
        cams = service.estimate_batch(torch.cat(z_objs), obs, 2,
                                      torch.Generator().manual_seed(seed))
        poses = resp[rid - 1]["poses"]
        assert len(poses) == 2
        for pose, cam in zip(poses, cams):
            np.testing.assert_array_equal(pose["translation"], cam.translation[0].numpy())
            np.testing.assert_array_equal(pose["log_quaternion"],
                                          cam.log_quaternion[0].numpy())
    assert isinstance(cams[0], Camera)


def test_service_runs_as_a_program(frames):
    requests = [{"cmd": "ping"}, {"cmd": "register", "object": "a", "npz": frames["refs_a"]},
                {"cmd": "shutdown"}]
    proc = subprocess.run(
        [sys.executable, "-m", "latentfusion_tpu_torch.serve", "--stdio", *ARGS],
        input="\n".join(json.dumps(r) for r in requests) + "\n", capture_output=True,
        text=True, cwd=ROOT, timeout=120, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    resp = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r["ok"] for r in resp] == [True, True, True] and resp[-1]["shutdown"]
