"""The port's record tools held against the JAX package's on the CPU:
``eval_cameras.json`` against JAX's draws (``PRNGKey(7)`` reference views,
``PRNGKey(55)`` targets), ``metropolis_eval.main --tiny`` and
``serving_accuracy.main`` at truncated budgets writing the records'
layouts, and the served half through ``serve_lines`` against the service's
own in-process estimate of the same frames.

    python tests/test_torch_eval_tools.py --write   # rewrites eval_cameras.json
"""
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from latentfusion_tpu_torch import dtypes, metropolis_eval, serve, serving_accuracy  # noqa: E402

ABOUT = ("Cameras of the record tools (tools/metropolis_eval.py, tools/serving_accuracy.py), "
         "drawn by the JAX package in float32 on the CPU. reference: "
         "zoo.random_view_cameras(PRNGKey(7), 16) at the demo family's size and distance; "
         "metropolis_targets: PRNGKey(55) split in three per target (ek, k1, k2), "
         "testing.make_camera(1, z=5.78, f=615, 640x480) at quat.random(k1, 1); "
         "serving_targets: per round and object PRNGKey(55) split in two (ek, k1), the same "
         "camera. tests/test_torch_eval_tools.py recomputes every entry.")
METROPOLIS_TARGETS, SERVING_ROUNDS, SERVING_OBJECTS = 8, 3, 2



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

def jax_eval_cameras() -> dict:
    """The record tools' cameras as the JAX package draws them."""
    import jax

    from latentfusion_tpu import testing as jtesting
    from latentfusion_tpu import zoo as jzoo
    from latentfusion_tpu.three import quaternion as jquat

    def target(key):
        return np.asarray(jtesting.make_camera(
            1, z=jzoo.DEMO_CAMERA_DIST, f=615.0, width=640, height=480,
            quats=jquat.random(key, 1)).extrinsic)[0].tolist()

    ref = jzoo.random_view_cameras(jax.random.PRNGKey(7), 16, jzoo.DEMO_INPUT_SIZE,
                                   jzoo.DEMO_CAMERA_DIST)
    ek, metro = jax.random.PRNGKey(55), []
    for _ in range(METROPOLIS_TARGETS):
        ek, k1, _ = jax.random.split(ek, 3)
        metro.append(target(k1))
    ek, serving = jax.random.PRNGKey(55), []
    for _ in range(SERVING_ROUNDS):
        row = []
        for _ in range(SERVING_OBJECTS):
            ek, k1 = jax.random.split(ek)
            row.append(target(k1))
        serving.append(row)
    return {"about": ABOUT, "intrinsic": np.asarray(ref.intrinsic)[0].tolist(),
            "z_span": float(ref.z_span), "width": int(ref.width), "height": int(ref.height),
            "reference": np.asarray(ref.extrinsic).tolist(), "metropolis_targets": metro,
            "serving_targets": serving}


def test_committed_cameras_are_jax_draws():
    assert json.loads(metropolis_eval.EVAL_CAMERAS.read_text()) == jax_eval_cameras()


def test_load_eval_cameras():
    cams = metropolis_eval.load_eval_cameras("cpu")
    assert len(cams["reference"]) == 16 and cams["reference"].width == 640
    assert len(cams["metropolis_targets"]) == METROPOLIS_TARGETS
    assert [len(r) for r in cams["serving_targets"]] == [SERVING_OBJECTS] * SERVING_ROUNDS
    rec = jax_eval_cameras()
    np.testing.assert_array_equal(cams["metropolis_targets"][3].extrinsic[0].numpy(),
                                  np.asarray(rec["metropolis_targets"][3], np.float32))
    np.testing.assert_array_equal(cams["reference"].intrinsic[0].numpy(),
                                  np.asarray(rec["intrinsic"], np.float32))


# ------------------------------------------------------------ metropolis_eval
def _keys(d):
    return {k: _keys(v) if isinstance(v, dict) else None for k, v in d.items()}


def test_metropolis_eval_tiny_writes_the_record_layout(tmp_path):
    out = metropolis_eval.main(["--tiny", "--targets", "1", "--chains", "4", "--mh-iters", "2",
                                "--refine-samples", "2", "--refine-iters", "2",
                                "--out", str(tmp_path), "--device", "cpu"])
    assert dtypes.get_compute_dtype() == torch.float32
    record = json.loads((ROOT / "artifacts" / "metropolis" / "pose_eval.json").read_text())
    written = json.loads((tmp_path / "pose_eval.json").read_text())
    assert written == out
    assert _keys(written) == _keys(record)
    for part in ("metropolis", "cem_control"):
        assert list(written[part]["budget"]) == list(record[part]["budget"])
        assert _keys(written[part]["targets"][0]) == _keys(record[part]["targets"][0])
        assert len(written[part]["targets"]) == 1
        assert np.isfinite(written[part]["targets"][0]["refined"]["add_s"])
    assert written["diameter"] == record["diameter"]


@pytest.mark.parametrize("tool", [metropolis_eval, serving_accuracy])
def test_record_tools_need_an_out_directory(tool, capsys):
    """No default --out: a run from the repo root must not overwrite the
    JAX package's committed record under artifacts/."""
    with pytest.raises(SystemExit):
        tool.parse_args(["--device", "cpu"])
    assert "--out" in capsys.readouterr().err


def test_metropolis_eval_runs_on_cuda_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        metropolis_eval.main(["--tiny", "--out", str(tmp_path)])


# ----------------------------------------------------------- serving_accuracy
TRUNCATED = ["--objects", "2", "--rounds", "1", "--eval-views", "2", "--device", "cpu"]


@pytest.fixture
def small_budget(monkeypatch):
    """CEM 8 x 2 and one refinement step, in both halves."""
    monkeypatch.setattr(serving_accuracy, "CEM_SAMPLES", 8)
    monkeypatch.setattr(serving_accuracy, "CEM_ITERS", 2)
    monkeypatch.setattr(serving_accuracy, "REFINE_ITERS", 1)


def _tiny_pool_checkpoint(tmp_path):
    """pool-128's split record beside the committed checkpoint's leaves."""
    src = ROOT / "artifacts" / "unseen_objects_pool128"
    dst = tmp_path / "pool"
    dst.mkdir()
    for name in ("unseen_objects.npz", "unseen_objects_keys.json", "pose_eval.json"):
        (dst / name).symlink_to(src / name)
    return dst / "unseen_objects.npz"


def in_process_rpc(args):
    """The service in this process, spoken to through ``serve_lines``."""
    coarse, fine = serving_accuracy.estimator_configs(args)
    service = serve.PoseService(serve.load_model(serve.parse_args(
        ["--demo-npz", str(args.checkpoint), "--device", "cpu"])), coarse, fine, top_k=16)

    def rpc(req):
        out = io.StringIO()
        serve.serve_lines(service, io.StringIO(json.dumps(req) + "\n"), out)
        return json.loads(out.getvalue())
    return service, rpc


def test_serving_accuracy_writes_the_record_layout(tmp_path, small_budget):
    """Both halves at a truncated budget (one round, 2 views, CEM 8 x 1,
    one refinement step) on the pool-128 checkpoint, the served half
    through ``serve_lines`` in this process: the record's layout, and each
    served pose is the service's own estimate of the frame."""
    ckpt = _tiny_pool_checkpoint(tmp_path)
    argv = TRUNCATED + ["--checkpoint", str(ckpt), "--out", str(tmp_path / "out")]
    args = serving_accuracy.parse_args(argv)
    service, rpc = in_process_rpc(args)
    replies = []

    def spy(req):
        reply = rpc(req)
        replies.append((req, reply))
        return reply

    out = serving_accuracy.main(argv, rpc=spy)
    assert dtypes.get_compute_dtype() == torch.float32
    record = json.loads((ROOT / "artifacts" / "serving" / "accuracy.json").read_text())
    written = json.loads((tmp_path / "out" / "accuracy.json").read_text())
    assert written == out
    assert set(written) == set(record)
    for half in ("estimate_batch", "served"):
        assert set(written[half]) == set(record[half])
        assert set(written[half]["rounds"][0]) == set(record[half]["rounds"][0])
        assert len(written[half]["rounds"][0]["objects"]) == 2
    req, reply = replies[-1]
    assert req["cmd"] == "estimate" and reply["ok"]
    frames = [serve.observation_from_npz(p, torch.device("cpu")) for p in req["npz"]]
    z_objs = torch.cat([service.latents[o] for o in req["object"]])
    direct = service.estimate_batch(z_objs, frames, 16,
                                    torch.Generator().manual_seed(req["seed"]))
    for pose, cams in zip(reply["poses"], direct):
        np.testing.assert_array_equal(np.asarray(pose["extrinsic"], np.float32),
                                      cams.extrinsic[0].numpy())
    assert sorted(p.name for p in (tmp_path / "out" / "frames").iterdir()) == [
        "refs_o0.npz", "refs_o1.npz", "target_r0_o0.npz", "target_r0_o1.npz"]


def test_serving_accuracy_spawns_the_service(tmp_path, small_budget):
    """The served half through ``python -m latentfusion_tpu_torch.serve``."""
    ckpt = _tiny_pool_checkpoint(tmp_path)
    out = serving_accuracy.main(TRUNCATED + ["--objects", "1", "--checkpoint", str(ckpt),
                                             "--out", str(tmp_path / "out")])
    assert len(out["served"]["rounds"]) == 1
    assert np.isfinite(out["served"]["rounds"][0]["objects"][0]["add_s"])


if __name__ == "__main__":
    if sys.argv[1:] == ["--write"]:
        import jax

        jax.config.update("jax_platforms", "cpu")
        metropolis_eval.EVAL_CAMERAS.write_text(json.dumps(jax_eval_cameras()) + "\n")
    else:
        raise SystemExit(__doc__)
