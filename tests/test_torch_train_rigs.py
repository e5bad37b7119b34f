"""The training halves of the three rigs (``train_encoder_distill.py``,
``train_unseen_objects.py``, ``train_unseen_real.py``) and the parameter
files they write, held against the JAX tools on the CPU.

Each distillation rig's loss on the same weights (tiny family, input 16,
JAX's weights carried across) at JAX's camera draws, within 5e-4 of the
largest term, in fp32: the JAX side is the tools' ``distill_loss``
written out here from the JAX package's functions (the tools define it
inside ``main``). The real-data rig's chunk loop equals its steps taken one
by one from the same buffer indices, bit for bit, and its ring buffer
writes over the oldest slot. ``to_jax_params`` inverts ``from_jax_params``
bit for bit, leaf order included, on the tiny and demo trees and the
committed encoder-distill checkpoint (the mid and flagship trees under
``-m slow``). A few steps of each tool on the CPU write npz files that the
JAX tools' loader (leaves unflattened against the family's tree) and the
port's evaluation halves read.
"""
import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentfusion_tpu import testing as jtesting
from latentfusion_tpu import zoo as jzoo
from latentfusion_tpu.pose import estimation as jestimation
from latentfusion_tpu.recon import models as jmodels

from latentfusion_tpu_torch import testing as ttesting
from latentfusion_tpu_torch import train_encoder_distill as tdistill
from latentfusion_tpu_torch import train_unseen_objects as tobjects
from latentfusion_tpu_torch import train_unseen_real as treal
from latentfusion_tpu_torch import unseen_eval
from latentfusion_tpu_torch.camera import Camera
from latentfusion_tpu_torch.recon.checkpoint import from_jax_params, load_params_npz, to_jax_params

from test_torch_train import NET_TOL, port_models, tiny_family  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
DISTILL = ROOT / "artifacts" / "encoder_distill"
CAMERA_DIST = 5.78
SIZE = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def port_camera(cam) -> Camera:
    return Camera(torch.from_numpy(np.array(cam.intrinsic)),
                  torch.from_numpy(np.array(cam.extrinsic)), z_span=float(cam.z_span),
                  width=cam.width, height=cam.height, device="cpu")


def jax_terms(mods, params, obs, cam, o_depth, o_mask, target, frame_loss_weight):
    """tools/train_encoder_distill.py's and tools/train_unseen_objects.py's
    distill_loss after their draws (:128-160, :189-226)."""
    sc, fu, ph = mods
    obs = obs.zoom(CAMERA_DIST, SIZE).prepare().normalize()
    z_obj, _ = jmodels.encode(sc, params["sculptor"], fu, params["fuser"], obs.camera,
                              obs.color[None], obs.depth[None], obs.mask[None])
    y, _, _ = jmodels.decode(ph, params["photographer"], z_obj, cam, interpret=True)
    pred_depth, pred_mask_logits = y["depth"][0], y["mask_logits"][0]
    depth_l1 = jnp.abs(pred_depth - o_depth).mean()
    mask_bce = jestimation._bce_with_logits(pred_mask_logits, o_mask).mean()
    loss = 25.0 * depth_l1 + 25.0 * mask_bce
    frame_ld = jestimation.default_pose_loss(target, cam.denormalize_depth(pred_depth),
                                             pred_mask_logits, cam)
    frame_depth = frame_ld["depth"].mean()
    loss = loss + frame_loss_weight * (frame_depth + 0.3 * frame_ld["ov_depth"].mean())
    return {"loss": loss, "depth_l1": depth_l1, "mask_bce": mask_bce,
            "frame_depth": frame_depth}


def assert_terms_close(ours, theirs):
    loss, terms = ours
    got = {"loss": loss, **terms}
    scale = float(theirs["loss"])
    for k, v in theirs.items():
        assert abs(float(got[k]) - float(v)) <= NET_TOL * scale, (k, float(got[k]), float(v))


def jax_cameras(seed, views_in=2, views_out=2):
    k_in, k_out = jax.random.split(jax.random.PRNGKey(seed))
    return (jzoo.random_view_cameras(k_in, views_in, SIZE, CAMERA_DIST),
            jzoo.random_view_cameras(k_out, views_out, SIZE, CAMERA_DIST))


def test_encoder_distill_loss_matches_jax(tiny_family):
    mods, params = tiny_family
    oracle = jtesting.EllipsoidOracleModel(input_size=SIZE, camera_dist=CAMERA_DIST,
                                           axes=tdistill.AXES)
    cam_in, cam_full = jax_cameras(1)

    def jax_loss(params, cam_in, cam_full):  # jitted, as the tool's step runs it
        cam = cam_full.zoom(None, SIZE, CAMERA_DIST)
        y_o, _, _ = oracle.decode_latent(None, cam)
        return jax_terms(mods, params, oracle.make_observation(cam_in, shaded=True), cam,
                         y_o["depth"][0], (y_o["mask"][0] > 0.5).astype(jnp.float32),
                         oracle.make_observation(cam_full), 2.0)

    theirs = jax.jit(jax_loss)(params, cam_in, cam_full)
    toracle = ttesting.EllipsoidOracleModel(input_size=SIZE, camera_dist=CAMERA_DIST,
                                            axes=tdistill.AXES, device="cpu")
    ours = tdistill.ellipsoid_loss(port_models(params), toracle, port_camera(cam_in),
                                   port_camera(cam_full), 2.0)
    assert_terms_close(ours, theirs)


def test_unseen_objects_loss_matches_jax(tiny_family):
    mods, params = tiny_family
    pool, _ = jtesting.sample_lobe_shapes(0, 3, diameter=1.0)
    shape = jtesting.index_lobe_shape(pool, 2)
    cam_in, cam_full = jax_cameras(2)
    cam = cam_full.zoom(None, SIZE, CAMERA_DIST)

    def observation(c):
        from latentfusion_tpu.observation import Observation

        depth, mask, _, onehot = jtesting.render_lobe_shape(c, shape)
        return Observation(jtesting.lobe_shape_color(c, depth, mask, onehot, shape), depth,
                           mask, c)

    def jax_loss(params, cam_in, cam, cam_full):  # jitted, as the tool's step runs it
        depth_m, o_mask, _, _ = jtesting.render_lobe_shape(cam, shape, SIZE)
        o_depth = jnp.where(o_mask > 0.5, cam.normalize_depth(depth_m), -1.0)
        return jax_terms(mods, params, observation(cam_in), cam, o_depth, o_mask,
                         observation(cam_full), 2.0)

    theirs = jax.jit(jax_loss)(params, cam_in, cam, cam_full)
    tpool, _ = ttesting.sample_lobe_shapes(0, 3, diameter=1.0, device="cpu")
    ours = tobjects.lobe_loss(port_models(params), ttesting.index_lobe_shape(tpool, 2),
                              port_camera(cam_in), port_camera(cam_full), SIZE, 2.0)
    assert_terms_close(ours, theirs)


def item(seed):
    """A quantised item of 1 + 1 views at 8x6, as the loader's workers
    give it (no clean input group)."""
    rng = np.random.RandomState(seed)

    def group():
        return {"render": rng.randint(0, 256, (1, 3, 6, 8)).astype(np.uint8),
                "mask": (rng.rand(1, 6, 8) > 0.5).astype(np.uint8) * 255,
                "depth": (1.5 + rng.rand(1, 6, 8)).astype(np.float16),
                "extrinsic": np.eye(4, dtype=np.float32)[None],
                "intrinsic": np.eye(3, 4, dtype=np.float32)[None]}
    return {"in": group(), "out_gt": group()}


def test_ring_buffer_writes_over_the_oldest():
    items = [item(i) for i in range(5)]
    buf = treal.RingBuffer(items[0], 3, "cpu")
    assert buf.filled == 0
    for i, it in enumerate(items):
        buf.write(it)
        assert buf.filled == min(i + 1, 3)
    for slot, i in ((0, 3), (1, 4), (2, 2)):
        got = buf.take(torch.tensor(slot))
        assert got["in"]["render"].shape == (1, 1, 3, 6, 8)
        assert got["in"]["render"].dtype == torch.float32
        np.testing.assert_array_equal(got["in"]["render"][0].numpy(),
                                      items[i]["in"]["render"].astype(np.float32) / 255.0)
        np.testing.assert_array_equal(got["out_gt"]["depth"][0].numpy(),
                                      items[i]["out_gt"]["depth"].astype(np.float32))
    assert buf.slots["in"]["render"].dtype == torch.uint8


def test_chunk_loop_equals_steps_one_by_one(tiny_family):
    """run_chunk against the same steps taken by hand from the same
    generator: the same buffer indices and parameters, bit for bit."""
    from latentfusion_tpu_torch.train import step as tstep
    from latentfusion_tpu_torch.utils import cosine_decay_schedule

    from test_torch_train import raw_batch

    _, params = tiny_family
    raw = [raw_batch(s, b=1)[1] for s in (20, 21)]
    raw = [{g: {k: v for k, v in grp.items()} for g, grp in r.items() if g != "in_gt"}
           for r in raw]
    from latentfusion_tpu_torch.data.loader import encode_transport

    quantised = [encode_transport({g: {k: v[0] for k, v in grp.items()}
                                   for g, grp in r.items()}) for r in raw]
    schedule = cosine_decay_schedule(1e-3, 10, alpha=0.01)
    config = dict(treal.step_config(100), camera_dist=3.0)

    def fresh():
        mods = port_models(params)
        state = tstep.init_train_state(mods, tstep.make_optimizer("adam", 1e-3))
        step = tstep.make_recon_train_step(mods["sculptor"], mods["fuser"],
                                           mods["photographer"], config=config)
        buf = treal.RingBuffer(quantised[0], 4, "cpu")
        for q in quantised:
            buf.write(q)
        return mods, state, step, buf

    mods_a, state_a, step_a, buf_a = fresh()
    gen_a = torch.Generator().manual_seed(7)
    state_a, aux = treal.run_chunk(step_a, state_a, buf_a, 3, gen_a, schedule)
    mods_b, state_b, step_b, buf_b = fresh()
    gen_b = torch.Generator().manual_seed(7)
    indices, totals = [], []
    for _ in range(3):
        index = torch.randint(buf_b.filled, (), generator=gen_b)
        indices.append(int(index))
        for group in state_b.optimizer.param_groups:
            group["lr"] = schedule(state_b.step)
        state_b, scalars = step_b(state_b, buf_b.take(index), gen_b)
        totals.append(scalars["loss/generator/total"])
    assert state_a.step == state_b.step == 3 and set(indices) <= {0, 1}
    assert torch.equal(aux["loss/generator/total"], sum(totals) / 3)
    for name in mods_a:
        for (k, a), b in zip(mods_a[name].state_dict().items(),
                             mods_b[name].state_dict().values()):
            assert torch.equal(a, b), (name, k)


def keyed_tree(params):
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(map(str, p)): np.asarray(v) for p, v in leaves}


def assert_round_trip(flat):
    back = to_jax_params(from_jax_params(flat))
    assert list(back) == list(flat)
    for k, v in flat.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


@functools.lru_cache(maxsize=None)
def family_params(family):
    makers = {f: (getattr(jzoo, f"{f}_sculptor"), getattr(jzoo, f"{f}_fuser"),
                  getattr(jzoo, f"{f}_photographer"))
              for f in ("tiny", "demo", "mid", "flagship")}
    mods = [make() for make in makers[family]]
    return jzoo.init_recon_params(jax.random.PRNGKey(0), *mods, batch=1, views=2)


@pytest.mark.parametrize("family", ["tiny", "demo"])
def test_to_jax_params_inverts_from_jax_params(family):
    assert_round_trip(keyed_tree(family_params(family)))


def test_to_jax_params_inverts_the_committed_checkpoint():
    flat = load_params_npz(DISTILL / "encoder_distill.npz", DISTILL / "encoder_distill_keys.json")
    assert_round_trip(flat)


@pytest.mark.slow
@pytest.mark.parametrize("family", ["mid", "flagship"])
def test_to_jax_params_inverts_from_jax_params_at_width(family):
    assert_round_trip(keyed_tree(family_params(family)))


def jax_unflatten(path, family):
    """The JAX tools' loader: the npz's leaves unflattened against the
    family's parameter tree."""
    template = family_params(family)
    with np.load(path) as data:
        leaves = [jnp.asarray(data[str(i)]) for i in range(len(data.files))]
    return jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(template), leaves)


def assert_loads_in_both(path, family, keys):
    tree = jax_unflatten(path, family)
    flat = keyed_tree(tree)
    assert list(flat) == json.loads(keys.read_text())
    model = unseen_eval.build_model(family, path, "cpu", keys=keys)
    state = {f"{name}.{k}": v for name, m in (("sculptor", model.sculptor),
                                              ("fuser", model.fuser),
                                              ("photographer", model.photographer))
             for k, v in m.state_dict().items()}
    ref = from_jax_params(flat)
    assert set(state) == {k for k in ref}
    assert all(torch.equal(state[k], ref[k]) for k in ref)


def test_unseen_objects_tool_writes_what_both_load(tmp_path):
    history = tobjects.main(["--steps", "3", "--family", "tiny", "--train-objects", "2",
                             "--views-in", "2", "--views-out", "2", "--out", str(tmp_path),
                             "--device", "cpu"])
    assert [row["step"] for row in history] == [2]
    assert all(np.isfinite(v) for v in history[0].values())
    assert_loads_in_both(tmp_path / "unseen_objects.npz", "tiny",
                         tmp_path / "unseen_objects_keys.json")


def test_unseen_real_tool_writes_what_both_load(tmp_path):
    from latentfusion_tpu_torch.data import synthetic as tsynth

    # Small banks in place: the tool writes its full-size ones only where none are.
    tsynth.make_procedural_textures(tmp_path / "assets" / "textures", n=2, size=32)
    tsynth.make_procedural_backgrounds(tmp_path / "assets" / "backgrounds", n_color=2,
                                       n_depth=0, width=64, height=48)
    history = treal.main(["--steps", "2", "--chunk-steps", "1", "--family", "tiny",
                          "--train-objects", "2", "--workers", "0", "--min-buffer", "2",
                          "--buffer-items", "2", "--views-in", "2", "--views-out", "2",
                          "--render-width", "64", "--render-height", "48",
                          "--out", str(tmp_path), "--device", "cpu"])
    assert [row["step"] for row in history] == [1, 2]
    assert all(np.isfinite(row["loss"]) for row in history)
    keys = tmp_path / "keys.json"
    keys.write_text(json.dumps(list(keyed_tree(family_params("tiny")))))
    assert_loads_in_both(tmp_path / "unseen_real.npz", "tiny", keys)


def test_encoder_distill_tool_writes_what_both_load(tmp_path):
    summary = tdistill.main([
        "--steps", "2", "--views-in", "2", "--views-out", "2", "--out", str(tmp_path),
        "--eval-targets", "1", "--eval-views", "2", "--cem-samples", "8", "--cem-iters", "2",
        "--cem-elites", "4", "--refine-samples", "2", "--refine-iters", "2",
        "--device", "cpu"])
    assert len(summary["targets"]) == 1 and (tmp_path / "pose_eval.json").exists()
    assert_loads_in_both(tmp_path / "encoder_distill.npz", "demo",
                         tmp_path / "encoder_distill_keys.json")
