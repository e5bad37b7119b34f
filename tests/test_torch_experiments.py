"""The learned-weights experiment tools (``train_oracle_distill.py``,
``train_cube_demo.py``, ``trained_pose_experiment.py``, and the encoder
distillation's ``--coarse-config`` and ``.pth``) held against the JAX
package and its tools on the CPU.

- The decoder-only ``LatentFusionModel`` (``sculptor=None``) on the
  committed ``artifacts/oracle_distill/distilled.npz`` renders JAX's depth
  and mask at 4 cameras, within 5e-4 of the largest value (fp32); what
  needs the Sculptor raises.
- ``distilled.npz`` is read by the port and written back the same bits,
  leaf order and keys included, so either package's ``--skip-train`` reads
  the other's file.
- ``distill_loss`` (tiny photographer, 16² renders) against the JAX tool's,
  written out here from the JAX package's functions (the tool defines it
  inside ``main``), terms within 5e-4 of the loss; its gradients for the
  photographer and the latent within 5e-4 of each tensor's largest, or 3x
  the port's own noise floor (every convolution's output times (1 + eps
  N(0, 1)), as ``tests/test_torch_train.py``).
- The sharpness probe at 3 of its 13 angles, fp32, on the committed
  checkpoint, within 5e-4 of JAX's curve computed here, which equals the
  committed one (``tests/oracle_distill_sharpness.json``, written by
  ``tests/oracle_distill_witness.py --curves``); ``-m slow`` recomputes
  JAX's 13 points and the port's.
- ``experiment_cameras.json`` equals JAX's draws (recomputed here;
  ``python tests/test_torch_experiments.py --write`` rewrites it).
- The tools' constants (CEM and refinement settings, the step configs, the
  cube demo's module args) equal the JAX tools' literals, read from their
  source; ``--coarse-config slow`` builds JAX's estimator settings in both
  distillation tools.
- One cube-demo training step (tiny widths rendering 64², the tool's
  config: ``remat``, top-4096 hard smooth-L1, 25/25) and the trained-pose
  experiment's first two steps (the small stack, L1; the second from JAX's
  parameters after the first) on batches rendered once (the port's
  rasterizer, Python's seed fixed) and fed to both packages, with JAX's
  orientation draw injected: losses within 5e-4, gradients within 5e-4 or
  3x the port's noise floor, and the port's Adam given JAX's gradient makes
  JAX's update; the cube step's ``.pth`` loads in both packages to the
  same tensors. Where a pre-activation lies within 1e-5 of its tensor's
  largest from 0 with the other sign in JAX's compiled step, the port's
  leaky ReLU takes JAX's branch (``on_jax_side_of_kinks``; ROADMAP Queue 3
  item 12). The cube step with ``zoo.tiny_*`` at 32³ is held module by
  module on JAX's values (``-m slow``: whole, within 3x JAX's own
  jit-vs-eager spread).
- One evaluation row of the oracle distillation (CEM, refinement, ADD-S,
  ``loss_at_gt``, ``loss_refined``) with JAX's CEM draws at a shrunken
  budget under ``slow``: at tiny width in tier-1 (against JAX's row, which
  ``python tests/test_torch_experiments.py --write`` writes and ``-m slow``
  recomputes), on the committed checkpoint with ``-m slow``.

Budget: about 86 s on one worker (JAX's compiles included; one core of
an 8-core host): the sharpness probe 24 s (JAX's 3 points computed here),
the cube step 12 s, the trained-pose steps 11 s, the decoder render 10 s,
the cube step's modules 9 s, the loss and its floor 6 s, the tiny
evaluation row 5 s (JAX's row committed in
``tests/oracle_distill_rows.json``; ``-m slow`` recomputes it in about 30
s), the rest 4 s.
"""
import ast
import contextlib
import functools
import importlib.util
import json
import random
import re
import sys
from pathlib import Path

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentfusion_tpu import testing as jtesting
from latentfusion_tpu import zoo as jzoo
from latentfusion_tpu.modules.equalized import EqualizedConv as JEqualizedConv
from latentfusion_tpu.pose import estimation as jest
from latentfusion_tpu.pose import metrics as jmetrics
from latentfusion_tpu.recon import fusion as jfusion
from latentfusion_tpu.recon import models as jmodels
from latentfusion_tpu.recon.inference import LatentFusionModel as JModel
from latentfusion_tpu.three import orientation as jorientation
from latentfusion_tpu.three import quaternion as jquat
from latentfusion_tpu.train import step as jstep

from latentfusion_tpu_torch import testing as ttesting
from latentfusion_tpu_torch import train_cube_demo as tcube
from latentfusion_tpu_torch import train_encoder_distill as tdistill
from latentfusion_tpu_torch import train_oracle_distill as toracle
from latentfusion_tpu_torch import trained_pose_experiment as tpose
from latentfusion_tpu_torch import unseen_eval
from latentfusion_tpu_torch import zoo as tzoo
from latentfusion_tpu_torch.camera import Camera
from latentfusion_tpu_torch.modules.equalized import EqualizedConv as TEqualizedConv
from latentfusion_tpu_torch.observation import Observation
from latentfusion_tpu_torch.recon import checkpoint as tckpt
from latentfusion_tpu_torch.recon.inference import LatentFusionModel as TModel
from latentfusion_tpu_torch.train import step as tstep

sys.path.insert(0, str(Path(__file__).resolve().parent))
import oracle_distill_witness as witness  # noqa: E402
from test_torch_train import (CAMERA_DIST, FLOOR_EPS, FLOOR_FACTOR, GEOM_TOL,  # noqa: E402
                              NET_TOL, assert_grads_match, assert_optimizer_matches,
                              capture, grads_of, keyed, orientations,
                              raw_batch)
from test_torch_unseen import JaxCemDraws  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RECORD = ROOT / "artifacts" / "oracle_distill"
CURVES = json.loads(witness.CURVES.read_text())
PROBE_POINTS = (0, 3, 6)  # 0, 0.15 and 0.3 rad
SIZE = 16  # the tiny photographer's renders


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


def close_rel(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(float(np.abs(b).max()), 1e-30), (
        float(np.abs(a - b).max()), float(np.abs(b).max()))


# ---------------------------------------------------------------- JAX draws
def jax_camera_draws() -> dict:
    """What ``experiment_cameras.json`` holds, drawn by the JAX package."""
    refs = [np.asarray(jquat.random(k, 1))[0]
            for k in jax.random.split(jax.random.PRNGKey(7), 8)]
    ek, targets = jax.random.PRNGKey(55), []
    for _ in range(8):
        ek, k1, _ = jax.random.split(ek, 3)
        targets.append(np.asarray(jquat.random(k1, 1))[0])
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    return {"reference_quats": np.stack(refs), "target_quats": np.stack(targets),
            "trained_pose_gt_quat": np.asarray(jquat.random(jax.random.PRNGKey(99), 1))[0],
            "trained_pose_perturb_quats": np.asarray(jquat.perturb(k1, jquat.identity(8), 0.3)),
            "trained_pose_translation_noise": np.asarray(jax.random.normal(k2, (8, 3)) * 0.1)}


def write_camera_draws() -> None:
    rec = json.loads(tcube.EXPERIMENT_CAMERAS.read_text())
    rec.update({k: np.asarray(v, np.float64).tolist() for k, v in jax_camera_draws().items()})
    tcube.EXPERIMENT_CAMERAS.write_text(json.dumps(rec, indent=1) + "\n")


def test_experiment_cameras_are_jax_draws():
    draws = tcube.load_draws()
    jax_draws = jax_camera_draws()
    assert set(draws) == set(jax_draws)
    for k, v in jax_draws.items():
        np.testing.assert_array_equal(draws[k], v)


# ------------------------------------------------------- JAX tool literals
def tool_literals(name: str) -> dict:
    """The literals of a JAX tool, its module-level constants substituted:
    ``coarse_kw`` under each branch of ``args.coarse_config``, the
    ``config=`` of ``make_recon_train_step`` and the keywords of each
    estimator it builds (those made of constants)."""
    tree = ast.parse((ROOT / "tools" / f"{name}.py").read_text())
    names = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            try:
                names[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass

    def value(node):
        return eval(compile(ast.Expression(node), name, "eval"),  # noqa: S307 (constants only)
                    {"__builtins__": {"dict": dict}}, dict(names))

    def consts(call):
        kw = {}
        for k in call.keywords:
            try:
                kw[k.arg] = value(k.value)
            except (NameError, AttributeError, TypeError):
                pass
        return kw

    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.If) and "coarse_config" in ast.unparse(node.test):
            for branch, body in (("slow", node.body), ("quick", node.orelse)):
                out[f"coarse_{branch}"] = consts(body[0].value)
        if isinstance(node, ast.Call):
            fn = ast.unparse(node.func)
            if fn.endswith("make_recon_train_step"):
                out["step_config"] = next(value(k.value) for k in node.keywords
                                          if k.arg == "config")
            for est in ("CrossEntropyPoseEstimator", "GradientPoseEstimator"):
                if fn.endswith(est):
                    out.setdefault(est, []).append(consts(node))
    return out


def test_oracle_distill_settings_are_the_jax_tools():
    jax_tool = tool_literals("train_oracle_distill")
    for config in ("quick", "slow"):
        args = toracle.get_args(["--out", "x", "--coarse-config", config])
        assert toracle.coarse_kwargs(args) == jax_tool[f"coarse_{config}"]
    assert jax_tool["GradientPoseEstimator"] == [toracle.FINE]
    assert jax_tool["CrossEntropyPoseEstimator"] == [
        {"num_gmm_components": 6, "sample_flipped": True}]
    tool = witness._tool()
    assert (tool.INPUT_SIZE, tool.CAMERA_DIST, tool.AXES, tool.LATENT_CHANNELS) == (
        toracle.INPUT_SIZE, toracle.CAMERA_DIST, toracle.AXES, toracle.LATENT_CHANNELS)
    # The tool's photographer is the demo family's (zoo.demo_photographer).
    assert (tool.PHOTOGRAPHER_CAMERA_CONFIG, tool.PHOTOGRAPHER_IMAGE_CONFIG, tool.LATENT_SIZE) == (
        tzoo.DEMO_PHOTOGRAPHER_CAMERA_CONFIG, tzoo.DEMO_PHOTOGRAPHER_IMAGE_CONFIG,
        tzoo.DEMO_INPUT_SIZE // 16)
    args = toracle.get_args(["--out", "x", "--coarse-samples", "40", "--coarse-iters", "3"])
    assert toracle.coarse_kwargs(args) == {**jax_tool["coarse_quick"], "num_samples": 40,
                                           "num_iters": 3, "num_elites": 48}


@pytest.mark.parametrize("config", ["quick", "slow"])
def test_coarse_config_builds_the_jax_estimators(config):
    """Both distillation tools' CEM under ``--coarse-config``: JAX's
    budget, learning rate, loss weights and ranking."""
    want = tool_literals("train_encoder_distill")[f"coarse_{config}"]
    assert want == tool_literals("train_oracle_distill")[f"coarse_{config}"]
    args = tdistill.get_args(["--out", "x", "--coarse-config", config])
    model = toracle.decoder_model(tzoo.demo_photographer(device="cpu"), "cpu")
    cems = [unseen_eval.build_estimators(model, tdistill.budget_of(args),
                                         coarse_config=config)[0],
            toracle.build_estimators(model, toracle.get_args(
                ["--out", "x", "--coarse-config", config]))[0]]
    for cem in cems:
        got = {k: getattr(cem, k) for k in want}
        got["loss_weights"] = {k: v for k, v in cem.loss_weights.items() if v}
        assert got == want
        assert (cem.num_gmm_components, cem.sample_flipped) == (6, True)
    over = tdistill.budget_of(tdistill.get_args(["--out", "x", "--coarse-config", config,
                                                 "--cem-samples", "8"]))
    assert over["cem_samples"] == 8 and over["cem_iters"] == want["num_iters"]


def test_cube_and_pose_settings_are_the_jax_tools():
    cube = tool_literals("train_cube_demo")
    assert cube["step_config"] == tcube.STEP_CONFIG
    assert cube["CrossEntropyPoseEstimator"] == [tcube.COARSE]
    assert cube["GradientPoseEstimator"] == [tcube.FINE]
    pose = tool_literals("trained_pose_experiment")
    assert pose["step_config"] == tpose.STEP_CONFIG
    assert pose["GradientPoseEstimator"] == [tpose.FINE]
    spec = importlib.util.spec_from_file_location("_jax_cube_demo",
                                                  ROOT / "tools" / "train_cube_demo.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    sculptor, _, photographer = module.make_models()
    args = tzoo.demo_module_args(input_depth=False)
    assert args["sculptor"] == sculptor.checkpoint_args()
    assert args["photographer"] == photographer.checkpoint_args()


# --------------------------------------------------- the committed checkpoint
@pytest.fixture(scope="module")
def jax_distilled():
    """The JAX tool's photographer and its parameters: the npz's leaves
    nested by the paths JAX flattened them under (``distilled_keys.json``),
    the tree the tool's ``--skip-train`` unflattens them into (-m slow's
    witness curve goes through the tool's own template)."""
    tool = witness._tool()
    photographer = jmodels.Photographer(
        in_size=tool.LATENT_SIZE, image_config=tool.PHOTOGRAPHER_IMAGE_CONFIG,
        camera_config=tool.PHOTOGRAPHER_CAMERA_CONFIG, object_config=None,
        projection_type="factor", predict_color=False, predict_depth=True,
        predict_mask=True, cube_size=1.0, scale_mode="nearest")
    params = tckpt.nest_params(tckpt.load_params_npz(RECORD / "distilled.npz",
                                                     RECORD / "distilled_keys.json"))
    return tool, photographer, jax.tree_util.tree_map(jnp.asarray, params)


@pytest.fixture(scope="module")
def port_distilled():
    photographer = tzoo.demo_photographer(device="cpu")
    z_obj = toracle.load_distilled(RECORD, photographer, "cpu")
    return photographer, z_obj


def jax_decoder_model(jax_distilled):
    tool, photographer, params = jax_distilled
    model = JModel(sculptor=None, sculptor_params={}, fuser=None, fuser_params={},
                   photographer=photographer, photographer_params=params["photographer"],
                   camera_dist=tool.CAMERA_DIST)
    assert model.input_size is None
    model.input_size = tool.INPUT_SIZE
    return model


def test_decoder_only_model_matches_jax(jax_distilled, port_distilled):
    tool, _, params = jax_distilled
    bare = TModel(None, None, None, None, tzoo.demo_photographer(device="cpu"), None,
                  camera_dist=toracle.CAMERA_DIST, device="cpu")
    assert bare.input_size is None
    with pytest.raises(ValueError, match="Sculptor"):
        bare.build_latent_object(None)
    with pytest.raises(ValueError, match="input_size"):
        bare.zoom_observation(Observation(torch.zeros(1, 3, 4, 4), torch.zeros(1, 1, 4, 4),
                                          torch.zeros(1, 1, 4, 4),
                                          tzoo.canonical_camera(1, device="cpu")))
    jm = jax_decoder_model(jax_distilled)
    tm = toracle.decoder_model(port_distilled[0], "cpu")
    jcam = witness.tool_cameras(tool, jax.random.PRNGKey(5), 4, zoomed=False)
    jy, _ = jm.render_latent_object(params["z_obj"], jcam.zoom(None, 128, tool.CAMERA_DIST))
    ty, _ = tm.render_latent_object(port_distilled[1],
                                    port_camera(jcam).zoom(None, 128, toracle.CAMERA_DIST))
    for k in ("depth", "mask"):
        close_rel(ty[k], jy[k], NET_TOL)


def test_distilled_npz_reads_and_writes_jax_bits(port_distilled, tmp_path):
    toracle.save_distilled(tmp_path, *port_distilled)
    assert (json.loads((tmp_path / "distilled_keys.json").read_text())
            == json.loads((RECORD / "distilled_keys.json").read_text()))
    with np.load(RECORD / "distilled.npz") as theirs, np.load(tmp_path / "distilled.npz") as ours:
        assert theirs.files == ours.files
        for k in theirs.files:
            assert ours[k].dtype == theirs[k].dtype
            np.testing.assert_array_equal(ours[k], theirs[k])


def sharpness_of(port_distilled, angles):
    photographer, z_obj = port_distilled
    model = toracle.decoder_model(photographer, "cpu")
    args = toracle.get_args(["--out", "x"])
    _, fine = toracle.build_estimators(model, args)
    oracle = ttesting.EllipsoidOracleModel(input_size=128, camera_dist=toracle.CAMERA_DIST,
                                           axes=toracle.AXES, device="cpu")
    return [p["loss"] for p in toracle.sharpness_curve(fine, z_obj, oracle, "cpu", angles)]


def test_sharpness_probe_matches_jax(port_distilled):
    """The probe at 3 of its angles, fp32: JAX's curve computed here equals
    the committed one (which gate (a) of the chip run reads), and the
    port's is within 5e-4 of it."""
    angles = [toracle.PROBE_ANGLES[i] for i in PROBE_POINTS]
    theirs = witness.sharpness_curves(angles, ("float32",))["float32"]
    np.testing.assert_allclose(theirs, [CURVES["float32"][i] for i in PROBE_POINTS], rtol=1e-6)
    ours = sharpness_of(port_distilled, angles)
    for i, loss, ref in zip(PROBE_POINTS, ours, theirs):
        assert abs(loss - ref) <= NET_TOL * ref, i


@pytest.mark.slow
def test_sharpness_curve_matches_jax(port_distilled):
    curves = witness.sharpness_curves()
    np.testing.assert_allclose(curves["float32"], CURVES["float32"], rtol=1e-6)
    ours = sharpness_of(port_distilled, toracle.PROBE_ANGLES)
    np.testing.assert_allclose(ours, curves["float32"], rtol=NET_TOL)


# ------------------------------------------------------------- the loss
AXES = toracle.AXES


def jax_distill_loss(photographer, oracle, params, z_obj, cam_full, frame_loss_weight):
    """tools/train_oracle_distill.py's distill_loss (:146-183) after its draws."""
    views = len(cam_full)
    cam = cam_full.zoom(None, SIZE, toracle.CAMERA_DIST)
    y_o, _, _ = oracle.decode_latent(None, cam)
    o_depth = y_o["depth"][0]
    o_mask = (y_o["mask"][0] > 0.5).astype(jnp.float32)
    z = jnp.broadcast_to(z_obj, (1, views, *z_obj.shape[2:])).reshape(views, *z_obj.shape[2:])
    y = photographer.interpret_logits(photographer.apply(params, z, cam)[0])
    depth_l1 = jnp.abs(y["depth"] - o_depth).mean()
    mask_bce = jest._bce_with_logits(y["mask_logits"], o_mask).mean()
    loss = 25.0 * depth_l1 + 25.0 * mask_bce
    frame = jest.default_pose_loss(oracle.make_observation(cam_full),
                                   cam.denormalize_depth(y["depth"]), y["mask_logits"], cam)
    frame_depth = frame["depth"].mean()
    loss = loss + frame_loss_weight * (frame_depth + 0.3 * frame["ov_depth"].mean())
    return loss, {"depth_l1": depth_l1, "mask_bce": mask_bce, "frame_depth": frame_depth}


def tiny_photographer_params():
    """JAX's parameters of the tiny photographer: the port's N(0, 1) draw
    from seed 0 (``zoo.init_weights_``) through ``to_jax_params``."""
    ph = tzoo.tiny_photographer(device="cpu", generator=torch.Generator().manual_seed(0))
    tree = tckpt.nest_params(tckpt.to_jax_params({f"photographer.{k}": v
                                                  for k, v in ph.state_dict().items()}))
    return jax.tree_util.tree_map(jnp.asarray, tree["photographer"])


def test_distill_loss_and_gradients_match_jax():
    jph = jzoo.tiny_photographer()
    joracle = jtesting.EllipsoidOracleModel(input_size=SIZE, camera_dist=toracle.CAMERA_DIST,
                                            axes=AXES)
    cam_full = jzoo.random_view_cameras(jax.random.PRNGKey(3), 4, SIZE, toracle.CAMERA_DIST)
    z_obj = jax.random.normal(jax.random.PRNGKey(2), (1, 1, 4, 8, 8, 8)) * 0.1
    params = tiny_photographer_params()

    def loss_fn(params, z_obj):
        return jax_distill_loss(jph, joracle, params, z_obj, cam_full, 2.0)

    (jloss, jterms), (jg_params, jg_z) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(params, z_obj)
    state = keyed({"photographer": params})
    toracle_ = ttesting.EllipsoidOracleModel(input_size=SIZE, camera_dist=toracle.CAMERA_DIST,
                                             axes=AXES, device="cpu")
    tcam = port_camera(cam_full)

    def port(context=None):
        ph = tzoo.tiny_photographer(device="cpu").train()
        ph.load_state_dict({k[len("photographer."):]: torch.from_numpy(v)
                            for k, v in state.items()})
        z = torch.from_numpy(np.array(z_obj)).requires_grad_(True)
        with context(ph) if context else contextlib.nullcontext():
            loss, terms = toracle.distill_loss(ph, z, toracle_, tcam, 2.0)
            loss.backward()
        grads = {f"photographer.{k}": p.grad.numpy() for k, p in ph.named_parameters()}
        grads["z_obj"] = z.grad.numpy()
        return loss, terms, grads

    loss, terms, grads = port()
    scale = float(jloss)
    assert abs(float(loss) - scale) <= NET_TOL * scale
    for k, v in jterms.items():
        assert abs(float(terms[k]) - float(v)) <= NET_TOL * scale, k
    ref = {**keyed({"photographer": jg_params}), "z_obj": np.asarray(jg_z)}
    assert set(grads) == set(ref)

    def errs(ours):
        return {k: float(np.abs(ours[k] - ref[k]).max()) / max(float(np.abs(ref[k]).max()),
                                                               1e-30) for k in ref}

    floors = [max(errs(port(lambda m, e=eps, d=draw: ttesting.convs_perturbed(m, e, d))[2]
                       ).values()) for eps in FLOOR_EPS for draw in range(3)]
    tol = max(NET_TOL, FLOOR_FACTOR * max(floors))
    got = errs(grads)
    assert max(got.values()) <= tol, (tol, sorted(got.items(), key=lambda kv: -kv[1])[:3])


# ------------------------------------------------------ the training steps
@pytest.fixture(scope="module")
def cube_pool(tmp_path_factory):
    """Batches of the cube demo's stream (the port's rasterizer), rendered
    once: (torch, numpy) pairs at the trained-pose experiment's 96x72."""
    mesh = tcube.make_cube_obj(tmp_path_factory.mktemp("cube"))

    def pool(n, batch, views_in, views_out, seed=0):
        # The stream seeds its worker from Python's random: fix it, so the
        # batches are the same from run to run.
        state, np_state = random.getstate(), np.random.get_state()
        random.seed(seed)
        np.random.seed(seed)
        try:
            out = tcube.render_pool(mesh, n, batch, views_in, views_out, tpose.W, tpose.H,
                                    "cpu")
        finally:
            random.setstate(state)
            np.random.set_state(np_state)
        return [(b, {k: {kk: vv.numpy() for kk, vv in v.items()} for k, v in b.items()})
                for b in out]
    return pool


def jax_params_of(port_modules) -> dict:
    """JAX's parameter tree of the port's modules (N(0, 1) from seed 0):
    ``to_jax_params`` instead of JAX's jitted init, which costs more than
    the step."""
    mods = port_modules()
    gen = torch.Generator().manual_seed(0)
    for m in mods.values():
        tzoo.init_weights_(m, gen)
    state = {f"{name}.{k}": v for name, m in mods.items() for k, v in m.state_dict().items()}
    return jax.tree_util.tree_map(jnp.asarray,
                                  tckpt.nest_params(tckpt.to_jax_params(state)))


def floor_tolerance(run_first_step, grads, draws: int):
    """``tests/test_torch_train.py``'s ``grad_tolerance`` with ``draws``
    draws at each eps (3 there): max(NET_TOL, FLOOR_FACTOR x the largest
    floor)."""
    floors = []
    for eps in FLOOR_EPS:
        for draw in range(draws):
            mods = run_first_step(lambda m, e=eps, d=draw: ttesting.convs_perturbed(
                torch.nn.ModuleList(m.values()), e, d))
            ours = grads_of(mods)
            floors.append(max(float(np.abs(ours[k] - grads[k]).max())
                              / max(float(np.abs(grads[k]).max()), 1e-30) for k in grads))
    return max(NET_TOL, FLOOR_FACTOR * max(floors))


# A pre-activation this close to 0, relative to its tensor's largest, is
# one whose leaky-ReLU branch fp32 rounding decides: JAX's own jitted and
# eager steps take different branches at such elements.
KINK_NEAR = 1e-5


def _conv_key(top: str, path: str) -> str:
    """"Sculptor:camera_blocks_0/conv1": a convolution by its top module and
    JAX's path (the port's ``camera_blocks.0.conv1``)."""
    return f"{top}:{re.sub(r'[.]([0-9]+)', r'_\1', path).replace('.', '/')}"


class JaxPreactivations:
    """Each convolution's output in JAX's compiled step, outside the fuser:
    a ``jax.debug.callback`` that ``flax.linen.intercept_methods`` adds
    while the step traces (the step's gradients are the same bits with and
    without it). Under ``remat`` the backward's recompute sends it again."""

    def __init__(self):
        self.values = {}

    def _keep(self, key, value):
        self.values.setdefault(key, []).append(np.asarray(value))

    @contextlib.contextmanager
    def tracing(self):
        def intercept(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            m = context.module
            if (context.method_name == "__call__" and isinstance(m, JEqualizedConv)
                    and "gru" not in m.path):
                top = m
                while isinstance(top.parent, flax.linen.Module):
                    top = top.parent
                jax.debug.callback(functools.partial(
                    self._keep, _conv_key(type(top).__name__, ".".join(m.path))), out)
            return out

        with flax.linen.intercept_methods(intercept):
            yield


@contextlib.contextmanager
def on_jax_side_of_kinks(mods, jax_values, aligned):
    """Inside, an element of a port convolution's output whose sign is not
    JAX's takes JAX's value (its gradient still flows), so the leaky ReLU
    after it takes JAX's branch. Each such element lies within
    ``KINK_NEAR`` of its tensor's largest from 0 in both packages, or this
    fails; ``aligned`` gets (key, count, distance)."""
    def hook(key, _module, _inputs, y):
        ref = torch.from_numpy(jax_values[key][-1].copy())
        flip = torch.sign(y.detach()) != torch.sign(ref)
        if not flip.any():
            return y
        near = max(float(y.detach()[flip].abs().max()),
                   float(ref[flip].abs().max())) / float(ref.abs().max())
        aligned.append((key, int(flip.sum()), near))
        assert near <= KINK_NEAR, (key, near)
        return y + torch.where(flip, ref - y.detach(), torch.zeros_like(y))

    handles = [m.register_forward_hook(functools.partial(hook, _conv_key(type(top).__name__,
                                                                          path)))
               for top in mods.values() for path, m in top.named_modules()
               if isinstance(m, TEqualizedConv) and "gru" not in path]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def jax_step_of(jmods, config):
    """The JAX recon step whose optimizer state keeps the step's gradient
    and update (``capture``), that optimizer, and the recorder of its
    convolutions' outputs."""
    opt = capture(jstep.make_optimizer("adam", 1e-3))
    return (jstep.make_recon_train_step(*jmods, opt, config=config), opt,
            JaxPreactivations())


def step_matches(jax_step, params, port_modules, config, batch, key, draws=3, spread=0.0):
    """One step of the JAX recon step and the port's from the same
    parameters and batch (JAX's orientation draw injected): the loss terms
    within 5e-4, every gradient within 5e-4 or 3x the port's noise floor,
    and the port's Adam given JAX's gradient makes JAX's update. The port's
    leaky ReLUs take JAX's branch at the pre-activations whose sign the two
    packages' rounding decides differently (``on_jax_side_of_kinks``): one
    such element flipped moves the Sculptor's gradients by up to 1.2 %,
    and the multiplicative noise floor never flips a sign. (The parameters
    after the step are not compared: with b1 = 0 Adam's first update is
    lr * sign(g), which flips on gradient elements below the gradients'
    tolerance.) ``spread``, JAX's own, raises the gradients' gate to 3x it
    where it is larger. Returns (the port's modules, JAX's parameters after
    the step, the aligned elements)."""
    jax_step[2].values = {}
    with jax_step[2].tracing():
        jstate, jscalars = jax_step[0](jstep.init_gan_train_state(params, jax_step[1]),
                                       batch[1], key)
    jax.effects_barrier()
    jax_values = jax_step[2].values
    for key_, values in jax_values.items():  # the recompute takes the forward's branch
        assert all(np.array_equal(np.sign(v), np.sign(values[0])) for v in values), key_
    rotations = [torch.from_numpy(np.array(q)) for q in orientations(key, 1)]
    state = keyed(params)
    aligned = []

    def port(context=None):
        mods = port_modules()
        for name, module in mods.items():
            module.load_state_dict({k[len(name) + 1:]: torch.from_numpy(v)
                                    for k, v in state.items() if k.startswith(name + ".")})
        tstate = tstep.init_train_state(mods, tstep.make_optimizer("adam", 1e-3))
        step = tstep.make_recon_train_step(mods["sculptor"], mods["fuser"],
                                           mods["photographer"], config=config)
        with on_jax_side_of_kinks(mods, jax_values, aligned), \
                (context(mods) if context else contextlib.nullcontext()):
            _, scalars = step(tstate, batch[0], rotations=rotations)
        return mods, scalars

    mods, tscalars = port()
    assert set(tscalars) == set(jscalars)
    for k in jscalars:
        assert abs(float(tscalars[k]) - float(jscalars[k])) <= NET_TOL * max(
            abs(float(jscalars[k])), 1.0), k
    first = list(aligned)
    tol = max(floor_tolerance(lambda context: port(context)[0], grads_of(mods), draws),
              FLOOR_FACTOR * spread)
    assert_grads_match(mods, jstate.opt_state[1], tol)
    assert_optimizer_matches([jstate.opt_state[1]], [jstate.opt_state[2]])
    return mods, jstate.params, first


# Tiny widths rendering 64² (the top-4096 loss needs 4096 pixels a view)
# from 16³ volumes: one more down in the Sculptor's and one more up in the
# Photographer's image U-Net than zoo.tiny_*. zoo.tiny_* at input 64 (32³
# volumes) is held module by module below, and whole under -m slow.
CUBE_SCULPTOR = dict(in_size=64, image_config=((4, "D", 8, "D", 8), (8,)),
                     camera_config=(4, 4), object_config=(4, 4), projection_type="factor",
                     cube_size=1.0)
CUBE_PHOTOGRAPHER = dict(in_size=16, image_config=((4, "D", 8), (8, "U", 8, "U", 8, "U", 4)),
                         camera_config=(4, 4), object_config=None, projection_type="factor",
                         predict_depth=True, predict_mask=True, cube_size=1.0)
CUBE_CONFIG = {**tcube.STEP_CONFIG, "camera_dist": CAMERA_DIST}


def test_cube_demo_step_matches_jax(tmp_path):
    """One step at the cube demo's config (``remat``, top-4096 hard
    smooth-L1, 25/25) at tiny widths rendering 64², on
    ``tests/test_torch_train.py``'s oracle batch (its camera distance); the
    ``.pth`` of the port's modules loads in both packages to the same
    tensors."""
    from latentfusion_tpu_torch.recon import models as tmodels
    from latentfusion_tpu_torch.recon.fusion import GRUFuser

    jmods = (jmodels.Sculptor(**CUBE_SCULPTOR), jzoo.tiny_fuser(),
             jmodels.Photographer(**CUBE_PHOTOGRAPHER))

    def port_modules():
        return {"sculptor": tmodels.Sculptor(**CUBE_SCULPTOR), "fuser": GRUFuser(4, 1.0),
                "photographer": tmodels.Photographer(**CUBE_PHOTOGRAPHER)}

    mods, _, _ = step_matches(jax_step_of(jmods, CUBE_CONFIG), jax_params_of(port_modules),
                              port_modules, CUBE_CONFIG, raw_batch(10, 1, 2, 2, 64, 48),
                              jax.random.PRNGKey(20))
    args = {"sculptor": jmods[0].checkpoint_args(), "photographer": jmods[2].checkpoint_args()}
    tckpt.save_reference_checkpoint(
        tmp_path / "checkpoint.pth", tckpt.reference_entries(args, mods["fuser"]),
        {name: m.state_dict() for name, m in mods.items()}, name="cube_demo",
        args={"camera_dist": tcube.CAMERA_DIST})
    ours = TModel.from_checkpoint(tmp_path / "checkpoint.pth", device="cpu")
    theirs = JModel.from_checkpoint(str(tmp_path / "checkpoint.pth"))
    assert theirs.camera_dist == ours.camera_dist == tcube.CAMERA_DIST
    jparams = keyed({"sculptor": theirs.sculptor_params, "fuser": theirs.fuser_params,
                     "photographer": theirs.photographer_params})
    for name, module in mods.items():
        for k, v in module.state_dict().items():
            np.testing.assert_array_equal(jparams[f"{name}.{k}"], v.numpy())
            assert torch.equal(getattr(ours, name).state_dict()[k], v)


# The modules a step is held by one at a time.
BLOCKS = ("Block", "InputBlock", "OutputBlock", "FactorProjection2d3d", "FactorProjection3d2d")


class JaxBlocks(JaxPreactivations):
    """Also each block's input and output in JAX's compiled step, and their
    cotangents (an identity with a custom VJP that sends its cotangent),
    and the Photographer's input."""

    def __init__(self):
        super().__init__()
        self.cots = {}

    def _keep_cot(self, key, value):
        self.cots.setdefault(key, []).append(np.asarray(value))

    def _tap(self, key, x):
        @jax.custom_vjp
        def tap(v):
            return v

        def bwd(_, g):
            jax.debug.callback(functools.partial(self._keep_cot, key), g)
            return (g,)

        tap.defvjp(lambda v: (v, None), bwd)
        x = tap(x)
        jax.debug.callback(functools.partial(self._keep, key), x)
        return x

    @contextlib.contextmanager
    def tracing(self):
        def intercept(next_fun, args, kwargs, context):
            m = context.module
            name = type(m).__name__
            if context.method_name != "__call__" or "gru" in m.path or not (
                    name in BLOCKS or (name == "Photographer" and not m.path)):
                return next_fun(*args, **kwargs)
            top = m
            while isinstance(top.parent, flax.linen.Module):
                top = top.parent
            key = _conv_key(type(top).__name__, ".".join(m.path))
            out = next_fun(self._tap(key + "<in", args[0]), *args[1:], **kwargs)
            return out if name == "Photographer" else self._tap(key + ">out", out)

        with super().tracing(), flax.linen.intercept_methods(intercept):
            yield


def test_cube_demo_step_modules_match_jax():
    """The cube demo's step with ``zoo.tiny_*`` at input 64 (32³ volumes,
    the N(0, 1) weights of seed 0, the oracle batch of the 16³ case), held
    module by module: each block of the Sculptor and the Photographer and
    each volume sampler (K1-fwd, K1-bwd-vol) of the port, given the input
    and the output's cotangent of JAX's compiled step, gives its output,
    its input's cotangent and its parameters' gradients within 5e-4 (all
    within 1.5e-5 here). Whole, this step parts from JAX's by 5.4e-4 of the
    Sculptor's second object-block convolution's gradient once two
    elements on the leaky ReLU's kink take JAX's side (1.2 % before): the
    4-channel PixelNorms amplify each package's fp32 rounding, and JAX's
    own jitted and eager gradients part by 3.05e-4 of the same tensor
    (``-m slow`` holds the whole step to that spread)."""
    from latentfusion_tpu_torch import transforms as ttransforms
    from latentfusion_tpu_torch.recon.utils import process_batch

    params = jax_params_of(tiny_cube_modules)
    batch, key = raw_batch(10, 1, 2, 2, 64, 48), jax.random.PRNGKey(20)
    jax_blocks = JaxBlocks()
    opt = capture(jstep.make_optimizer("adam", 1e-3))
    with jax_blocks.tracing():
        jstate, _ = jstep.make_recon_train_step(*jax_tiny_cube_modules(), opt, config=CUBE_CONFIG)(
            jstep.init_gan_train_state(params, opt), batch[1], key)
    jax.effects_barrier()
    jgrads, values, cots = keyed(jstate.opt_state[1]), jax_blocks.values, jax_blocks.cots
    mods = tiny_cube_modules()
    state = keyed(params)
    for name, module in mods.items():
        module.load_state_dict({k[len(name) + 1:]: torch.from_numpy(v)
                                for k, v in state.items() if k.startswith(name + ".")})

    def run(fn, x_key, y_key, *args):
        x = torch.from_numpy(values[x_key][-1].copy()).requires_grad_(True)
        y = fn(x, *args)
        if y.shape != values[y_key][-1].shape:  # the U-Net's last block: its heads below
            y = fn(x, skip_scale=True)
        y.backward(torch.from_numpy(cots[y_key][-1].copy()))
        errs = {"out": rel_err(y.detach(), values[y_key][-1])}
        if x_key in cots:  # not the network's input
            errs["in"] = rel_err(x.grad, cots[x_key][-1])
        return errs

    errs, held, aligned = {}, set(), []
    with on_jax_side_of_kinks(mods, values, aligned):
        for name, top in mods.items():
            for path, m in top.named_modules():
                if type(m).__name__ in BLOCKS and "gru" not in path:
                    key_ = _conv_key(type(top).__name__, path)
                    m.zero_grad()
                    errs[key_] = run(m, key_ + "<in", key_ + ">out")
                    for pname, p in m.named_parameters():
                        errs[key_][pname] = rel_err(p.grad, jgrads[f"{name}.{path}.{pname}"])
                        held.add(f"{name}.{path}.{pname}")
    proc = process_batch(batch[0], 1.0, CAMERA_DIST, 64, True, None,
                         torch.from_numpy(np.array(orientations(key, 1)[0])))
    errs["camera_to_object"] = run(ttransforms.camera_to_object, "Sculptor:camera_blocks_0>out",
                                   "Sculptor:object_blocks_0<in", proc["in"]["camera"], 1.0)
    errs["object_to_camera"] = run(ttransforms.object_to_camera, "Photographer:<in",
                                   "Photographer:camera_blocks_0<in", proc["out_gt"]["camera"],
                                   1.0)
    assert held == {f"{name}.{k}" for name in ("sculptor", "photographer")
                    for k, _ in mods[name].named_parameters()}
    worst = {k: max(v.values()) for k, v in errs.items()}
    assert max(worst.values()) <= NET_TOL, sorted(worst.items(), key=lambda kv: -kv[1])[:3]


def tiny_cube_modules():
    return {"sculptor": tzoo.tiny_sculptor(64, device="cpu"),
            "fuser": tzoo.tiny_fuser(device="cpu"),
            "photographer": tzoo.tiny_photographer(32, device="cpu")}


def jax_tiny_cube_modules():
    return jzoo.tiny_sculptor(64), jzoo.tiny_fuser(), jzoo.tiny_photographer(32)


def rel_err(ours, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(ours, np.float64) - ref).max()) / max(
        float(np.abs(ref).max()), 1e-30)


@pytest.mark.slow
def test_cube_demo_step_at_32_cubed_matches_jax():
    """The whole step of the module-by-module case: the port's gradients
    within 3x JAX's own spread (its jitted step against the same step run
    eagerly, 3.05e-4) of JAX's jitted step, or 3x the port's noise floor,
    or 5e-4, the largest (the port reads 5.4e-4). About 70 s."""
    params = jax_params_of(tiny_cube_modules)
    batch, key = raw_batch(10, 1, 2, 2, 64, 48), jax.random.PRNGKey(20)
    opt = capture(jstep.make_optimizer("adam", 1e-3))
    step = jstep.make_recon_train_step(*jax_tiny_cube_modules(), opt, config=CUBE_CONFIG)
    jitted, _ = step(jstep.init_gan_train_state(params, opt), batch[1], key)
    with jax.disable_jit():
        eager, _ = jstep.make_recon_train_step(*jax_tiny_cube_modules(), opt, config=CUBE_CONFIG)(
            jstep.init_gan_train_state(params, opt), batch[1], key)
    jitted_g, eager_g = keyed(jitted.opt_state[1]), keyed(eager.opt_state[1])
    spread = max(rel_err(eager_g[k], jitted_g[k]) for k in jitted_g)
    assert spread > 0  # the two programs round differently

    step_matches(jax_step_of(jax_tiny_cube_modules(), CUBE_CONFIG), params, tiny_cube_modules,
                 CUBE_CONFIG, batch, key, draws=1, spread=spread)


def jax_small_stack():
    """tools/trained_pose_experiment.py's small stack (:50-58)."""
    sculptor = jmodels.Sculptor(in_size=32, image_config=((8, "D", 16), (16,)),
                                camera_config=(16, 16), object_config=(16, 16),
                                projection_type="factor", cube_size=1.0)
    photographer = jmodels.Photographer(in_size=16, image_config=((8, "D", 16),
                                                                  (16, "U", 16, "U", 8)),
                                        camera_config=(16, 16), object_config=None,
                                        projection_type="factor", predict_depth=True,
                                        predict_mask=True, cube_size=1.0)
    return sculptor, jfusion.GRUFuser(in_channels=16), photographer


def test_trained_pose_steps_match_jax(cube_pool):
    """The trained-pose experiment's first two steps (its config, its small
    stack) on two batches of a cube pool drawn at Python seed 1: the second
    from JAX's parameters after the first. There one element of the
    Sculptor's first object-block convolution and one of the Photographer's
    camera-block second convolution lie within 1.2e-6 of their largest
    from 0; the port, JAX's jitted step and JAX's eager gradient do not all
    take the same branch of the leaky ReLU there (JAX's jitted and eager
    gradients part by 0.54 %, the port and JAX's jitted by 0.69 %). Taken
    on JAX's side, every gradient agrees within 1.1e-5."""
    def port_modules():
        return dict(zip(("sculptor", "fuser", "photographer"), tpose.make_models("cpu")))

    params = jax_params_of(port_modules)
    jax_step = jax_step_of(jax_small_stack(), tpose.STEP_CONFIG)
    aligned = []
    for batch, key in zip(cube_pool(2, 1, 2, 2, seed=1),
                          (jax.random.PRNGKey(1), jax.random.PRNGKey(2))):
        _, params, step_aligned = step_matches(jax_step, params, port_modules,
                                               tpose.STEP_CONFIG, batch, key)
        aligned.append(step_aligned)
    # The second step's two kinks (a change that moved the pre-activations
    # would show here first).
    assert sorted(k for k, _, _ in aligned[1]) == ["Photographer:camera_blocks_0/conv2",
                                                   "Sculptor:object_blocks_0/conv1"]


# ------------------------------------------------------- evaluation rows
def jax_row(model, oracle, z_obj, gt_cam, coarse_kw, fine_kw, key):
    """The JAX tool's evaluation of one target (:304-349)."""
    coarse = jest.CrossEntropyPoseEstimator(model=model, num_gmm_components=6,
                                            sample_flipped=True, **coarse_kw)
    fine = jest.GradientPoseEstimator(model=model, **fine_kw)
    points = jnp.asarray(np.asarray(jorientation.evenly_distributed_points(512))
                         * np.asarray(AXES))
    target = jax.jit(oracle.make_observation)(gt_cam)
    coarse_cams = coarse.estimate(z_obj, target, key=key)
    best = fine.estimate(z_obj, target, camera=coarse_cams[:fine_kw["num_samples"]])

    def cam_metrics(c):
        m = jmetrics.camera_metrics(gt_cam, c, points, scale_to_meters=1.0)
        return {k: float(m[k]) for k in ("add_s", "rotation_dist", "translation_dist")}

    def score(c):
        loss, _ = fine._score_hypotheses(z_obj, target, c)
        return float(loss.min())

    return {"coarse": cam_metrics(coarse_cams[0]), "refined": cam_metrics(best[0]),
            "loss_at_gt": score(gt_cam), "loss_refined": score(best[:1]),
            "add_s_01d": bool(cam_metrics(best[0])["add_s"] < 0.1 * toracle.DIAMETER)}


SHRUNKEN_FINE = {**toracle.FINE, "num_samples": 2, "num_iters": 2, "ranking_size": 2}
JAX_ROWS = Path(__file__).with_name("oracle_distill_rows.json")
ROW_SEED = 4  # the target's rotation key; the CEM's key is ROW_SEED + 1


def tiny_row_setup():
    """The tiny-width row's inputs: the tiny photographer's JAX parameters,
    a random latent (numpy seed 2), the CEM's budget under ``slow``'s
    semantics (8 x 2)."""
    z_obj = np.random.RandomState(2).randn(1, 1, 4, 8, 8, 8).astype(np.float32)
    args = toracle.get_args(["--out", "x", "--coarse-config", "slow", "--coarse-samples", "8",
                             "--coarse-iters", "2"])
    return tiny_photographer_params(), z_obj, toracle.coarse_kwargs(args)


def jax_tiny_row() -> dict:
    params, z_obj, coarse_kw = tiny_row_setup()
    jph = jzoo.tiny_photographer()
    jm = JModel(sculptor=None, sculptor_params={}, fuser=None, fuser_params={},
                photographer=jph, photographer_params=params, camera_dist=toracle.CAMERA_DIST)
    jm.input_size = SIZE
    return jax_row(jm, jtesting.EllipsoidOracleModel(input_size=SIZE,
                                                      camera_dist=toracle.CAMERA_DIST, axes=AXES),
                   jnp.asarray(z_obj), row_camera(), coarse_kw, SHRUNKEN_FINE,
                   jax.random.PRNGKey(ROW_SEED + 1))


def row_camera():
    return jtesting.make_camera(1, z=toracle.CAMERA_DIST, f=615.0, width=640, height=480,
                                quats=jquat.random(jax.random.PRNGKey(ROW_SEED), 1))


def write_jax_rows() -> None:
    JAX_ROWS.write_text(json.dumps({
        "about": "tests/test_torch_experiments.py's tiny-width evaluation row as the JAX "
                 "package computes it (CPU, fp32): jax_tiny_row(). python "
                 "tests/test_torch_experiments.py --write rewrites it; -m slow recomputes it.",
        "tiny": jax_tiny_row()}, indent=1) + "\n")


def port_row(tm, z_obj, size, coarse_kw, fine_kw, seed) -> dict:
    """The port's ``evaluate_target`` at ``row_camera()``, its CEM given
    JAX's draws from ``PRNGKey(seed + 1)``."""
    from latentfusion_tpu_torch.pose import estimation as test

    oracle = ttesting.EllipsoidOracleModel(input_size=size, camera_dist=toracle.CAMERA_DIST,
                                           axes=AXES, device="cpu")
    coarse = test.CrossEntropyPoseEstimator(model=tm, num_gmm_components=6, sample_flipped=True,
                                            **coarse_kw)
    fine = test.GradientPoseEstimator(model=tm, **fine_kw)
    return toracle.evaluate_target(coarse, fine, torch.as_tensor(np.array(z_obj)), oracle,
                                   port_camera(row_camera()), toracle.surface_points("cpu"),
                                   None, draws=JaxCemDraws(jax.random.PRNGKey(seed + 1), 6))


def assert_rows_match(ours, theirs) -> None:
    """Metrics within 2e-4 (geometry), losses within 5e-4, the same outcome."""
    for part in ("coarse", "refined"):
        for k, v in theirs[part].items():
            assert abs(ours[part][k] - v) <= GEOM_TOL * max(1.0, abs(v)), (part, k,
                                                                            ours[part][k], v)
    for k in ("loss_at_gt", "loss_refined"):
        assert abs(ours[k] - theirs[k]) <= NET_TOL * theirs[k], (k, ours[k], theirs[k])
    assert ours["add_s_01d"] == theirs["add_s_01d"]


def tiny_port_row() -> dict:
    params, z_obj, coarse_kw = tiny_row_setup()
    ph = tzoo.tiny_photographer(device="cpu")
    ph.load_state_dict({k[len("photographer."):]: torch.from_numpy(np.array(v))
                        for k, v in keyed({"photographer": params}).items()})
    tm = toracle.decoder_model(ph, "cpu")
    tm.input_size = SIZE
    return port_row(tm, z_obj, SIZE, coarse_kw, SHRUNKEN_FINE, ROW_SEED)


def test_evaluation_row_matches_jax_at_tiny_width():
    """The tiny photographer (N(0, 1) weights, a random latent) rendering
    16², CEM 8 x 2 under ``slow``'s semantics with JAX's draws, refinement
    2 x 2: the port's row against JAX's (``tests/oracle_distill_rows.json``;
    ``-m slow`` recomputes it)."""
    assert_rows_match(tiny_port_row(), json.loads(JAX_ROWS.read_text())["tiny"])


@pytest.mark.slow
def test_jax_rows_are_jax():
    theirs = jax_tiny_row()
    committed = json.loads(JAX_ROWS.read_text())["tiny"]
    assert committed["add_s_01d"] == theirs["add_s_01d"]
    for part in ("coarse", "refined"):
        np.testing.assert_allclose([committed[part][k] for k in theirs[part]],
                                   list(theirs[part].values()), rtol=1e-5, atol=1e-6)
    assert_rows_match(tiny_port_row(), theirs)


@pytest.mark.slow
def test_evaluation_row_matches_jax_on_the_checkpoint(jax_distilled, port_distilled):
    """A target of the committed checkpoint under ``slow``, CEM 16 x 2 and
    refinement 2 x 2, against JAX on the same draws."""
    tool, photographer, params = jax_distilled
    jm = jax_decoder_model(jax_distilled)
    args = toracle.get_args(["--out", "x", "--coarse-config", "slow", "--coarse-samples", "16",
                             "--coarse-iters", "2"])
    coarse_kw = toracle.coarse_kwargs(args)
    theirs = jax_row(jm, jtesting.EllipsoidOracleModel(input_size=128,
                                                        camera_dist=toracle.CAMERA_DIST,
                                                        axes=AXES),
                     params["z_obj"], row_camera(), coarse_kw, SHRUNKEN_FINE,
                     jax.random.PRNGKey(ROW_SEED + 1))
    ours = port_row(toracle.decoder_model(port_distilled[0], "cpu"), np.asarray(params["z_obj"]),
                    128, coarse_kw, SHRUNKEN_FINE, ROW_SEED)
    assert_rows_match(ours, theirs)


if __name__ == "__main__":
    if sys.argv[1:] == ["--write"]:
        write_camera_draws()
        write_jax_rows()
    else:
        print("python tests/test_torch_experiments.py --write  # rewrite experiment_cameras.json")
