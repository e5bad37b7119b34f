"""The port's image-based rendering (``ibr.py``) and the reconstruction API
(``LatentFusionModel.render_full``, ``render_ibr_basic``, ``render_ibr``,
the IBR generator's loading) held against the JAX package on the CPU, on
the same seeded numpy inputs and weights.

Tolerances: 2e-4 (the JAX suite's geometry tolerance) for warp fields and
reprojections, relative to the largest value; 5e-4 for networks, relative
to the largest value of each output. The warp fields here reach past the
source viewports, so border pixels sample zero padding.

Phase 10 of ``chip_smoke.py`` reads ``latentfusion_tpu_torch/recon_cameras.json``:
cameras drawn with numpy from ``RECON_SEED`` and the JAX package's fp32
results at them. ``test_recon_cameras_are_the_numpy_draws`` (tier-1) holds
the cameras to the draws; the slow test recomputes the JAX results, and
``python tests/test_torch_ibr.py --write`` rewrites the file.
"""
import json
import math
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from latentfusion_tpu import ibr as jibr  # noqa: E402
from latentfusion_tpu import testing as jtesting  # noqa: E402
from latentfusion_tpu import zoo as jzoo  # noqa: E402
from latentfusion_tpu.camera import Camera as JCamera  # noqa: E402
from latentfusion_tpu.modules.unet import UNet2d as JUNet2d  # noqa: E402
from latentfusion_tpu.observation import Observation as JObservation  # noqa: E402
from latentfusion_tpu.recon import checkpoint as jckpt  # noqa: E402
from latentfusion_tpu.recon.inference import LatentFusionModel as JModel  # noqa: E402

from latentfusion_tpu_torch import ibr as tibr  # noqa: E402
from latentfusion_tpu_torch import zoo as tzoo  # noqa: E402
from latentfusion_tpu_torch.camera import Camera as TCamera  # noqa: E402
from latentfusion_tpu_torch.modules.unet import UNet2d as TUNet2d  # noqa: E402
from latentfusion_tpu_torch.observation import Observation as TObservation  # noqa: E402
from latentfusion_tpu_torch.recon.checkpoint import from_jax_params, split_state_dict  # noqa: E402
from latentfusion_tpu_torch.recon.inference import LatentFusionModel as TModel  # noqa: E402
from latentfusion_tpu_torch.three import host  # noqa: E402

GEOM_TOL = 2e-4
NET_TOL = 5e-4
H, W = 48, 64
ROOT = Path(__file__).resolve().parents[1]
DISTILL = ROOT / "artifacts" / "encoder_distill"
RECON_CAMERAS = ROOT / "latentfusion_tpu_torch" / "recon_cameras.json"
RECON_SEED = 20261017
RECON_REFS, RECON_TARGETS = 16, 8
ORACLE_AXES = (0.21, 0.36, 0.5)  # tools/train_encoder_distill.py's ellipsoid
F, WIDTH, HEIGHT = 615.0, 640, 480


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(x):
    return torch.from_numpy(np.array(x))


def close_rel(a, b, tol):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(float(np.abs(b).max()), 1.0)
    np.testing.assert_allclose(a / scale, b / scale, atol=tol, rtol=0)


def to_state(params):
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return from_jax_params({jax.tree_util.keystr(p): np.asarray(v) for p, v in leaves})


def draw_extrinsics(rng, n, dist, jitter):
    q = rng.randn(n, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    trans = (np.array([0.0, 0.0, dist], np.float32)
             + (rng.randn(n, 3) * np.asarray(jitter)).astype(np.float32))
    return host.to_extrinsic_matrix(trans, q)


def both_cameras(ext, K=None, viewport=None, width=W, height=H):
    if K is None:
        K = np.tile(np.array([[64.0, 0, width / 2], [0, 64.0, height / 2], [0, 0, 1]],
                             np.float32), (len(ext), 1, 1))
    return (JCamera(K, ext, viewport=viewport, width=width, height=height),
            TCamera(K, ext, viewport=viewport, width=width, height=height, device="cpu"))


def t_camera(jc: JCamera) -> TCamera:
    """The port's camera with the JAX camera's leaves."""
    return TCamera(t(jc.intrinsic), None, jc.z_span, t(jc.viewport), width=jc.width,
                   height=jc.height, log_quaternion=t(jc.log_quaternion),
                   translation=t(jc.translation), device="cpu")


def zoomed_pair(rng, n, size=16, dist=1.5, jitter=(0.05, 0.05, 0.1)):
    """Zoomed cameras, the port's with the leaves of JAX's (jitted) zoom."""
    jc, _ = both_cameras(draw_extrinsics(rng, n, dist, jitter))
    jz = jax.jit(lambda c: c.zoom(None, size, dist))(jc)
    return jz, t_camera(jz)


# -------------------------------------------------------------------- ibr
def test_warp_field_and_reprojection(rng):
    """Views a few tenths of a radian apart: part of each warp field falls
    outside the source viewport (zero padding at the border)."""
    jin, tin = zoomed_pair(rng, 3)
    jout, tout = zoomed_pair(rng, 2)
    depth_in = np.tanh(rng.randn(3, 1, 16, 16)).astype(np.float32)
    depth_out = np.tanh(rng.randn(2, 1, 16, 16)).astype(np.float32)
    image = rng.rand(3, 3, 16, 16).astype(np.float32)
    grid_j = jax.jit(jibr.depth_to_warp_field)(jin, jout, jnp.asarray(depth_out))
    grid_t = tibr.depth_to_warp_field(tin, tout, t(depth_out))
    close_rel(grid_t, grid_j, GEOM_TOL)
    assert float(grid_t.abs().max()) > 1.0
    got = tibr.reproject_views(t(image), t(depth_in), t(depth_out), tin, tout)
    want = jax.jit(jibr.reproject_views)(jnp.asarray(image), jnp.asarray(depth_in),
                                         jnp.asarray(depth_out), jin, jout)
    for g, w in zip(got, want):
        close_rel(g, w, GEOM_TOL)
    border = (grid_t.abs() > 1.0).any(-1)
    assert bool(border.any()) and bool((~border).any())


def test_reproject_views_batch(rng):
    jin, tin = zoomed_pair(rng, 6)
    jout, tout = zoomed_pair(rng, 4)
    image = rng.rand(2, 3, 3, 16, 16).astype(np.float32)
    depth_in = np.tanh(rng.randn(2, 3, 1, 16, 16)).astype(np.float32)
    depth_out = np.tanh(rng.randn(2, 2, 1, 16, 16)).astype(np.float32)
    got = tibr.reproject_views_batch(t(image), t(depth_in), t(depth_out), tin, tout)
    want = jax.jit(jibr.reproject_views_batch)(jnp.asarray(image), jnp.asarray(depth_in),
                                               jnp.asarray(depth_out), jin, jout)
    for g, w in zip(got, want):
        close_rel(g, w, GEOM_TOL)


@pytest.mark.parametrize("weight_type", ["cam_dist", "cam_angle", "cam_hybrid", "depth"])
@pytest.mark.parametrize("eps", [1e-2, 1e-4])
def test_render_ibr_weight_types(rng, weight_type, eps):
    jin, tin = zoomed_pair(rng, 4)
    jout, tout = zoomed_pair(rng, 2)
    image = rng.rand(2, 2, 3, 16, 16).astype(np.float32)
    depth_in = np.tanh(rng.randn(2, 2, 1, 16, 16)).astype(np.float32)
    depth_out = np.tanh(rng.randn(2, 1, 1, 16, 16)).astype(np.float32)
    got = tibr.render_ibr(tin, tout, t(image), t(depth_in), t(depth_out), 0.5,
                          weight_type, eps)
    want = jax.jit(lambda *a: jibr.render_ibr(*a, 0.5, weight_type, eps))(
        jin, jout, jnp.asarray(image), jnp.asarray(depth_in), jnp.asarray(depth_out))
    for g, w in zip(got, want):
        close_rel(g, w, GEOM_TOL)
    with pytest.raises(ValueError):
        tibr.render_ibr(tin, tout, t(image), t(depth_in), t(depth_out), 0.5, "other")


def test_blend_and_warp_blend_logits(rng):
    """Flows of up to 5 pixels at a 16-pixel frame: the base grid's edge
    rows and columns clip to [-1, 1] and sample the border."""
    reproj = rng.rand(2, 3, 3, 16, 16).astype(np.float32)
    blend = rng.randn(2, 3, 16, 16).astype(np.float32)
    for g, w in zip(tibr.blend_logits(t(blend), t(reproj)),
                    jibr.blend_logits(jnp.asarray(blend), jnp.asarray(reproj))):
        close_rel(g, w, 1e-6)
    logits = (3 * rng.randn(2, 9, 16, 16)).astype(np.float32)
    got = tibr.warp_blend_logits(t(logits), t(reproj), 5)
    want = jibr.warp_blend_logits(jnp.asarray(logits), jnp.asarray(reproj), 5)
    for g, w in zip(got, want):
        close_rel(g, w, GEOM_TOL)
    # The edge pixels, where the clipped grid meets the border.
    edge = np.zeros((16, 16), bool)
    edge[[0, -1]] = edge[:, [0, -1]] = True
    close_rel(got[0].numpy()[..., edge], np.asarray(want[0])[..., edge], GEOM_TOL)


# -------------------------------------------------------- the tiny family
@pytest.fixture(scope="module")
def tiny():
    """The tiny family on both sides with JAX's random weights, an IBR
    generator (a tiny UNet2d, 1 + 5 V_i inputs, 3 V_i outputs) whose JAX
    parameters go through the weight-carrying function, a latent, 3
    full-frame reference views and 2 target cameras."""
    rng = np.random.RandomState(3)
    sc, fu, ph = jzoo.tiny_sculptor(), jzoo.tiny_fuser(), jzoo.tiny_photographer()
    params = jzoo.init_recon_params(jax.random.PRNGKey(0), sc, fu, ph, batch=1, views=2)
    views = 3
    gen_j = JUNet2d(1 + 5 * views, (views,) * 3, ((8, "D", 8), (8, "U", 8)))
    gen_params = jax.jit(gen_j.init)(jax.random.PRNGKey(1),
                                     jnp.zeros((1, 1 + 5 * views, 16, 16)))
    jm = JModel(sc, params["sculptor"], fu, params["fuser"], ph, params["photographer"],
                camera_dist=1.5, generator=gen_j, generator_params=gen_params)
    state = split_state_dict(to_state({"sculptor": params["sculptor"],
                                       "fuser": params["fuser"],
                                       "photographer": params["photographer"],
                                       "generator": gen_params}))
    gen_t = TUNet2d(1 + 5 * views, (views,) * 3, ((8, "D", 8), (8, "U", 8)))
    tm = TModel(tzoo.tiny_sculptor(device="cpu"), state["sculptor"],
                tzoo.tiny_fuser(device="cpu"), state["fuser"],
                tzoo.tiny_photographer(device="cpu"), state["photographer"],
                camera_dist=1.5, device="cpu", generator=gen_t,
                generator_state=state["generator"])
    jref, tref = both_cameras(draw_extrinsics(rng, views, 1.5, (0.03, 0.03, 0.05)))
    mask = np.zeros((views, 1, H, W), np.float32)
    mask[:, :, 12:36, 20:44] = 1.0
    arrays = (rng.rand(views, 3, H, W).astype(np.float32),
              (1.5 + 0.1 * rng.rand(views, 1, H, W)).astype(np.float32), mask)
    z = (0.5 * rng.randn(1, 1, 4, 8, 8, 8)).astype(np.float32)
    jout, tout = both_cameras(draw_extrinsics(rng, 2, 1.5, (0.03, 0.03, 0.05)))
    return dict(jm=jm, tm=tm, jobs=JObservation(*arrays, jref),
                tobs=TObservation(*arrays, tref), jz=jnp.asarray(z), tz=t(z),
                jout=jout, tout=tout)


def test_render_full_matches_jax(tiny):
    got = tiny["tm"].render_full(tiny["tz"], tiny["tout"])
    want = jax.jit(lambda z: tiny["jm"].render_full(z, tiny["jout"]))(tiny["jz"])
    assert set(got) == set(want) == {"depth", "mask"}
    for k in want:
        assert got[k].shape == (2, 1, H, W)
        close_rel(got[k], want[k], NET_TOL)


def _jax_render_full_color(jm, z, obs, cam):
    """What ``render_full(..., input_obs=obs)`` computes, from the JAX
    package's own functions: its second squeeze of the color fails for any
    number of cameras (ROADMAP Queue 3), so the color of ``render_ibr_basic``
    is uncropped here as the original does for more than one camera."""
    cam_zoom = cam.zoom(None, jm.input_size, jm.camera_dist)
    y, _ = jm.render_ibr_basic(z, obs, cam_zoom, apply_mask=True, return_latent=False)
    return cam_zoom.uncrop(y["color"] / 2 + 0.5)[0]


def test_render_full_with_input_obs_matches_jax(tiny):
    """Two targets against JAX; one target (whose color the port takes as
    (1, 3, h, w) too) against the port's own two-target render. JAX's
    ``render_full(..., input_obs)`` itself raises for both counts."""
    jm, tm = tiny["jm"], tiny["tm"]
    got = tm.render_full(tiny["tz"], tiny["tout"], input_obs=tiny["tobs"])
    want = jax.jit(lambda z: jm.render_full(z, tiny["jout"]))(tiny["jz"])
    for k in ("depth", "mask"):
        close_rel(got[k], want[k], NET_TOL)
    color = jax.jit(lambda z: _jax_render_full_color(jm, z, tiny["jobs"], tiny["jout"]))(
        tiny["jz"])
    assert got["color"].shape == (2, 3, H, W)
    close_rel(got["color"], color, NET_TOL)
    one = tm.render_full(tiny["tz"], tiny["tout"][:1], input_obs=tiny["tobs"])
    for k in ("depth", "mask", "color"):
        close_rel(one[k], got[k][:1], 1e-6)
    for n_out in (1, 2):
        with pytest.raises((ValueError, TypeError)):
            jax.jit(lambda z: jm.render_full(z, tiny["jout"][:n_out],
                                             input_obs=tiny["jobs"]))(tiny["jz"])


def test_render_ibr_basic_matches_jax(tiny):
    jzoom = tiny["jout"].zoom(None, 16, 1.5)
    tzoom = tiny["tout"].zoom(None, 16, 1.5)
    y_t, z_t = tiny["tm"].render_ibr_basic(tiny["tz"], tiny["tobs"], tzoom)
    y_j, z_j = jax.jit(lambda z: tiny["jm"].render_ibr_basic(z, tiny["jobs"], jzoom))(
        tiny["jz"])
    assert set(y_t) == set(y_j)
    for k in y_j:
        close_rel(y_t[k], y_j[k], NET_TOL)
    close_rel(z_t, z_j, NET_TOL)
    assert tuple(y_t["color"].shape) == (2, 3, 16, 16)


@pytest.mark.parametrize("n_out", [1, 2])
def test_render_ibr_with_generator_matches_jax(tiny, n_out):
    jzoom = tiny["jout"][:n_out].zoom(None, 16, 1.5)
    tzoom = tiny["tout"][:n_out].zoom(None, 16, 1.5)
    y_t, z_t = tiny["tm"].render_ibr(tiny["tz"], tiny["tobs"], tzoom)
    y_j, z_j = jax.jit(lambda z: tiny["jm"].render_ibr(z, tiny["jobs"], jzoom))(tiny["jz"])
    assert set(y_t) == set(y_j)
    for k in y_j:
        assert tuple(y_t[k].shape) == tuple(y_j[k].shape), k
        close_rel(y_t[k], y_j[k], NET_TOL)
    close_rel(z_t, z_j, NET_TOL)


def test_render_latent_ibr_functions_match_jax(tiny):
    jin, tin = tiny["jobs"].camera.zoom(None, 16, 1.5), tiny["tobs"].camera.zoom(None, 16, 1.5)
    jout, tout = tiny["jout"].zoom(None, 16, 1.5), tiny["tout"].zoom(None, 16, 1.5)
    image = np.random.RandomState(5).rand(1, 3, 3, 16, 16).astype(np.float32)
    ph_j, ph_t = tiny["jm"].photographer, tiny["tm"].photographer
    params = tiny["jm"].photographer_params
    with torch.no_grad():
        got = tibr.render_latent_ibr(ph_t, tiny["tz"], tin, tout, t(image))
    want = jax.jit(lambda z: jibr.render_latent_ibr(ph_j, params, z, jin, jout,
                                                    jnp.asarray(image)))(tiny["jz"])
    for g, w in zip(got, want):
        close_rel(g, w, NET_TOL)
    for apply_mask in (False, True):
        with torch.no_grad():
            y_t, z_t = tibr.render_latent_ibr2(ph_t, tiny["tz"], tin, tout, t(image),
                                               apply_mask=apply_mask)
        y_j, z_j = jax.jit(lambda z: jibr.render_latent_ibr2(
            ph_j, params, z, jin, jout, jnp.asarray(image), apply_mask=apply_mask))(tiny["jz"])
        for k in y_j:
            close_rel(y_t[k], y_j[k], NET_TOL)
        close_rel(z_t, z_j, NET_TOL)


def test_from_checkpoint_loads_the_generator(tiny, tmp_path):
    """A reference-format checkpoint with a ``generator`` module: the port
    builds the UNet2d from its args and loads its state dict."""
    jm = tiny["jm"]

    def module_ckpt(module, params):
        return {"args": module.checkpoint_args(),
                "state_dict": {k: torch.from_numpy(np.array(v)) for k, v in
                               jckpt.export_torch_state_dict(params).items()}}

    payload = {
        "name": "tiny-ibr", "epoch": 0,
        "args": {"camera_dist": 1.5, "no_discriminator": True},
        "modules": {
            "sculptor": module_ckpt(jm.sculptor, jm.sculptor_params),
            "photographer": module_ckpt(jm.photographer, jm.photographer_params),
            "fuser": {"type": "GRUFuser", "args": {"in_channels": 4, "cube_size": 1.0},
                      "state_dict": {k: torch.from_numpy(np.array(v)) for k, v in
                                     jckpt.export_torch_state_dict(jm.fuser_params).items()}},
            "generator": {"args": {"in_channels": 16, "out_channels": [3, 3, 3],
                                   "block_config": [[8, "D", 8], [8, "U", 8]],
                                   "conv_module": "EqualizedConv2d"},
                          "state_dict": {k: torch.from_numpy(np.array(v)) for k, v in
                                         jckpt.export_torch_state_dict(
                                             jm.generator_params).items()}},
        },
    }
    path = tmp_path / "model.pth"
    torch.save(payload, path)
    loaded = TModel.from_checkpoint(path, device="cpu")
    assert isinstance(loaded.generator, TUNet2d)
    for k, v in tiny["tm"].generator.state_dict().items():
        assert torch.equal(loaded.generator.state_dict()[k], v), k
    tzoom = tiny["tout"].zoom(None, 16, 1.5)
    y_a, _ = loaded.render_ibr(tiny["tz"], tiny["tobs"], tzoom)
    y_b, _ = tiny["tm"].render_ibr(tiny["tz"], tiny["tobs"], tzoom)
    assert torch.equal(y_a["color"], y_b["color"])
    del payload["modules"]["generator"]
    torch.save(payload, path)
    assert TModel.from_checkpoint(path, device="cpu").generator is None
    with pytest.raises(ValueError, match="generator"):
        TModel.from_checkpoint(path, device="cpu").render_ibr(tiny["tz"], tiny["tobs"], tzoom)


# ------------------------------------------------- chip_smoke.py phase 10
def recon_camera_draws(seed: int = RECON_SEED):
    """Phase 10's cameras: 16 reference and 8 target extrinsics drawn with
    numpy, normalised N(0, 1) quaternions (uniform rotations) at the demo
    family's distance with N(0, (0.1, 0.1, 0.25)) jitter for the references
    and N(0, (0.05, 0.05, 0.1)) for the targets."""
    rng = np.random.RandomState(seed)
    refs = draw_extrinsics(rng, RECON_REFS, jzoo.DEMO_CAMERA_DIST, (0.1, 0.1, 0.25))
    targets = draw_extrinsics(rng, RECON_TARGETS, jzoo.DEMO_CAMERA_DIST, (0.05, 0.05, 0.1))
    return refs, targets


def recon_intrinsic():
    return np.array([[F, 0.0, WIDTH / 2], [0.0, F, HEIGHT / 2], [0.0, 0.0, 1.0]], np.float32)


def test_recon_cameras_are_the_numpy_draws():
    rec = json.loads(RECON_CAMERAS.read_text())
    refs, targets = recon_camera_draws(rec["seed"])
    assert rec["seed"] == RECON_SEED
    assert np.array_equal(np.asarray(rec["reference"]["extrinsic"], np.float32), refs)
    assert np.array_equal(np.asarray(rec["targets"]["extrinsic"], np.float32), targets)
    assert np.array_equal(np.asarray(rec["intrinsic"], np.float32), recon_intrinsic())
    assert rec["oracle_axes"] == list(ORACLE_AXES)
    assert len(rec["jax_float32"]) == RECON_TARGETS


def jax_recon_record() -> dict:
    """The JAX package's fp32 results on phase 10's inputs: the 16 shaded
    oracle views saved and loaded back (PNG quantisation), the latent of
    the loaded views with the learned demo weights, then per target the
    sums of ``render_full``'s depth, mask and, from ``render_ibr_basic``,
    color (its sum and its sum of magnitudes), the full-frame color of
    ``render_full(..., input_obs)`` (composed as
    ``_jax_render_full_color``), and the mask IoU and mean depth error
    inside both masks against the oracle's truth."""
    sc, fu, ph = jzoo.demo_sculptor(), jzoo.demo_fuser(), jzoo.demo_photographer()
    template = jax.eval_shape(
        lambda k: jzoo.init_recon_params(k, sc, fu, ph, batch=1, views=2),
        jax.random.PRNGKey(0))
    params = jzoo.load_params_npz(DISTILL / "encoder_distill.npz", template)
    jm = JModel(sc, params["sculptor"], fu, params["fuser"], ph, params["photographer"],
                camera_dist=jzoo.DEMO_CAMERA_DIST)
    refs, targets = recon_camera_draws()
    K = recon_intrinsic()
    ref_cams = JCamera(np.tile(K, (RECON_REFS, 1, 1)), refs, z_span=0.5,
                       width=WIDTH, height=HEIGHT)
    tar_cams = JCamera(np.tile(K, (RECON_TARGETS, 1, 1)), targets, z_span=0.5,
                       width=WIDTH, height=HEIGHT)
    oracle = jtesting.EllipsoidOracleModel(jzoo.DEMO_INPUT_SIZE, jzoo.DEMO_CAMERA_DIST,
                                           ORACLE_AXES)
    ref_obs = jax.jit(lambda c: oracle.make_observation(c, shaded=True))(ref_cams)
    truth = jax.jit(oracle.make_observation)(tar_cams)
    with tempfile.TemporaryDirectory() as d:
        ref_obs.save(d)
        loaded = JObservation.load(d)
    z = jm.build_latent_object(loaded)
    out = jm.render_full(z, tar_cams)
    cam_zoom = tar_cams.zoom(None, jm.input_size, jm.camera_dist)
    y_ibr, _ = jm.render_ibr_basic(z, loaded, cam_zoom, apply_mask=True, return_latent=False)
    color_full = _jax_render_full_color(jm, z, loaded, tar_cams)
    rows = []
    for i in range(RECON_TARGETS):
        pred = np.asarray(out["mask"][i, 0]) > 0.5
        true = np.asarray(truth.mask[i, 0]) > 0.5
        both = pred & true
        depth = np.asarray(out["depth"][i, 0], np.float64)
        ibr = np.asarray(y_ibr["color"][i], np.float64)
        rows.append({
            "depth": float(depth.sum()),
            "mask": float(np.asarray(out["mask"][i], np.float64).sum()),
            "color_ibr_basic": float(ibr.sum()),
            "color_ibr_basic_abs": float(np.abs(ibr).sum()),
            "color_full": float(np.asarray(color_full[i], np.float64).sum()),
            "iou": float(both.sum() / max((pred | true).sum(), 1)),
            "depth_err": float(np.abs(depth - np.asarray(truth.depth[i, 0]))[both].mean()),
        })
    return {
        "about": ("chip_smoke.py phase 10 (the reconstruction API): cameras of 16 shaded "
                  "reference views and 8 targets of the ellipsoid oracle (semi-axes "
                  "oracle_axes), 640x480 at f = 615, drawn with numpy from seed by "
                  "tests/test_torch_ibr.py::recon_camera_draws; jax_float32: per target, "
                  "the JAX package's fp32 CPU results with the learned demo weights of "
                  "artifacts/encoder_distill/encoder_distill.npz, from the reference views "
                  "saved and loaded back: sums of render_full's depth and mask, of "
                  "render_ibr_basic's color (and of its magnitudes) and of render_full's "
                  "full-frame IBR color, and the mask IoU and mean depth error inside both "
                  "masks against the oracle's truth. tests/test_torch_ibr.py recomputes "
                  "every entry."),
        "seed": RECON_SEED, "oracle_axes": list(ORACLE_AXES),
        "intrinsic": K.tolist(),
        "reference": {"extrinsic": refs.tolist()},
        "targets": {"extrinsic": targets.tolist()},
        "jax_float32": rows,
    }


@pytest.mark.slow
def test_recon_record_recomputed_from_jax():
    """Every JAX entry of recon_cameras.json recomputed: the sums within
    1e-6 relative (the same fp32 program on another CPU), IoU and depth
    error within 1e-6."""
    rec = json.loads(RECON_CAMERAS.read_text())
    fresh = jax_recon_record()
    for key in ("seed", "oracle_axes", "intrinsic", "reference", "targets"):
        assert fresh[key] == rec[key], key
    for got, want in zip(fresh["jax_float32"], rec["jax_float32"]):
        for k, v in want.items():
            assert math.isclose(got[k], v, rel_tol=1e-6, abs_tol=1e-6), (k, got[k], v)


@pytest.mark.slow
def test_recon_phase_on_the_port_matches_the_record():
    """chip_smoke.py phase 10's pipeline on the port on the CPU (its own
    helpers: the port's oracle views through save + load, the learned demo
    weights): the per-target sums against the JAX record within phase 10's
    tolerances (depth and color 1e-3 relative, the basic IBR color to its
    sum of magnitudes, mask 0.1 % of the frame's pixels). Prints the
    spread."""
    import chip_smoke

    from latentfusion_tpu_torch.recon.checkpoint import load_params_npz

    state = split_state_dict(from_jax_params(load_params_npz(
        DISTILL / "encoder_distill.npz", DISTILL / "encoder_distill_keys.json")))
    tm = TModel(tzoo.demo_sculptor(device="cpu"), state["sculptor"],
                tzoo.demo_fuser(device="cpu"), state["fuser"],
                tzoo.demo_photographer(device="cpu"), state["photographer"],
                camera_dist=tzoo.DEMO_CAMERA_DIST, device="cpu")
    rec, refs, targets, truth = chip_smoke.recon_inputs(torch.device("cpu"))
    loaded = chip_smoke.png_round_trip(refs)
    z = tm.build_latent_object(loaded)
    zoom = targets.zoom(None, tm.input_size, tm.camera_dist)
    basic, _ = tm.render_ibr_basic(z, loaded, zoom, return_latent=False)
    out = {"full": tm.render_full(z, targets), "basic": basic,
           "full_ibr": tm.render_full(z, targets, input_obs=loaded)}
    spread = {}
    for got, want in zip(chip_smoke.recon_sums(out, truth), rec["jax_float32"]):
        for k, scale in (("depth", abs(want["depth"])), ("mask", WIDTH * HEIGHT),
                         ("color_ibr_basic", want["color_ibr_basic_abs"]),
                         ("color_full", abs(want["color_full"]))):
            spread[k] = max(spread.get(k, 0.0), abs(got[k] - want[k]) / scale)
    print(f"port (CPU) against the JAX record: {json.dumps(spread)}")
    assert max(spread.values()) <= chip_smoke.SUMS_TOL


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_ibr.py --write")
    jax.config.update("jax_platforms", "cpu")
    RECON_CAMERAS.write_text(json.dumps(jax_recon_record()) + "\n")
    print(f"wrote {RECON_CAMERAS}")
