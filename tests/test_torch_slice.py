"""The port's build + render slice held against the JAX package end to end:
preprocess the reference views, build the latent object (Sculptor encode,
GRU fold), render it from 8 hypothesis cameras (CPU, fp32).

Tolerance: 5e-4 for networks, relative to the largest magnitude of each
output (the latent's entries reach about 20 with the learned weights).
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentfusion_tpu import three as jthree
from latentfusion_tpu import zoo as jzoo
from latentfusion_tpu.camera import Camera as JCamera
from latentfusion_tpu.observation import Observation as JObservation
from latentfusion_tpu.recon.checkpoint import export_torch_state_dict
from latentfusion_tpu.recon.inference import LatentFusionModel as JModel

from latentfusion_tpu_torch import zoo as tzoo
from latentfusion_tpu_torch.camera import Camera as TCamera
from latentfusion_tpu_torch.observation import Observation as TObservation
from latentfusion_tpu_torch.recon.checkpoint import (from_jax_params,
                                                     load_params_npz,
                                                     split_state_dict)
from latentfusion_tpu_torch.recon.inference import LatentFusionModel as TModel

NET_TOL = 5e-4
ROOT = Path(__file__).resolve().parents[1]
DISTILL = ROOT / "artifacts" / "encoder_distill"
REFS_O0 = ROOT / "artifacts" / "serving" / "frames" / "refs_o0.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def to_state(params):
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return from_jax_params({jax.tree_util.keystr(p): np.asarray(v)
                            for p, v in leaves})


def close_rel(a, b, tol=NET_TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    scale = max(float(np.abs(b).max()), 1.0)
    np.testing.assert_allclose(a / scale, b / scale, atol=tol)


def random_extrinsics(rng, n, dist, jitter=0.0):
    q = rng.randn(n, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = np.tile(np.array([[0.0, 0.0, dist]], np.float32), (n, 1))
    t += (jitter * rng.randn(n, 3)).astype(np.float32)
    return np.array(jthree.to_extrinsic_matrix(jnp.asarray(t), jnp.asarray(q)))


def run_both(jm, tm, views, n_cams, rng):
    """Build from ``views`` and render ``n_cams`` cameras on both sides."""
    h, w = views["color"].shape[-2:]
    args = (views["color"], views["depth"], views["mask"])
    jobs = JObservation(*args, JCamera(views["intrinsic"], views["extrinsic"],
                                       width=w, height=h))
    tobs = TObservation(*args, TCamera(views["intrinsic"], views["extrinsic"],
                                       width=w, height=h, device="cpu"))
    z_j = np.asarray(jm.build_latent_object(jobs))
    z_t = tm.build_latent_object(tobs)
    close_rel(z_t.numpy(), z_j)

    ext = random_extrinsics(rng, n_cams, jm.camera_dist)
    K = np.repeat(views["intrinsic"][:1], n_cams, axis=0)
    jcam = JCamera(K, ext, width=w, height=h).zoom(None, jm.input_size,
                                                   jm.camera_dist)
    tcam = TCamera(K, ext, width=w, height=h, device="cpu").zoom(
        None, tm.input_size, tm.camera_dist)
    # Both sides render the JAX latent, so the comparison isolates decode.
    y_j, lat_j = jm.render_latent_object(jnp.asarray(z_j), jcam)
    y_t, lat_t = tm.render_latent_object(torch.from_numpy(z_j), tcam)
    for key in ("depth", "mask"):
        close_rel(y_t[key].numpy(), y_j[key])
    close_rel(lat_t.numpy(), lat_j)
    return y_t


def tiny_views(rng, n=4, h=48, w=64):
    K = np.tile(np.array([[64, 0, w / 2], [0, 64, h / 2], [0, 0, 1]],
                         np.float32)[None], (n, 1, 1))
    # Reference views off the exact center, as real ones are: with the
    # object centred to the last bit, crop corners land within an ulp of an
    # integer, and the JAX package's jitted and eager builds then truncate
    # them differently (ROADMAP Queue 3).
    ext = random_extrinsics(rng, n, 1.5, jitter=0.03)
    mask = np.zeros((n, 1, h, w), np.float32)
    mask[:, :, 12:36, 20:44] = 1.0
    return {"color": rng.rand(n, 3, h, w).astype(np.float32),
            "depth": (1.5 + 0.1 * rng.rand(n, 1, h, w)).astype(np.float32),
            "mask": mask, "intrinsic": K, "extrinsic": ext}


@pytest.fixture(scope="module")
def tiny_pair():
    sc, fu, ph = jzoo.tiny_sculptor(), jzoo.tiny_fuser(), jzoo.tiny_photographer()
    params = jzoo.init_recon_params(jax.random.PRNGKey(0), sc, fu, ph,
                                    batch=1, views=2)
    jm = JModel(sc, params["sculptor"], fu, params["fuser"], ph,
                params["photographer"], camera_dist=1.5)
    tm = TModel(tzoo.tiny_sculptor(device="cpu"), to_state(params["sculptor"]),
                tzoo.tiny_fuser(device="cpu"), to_state(params["fuser"]),
                tzoo.tiny_photographer(device="cpu"),
                to_state(params["photographer"]), camera_dist=1.5, device="cpu")
    return jm, tm, params


def test_tiny_slice_matches_jax(rng, tiny_pair):
    jm, tm, _ = tiny_pair
    y = run_both(jm, tm, tiny_views(rng), 8, rng)
    assert y["depth"].shape == (1, 8, 1, 16, 16)


def test_centred_views_match_eager_jax(rng, tiny_pair):
    """Reference views centred to the last bit put crop corners within an
    ulp of an integer. There the port agrees with the JAX package run
    eagerly (truncating the corner the same way); the jitted JAX build may
    crop one pixel off (ROADMAP Queue 3)."""
    from latentfusion_tpu.recon import models as jmodels

    jm, tm, params = tiny_pair
    views = tiny_views(rng)
    views["extrinsic"][:, :3, 3] = (0.0, 0.0, 1.5)
    h, w = views["color"].shape[-2:]
    args = (views["color"], views["depth"], views["mask"])
    jobs = jm.preprocess_observation(JObservation(
        *args, JCamera(views["intrinsic"], views["extrinsic"], width=w, height=h)))
    tobs = tm.preprocess_observation(TObservation(
        *args, TCamera(views["intrinsic"], views["extrinsic"], width=w, height=h,
                       device="cpu")))
    vp = tobs.camera.viewport.numpy()
    gap = np.ceil(vp) - vp
    assert ((gap > 0) & (gap < 1e-5)).any()  # a corner just below an integer
    np.testing.assert_array_equal(np.trunc(vp),
                                  np.trunc(np.asarray(jobs.camera.viewport)))
    z_j, _ = jmodels.encode(jm.sculptor, params["sculptor"], jm.fuser,
                            params["fuser"], jobs.camera, jobs.color[None],
                            jobs.depth[None], jobs.mask[None])
    close_rel(tm.build_latent_object(tobs).numpy(), np.asarray(z_j))


def test_from_checkpoint_loads_reference_schema(rng, tmp_path, tiny_pair):
    """A reference-schema .pth (the JAX package's export) loads with a plain
    load_state_dict and renders what the JAX model renders."""
    jm, _, params = tiny_pair
    modules = {
        "sculptor": {"args": jm.sculptor.checkpoint_args(),
                     "params": params["sculptor"]},
        "photographer": {"args": jm.photographer.checkpoint_args(),
                         "params": params["photographer"]},
        "fuser": {"type": "GRUFuser", "args": {"in_channels": 4, "cube_size": 1.0},
                  "params": params["fuser"]},
    }
    for mod in modules.values():
        mod["state_dict"] = {k: torch.from_numpy(np.array(v)) for k, v in
                             export_torch_state_dict(mod.pop("params")).items()}
    path = tmp_path / "checkpoint.pth"
    torch.save({"name": "tiny", "epoch": 0, "args": {"camera_dist": 1.5},
                "modules": modules}, path)
    tm = TModel.from_checkpoint(path, device="cpu")
    assert tm.camera_dist == 1.5 and tm.input_size == 16
    run_both(JModel.from_checkpoint(path), tm, tiny_views(rng, n=3), 4, rng)


def test_demo_family_with_learned_weights_matches_jax(rng):
    """encoder_distill.npz on the first 4 reference views of refs_o0, 8
    cameras. JAX reads the npz through zoo.load_params_npz, the port
    through its own numpy loader and the keys json."""
    sc, fu, ph = jzoo.demo_sculptor(), jzoo.demo_fuser(), jzoo.demo_photographer()
    template = jax.eval_shape(
        lambda k: jzoo.init_recon_params(k, sc, fu, ph, batch=1, views=2),
        jax.random.PRNGKey(0))
    params = jzoo.load_params_npz(DISTILL / "encoder_distill.npz", template)
    jm = JModel(sc, params["sculptor"], fu, params["fuser"], ph,
                params["photographer"], camera_dist=jzoo.DEMO_CAMERA_DIST)
    state = split_state_dict(from_jax_params(load_params_npz(
        DISTILL / "encoder_distill.npz", DISTILL / "encoder_distill_keys.json")))
    tm = TModel(tzoo.demo_sculptor(device="cpu"), state["sculptor"],
                tzoo.demo_fuser(device="cpu"), state["fuser"],
                tzoo.demo_photographer(device="cpu"), state["photographer"],
                camera_dist=tzoo.DEMO_CAMERA_DIST, device="cpu")
    with np.load(REFS_O0) as z:
        views = {k: z[k][:4] for k in z.files}
    y = run_both(jm, tm, views, 8, rng)
    # The learned model sees the object: some, not all, pixels are inside.
    coverage = float((y["mask"] > 0.5).float().mean())
    assert 0.01 < coverage < 0.9


def test_load_params_npz_names_every_leaf():
    params = load_params_npz(DISTILL / "encoder_distill.npz",
                             DISTILL / "encoder_distill_keys.json")
    keys = json.loads((DISTILL / "encoder_distill_keys.json").read_text())
    assert list(params) == keys
    state = split_state_dict(from_jax_params(params))
    assert set(state) == {"sculptor", "fuser", "photographer"}
    assert state["sculptor"]["image_encoder.input_block.conv.module.weight"].shape == (
        32, 5, 1, 1)
