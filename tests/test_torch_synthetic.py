"""The port's synthetic training stream and its loader
(``latentfusion_tpu_torch/data/synthetic.py``, ``data/loader.py``) held
against the JAX package on the CPU.

A whole item of the stream, with the tool's conditions (random materials,
UV textures, random color and depth backgrounds, color and depth noise,
mask corruption, camera translation jitter), against JAX's with JAX's
poses injected into both and the same ``random`` and ``np.random`` seeds:
every array bit for bit but the corrupted input masks, which differ only
within one pixel of an ellipse's edge (the ellipse fill is held to OpenCV's
in tests/test_torch_augment.py). The procedural meshes, textures and
backgrounds: the arrays the JAX package writes (its ``imwrite`` patched
here) bit for bit, and the port's PNG files read back to them. The
loader: inline batches are the dataset's items, 2 worker processes, the
quantised transport against JAX's, pickling.
"""
import json
import os
import pickle
import random
import subprocess
import sys
from pathlib import Path

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from latentfusion_tpu.data import loader as jloader
from latentfusion_tpu.data import synthetic as jsynth

from latentfusion_tpu_torch import png
from latentfusion_tpu_torch import testing as ttesting
from latentfusion_tpu_torch.augment import cv_compat
from latentfusion_tpu_torch.data import loader as tloader
from latentfusion_tpu_torch.data import synthetic as tsynth

W, H = 64, 48


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("assets")
    pool, _ = ttesting.sample_lobe_shapes(0, 2, device="cpu")
    meshes = ttesting.lobe_shape_meshes(pool, root / "meshes", lat=10, lon=20)
    blobs = tsynth.make_procedural_blobs(root / "blobs", n_objs=1, n_verts=200)
    tex = tsynth.make_procedural_textures(root / "tex", n=3, size=32)
    bg = tsynth.make_procedural_backgrounds(root / "bg", n_color=2, n_depth=2, width=W,
                                            height=H)
    return {"meshes": meshes + blobs, "tex": tex, "bg": bg}


def datasets(assets, **extra):
    kwargs = dict(num_input_views=2, num_output_views=2, width=W, height=H,
                  size_jitter=(0.6, 1.0), random_materials=True, use_textures=True,
                  textures_dir=assets["tex"], color_random_background=True,
                  color_background_dir=assets["bg"], depth_random_background=True,
                  depth_background_dir=assets["bg"], mask_noise_p=1.0,
                  color_noise_level=0.05, depth_noise_level=0.02,
                  camera_translation_noise=0.01, seed=0, **extra)
    t = tsynth.SyntheticDataset(assets["meshes"], **kwargs)
    j = jsynth.SyntheticDataset(assets["meshes"], **kwargs)
    # The JAX package indexes JPEG textures and color backgrounds; give it the
    # port's PNG files (imageio reads them).
    j.texture_paths = list(t.texture_paths)
    j.color_background_paths = list(t.color_background_paths)
    j.depth_background_paths = list(t.depth_background_paths)
    return j, t


def test_indexes_png_assets(assets):
    _, t = datasets(assets)
    assert [p.name for p in t.texture_paths] == [f"tex_{i:03d}.png" for i in range(3)]
    assert [p.name for p in t.color_background_paths] == ["bg_000.png", "bg_001.png"]
    assert [p.name for p in t.depth_background_paths] == ["depth_000.png", "depth_001.png"]


def test_jpeg_assets_raise(tmp_path, assets, caplog):
    """A damaged JPEG raises in read_image; load_random_image skips it with
    a warning, as the JAX package skips a file imageio cannot read, and
    raises when no file of the bank reads."""
    _, t = datasets(assets)
    (tmp_path / "tex.jpg").write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ValueError, match="JPEG"):
        tsynth.read_image(tmp_path / "tex.jpg")
    with pytest.raises(RuntimeError, match="could not load"):
        t.load_random_image([tmp_path / "tex.jpg"])
    assert "failed to read image" in caplog.text


def edge_of_drawn(drawn, shape):
    edges = np.zeros(shape, bool)
    for center, axes, angle in drawn:
        region = np.zeros(shape, np.uint8)
        cv2.ellipse(region, center, axes, angle, 0, 360, 1, -1)
        padded = np.pad(region, 1)
        k = np.ones((3, 3), np.uint8)
        edges |= (cv2.dilate(padded, k)[1:-1, 1:-1]
                  != cv2.erode(padded, k, borderValue=0)[1:-1, 1:-1])
    return edges


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_get_item_matches_jax_with_its_poses(assets, monkeypatch, seed):
    j, t = datasets(assets, emit_in_gt=True)
    for ds in (j, t):
        random.seed(seed)
        ds.worker_init_fn(0)
    poses = [j.random_poses(2), j.random_poses(2)]
    for ds in (j, t):
        monkeypatch.setattr(ds, "random_poses", lambda n, *a, it=iter(list(poses)), **k: next(it))

    random.seed(100 + seed)
    np.random.seed(100 + seed)
    a = j._get_item()
    state = (random.getstate(), np.random.get_state()[1].copy())
    drawn = []
    fill = cv_compat.fill_ellipse

    def recorded(img, center, axes, angle, value):
        drawn.append((len(drawn), center, axes, angle))
        return fill(img, center, axes, angle, value)

    monkeypatch.setattr(cv_compat, "fill_ellipse", recorded)
    random.seed(100 + seed)
    np.random.seed(100 + seed)
    b = t._get_item()
    assert random.getstate() == state[0]
    assert np.array_equal(np.random.get_state()[1], state[1])

    assert a.keys() == b.keys() == {"in", "in_gt", "out_gt"}
    for group in a:
        for key in a[group]:
            x, y = np.asarray(a[group][key]), b[group][key]
            assert x.dtype == y.dtype and x.shape == y.shape, (group, key)
            if (group, key) == ("in", "mask"):
                flips = x != y
                edges = edge_of_drawn([d[1:] for d in drawn], (H, W))
                assert not (flips & ~edges).any()
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{group}/{key}")
    assert b["in_gt"]["mask"].sum() > 0


def test_random_poses_draw_from_the_worker_generator(assets):
    _, t = datasets(assets)
    t.worker_init_fn(1)
    trans, quats = t.random_poses(5)
    assert trans.shape == (5, 3) and quats.shape == (5, 4)
    np.testing.assert_allclose(np.linalg.norm(quats, axis=1), 1.0, atol=1e-6)
    assert (trans[:, 2] >= 1.5).all() and (trans[:, 2] <= 3.0).all()
    t2 = datasets(assets)[1]
    t2.worker_init_fn(1)
    np.testing.assert_array_equal(t2.random_poses(5)[1], quats)
    for kwargs in ({"constrained": True}, {"disk_sample": True}):
        _, q = t.random_poses(4, **kwargs)
        np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-5)
    j, _ = datasets(assets)
    jt, jq = j.orbit_poses(6)
    tt, tq = t.orbit_poses(6)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(tq, jq, atol=1e-6)


# ----------------------------------------------------------- generators
def test_procedural_assets_match_jax(tmp_path, monkeypatch):
    written = {}
    monkeypatch.setattr(imageio, "imwrite",
                        lambda path, arr: written.__setitem__(path.name, np.asarray(arr)))
    jsynth.make_procedural_textures(tmp_path / "j", n=4, size=40, seed=3)
    jsynth.make_procedural_backgrounds(tmp_path / "j", n_color=3, n_depth=2, width=W,
                                       height=H, seed=2)
    tsynth.make_procedural_textures(tmp_path / "t", n=4, size=40, seed=3)
    tsynth.make_procedural_backgrounds(tmp_path / "t", n_color=3, n_depth=2, width=W,
                                       height=H, seed=2)
    assert len(written) == 9
    for name, arr in written.items():
        path = tmp_path / "t" / name.replace(".jpg", ".png")
        np.testing.assert_array_equal(png.read_png(path), arr, err_msg=name)
        assert png.read_png(path).dtype == arr.dtype


def test_procedural_blobs_match_jax(tmp_path):
    a = jsynth.make_procedural_blobs(tmp_path / "j", n_objs=2, n_verts=150)
    b = tsynth.make_procedural_blobs(tmp_path / "t", n_objs=2, n_verts=150)
    for x, y in zip(a, b):
        assert x.read_text() == y.read_text()


def test_load_random_depth_matches_jax(assets):
    j, t = datasets(assets)
    a = (random.seed(5), j.load_random_depth(j.depth_background_paths))[1]
    b = (random.seed(5), t.load_random_depth(t.depth_background_paths))[1]
    np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- loader
def test_transport_codec_matches_jax(assets):
    _, t = datasets(assets, emit_in_gt=True)
    random.seed(0)
    t.worker_init_fn(0)
    item = t._get_item()
    enc = tloader.encode_transport(item)
    jenc = jloader.encode_transport(item)
    assert jax.tree_util.tree_structure(enc) == jax.tree_util.tree_structure(jenc)
    for x, y in zip(jax.tree_util.tree_leaves(enc), jax.tree_util.tree_leaves(jenc)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    batch = tloader.collate([enc, enc])
    host = tloader.decode_transport(batch)
    dev = tloader.decode_transport(tloader.to_tensors(batch))
    jdec = jloader.decode_transport(jax.tree_util.tree_map(jnp.asarray, batch))
    for x, y, z in zip(jax.tree_util.tree_leaves(host), jax.tree_util.tree_leaves(dev),
                       jax.tree_util.tree_leaves(jdec)):
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x, y.numpy())
        # XLA turns JAX's jitted division by 255 into a product with its
        # reciprocal: within one rounding of the quotient.
        np.testing.assert_allclose(x, np.asarray(z), rtol=2 ** -23, atol=0)


def test_inline_loader_batches_are_the_items(assets):
    _, t = datasets(assets)
    random.seed(1)
    it = iter(tloader.IterableLoader(t, batch_size=2, device="cpu"))
    batches = [next(it) for _ in range(2)]
    _, t2 = datasets(assets)
    random.seed(1)
    t2.worker_init_fn(0)
    items = iter(t2)
    for batch in batches:
        want = tloader.collate([next(items), next(items)])
        for group in want:
            for key in want[group]:
                assert batch[group][key].dtype == torch.float32
                np.testing.assert_array_equal(batch[group][key].numpy(), want[group][key])
    host = next(iter(tloader.IterableLoader(t, batch_size=1, device=None,
                                            transport="quantized", decode=False)))
    assert host["in"]["render"].dtype == np.uint8 and host["in"]["depth"].dtype == np.float16


TWO_WORKERS = """
import json, sys
import torch
from latentfusion_tpu_torch.data import loader, synthetic
meshes, tex, bg, transport = json.loads(sys.argv[1])
dataset = synthetic.SyntheticDataset(meshes, num_input_views=2, num_output_views=2, width=64,
                                     height=48, random_materials=True, use_textures=True,
                                     textures_dir=tex, color_random_background=True,
                                     color_background_dir=bg, mask_noise_p=1.0, seed=0)
feed = loader.IterableLoader(dataset, batch_size=2, num_workers=2, prefetch_factor=1,
                             device="cpu", transport=transport)
try:
    it = iter(feed)
    batches = [next(it) for _ in range(3)]
finally:
    feed.shutdown()
print(json.dumps([{"shape": list(b["in"]["render"].shape), "dtype": str(b["in"]["render"].dtype),
                   "min": float(b["in"]["render"].min()), "max": float(b["in"]["render"].max()),
                   "mask": float(b["out_gt"]["mask"].sum()),
                   "sum": float(b["in"]["render"].double().sum())} for b in batches]))
"""


@pytest.mark.parametrize("transport", [None, "quantized"])
def test_loader_with_two_workers(assets, transport):
    """Two forked worker processes, from a fresh interpreter (this test
    process runs JAX's threads, which a fork would copy)."""
    args = json.dumps([[str(p) for p in assets["meshes"]], str(assets["tex"]),
                       str(assets["bg"]), transport])
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", TWO_WORKERS, args], cwd=root, timeout=120,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(root)})
    assert out.returncode == 0, out.stderr[-2000:]
    batches = json.loads(out.stdout.strip().splitlines()[-1])
    for b in batches:
        assert b["shape"] == [2, 2, 3, H, W] and b["dtype"] == "torch.float32"
        assert 0.0 <= b["min"] and b["max"] <= 1.0 and b["mask"] > 0
    assert len({b["sum"] for b in batches}) == 3


def test_dataset_pickles(assets):
    _, t = datasets(assets)
    clone = pickle.loads(pickle.dumps(t))
    random.seed(3)
    clone.worker_init_fn(0)
    item = next(iter(clone))
    assert item["in"]["render"].shape == (2, 3, H, W)
    with pytest.raises(ValueError, match="transport"):
        tloader.IterableLoader(t, 1, transport="jpeg", device="cpu")
