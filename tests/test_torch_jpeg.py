"""The port's JPEG decoder (``latentfusion_tpu_torch/jpeg.py``,
``csrc/jpeg.cpp``) against ``imageio.v2.imread`` (Pillow over libjpeg-turbo)
on the CPU: bytes equal on the JPEG banks the JAX package writes
(``make_procedural_textures`` and ``make_procedural_backgrounds``), on the
bank committed under ``tests/data/jpeg_bank``, and on files Pillow writes in
every layout the decoder takes (greyscale, 4:4:4, 4:2:2, 4:2:0, odd sizes,
restart intervals); a progressive file raises ``NoDecoderError``; the
synthetic stream on the JAX package's JPEG bank gives JAX's item; a
640x480 4:2:0 file decodes in at most 20 ms on one core.
"""
import io
import random
import time
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from latentfusion_tpu.data import synthetic as jsynth

from latentfusion_tpu_torch import jpeg
from latentfusion_tpu_torch import testing as ttesting
from latentfusion_tpu_torch.data import synthetic as tsynth

BANK = Path(__file__).resolve().parent / "data" / "jpeg_bank"
SPEED_MS = 20.0


def pillow_jpeg(image, **kwargs) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, format="JPEG", **kwargs)
    return buf.getvalue()


def smooth_image(rng, h, w, channels=3):
    """Low-frequency color fields with fine noise: every DCT band in use."""
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.zeros((h, w, channels))
    for c in range(channels):
        a, b, p = rng.rand(3) * 6
        img[..., c] = 0.5 + 0.4 * np.sin(a * xx + b * yy + p)
    img += 0.15 * rng.rand(h, w, channels)
    img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


@pytest.fixture(scope="module")
def jax_bank(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_bank")
    jsynth.make_procedural_textures(root / "tex", n=4, size=64)
    jsynth.make_procedural_backgrounds(root / "bg", n_color=3, n_depth=0, width=80,
                                       height=60)
    return root


def test_jax_bank_bytes_equal_imageio(jax_bank):
    paths = sorted(jax_bank.glob("**/*.jpg"))
    assert len(paths) == 7
    for path in paths:
        ref = imageio.imread(path)
        out = jpeg.read_jpeg(path)
        assert out.dtype == ref.dtype == np.uint8 and out.shape == ref.shape, path
        np.testing.assert_array_equal(out, ref, err_msg=str(path))
        np.testing.assert_array_equal(tsynth.read_image(path), ref)


def test_committed_bank_bytes_equal_imageio():
    paths = sorted(BANK.glob("**/*.jpg"))
    assert [p.parent.name for p in paths] == ["backgrounds"] * 8 + ["textures"] * 8
    for path in paths:
        out = jpeg.read_jpeg(path)
        np.testing.assert_array_equal(out, imageio.imread(path), err_msg=str(path))
    assert jpeg.read_jpeg(BANK / "backgrounds" / "bg_000.jpg").shape == (480, 640, 3)
    assert jpeg.read_jpeg(BANK / "textures" / "tex_000.jpg").shape == (256, 256, 3)


@pytest.mark.parametrize("size", [(48, 64), (37, 23), (23, 37), (1, 1), (9, 17), (100, 3)])
@pytest.mark.parametrize("layout", [
    {"subsampling": 0}, {"subsampling": 1}, {"subsampling": 2},
    {"subsampling": 2, "restart_marker_blocks": 3, "quality": 50},
    {"subsampling": 1, "restart_marker_rows": 1, "quality": 97},
    {"grey": True}, {"grey": True, "restart_marker_blocks": 2},
])
def test_pillow_layouts_bytes_equal(size, layout):
    layout = dict(layout)
    grey = layout.pop("grey", False)
    rng = np.random.RandomState(hash((size, grey)) % 2 ** 31)
    data = pillow_jpeg(smooth_image(rng, *size, 1 if grey else 3), **layout)
    ref = np.asarray(Image.open(io.BytesIO(data)))
    out = jpeg.decode_jpeg(data)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


def test_progressive_and_damaged_raise():
    img = smooth_image(np.random.RandomState(0), 32, 40)
    with pytest.raises(jpeg.NoDecoderError, match="progressive"):
        jpeg.decode_jpeg(pillow_jpeg(img, progressive=True))
    assert issubclass(jpeg.NoDecoderError, ValueError)
    assert tsynth.NoDecoderError is jpeg.NoDecoderError
    good = pillow_jpeg(img)
    for bad in (b"", b"\xff\xd8", good[:40], b"\x00" + good[1:]):
        with pytest.raises(ValueError, match="JPEG"):
            jpeg.decode_jpeg(bad)


def test_load_random_image_skips_what_does_not_decode(tmp_path, caplog):
    """A greyscale JPEG is skipped (not RGB), a progressive one with a
    warning, as the JAX package skips what imageio cannot read."""
    rng = np.random.RandomState(1)
    (tmp_path / "grey.jpg").write_bytes(pillow_jpeg(smooth_image(rng, 16, 16, 1)))
    (tmp_path / "prog.jpg").write_bytes(pillow_jpeg(smooth_image(rng, 16, 16), progressive=True))
    (tmp_path / "rgb.jpg").write_bytes(pillow_jpeg(smooth_image(rng, 16, 16)))
    ds = tsynth.SyntheticDataset([], 1, 1)
    random.seed(0)
    out = ds.load_random_image(sorted(tmp_path.glob("*.jpg")))
    np.testing.assert_array_equal(out, imageio.imread(tmp_path / "rgb.jpg"))
    random.seed(3)
    for _ in range(8):
        ds.load_random_image(sorted(tmp_path.glob("*.jpg")))
    assert "failed to read image" in caplog.text and "prog.jpg" in caplog.text


def test_stream_on_jax_jpeg_bank_matches_jax(tmp_path, jax_bank, monkeypatch):
    """One item of the stream with JPEG textures and color backgrounds (the
    JAX package's bank, as the recipe's COCO banks): JAX's poses injected,
    the same ``random`` and ``np.random`` seeds, every array bit for bit
    (no mask corruption here)."""
    pool, _ = ttesting.sample_lobe_shapes(0, 1, device="cpu")
    meshes = ttesting.lobe_shape_meshes(pool, tmp_path / "meshes", lat=10, lon=20)
    kwargs = dict(num_input_views=2, num_output_views=2, width=64, height=48,
                  random_materials=True, use_textures=True, textures_dir=jax_bank / "tex",
                  color_random_background=True, color_background_dir=jax_bank / "bg",
                  color_noise_level=0.05, seed=0)
    j = jsynth.SyntheticDataset(meshes, **kwargs)
    t = tsynth.SyntheticDataset(meshes, **kwargs)
    assert t.texture_paths == j.texture_paths and len(t.texture_paths) == 4
    assert t.color_background_paths == j.color_background_paths
    for ds in (j, t):
        random.seed(5)
        ds.worker_init_fn(0)
    poses = [j.random_poses(2), j.random_poses(2)]
    for ds in (j, t):
        monkeypatch.setattr(ds, "random_poses", lambda n, *a, it=iter(list(poses)), **k: next(it))
    items = []
    for ds in (j, t):
        random.seed(11)
        np.random.seed(11)
        items.append(ds._get_item())
    a, b = items
    for group in a:
        for key in a[group]:
            np.testing.assert_array_equal(np.asarray(a[group][key]), b[group][key],
                                          err_msg=f"{group}/{key}")


def test_decodes_640x480_420_within_20_ms():
    data = (BANK / "backgrounds" / "bg_001.jpg").read_bytes()
    assert Image.open(io.BytesIO(data)).layer[1][1:3] == (1, 1)  # chroma halved both ways
    jpeg.decode_jpeg(data)
    times = []
    for _ in range(15):
        t0 = time.perf_counter()
        jpeg.decode_jpeg(data)
        times.append((time.perf_counter() - t0) * 1e3)
    assert min(times) <= SPEED_MS, times
