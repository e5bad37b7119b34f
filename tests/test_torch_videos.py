"""The port's video writer (``latentfusion_tpu_torch/videos.py``) against
the JAX package's image-sequence fallback (``latentfusion_tpu/videos.py``
where no ffmpeg writer opens), and ``poserbpf_comparison --video`` on the
committed MOPED capture. Budget: about 25 s on one worker.
"""
import sys
from pathlib import Path

import imageio.v2 as imageio
import numpy as np
import pytest

from latentfusion_tpu import videos as jvideos

from latentfusion_tpu_torch import png, poserbpf_comparison, videos

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tests"))
import make_moped_synth  # noqa: E402
import test_evaluate_bop as fake_bop  # noqa: E402

CAPTURE = make_moped_synth.OUT


def frames(rng):
    """Each frame layout the writers take: float CHW, float HWC, uint8 HWC,
    one-channel CHW, two-dimensional gray (floats reach past [0, 1])."""
    h, w = 12, 20
    return [rng.uniform(-0.2, 1.2, (3, h, w)).astype(np.float32),
            rng.uniform(0, 1, (h, w, 3)),
            rng.randint(0, 256, (h, w, 3)).astype(np.uint8),
            rng.uniform(0, 1, (1, h, w)).astype(np.float32),
            rng.uniform(0, 1, (h, w)).astype(np.float32)]


def test_writer_matches_jax_fallback(rng, tmp_path, monkeypatch):
    """The same file names, and the same pixels read back by imageio, as
    the JAX writer's image sequence (its ffmpeg writer made to fail)."""
    def no_ffmpeg(*args, **kwargs):
        raise RuntimeError("no ffmpeg here")

    monkeypatch.setattr(imageio, "get_writer", no_ffmpeg)
    items = frames(rng)
    with jvideos.VideoWriter(tmp_path / "jax" / "clip.mp4", fps=15) as w:
        for f in items[:4]:  # JAX's fallback takes no two-dimensional frame
            w.write(f)
    videos.write_video(tmp_path / "port" / "clip.mp4", items, fps=15)
    jax_files = sorted(p.name for p in (tmp_path / "jax" / "clip").iterdir())
    port_files = sorted(p.name for p in (tmp_path / "port" / "clip").iterdir())
    assert jax_files == ["000000.png", "000001.png", "000002.png", "000003.png"]
    assert port_files == jax_files + ["000004.png"]
    for name in jax_files:
        ours = imageio.imread(tmp_path / "port" / "clip" / name)
        np.testing.assert_array_equal(ours, imageio.imread(tmp_path / "jax" / "clip" / name))
        assert ours.dtype == np.uint8 and ours.shape == (12, 20, 3)
    gray = imageio.imread(tmp_path / "port" / "clip" / "000004.png")
    np.testing.assert_array_equal(gray[..., 0], gray[..., 2])


def test_read_video_round_trip(rng, tmp_path):
    items = frames(rng)
    videos.write_video(tmp_path / "clip.mp4", items)
    back = list(videos.read_video(tmp_path / "clip.mp4"))
    assert len(back) == len(items)
    np.testing.assert_array_equal(back[2], items[2])
    np.testing.assert_array_equal(back[0], (np.clip(items[0], 0, 1) * 255).astype(
        np.uint8).transpose(1, 2, 0))
    assert [f.shape for f in videos.read_video(tmp_path / "clip")] == [(12, 20, 3)] * 5
    (tmp_path / "real.mp4").write_bytes(b"\x00\x00\x00\x18ftypmp42")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        list(videos.read_video(tmp_path / "real.mp4"))
    with pytest.raises(NotImplementedError):
        list(videos.read_video(tmp_path / "missing.mp4"))


def test_poserbpf_comparison_writes_video_frames(tmp_path):
    """Two tracked frames of the committed capture on the tiny family with
    ``--video``: the frames read back at the capture's size, each the
    frame's color with the estimate's mask added to its red channel only."""
    ckpt = fake_bop.make_checkpoint(tmp_path)
    coarse, fine = fake_bop.write_mini_configs(tmp_path)
    out = tmp_path / "out"
    rows, _ = poserbpf_comparison.main([
        "--checkpoint", str(ckpt), "--reference-scene", str(CAPTURE / "reference"),
        "--eval-scene", str(CAPTURE / "evaluation"), "--num-ref-views", "4",
        "--coarse-config", str(coarse), "--fine-config", str(fine), "--max-frames", "2",
        "--out", str(out), "--video", "--device", "cpu"])
    assert len(rows) == 2 and (out / "results.json").exists()
    written = list(videos.read_video(out / "tracking.mp4"))
    assert sorted(p.name for p in (out / "tracking").iterdir()) == ["000000.png", "000001.png"]
    from latentfusion_tpu_torch.data.realsense import RealsenseDataset

    ds = RealsenseDataset(CAPTURE / "evaluation")
    for i, frame in enumerate(written):
        color = np.asarray(ds[i]["color"]).transpose(1, 2, 0)
        assert frame.shape == (*color.shape[:2], 3)
        expect = (np.clip(color, 0, 1) * 255).astype(np.uint8).astype(int)
        frame = frame.astype(int)
        assert np.abs(frame[..., 1:] - expect[..., 1:]).max() <= 1
        assert (frame[..., 0] >= expect[..., 0] - 1).all()
        assert (frame[..., 0] > expect[..., 0] + 1).any()  # the mask is drawn
    assert png.read_png(out / "tracking" / "000000.png").shape == written[0].shape
