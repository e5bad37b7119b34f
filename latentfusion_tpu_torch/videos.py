"""Video writing as an image sequence (counterpart of
``latentfusion_tpu/videos.py``).

The JAX package writes h264 through imageio-ffmpeg where it can and
otherwise an image sequence: ``VideoWriter("out/tracking.mp4")`` writes
``out/tracking/000000.png``, ``000001.png``, ... This package always takes
that path, with ``png.py`` (the GPU machine has no imageio or ffmpeg), so
its files have the JAX fallback's names and pixels. ``read_video`` reads
such a sequence back; decoding a video file is not ported (ROADMAP.md,
Queue 1).
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterator

import numpy as np

from . import png


def _to_uint8(frame) -> np.ndarray:
    """A frame as (H, W, 3) uint8: floats in [0, 1] scaled by 255 and
    truncated, channels-first moved last, gray repeated."""
    frame = np.asarray(frame)
    if frame.dtype != np.uint8:
        frame = (np.clip(frame, 0, 1) * 255).astype(np.uint8)
    if frame.ndim == 3 and frame.shape[0] in (1, 3):
        frame = frame.transpose(1, 2, 0)
    if frame.ndim == 2:
        frame = frame[..., None]
    if frame.shape[-1] == 1:
        frame = np.repeat(frame, 3, axis=-1)
    return frame


def frames_dir(path) -> Path:
    """The directory of the image sequence that stands for video ``path``."""
    return Path(path).with_suffix("")


class VideoWriter:
    """Writes each frame as ``<path without suffix>/<index:06d>.png``."""

    def __init__(self, path, fps: int = 30):
        self.path = Path(path)
        self.fps = fps
        self._frames_dir = frames_dir(self.path)
        self._frames_dir.mkdir(parents=True, exist_ok=True)
        self._count = 0

    def write(self, frame):
        png.write_png(self._frames_dir / f"{self._count:06d}.png", _to_uint8(frame))
        self._count += 1

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_video(path) -> Iterator[np.ndarray]:
    """The frames (H, W, 3) uint8 of the image sequence ``VideoWriter``
    wrote for ``path`` (or of the directory ``path``), in order. A video
    file raises ``NotImplementedError``."""
    path = Path(path)
    folder = path if path.is_dir() else frames_dir(path)
    if path.is_file() or not folder.is_dir():
        raise NotImplementedError(
            f"{path}: decoding a video file is not ported (ROADMAP.md, Queue 1); "
            "read_video reads the image sequences VideoWriter writes")
    for frame in sorted(folder.glob("[0-9]" * 6 + ".png")):
        yield png.read_png(frame)


def write_video(path, frames, fps: int = 30):
    with VideoWriter(path, fps=fps) as w:
        for frame in frames:
            w.write(frame)
