"""Training meters and the interval-gated metric writer (counterpart of
``latentfusion_tpu/train/logging.py``): moving-average and epoch meters,
and TensorBoard scalars, images and histograms when TensorBoard is
available."""
from __future__ import annotations

import collections
import logging
import time
from typing import Dict

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _scalar(value) -> float:
    if isinstance(value, torch.Tensor):
        value = value.detach().float().cpu().numpy()
    return float(np.asarray(value).reshape(()))


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def add(self, value):
        self.sum += _scalar(value)
        self.count += 1

    @property
    def mean(self):
        return self.sum / max(self.count, 1)


class MovingAverageMeter:
    def __init__(self, window: int = 20):
        self.window = window
        self.values = collections.deque(maxlen=window)

    def add(self, value):
        self.values.append(_scalar(value))

    @property
    def mean(self):
        return float(np.mean(self.values)) if self.values else 0.0


class MetricLogger:
    """Moving-average and epoch meters per tag; a TensorBoard writer under
    ``log_dir`` when ``torch.utils.tensorboard`` can be imported, scalars
    every ``scalar_interval`` steps."""

    def __init__(self, log_dir=None, scalar_interval: int = 10,
                 histogram_interval: int = 100, image_interval: int = 500,
                 show_interval: int = 1000):
        self.writer = None
        if log_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(str(log_dir))
            except Exception as e:  # pragma: no cover
                logger.warning("tensorboard unavailable: %s", e)
        self.intervals = {
            "scalar": scalar_interval,
            "histogram": histogram_interval,
            "image": image_interval,
            "show": show_interval,
        }
        self.global_step = 0
        self.moving_meters: Dict[str, MovingAverageMeter] = \
            collections.defaultdict(MovingAverageMeter)
        self.epoch_meters: Dict[str, AverageMeter] = \
            collections.defaultdict(AverageMeter)
        self._mark = time.time()

    def step(self):
        self.global_step += 1

    def is_it_time_yet(self, kind: str) -> bool:
        interval = self.intervals.get(kind, 1)
        if interval <= 0:
            return False
        return self.global_step % interval == 0

    def mark_time(self) -> float:
        now = time.time()
        delta = now - self._mark
        self._mark = now
        return delta

    def put_scalar(self, tag: str, value):
        value = _scalar(value)
        self.moving_meters[tag].add(value)
        self.epoch_meters[tag].add(value)
        if self.writer is not None and self.is_it_time_yet("scalar"):
            self.writer.add_scalar(tag, self.moving_meters[tag].mean,
                                   self.global_step)

    def put_scalars(self, scalars: Dict):
        for k, v in scalars.items():
            self.put_scalar(k, v)

    def put_histogram(self, tag: str, values):
        if self.writer is not None and self.is_it_time_yet("histogram"):
            if isinstance(values, torch.Tensor):
                values = values.detach().float().cpu().numpy()
            self.writer.add_histogram(tag, np.asarray(values).reshape(-1),
                                      self.global_step)

    def put_image(self, tag: str, image):
        """image: (C, H, W) or (H, W, C) in [0, 1]."""
        if self.writer is not None:
            if isinstance(image, torch.Tensor):
                image = image.detach().float().cpu().numpy()
            img = np.asarray(image)
            fmt = "CHW" if img.shape[0] in (1, 3) else "HWC"
            self.writer.add_image(tag, img, self.global_step, dataformats=fmt)

    def put_text(self, tag: str, text: str):
        if self.writer is not None:
            self.writer.add_text(tag, text, self.global_step)

    def epoch_summary(self) -> Dict[str, float]:
        out = {k: m.mean for k, m in self.epoch_meters.items()}
        for m in self.epoch_meters.values():
            m.reset()
        return out

    def close(self):
        if self.writer is not None:
            self.writer.close()
