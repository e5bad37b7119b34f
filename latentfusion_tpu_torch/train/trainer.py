"""The training harness (counterpart of ``latentfusion_tpu/train/trainer.py``):
the epoch loop over an endless loader, params.json, the ``initial``,
``epoch-latest``, every-``save_interval`` and ``best-<metric>``
checkpoints, and the meters.

Checkpoints are the JAX trainer's: a pickle of ``{"args", "modules": {name:
{"args", "params"}}, "name", "epoch"}`` whose ``params`` are JAX parameter
trees of numpy arrays (``recon.checkpoint.to_jax_params``), so either
package resumes from the other's. ``export_torch_checkpoint`` writes the
reference ``.pth`` that both packages' ``LatentFusionModel.from_checkpoint``
load. The step's randomness comes from ``self.rng``, a ``torch.Generator``
on the training device seeded by ``seed``.

In a run over several ranks (``rank``) every rank runs the loop and takes
part in each checkpoint (gathering sharded parameters is a collective), and
rank 0 alone writes params.json, the checkpoints, the ``.pth`` and the
TensorBoard logs.
"""
from __future__ import annotations

import json
import logging
import pickle
import time
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .. import parallel
from ..recon import checkpoint as ckpt
from ..utils import MyEncoder
from .logging import MetricLogger

logger = logging.getLogger(__name__)


def save_checkpoint(path, payload: Dict[str, Any]):
    """Pickle ``payload`` (tensors as numpy arrays)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    def host(x):
        if isinstance(x, Mapping):
            return {k: host(v) for k, v in x.items()}
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy()
        return np.asarray(x) if hasattr(x, "dtype") else x

    with open(path, "wb") as f:
        pickle.dump(host(payload), f, protocol=pickle.HIGHEST_PROTOCOL)


def load_checkpoint(path) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return pickle.load(f)


def module_params(name: str, module: nn.Module) -> Dict[str, Any]:
    """``module``'s parameters as the JAX tree of module ``name``
    (``{"params": {...}}``; ``{}`` for a module without parameters)."""
    state = {f"{name}.{k}": v for k, v in parallel.full_state_dict(module).items()}
    return ckpt.nest_params(ckpt.to_jax_params(state)).get(name, {})


def load_module_params(module: nn.Module, tree: Mapping[str, Any]) -> None:
    """Load a JAX parameter tree (as ``module_params`` gives) into ``module``."""
    module.load_state_dict(ckpt.from_jax_params(ckpt.flatten_params(tree)))


class Trainer:
    """Epoch-loop harness. Subclasses provide ``run_iteration(batch, train,
    is_step)`` and ``create_checkpoint``. Each epoch runs ``batches_per_epoch
    * batch_groups`` iterations, as in the JAX package."""

    def __init__(self, *, name: str, save_dir, loader, batches_per_epoch: int,
                 batch_groups: int = 1, num_epochs: int = 10000,
                 save_interval: int = 10, logger_intervals: Optional[dict] = None,
                 rank: int = 0, **kwargs):
        self.name = name
        self.save_dir = Path(save_dir) / name
        self.loader = loader
        self.batches_per_epoch = batches_per_epoch
        self.batch_groups = batch_groups
        self.num_epochs = num_epochs
        self.save_interval = save_interval
        self.kwargs = kwargs
        self.rank = rank
        self.epoch = 0
        self.best_metrics: Dict[str, float] = {}
        self.plotter = MetricLogger(self.save_dir / "tb" if rank == 0 else None,
                                    **(logger_intervals or {}))
        self._time_mark = time.time()

    # Subclass hooks -------------------------------------------------------
    def run_iteration(self, batch, train: bool, is_step: bool):
        raise NotImplementedError

    def create_checkpoint(self) -> Dict[str, Any]:
        raise NotImplementedError

    # ----------------------------------------------------------------------
    def mark_time(self) -> float:
        now = time.time()
        delta = now - self._time_mark
        self._time_mark = now
        return delta

    def save_params_json(self):
        if self.rank != 0:
            return
        self.save_dir.mkdir(parents=True, exist_ok=True)
        with open(self.save_dir / "params.json", "w") as f:
            json.dump({"name": self.name, **{
                k: v for k, v in self.kwargs.items()
                if isinstance(v, (int, float, str, bool, list, tuple, type(None)))
            }}, f, indent=2, cls=MyEncoder)

    def save(self, tag: str):
        payload = self.create_checkpoint()
        if self.rank != 0:
            return
        payload.update({"name": self.name, "epoch": self.epoch})
        save_checkpoint(self.save_dir / f"ckpt-{tag}.npz.pkl", payload)
        logger.info("saved checkpoint %s", tag)

    def save_if_better(self, metric_name: str, value: float,
                       lower_is_better: bool = True):
        best = self.best_metrics.get(metric_name)
        better = best is None or (value < best if lower_is_better else value > best)
        if better:
            self.best_metrics[metric_name] = value
            self.save(f"best-{metric_name.replace('/', '_')}")

    def start(self, train: bool = True):
        self.save_params_json()
        self.save("initial")
        for epoch in range(self.epoch, self.num_epochs):
            self.epoch = epoch
            self.run_epoch(train=train)
            summary = self.plotter.epoch_summary()
            logger.info("epoch %d summary: %s", epoch, {
                k: round(v, 5) for k, v in list(summary.items())[:12]})
            self.on_epoch_end(summary)
            self.save("epoch-latest")
            if self.save_interval > 0 and (epoch + 1) % self.save_interval == 0:
                self.save(f"{epoch + 1:04d}")

    def on_epoch_end(self, summary: Dict[str, float]):
        for key in ("error/depth/l1", "loss/generator/total"):
            if key in summary:
                self.save_if_better(key, summary[key])
                break

    def run_epoch(self, train: bool = True):
        iters = self.batches_per_epoch * self.batch_groups
        it = iter(self.loader)
        for i in range(iters):
            batch = next(it)
            is_step = (i + 1) % self.batch_groups == 0
            self.run_iteration(batch, train, is_step)
            self.plotter.step()


class ReconTrainer(Trainer):
    """The reconstruction trainer: one ``step_fn`` (``train.step.
    make_recon_train_step``) call an iteration, whatever ``is_step`` says (as
    in the JAX package: ROADMAP Queue 3), with the input-noise weight of the
    epoch and the generator's learning rate ``lr_schedule(state.step)``.

    ``module_args`` holds each module's checkpoint args (``sculptor``,
    ``photographer``, ``discriminator``), the JAX modules'
    ``checkpoint_args()``."""

    def __init__(self, *, sculptor, fuser, photographer, discriminator=None,
                 state, step_fn, module_args: Mapping[str, dict],
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 input_noise_sched=None, seed: int = 0, camera_dist=1.5,
                 device="cpu", **kwargs):
        super().__init__(**kwargs)
        self.sculptor = sculptor
        self.fuser = fuser
        self.photographer = photographer
        self.discriminator = discriminator
        self.state = state
        self.step_fn = step_fn
        self.module_args = dict(module_args)
        self.lr_schedule = lr_schedule
        self.input_noise_sched = input_noise_sched
        self.camera_dist = camera_dist
        self.rng = torch.Generator(device).manual_seed(seed)

    def run_iteration(self, batch, train: bool = True, is_step: bool = True):
        noise_w = (self.input_noise_sched.get(self.epoch)
                   if self.input_noise_sched else 0.0)
        if self.lr_schedule is not None:
            for group in self.state.optimizer.param_groups:
                group["lr"] = self.lr_schedule(self.state.step)
        data_time = self.mark_time()
        self.state, scalars = self.step_fn(self.state, batch, self.rng,
                                           input_noise_weight=noise_w)
        compute_time = self.mark_time()
        self.plotter.put_scalars(scalars)
        self.plotter.put_scalar("time/data_load", data_time)
        self.plotter.put_scalar("time/compute", compute_time)

    def _modules(self) -> Dict[str, nn.Module]:
        mods = {"sculptor": self.sculptor, "photographer": self.photographer,
                "fuser": self.fuser}
        if self.discriminator is not None:
            mods["discriminator"] = self.discriminator
        return mods

    def _module_entries(self) -> Dict[str, Dict[str, Any]]:
        names = ("sculptor", "photographer") + (
            ("discriminator",) if self.discriminator is not None else ())
        return ckpt.reference_entries({k: self.module_args[k] for k in names}, self.fuser)

    def _run_args(self) -> Dict[str, Any]:
        return {"camera_dist": self.camera_dist, **{
            k: v for k, v in self.kwargs.items()
            if isinstance(v, (int, float, str, bool, type(None)))}}

    def create_checkpoint(self) -> Dict[str, Any]:
        modules = self._module_entries()
        for name, module in self._modules().items():
            modules[name]["params"] = module_params(name, module)
        return {"args": self._run_args(), "modules": modules}

    def export_torch_checkpoint(self, path):
        """Write the reference-format ``.pth``: each module's ``args`` and
        ``state_dict`` (on the CPU). Every rank calls it; rank 0 writes."""
        state_dicts = {name: parallel.full_state_dict(module)
                       for name, module in self._modules().items()}
        if self.rank == 0:
            ckpt.save_reference_checkpoint(path, self._module_entries(), state_dicts,
                                           name=self.name, epoch=self.epoch,
                                           args=self._run_args())


class IBRTrainer(ReconTrainer):
    """The IBR generator's trainer: ``generator`` (the ``UNet2d``) beside the
    reconstruction modules, in the checkpoint under ``generator`` with its
    ``in_channels``, ``out_channels`` and ``block_config``."""

    def __init__(self, *, generator: nn.Module, **kwargs):
        super().__init__(**kwargs)
        self.generator = generator

    def _modules(self) -> Dict[str, nn.Module]:
        return {**super()._modules(), "generator": self.generator}

    def _module_entries(self) -> Dict[str, Dict[str, Any]]:
        entries = super()._module_entries()
        gen = self.generator
        entries["generator"] = {"args": {"in_channels": gen.in_channels,
                                         "out_channels": gen.out_channels,
                                         "block_config": (gen.down_block_config,
                                                          gen.up_block_config)}}
        return entries
