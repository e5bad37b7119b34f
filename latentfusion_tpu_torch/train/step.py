"""The reconstruction training step (counterpart of
``latentfusion_tpu/train/step.py``): the generator path of the published
recipe, which trains with no discriminator. Depth hard smooth-L1 over the
top-k pixels and mask BCE (optionally a mask beta prior), Adam with betas
(0, 0.99), gradient accumulation over microbatches.

The modules train in place: ``init_train_state`` puts them in train mode
with their gradients on, and each step updates their parameters where they
are (the JAX package returns new parameter trees instead). Each step runs on
cuDNN's deterministic convolution algorithms
(``pose.estimation.deterministic_cudnn``), so two steps from the same state
and batch give the same bits.

Not ported yet, each raising ``NotImplementedError`` (ROADMAP.md Queue 1
item 8): the discriminator branch, ``reconstruct_input``,
``generator_input_depth``, a Photographer that predicts color, and
``remat``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn

from .. import losses as L
from ..pose import estimation
from ..pose.estimation import _bce_with_logits
from ..recon import models
from ..recon.utils import mask_normalized_depth, process_batch

_NOT_PORTED = "is not ported yet (ROADMAP.md Queue 1 item 8)"


@dataclasses.dataclass
class TrainState:
    """The optimizer over the modules' parameters and the step count."""
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(name: str = "adam", learning_rate: float = 1e-3,
                   b1: float = 0.0, b2: float = 0.99) -> Callable:
    """A factory ``params -> optimizer``. ``adam`` is ``optax.adam``'s
    update: eps 1e-8 outside the square root, bias-corrected moments."""
    if name == "adam":
        return lambda params: torch.optim.Adam(params, lr=learning_rate,
                                               betas=(b1, b2), eps=1e-8)
    if name == "sgd":
        return lambda params: torch.optim.SGD(params, lr=learning_rate)
    if name == "rmsprop":
        raise NotImplementedError(
            "rmsprop is not ported: optax adds eps inside the square root, "
            "torch.optim.RMSprop outside")
    raise ValueError(f"Unknown optimizer {name!r}")


def init_train_state(modules: Mapping[str, nn.Module], optimizer) -> TrainState:
    """Put ``modules`` (e.g. ``{"sculptor": ..., "fuser": ...,
    "photographer": ...}``) in train mode with gradients on, and build
    ``optimizer`` (a ``make_optimizer`` factory) over their parameters."""
    params = []
    for module in modules.values():
        module.train().requires_grad_(True)
        params.extend(module.parameters())
    return TrainState(optimizer(params))


def _recon_loss(kind: str, pred, target, k: int):
    if kind == "l1":
        return L.l1_loss(pred, target)
    if kind == "smooth_l1":
        return L.smooth_l1_loss(pred, target)
    if kind == "hard_l1":
        return L.hard_pixel_loss(L.l1_loss, pred, target, k)
    if kind == "hard_smooth_l1":
        return L.hard_pixel_loss(L.smooth_l1_loss, pred, target, k)
    if kind == "binary_cross_entropy":
        return L.binary_cross_entropy_loss(pred, target)
    raise ValueError(f"Unknown loss type {kind!r}")


def _depth_loss(y, gt_depth, gt_mask, config) -> torch.Tensor:
    depth_k = config.get("g_depth_recon_loss_k", 16384)
    return config.get("g_depth_recon_loss_weight", 25.0) * _recon_loss(
        config.get("g_depth_recon_loss_type", "hard_smooth_l1"), y["depth"],
        mask_normalized_depth(gt_depth, gt_mask), depth_k)


def _mask_beta_loss(y, config, out) -> None:
    beta_w = config.get("g_mask_beta_loss_weight", 0.0)
    if beta_w > 0:
        p = config.get("g_mask_beta_loss_param", 0.01)
        out["mask_beta"] = beta_w * L.beta_prior_loss(y["mask"], p, p)


def generator_losses(photographer, y: Dict, batch_gt: Dict, config: Dict
                     ) -> Dict[str, torch.Tensor]:
    """Weighted reconstruction losses of decoder outputs ``y`` against a
    processed ground-truth group: depth, mask on the probabilities (and the
    mask beta prior)."""
    if photographer.predict_color:
        raise NotImplementedError(f"predict_color {_NOT_PORTED}")
    out = {}
    if photographer.predict_depth:
        out["depth"] = _depth_loss(y, batch_gt["depth"], batch_gt["mask"],
                                   config)
    if photographer.predict_mask:
        out["mask"] = config.get("g_mask_recon_loss_weight", 25.0) * _recon_loss(
            config.get("g_mask_recon_loss_type", "binary_cross_entropy"),
            y["mask"], batch_gt["mask"], config.get("g_mask_recon_loss_k", 2000))
        _mask_beta_loss(y, config, out)
    return out


def _split(tree, m: int, i: int):
    """Microbatch ``i`` of ``m``: every tensor cut along dim 0 and every
    camera along its length (both object-major)."""
    if isinstance(tree, Mapping):
        return {k: _split(v, m, i) for k, v in tree.items()}
    size = len(tree) // m
    return tree[i * size:(i + 1) * size]


def _accumulate(num_microbatches: int, loss_fn, state: TrainState):
    """Zero the gradients, add each microbatch's ``loss_fn(i)`` / M to them
    by backward, step the optimizer. Returns (total loss, the loss dicts
    summed / M, the last microbatch's dict), detached. Forward and backward
    run on cuDNN's deterministic algorithms."""
    state.optimizer.zero_grad(set_to_none=True)
    total, summed, last = 0.0, {}, {}
    for i in range(num_microbatches):
        with estimation.deterministic_cudnn():
            loss_dict = loss_fn(i)
            loss = sum(loss_dict.values()) / num_microbatches
            loss.backward()
        total = total + loss.detach()
        last = {k: v.detach() for k, v in loss_dict.items()}
        for k, v in last.items():
            summed[k] = summed.get(k, 0.0) + v / num_microbatches
    state.optimizer.step()
    state.step += 1
    return total, summed, last


def make_train_step(sculptor, fuser, photographer, config: Optional[Dict] = None,
                    num_microbatches: int = 1):
    """The plain generator step on a processed batch (see
    ``recon.utils.process_batch``): ``{'in': {image (B, V, 3, h, w), depth,
    mask, camera (B*V)}, 'out_gt': {...}}``.

    Returns ``step(state, batch) -> (state, loss, loss_dict)``; with
    microbatches the gradient and the loss are averaged over them and
    ``loss_dict`` is the last one's, as in the JAX package."""
    config = config or {}

    def loss_fn(batch):
        bin, bout = batch["in"], batch["out_gt"]
        z_obj = models.encode(sculptor, fuser, bin["camera"], bin["image"],
                              bin.get("depth"), bin["mask"])
        y, _ = models.decode(photographer, z_obj, bout["camera"])
        return generator_losses(photographer, y, bout, config)

    def step(state: TrainState, batch):
        loss, _, aux = _accumulate(
            num_microbatches,
            lambda i: loss_fn(_split(batch, num_microbatches, i)), state)
        return state, loss, aux

    return step


def make_recon_train_step(sculptor, fuser, photographer, discriminator=None,
                          config: Optional[Dict] = None,
                          num_microbatches: int = 1):
    """One iteration of the published recipe on a raw batch:
    ``process_batch`` (random orientation) -> input masking -> encode ->
    decode at the output cameras -> depth and mask losses -> Adam.

    Returns ``step(state, raw_batch, generator=None, rotations=None) ->
    (state, scalars)``. ``num_microbatches`` > 1 cuts the batch along its
    objects and averages their gradients before one optimizer step (the
    reference's ``--batch-groups``); each microbatch draws its own random
    orientation from ``generator``, or takes ``rotations[i]`` (1, 4) when
    given. ``scalars`` holds ``loss/generator/<term>`` and
    ``loss/generator/total``, averaged over the microbatches."""
    config = dict(config or {})
    if discriminator is not None:
        raise NotImplementedError(f"the discriminator branch {_NOT_PORTED}")
    for option in ("reconstruct_input", "generator_input_depth", "remat"):
        if config.get(option, False):
            raise NotImplementedError(f"{option} {_NOT_PORTED}")
    if photographer.predict_color:
        raise NotImplementedError(f"predict_color {_NOT_PORTED}")
    cube_size = config.get("cube_size", 1.0)
    camera_dist = config.get("camera_dist", 1.5)
    random_orientation = config.get("random_orientation", True)
    crop_random_background = config.get("crop_random_background", False)
    color_random_background = config.get("color_random_background", False)
    mask_kind = config.get("g_mask_recon_loss_type", "binary_cross_entropy")

    def g_losses(batch, generator, rotation):
        proc = process_batch(batch, cube_size, camera_dist, sculptor.in_size,
                             random_orientation, generator, rotation)
        recon = proc["out_gt"]
        image_in = proc["in"]["image"]
        mask_in = proc["in"]["mask"]
        # The input views' depth would reach the Sculptor only with
        # generator_input_depth (not ported), so it is not masked here.
        if not color_random_background or crop_random_background:
            image_in = image_in * mask_in
        z_obj = models.encode(sculptor, fuser, proc["in"]["camera"], image_in,
                              None, mask_in)
        y, _ = models.decode(photographer, z_obj, recon["camera"])

        loss_dict = {}
        if photographer.predict_depth:
            loss_dict["depth"] = _depth_loss(y, recon["depth"], recon["mask"],
                                             config)
        if photographer.predict_mask:
            weight = config.get("g_mask_recon_loss_weight", 25.0)
            if mask_kind == "binary_cross_entropy":
                loss_dict["mask"] = weight * _bce_with_logits(
                    y["mask_logits"], recon["mask"]).mean()
            else:
                loss_dict["mask"] = weight * _recon_loss(
                    mask_kind, y["mask"], recon["mask"],
                    config.get("g_mask_recon_loss_k", 2000))
            _mask_beta_loss(y, config, loss_dict)
        return loss_dict

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None,
             rotations=None):
        def loss_fn(i):
            rotation = None if rotations is None else rotations[i]
            return g_losses(_split(batch, num_microbatches, i), generator, rotation)

        total, loss_dict, _ = _accumulate(num_microbatches, loss_fn, state)
        scalars = {f"loss/generator/{k}": v for k, v in loss_dict.items()}
        scalars["loss/generator/total"] = total
        return state, scalars

    return step
