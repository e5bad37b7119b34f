"""The reconstruction training step (counterpart of
``latentfusion_tpu/train/step.py``): the generator's reconstruction losses
(depth and color L1 or smooth-L1, optionally over the top-k pixels, mask
BCE, a mask beta prior) and optionally the multi-scale LSGAN discriminator
with annealed instance noise, with gradient accumulation over microbatches;
Adam with betas (0, 0.99), optax's RMSprop, or SGD.

The modules train in place: ``init_train_state`` and
``init_gan_train_state`` put them in train mode with their gradients on,
and each step updates their parameters where they are (the JAX package
returns new parameter trees instead). Each step runs on cuDNN's
deterministic convolution algorithms (``pose.estimation.deterministic_cudnn``),
so two steps from the same state and batch give the same bits.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from .. import losses as L
from ..camera import Camera
from ..device import resolve_device
from ..pose import estimation
from ..pose.estimation import _bce_with_logits
from ..recon import models
from ..recon.utils import mask_normalized_depth, process_batch
from ..three.batchview import bv2b

# The profiler range around the discriminator's calls in a step (its
# backward runs outside the range, in autograd's engine).
DISCRIMINATOR_RANGE = "discriminator"


@dataclasses.dataclass
class TrainState:
    """The optimizer over the generator's parameters, the step count, and
    the discriminator's optimizer (None without one)."""
    optimizer: torch.optim.Optimizer
    step: int = 0
    d_optimizer: Optional[torch.optim.Optimizer] = None


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop``'s update, not ``torch.optim.RMSprop``'s: the second
    moment starts at 0 and decays by ``decay`` (0.9), and eps is added
    inside the square root: nu = decay nu + (1 - decay) g^2, p -= lr g /
    sqrt(nu + eps)."""

    def __init__(self, params, lr: float = 1e-3, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                nu = self.state[p].setdefault("nu", torch.zeros_like(p))
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad, value=1 - group["decay"])
                p.addcdiv_(p.grad, (nu + group["eps"]).sqrt(), value=-group["lr"])


def make_optimizer(name: str = "adam", learning_rate: float = 1e-3,
                   b1: float = 0.0, b2: float = 0.99) -> Callable:
    """A factory ``params -> optimizer`` with optax's update rules: ``adam``
    (eps 1e-8 outside the square root, bias-corrected moments), ``sgd``,
    ``rmsprop`` (``OptaxRMSprop``)."""
    if name == "adam":
        return lambda params: torch.optim.Adam(params, lr=learning_rate,
                                               betas=(b1, b2), eps=1e-8)
    if name == "sgd":
        return lambda params: torch.optim.SGD(params, lr=learning_rate)
    if name == "rmsprop":
        return lambda params: OptaxRMSprop(params, lr=learning_rate)
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


def init_gan_train_state(modules: Mapping[str, nn.Module], optimizer,
                         discriminator: Optional[nn.Module] = None,
                         d_optimizer=None, device="cuda") -> TrainState:
    """``init_train_state`` on ``device`` (default the GPU), with the
    discriminator, when there is one, in train mode under its own optimizer
    (the training tool's is ``make_optimizer("adam", discriminator_lr)``)."""
    device = resolve_device(device)
    for module in (*modules.values(), discriminator):
        if module is not None:
            module.to(device)
    state = init_train_state(modules, optimizer)
    if discriminator is not None:
        discriminator.train().requires_grad_(True)
        state.d_optimizer = d_optimizer(list(discriminator.parameters()))
    return state


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


def _color_loss(pred, target, config) -> torch.Tensor:
    return config.get("g_color_recon_loss_weight", 50.0) * _recon_loss(
        config.get("g_color_recon_loss_type", "l1"), pred, target,
        config.get("g_color_recon_loss_k", 2000))


def generator_losses(photographer, y: Dict, batch_gt: Dict, config: Dict
                     ) -> Dict[str, torch.Tensor]:
    """Weighted reconstruction losses of decoder outputs ``y`` against a
    processed ground-truth group: depth, mask on the probabilities (and the
    mask beta prior), color against the masked image."""
    out = {}
    if photographer.predict_depth:
        out["depth"] = _depth_loss(y, batch_gt["depth"], batch_gt["mask"],
                                   config)
    if photographer.predict_mask:
        out["mask"] = config.get("g_mask_recon_loss_weight", 25.0) * _recon_loss(
            config.get("g_mask_recon_loss_type", "binary_cross_entropy"),
            y["mask"], batch_gt["mask"], config.get("g_mask_recon_loss_k", 2000))
        _mask_beta_loss(y, config, out)
    if photographer.predict_color:
        out["color"] = _color_loss(y["color"], batch_gt["image"] * batch_gt["mask"], config)
    return out


def _split(tree, m: int, i: int):
    """Microbatch ``i`` of ``m``: every tensor cut along dim 0 and every
    camera along its length (both object-major)."""
    if isinstance(tree, Mapping):
        return {k: _split(v, m, i) for k, v in tree.items()}
    size = len(tree) // m
    return tree[i * size:(i + 1) * size]


@contextlib.contextmanager
def _frozen(module: Optional[nn.Module]):
    """``module``'s parameters take no gradient inside the block (the
    generator's GAN term reads the discriminator but does not train it)."""
    params = [] if module is None else [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def _accumulate(num_microbatches: int, loss_fn, state: TrainState,
                discriminator: Optional[nn.Module] = None, d_loss_fn=None):
    """The one update rule of both steps: zero the gradients; for each
    microbatch ``i``, ``loss_fn(i) -> (loss dict, d_pack)`` and add the sum
    of its terms / M to the generator's gradients by backward (the
    discriminator's parameters frozen), then, with a discriminator, add
    ``d_loss_fn(d_pack)["total"]`` / M to its gradients; then step the
    optimizers. Both gradients are taken at the parameters from before the
    step. Forward and backward run on cuDNN's deterministic algorithms.
    Returns ({"generator/<term>", "generator/total"[,
    "discriminator/<term>"]: summed / M}, the last microbatch's generator
    dict), detached."""
    m = num_microbatches
    state.optimizer.zero_grad(set_to_none=True)
    if discriminator is not None:
        state.d_optimizer.zero_grad(set_to_none=True)
    summed, last = {}, {}

    def add(prefix, terms):
        for k, v in terms.items():
            summed[f"{prefix}/{k}"] = summed.get(f"{prefix}/{k}", 0.0) + v.detach() / m

    for i in range(m):
        with estimation.deterministic_cudnn():
            with _frozen(discriminator):
                loss_dict, d_pack = loss_fn(i)
                total = sum(loss_dict.values())
                (total / m).backward()
            last = {k: v.detach() for k, v in loss_dict.items()}
            add("generator", {**loss_dict, "total": total})
            if discriminator is not None:
                d_terms = d_loss_fn(d_pack)
                (d_terms["total"] / m).backward()
                add("discriminator", d_terms)
    state.optimizer.step()
    if discriminator is not None:
        state.d_optimizer.step()
    state.step += 1
    return summed, last


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
        y, _, _ = models.decode(photographer, z_obj, bout["camera"])
        return generator_losses(photographer, y, bout, config), None

    def step(state: TrainState, batch):
        summed, aux = _accumulate(
            num_microbatches,
            lambda i: loss_fn(_split(batch, num_microbatches, i)), state)
        return state, summed["generator/total"], aux

    return step


def _normal(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """N(0, 1) of ``shape`` from ``generator`` (drawn on its device), on ``device``."""
    if generator is None:
        raise ValueError("this step draws noise: pass a torch.Generator")
    return torch.randn(shape, generator=generator, device=generator.device).to(device)


def make_recon_train_step(sculptor, fuser, photographer, discriminator=None,
                          config: Optional[Dict] = None,
                          num_microbatches: int = 1):
    """One iteration of the training tool on a raw batch: ``process_batch``
    (random orientation) -> input masking [-> the input depth with N(0,
    ``depth_noise_std``) noise, clipped to [-1, 1], when
    ``generator_input_depth``] -> encode -> decode at the output cameras (and
    the input cameras, ``reconstruct_input``) -> depth, mask and color
    losses [-> the discriminator's LSGAN term at ``g_gan_loss_weight``] ->
    the generator's update [-> the discriminator's LSGAN loss on the real
    and the (detached) fake images, each with its own instance noise of
    ``input_noise_weight * input_noise_std`` N(0, 1), and its update].
    ``remat`` recomputes encode's and decode's activations in the backward
    (``torch.utils.checkpoint``) instead of keeping them.

    Returns ``step(state, raw_batch, generator=None, rotations=None,
    input_noise_weight=0.0) -> (state, scalars)``. ``num_microbatches`` > 1
    cuts the batch along its objects and averages the generator's and the
    discriminator's gradients over them before one update of each (the
    reference's ``--batch-groups``): both gradients are taken at the
    parameters from before the step. Each microbatch draws, from
    ``generator`` and in this order, its random orientation (unless
    ``rotations[i]`` (1, 4) is given), its depth noise, the real images'
    noise and the fake images' noise. ``scalars`` holds
    ``loss/generator/<term>``, ``loss/generator/total`` and, with a
    discriminator, ``loss/discriminator/{real,fake,total}``, averaged over
    the microbatches.

    The discriminator reads the images its ``discriminator_input_color``,
    ``_depth`` and ``_mask`` flags name, in that order; with none set the
    JAX step concatenates an empty list and fails, and this one raises
    ``ValueError`` when it is made. Its calls run inside a
    ``DISCRIMINATOR_RANGE`` profiler range."""
    config = dict(config or {})
    d_inputs = [k for k in ("color", "depth", "mask")
                if config.get(f"discriminator_input_{k}", False)]
    if discriminator is not None and not d_inputs:
        raise ValueError("the discriminator reads no input: set discriminator_input_color, "
                         "discriminator_input_depth or discriminator_input_mask")
    cube_size = config.get("cube_size", 1.0)
    camera_dist = config.get("camera_dist", 1.5)
    reconstruct_input = config.get("reconstruct_input", False)
    random_orientation = config.get("random_orientation", True)
    crop_random_background = config.get("crop_random_background", False)
    color_random_background = config.get("color_random_background", False)
    depth_random_background = config.get("depth_random_background", False)
    generator_input_depth = config.get("generator_input_depth", False)
    depth_noise_std = config.get("depth_noise_std", 0.25)
    crop_predicted_mask = config.get("crop_predicted_mask", False)
    gan_weight = config.get("g_gan_loss_weight", 1.0)
    noise_std = config.get("input_noise_std", 0.2)
    mask_kind = config.get("g_mask_recon_loss_type", "binary_cross_entropy")

    def encode(camera, image, depth, mask):
        return models.encode(sculptor, fuser, camera, image, depth, mask)

    def decode(z_obj, camera):
        return models.decode(photographer, z_obj, camera)[0]

    if config.get("remat", False):
        def remat(fn):
            return lambda *args: checkpoint(fn, *args, use_reentrant=False)

        encode, decode = remat(encode), remat(decode)

    def g_losses(batch, generator, rotation, input_noise_weight):
        """The generator's loss terms of one microbatch, and what the
        discriminator's loss reads."""
        proc = process_batch(batch, cube_size, camera_dist, sculptor.in_size,
                             random_orientation, generator, rotation)
        if reconstruct_input:
            recon_camera = Camera.vcat((proc["in_gt"]["camera"], proc["out_gt"]["camera"]),
                                       batch_size=batch["in"]["mask"].shape[0])
            recon = {k: torch.cat((proc["in_gt"][k], proc["out_gt"][k]), dim=1)
                     for k in ("image", "depth", "mask")}
        else:
            recon_camera = proc["out_gt"]["camera"]
            recon = {k: proc["out_gt"][k] for k in ("image", "depth", "mask")}
        image_in, depth_in, mask_in = (proc["in"]["image"], proc["in"].get("depth"),
                                       proc["in"]["mask"])
        if not color_random_background or crop_random_background:
            image_in = image_in * mask_in
        if generator_input_depth:
            if not depth_random_background or crop_random_background:
                depth_in = mask_normalized_depth(depth_in, mask_in)
            noise = _normal(depth_in.shape, generator, depth_in.device) * depth_noise_std
            depth_in = (depth_in + noise).clamp(-1, 1)
        else:
            depth_in = None
        y = decode(encode(proc["in"]["camera"], image_in, depth_in, mask_in), recon_camera)
        fake_image = y.get("color")
        if photographer.predict_mask and photographer.predict_color:
            fake_image = fake_image * (y["mask"] if crop_predicted_mask else recon["mask"])

        loss_dict = {}
        if photographer.predict_depth:
            loss_dict["depth"] = _depth_loss(y, recon["depth"], recon["mask"], config)
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
        if photographer.predict_color:
            loss_dict["color"] = _color_loss(fake_image, recon["image"], config)

        d_pack = None
        if discriminator is not None:
            fake = {"color": fake_image, "depth": y.get("depth"), "mask": y.get("mask")}
            y_fake = torch.cat([bv2b(fake[k]) for k in d_inputs], dim=1)
            y_real = torch.cat([bv2b(recon["image" if k == "color" else k])
                                for k in d_inputs], dim=1)
            mask_real = bv2b(recon["mask"])
            scale = input_noise_weight * noise_std
            real_noise = scale * _normal(y_real.shape, generator, y_real.device)
            fake_noise = scale * _normal(y_fake.shape, generator, y_fake.device)
            with record_function(DISCRIMINATOR_RANGE):
                loss_dict["gan"] = gan_weight * L.multiscale_lsgan_loss(
                    discriminator(y_fake + fake_noise, mask_real), 1)
            d_pack = (y_fake.detach(), y_real, mask_real, real_noise, fake_noise)
        return loss_dict, d_pack

    def d_losses(d_pack):
        y_fake, y_real, mask_real, real_noise, fake_noise = d_pack
        with record_function(DISCRIMINATOR_RANGE):
            real = L.multiscale_lsgan_loss(discriminator(y_real + real_noise, mask_real), 1)
            fake = L.multiscale_lsgan_loss(discriminator(y_fake + fake_noise, mask_real), 0)
        return {"real": real, "fake": fake, "total": real + fake}

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None,
             rotations=None, input_noise_weight: float = 0.0):
        m = num_microbatches
        summed, _ = _accumulate(
            m, lambda i: g_losses(_split(batch, m, i), generator,
                                  None if rotations is None else rotations[i],
                                  input_noise_weight),
            state, discriminator, d_losses)
        return state, {f"loss/{k}": v for k, v in summed.items()}

    return step
