"""Reconstruction losses (counterpart of ``latentfusion_tpu/losses.py``).

Not ported yet: ``lsgan_loss`` and ``multiscale_lsgan_loss`` (the
discriminator, ROADMAP.md Queue 1 item 5).
"""
from __future__ import annotations

import math

import torch


def reduce_loss(loss: torch.Tensor, reduction="mean") -> torch.Tensor:
    if reduction is None:
        return loss
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    raise ValueError(f"Unknown reduction {reduction!r}")


def l1_loss(x, y, reduction="mean"):
    return reduce_loss((x - y).abs(), reduction)


def smooth_l1_loss(x, y, reduction="mean", beta: float = 1.0):
    """``F.smooth_l1_loss`` semantics."""
    diff = (x - y).abs()
    loss = torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)
    return reduce_loss(loss, reduction)


def binary_cross_entropy_loss(pred, target, reduction="mean", eps=1e-12):
    """``F.binary_cross_entropy`` on probabilities, clipped to [eps, 1 - eps]."""
    pred = pred.clamp(eps, 1 - eps)
    loss = -(target * torch.log(pred) + (1 - target) * torch.log(1 - pred))
    return reduce_loss(loss, reduction)


def hard_pixel_loss(base_loss_fn, x, y, k: int, reduction="mean"):
    """The mean (or sum) of the ``k`` hardest pixels of each image. x, y
    (B, C, H, W); higher-rank inputs are folded to that. The per-pixel loss
    is reduced over channels first; ``k`` is cut to the pixel count."""
    if x.dim() > 4:
        x = x.reshape(-1, *x.shape[-3:])
    if y.dim() > 4:
        y = y.reshape(-1, *y.shape[-3:])
    loss = base_loss_fn(x, y, reduction=None)
    loss = loss.sum(dim=1) if reduction == "sum" else loss.mean(dim=1)
    loss = loss.reshape(x.shape[0], -1)
    loss, _ = torch.topk(loss, min(k, loss.shape[1]), dim=1)
    return reduce_loss(loss, reduction)


def _log_beta(alpha: float, beta: float) -> float:
    return math.lgamma(alpha) + math.lgamma(beta) - math.lgamma(alpha + beta)


def beta_prior_loss(tensor, alpha: float, beta: float, reduction="mean",
                    eps=1e-4):
    """Negative log density of a Beta(alpha, beta) prior, clipped at 0: with
    alpha, beta < 1 it pushes mask values toward 0 or 1."""
    loss = ((alpha - 1.0) * torch.log(tensor.clamp_min(eps))
            + (beta - 1.0) * torch.log((1.0 - tensor).clamp_min(eps))
            - _log_beta(alpha, beta))
    return reduce_loss((-loss).clamp_min(0), reduction)


class PerceptualLoss:
    """Feature-space L2: ``features_fn(x) -> [features]`` (for example
    ``modules.vgg.VGG16Features``) of both inputs, the per-item mean of
    (w_act (f1 - f2))² summed over the layers by ``layer_weights``."""

    def __init__(self, features_fn, layer_weights, w_act: float = 0.1, reduction="mean"):
        self.features_fn = features_fn
        self.layer_weights = layer_weights
        self.w_act = w_act
        self.reduction = reduction

    def __call__(self, x1, x2):
        feats1 = self.features_fn(x1)
        feats2 = self.features_fn(x2)
        loss = 0
        for w, f1, f2 in zip(self.layer_weights, feats1, feats2):
            f1 = f1.reshape(f1.shape[0], -1)
            f2 = f2.reshape(f2.shape[0], -1)
            loss += w * ((self.w_act * (f1 - f2)) ** 2).mean(dim=1)
        if self.reduction is not None:
            return reduce_loss(loss, self.reduction)
        return loss
