"""Diagonal-covariance Gaussian mixture with weighted EM, blending and
sampling (counterpart of ``latentfusion_tpu/pose/gmm.py``). Fixed shapes
throughout: elite selection enters the fit as per-sample weights. Random
draws take a ``torch.Generator`` and happen on its device."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class DiagGMM(NamedTuple):
    weights: torch.Tensor      # (K,)
    means: torch.Tensor        # (K, D)
    covariances: torch.Tensor  # (K, D), diagonal


def _log_prob(gmm: DiagGMM, x: torch.Tensor) -> torch.Tensor:
    """Per-component log densities (N, K)."""
    diff = x[:, None, :] - gmm.means[None]
    quad = (diff ** 2 / gmm.covariances[None]).sum(-1)
    logdet = torch.log(gmm.covariances).sum(-1)
    return -0.5 * (quad + logdet[None] + x.shape[-1] * math.log(2 * math.pi))


def fit(data: torch.Tensor, n_components: int,
        generator: Optional[torch.Generator] = None,
        sample_weights: Optional[torch.Tensor] = None, n_iter: int = 25,
        reg_covar: float = 1e-5,
        init_means: Optional[torch.Tensor] = None) -> DiagGMM:
    """Weighted EM fit of ``n_components`` diagonal Gaussians to ``data``
    (N, D). The means start at data points drawn by weight from
    ``generator`` (without replacement when N >= n_components), or at
    ``init_means``; the covariances at the weighted variance of all data."""
    n, d = data.shape
    if sample_weights is None:
        sample_weights = torch.ones(n, device=data.device)
    sw = sample_weights / sample_weights.sum().clamp_min(1e-12)
    if init_means is None:
        idx = torch.multinomial(sw.to(generator.device), n_components,
                                replacement=n < n_components,
                                generator=generator).to(data.device)
        init_means = data[idx]
    mean_all = (sw[:, None] * data).sum(0)
    var_all = (sw[:, None] * (data - mean_all) ** 2).sum(0) + reg_covar
    gmm = DiagGMM(torch.full((n_components,), 1.0 / n_components, device=data.device),
                  init_means, var_all[None].expand(n_components, d))
    for _ in range(n_iter):
        logp = _log_prob(gmm, data) + torch.log(gmm.weights.clamp_min(1e-12))[None]
        resp = torch.softmax(logp, dim=1) * sw[:, None]
        nk = resp.sum(0).clamp_min(1e-12)
        means = (resp.T @ data) / nk[:, None]
        diff2 = (data[:, None, :] - means[None]) ** 2
        cov = (resp[:, :, None] * diff2).sum(0) / nk[:, None] + reg_covar
        gmm = DiagGMM(nk / nk.sum(), means, cov)
    return gmm


def blend(old: DiagGMM, new: DiagGMM, alpha: float) -> DiagGMM:
    """The union of both mixtures' components, weighted 1 - alpha and alpha."""
    return DiagGMM(torch.cat(((1.0 - alpha) * old.weights, alpha * new.weights)),
                   torch.cat((old.means, new.means)),
                   torch.cat((old.covariances, new.covariances)))


def sample(gmm: DiagGMM, n: int, generator: torch.Generator) -> torch.Tensor:
    """``n`` draws (n, D): a component by weight, then its Gaussian."""
    dev = generator.device
    probs = gmm.weights.clamp_min(1e-30).to(dev)
    comp = torch.multinomial(probs, n, replacement=True, generator=generator)
    eps = torch.randn(n, gmm.means.shape[-1], generator=generator, device=dev)
    return sample_from(gmm, comp.to(gmm.means.device), eps.to(gmm.means.device))


def sample_from(gmm: DiagGMM, comp: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Draws from given component indices (n,) and unit normals (n, D)."""
    return gmm.means[comp] + eps * torch.sqrt(gmm.covariances[comp])
