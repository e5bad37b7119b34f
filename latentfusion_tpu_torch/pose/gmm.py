"""Diagonal-covariance Gaussian mixtures with weighted EM, blending and
sampling (counterpart of ``latentfusion_tpu/pose/gmm.py``), batched over a
leading axis of B independent mixtures (one per object of a multi-object
estimate). Fixed shapes throughout: elite selection enters the fit as
per-sample weights. Random draws take a ``torch.Generator`` and happen on
its device."""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class DiagGMM(NamedTuple):
    """B mixtures of K diagonal Gaussians over D dims."""
    weights: torch.Tensor      # (B, K)
    means: torch.Tensor        # (B, K, D)
    covariances: torch.Tensor  # (B, K, D), diagonal


def _log_prob(gmm: DiagGMM, x: torch.Tensor) -> torch.Tensor:
    """Per-component log densities (B, N, K) of x (B, N, D)."""
    diff = x[:, :, None, :] - gmm.means[:, None]
    quad = (diff ** 2 / gmm.covariances[:, None]).sum(-1)
    logdet = torch.log(gmm.covariances).sum(-1)
    return -0.5 * (quad + logdet[:, None] + x.shape[-1] * math.log(2 * math.pi))


def fit(data: torch.Tensor, n_components: int,
        generator: Optional[torch.Generator] = None,
        sample_weights: Optional[torch.Tensor] = None, n_iter: int = 25,
        reg_covar: float = 1e-5,
        init_means: Optional[torch.Tensor] = None) -> DiagGMM:
    """Weighted EM fits of ``n_components`` diagonal Gaussians to each of
    the B data sets of ``data`` (B, N, D), all at once. Each fit's means
    start at data points drawn by weight from ``generator`` (without
    replacement when N >= n_components), or at ``init_means`` (B, K, D);
    its covariances at the weighted variance of all its data."""
    b, n, d = data.shape
    if sample_weights is None:
        sample_weights = torch.ones(b, n, device=data.device)
    sw = sample_weights / sample_weights.sum(dim=1, keepdim=True).clamp_min(1e-12)
    if init_means is None:
        idx = torch.stack([torch.multinomial(w.to(generator.device), n_components,
                                             replacement=n < n_components,
                                             generator=generator) for w in sw])
        init_means = torch.gather(data, 1, idx.to(data.device)[..., None].expand(-1, -1, d))
    mean_all = (sw[..., None] * data).sum(1)
    var_all = (sw[..., None] * (data - mean_all[:, None]) ** 2).sum(1) + reg_covar
    gmm = DiagGMM(torch.full((b, n_components), 1.0 / n_components, device=data.device),
                  init_means, var_all[:, None].expand(b, n_components, d))
    for _ in range(n_iter):
        logp = _log_prob(gmm, data) + torch.log(gmm.weights.clamp_min(1e-12))[:, None]
        resp = torch.softmax(logp, dim=-1) * sw[..., None]
        nk = resp.sum(1).clamp_min(1e-12)
        # One product per mixture, as a single fit computes it: a batched
        # product may sum in another order (CPU's small-matrix loop, cuBLAS's
        # batched kernels), and a one-object estimate keeps its bits.
        means = torch.stack([r.T @ x for r, x in zip(resp, data)]) / nk[..., None]
        diff2 = (data[:, :, None, :] - means[:, None]) ** 2
        cov = (resp[..., None] * diff2).sum(1) / nk[..., None] + reg_covar
        gmm = DiagGMM(nk / nk.sum(dim=1, keepdim=True), means, cov)
    return gmm


def blend(old: DiagGMM, new: DiagGMM, alpha: float) -> DiagGMM:
    """The union of both mixtures' components, weighted 1 - alpha and alpha."""
    return DiagGMM(torch.cat(((1.0 - alpha) * old.weights, alpha * new.weights), dim=1),
                   torch.cat((old.means, new.means), dim=1),
                   torch.cat((old.covariances, new.covariances), dim=1))


def sample(gmm: DiagGMM, n: int, generator: torch.Generator) -> torch.Tensor:
    """``n`` draws (B, n, D) of each mixture: a component by weight, then
    its Gaussian."""
    dev = generator.device
    probs = gmm.weights.clamp_min(1e-30).to(dev)
    comp = torch.stack([torch.multinomial(p, n, replacement=True, generator=generator)
                        for p in probs])
    eps = torch.randn(*comp.shape, gmm.means.shape[-1], generator=generator, device=dev)
    return sample_from(gmm, comp.to(gmm.means.device), eps.to(gmm.means.device))


def sample_from(gmm: DiagGMM, comp: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Draws from given component indices (B, n) and unit normals (B, n, D)."""
    idx = comp[..., None].expand(-1, -1, gmm.means.shape[-1])
    return (torch.gather(gmm.means, 1, idx)
            + eps * torch.sqrt(torch.gather(gmm.covariances, 1, idx)))
