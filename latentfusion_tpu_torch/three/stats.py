"""Robust statistics, MAD outlier rejection (counterpart of
``latentfusion_tpu/three/stats.py``). The masks keep the data's shape;
medians of an even count are the mean of the two middle values, numpy's
convention (``torch.median`` would take the lower one)."""
from __future__ import annotations

import torch


def median(tensor: torch.Tensor, dim=None) -> torch.Tensor:
    """numpy's median: over all values when ``dim`` is None."""
    if dim is None:
        tensor, dim = tensor.reshape(-1), 0
    s = torch.sort(tensor, dim=dim).values
    m = s.shape[dim]
    return (s.select(dim, (m - 1) // 2) + s.select(dim, m // 2)) / 2.0


def mad(tensor: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Median absolute deviation along ``dim``."""
    return median((tensor - median(tensor, dim).unsqueeze(dim)).abs(), dim)


def mask_outliers_mad(data: torch.Tensor, m: float = 2.0) -> torch.Tensor:
    """True where a value lies within ``m`` MADs of the median."""
    med = median(data)
    dev = (data - med).abs()
    return dev / median(dev) < m


def mask_outliers(data: torch.Tensor, m: float = 2.0) -> torch.Tensor:
    """True where a value lies within ``m`` sample standard deviations of
    the mean."""
    return (data - data.mean()).abs() / torch.std(data) < m


def robust_mean(data: torch.Tensor, m: float = 2.0) -> torch.Tensor:
    """Mean of the values within ``m`` standard deviations."""
    mask = mask_outliers(data, m)
    return (data * mask).sum() / mask.sum().clamp_min(1)


def robust_mean_mad(data: torch.Tensor, m: float = 2.0) -> torch.Tensor:
    """Mean of the values within ``m`` MADs of the median."""
    mask = mask_outliers_mad(data, m)
    return (data * mask).sum() / mask.sum().clamp_min(1)
