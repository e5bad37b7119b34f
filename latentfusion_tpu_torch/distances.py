"""Distance functions (counterpart of ``latentfusion_tpu/distances.py``)."""
from __future__ import annotations

import torch


def _cosine_similarity(x1, x2, dim=1, eps=1e-8):
    """dot / max(|x1| |x2|, eps), as ``torch.cosine_similarity`` defines it."""
    dot = (x1 * x2).sum(dim=dim)
    n1 = torch.linalg.norm(x1, dim=dim)
    n2 = torch.linalg.norm(x2, dim=dim)
    return dot / (n1 * n2).clamp_min(eps)


def cosine_distance(x1, x2, dim=1, eps=1e-8):
    """1 - cosine similarity along ``dim`` (along the only dim of vectors)."""
    if x1.dim() == 1:
        dim = 0
    return 1.0 - _cosine_similarity(x1, x2, dim, eps)


def pairwise_distance(x1, x2, metric="cosine", p=2, eps=1e-8):
    """Row-wise distances of (N, D) tensors: cosine or Euclidean (p-norm)."""
    if metric == "cosine":
        return 1.0 - _cosine_similarity(x1, x2, dim=1, eps=eps)
    if metric == "euclidean":
        return torch.linalg.vector_norm(x1 - x2 + eps, ord=p, dim=1)
    raise ValueError(f"Unknown type {metric!r}")


def distance(x1, x2, metric="cosine", p=2, eps=1e-8, dim=0):
    """Cosine or p-norm distance along ``dim``."""
    if metric == "cosine":
        return 1.0 - _cosine_similarity(x1, x2, dim=dim, eps=eps)
    return torch.linalg.vector_norm(x1 - x2, ord=p, dim=dim)


def outer_distance(x1, x2, metric="cosine", p=2, eps=1e-8):
    """All-pairs distances (N, M) of the rows of x1 (N, D) and x2 (M, D):
    cosine, Euclidean, negative inner product, or the negative least-squares
    coefficient of x2 on x1 (``ols_coef``)."""
    if metric == "cosine":
        x12 = x1 @ x2.T
        w1 = torch.linalg.norm(x1, dim=1, keepdim=True)
        w2 = torch.linalg.norm(x2, dim=1, keepdim=True)
        return 1.0 - x12 / (w1 @ w2.T).clamp_min(eps)
    if metric == "euclidean":
        sq = ((x1 ** 2).sum(dim=1)[:, None] + (x2 ** 2).sum(dim=1)[None, :]
              - 2.0 * (x1 @ x2.T))
        return torch.sqrt(sq.clamp_min(0.0))
    if metric == "inner":
        return -(x1 @ x2.T)
    if metric == "ols_coef":
        w1 = torch.linalg.norm(x1, dim=1, keepdim=True)
        return -((x1 @ x2.T) / (w1 ** 2).clamp_min(eps))
    raise ValueError(f"Unknown type {metric!r}")
