"""Farthest-point sampling, which picks evenly spread reference views
(counterpart of ``latentfusion_tpu/three/utils.py``)."""
from __future__ import annotations

import torch


def farthest_points(data: torch.Tensor, n_clusters: int, dist_func,
                    return_center_indexes: bool = False,
                    return_distances: bool = False):
    """Farthest-point sampling of the rows of ``data`` (N, D).

    ``dist_func(center, data)`` gives the (N,) distances of every row to a
    centre broadcast to ``data``'s shape. Distances start at 1e7; each
    centre is the first row at the largest distance so far, and a row joins
    the newest centre that ties its running minimum. Returns the int32
    cluster of each row, and optionally the centres' indices and the
    distances."""
    n = data.shape[0]
    if n_clusters >= n:
        every = torch.arange(n, device=data.device)
        return (every, every) if return_center_indexes else every
    clusters = torch.full((n,), -1, dtype=torch.int32, device=data.device)
    distances = torch.full((n,), 1e7, dtype=torch.float32, device=data.device)
    centers = torch.zeros(n_clusters, dtype=torch.int32, device=data.device)
    for i in range(n_clusters):
        center_idx = torch.argmax(distances)
        centers[i] = center_idx
        new_distances = dist_func(data[center_idx][None].expand_as(data), data)
        distances = torch.minimum(distances, new_distances)
        clusters = torch.where(distances == new_distances,
                               torch.tensor(i, dtype=torch.int32, device=data.device),
                               clusters)
    if return_center_indexes:
        if return_distances:
            return clusters, centers, distances
        return clusters, centers
    return clusters
