"""Small tensor functions (counterpart of ``latentfusion_tpu/functional.py``)."""
from __future__ import annotations

import torch


def _channel_stats(tensor, mean, std):
    mean = torch.as_tensor(mean, dtype=torch.float32, device=tensor.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=tensor.device)
    if tensor.dim() == 4:
        return mean[None, :, None, None], std[None, :, None, None]
    if tensor.dim() == 3:
        return mean[:, None, None], std[:, None, None]
    raise ValueError(f"Unsupported number of dimensions ({tensor.dim()}).")


def normalize(tensor, mean, std):
    """Channel-wise (x - mean) / std of a (B, C, H, W) or (C, H, W) tensor."""
    mean, std = _channel_stats(tensor, mean, std)
    return (tensor - mean) / std


def denormalize(tensor, mean, std):
    """Channel-wise x * std + mean."""
    mean, std = _channel_stats(tensor, mean, std)
    return tensor * std + mean


def unit_normalize(tensor, axis, eps=1e-3):
    return tensor / (eps + torch.linalg.norm(tensor, dim=axis, keepdim=True))


def extract_features(layers, x, layer_names):
    """Run ``x`` through ``layers``, an ordered ``(name, fn)`` sequence (for
    a module, its ``named_children()``), and return the outputs of the
    layers named in ``layer_names``, in layer order."""
    wanted = set(layer_names)
    features = []
    for name, fn in layers:
        x = fn(x)
        if name in wanted:
            features.append(x)
    return features


def absolute_max_pool(tensor: torch.Tensor, axis: int) -> torch.Tensor:
    """The element of largest magnitude along ``axis``, keeping the dim."""
    index = torch.argmax(tensor.abs(), dim=axis, keepdim=True)
    return torch.take_along_dim(tensor, index, dim=axis)
