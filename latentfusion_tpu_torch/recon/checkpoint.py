"""Weights in and out of the port (counterpart of
``latentfusion_tpu/recon/checkpoint.py``).

The port's modules use the reference checkpoint's parameter names, which are
what ``latentfusion_tpu.recon.checkpoint.export_torch_state_dict`` emits:

    JAX   params/image_encoder/down_blocks_0/conv1/weight
    torch image_encoder.down_blocks.0.conv1.module.weight

``from_jax_params`` applies that renaming to JAX parameters given as numpy
arrays keyed by their pytree paths; ``load_params_npz`` reads the distill
rigs' enumerated-leaf npz files with numpy alone, naming each leaf by its
pytree path from the companion ``*_keys.json``.
"""
from __future__ import annotations

import inspect
import json
import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..modules.unet import UNet2d
from .fusion import fuser_from_checkpoint_args
from .models import Photographer, Sculptor


def _path_parts(key: str):
    """Pytree path -> names, from ``"['a']['b_0']['w']"`` (``keystr``),
    ``"['a']/['b_0']/['w']"`` (the keys json files) or ``"a/b_0/w"``."""
    parts = []
    for seg in key.split("/"):
        parts.extend(re.findall(r"\['([^']*)'\]", seg) or ([seg] if seg else []))
    return parts


def from_jax_params(params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """JAX parameters keyed by pytree path -> the port's ``state_dict``.

    A flax ``params`` level is dropped; other leading names (``sculptor``,
    ``fuser``, ``photographer``, ``discriminator``, ``generator``) stay as
    key prefixes. ``name_<i>`` becomes
    list indexing ``name.<i>``, and conv weights move under ``.module``.
    """
    state = {}
    for key, value in params.items():
        parts = []
        for p in _path_parts(key):
            if p == "params":
                continue
            segs = p.split("_")
            if len(segs) > 1 and segs[-1].isdigit():
                parts.extend(["_".join(segs[:-1]), segs[-1]])
            else:
                parts.append(p)
        value = np.asarray(value, dtype=np.float32)
        if parts[-1] == "weight" and value.ndim >= 2:
            parts = parts[:-1] + ["module", "weight"]
        state[".".join(parts)] = torch.from_numpy(value.copy())
    return state


def load_params_npz(path, keys_json) -> Dict[str, np.ndarray]:
    """Read an enumerated-leaf npz (leaf ``i`` stored as ``"i"``) and key each
    leaf by its pytree path, line ``i`` of ``keys_json``."""
    with open(keys_json) as f:
        keys = json.load(f)
    with np.load(path) as data:
        if len(data.files) != len(keys):
            raise ValueError(f"{path}: {len(data.files)} leaves, {keys_json} "
                             f"names {len(keys)}")
        return {key: data[str(i)] for i, key in enumerate(keys)}


def split_state_dict(state: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """``{"sculptor.x.y": v}`` -> ``{"sculptor": {"x.y": v}}``."""
    out: Dict[str, Dict[str, Any]] = {}
    for key, value in state.items():
        head, rest = key.split(".", 1)
        out.setdefault(head, {})[rest] = value
    return out


def _to_block_config(cfg):
    if isinstance(cfg, (list, tuple)):
        return tuple(_to_block_config(c) for c in cfg)
    return cfg


def _filter_args(cls, args: Mapping[str, Any]) -> Dict[str, Any]:
    names = set(inspect.signature(cls.__init__).parameters) - {"self"}
    out = {k: v for k, v in args.items() if k in names}
    for k in ("image_config", "camera_config", "object_config",
              "occlusion_config"):
        if out.get(k):
            out[k] = _to_block_config(out[k])
    return out


def patch_legacy_args(checkpoint: Mapping[str, Any]) -> Mapping[str, Any]:
    """Fill module args that old reference checkpoints lack, in place."""
    kwargs = checkpoint["args"]
    sc = checkpoint["modules"]["sculptor"]["args"]
    sc.setdefault("input_color", True)
    if "input_depth" not in sc:
        sc["input_depth"] = kwargs["generator_input_depth"]
    if "input_mask" not in sc:
        sc["input_mask"] = kwargs["generator_input_mask"]
    ph = checkpoint["modules"]["photographer"]["args"]
    for k in ("predict_color", "predict_depth", "predict_mask"):
        if k not in ph:
            ph[k] = kwargs[k]
    return checkpoint


def _load(module, entry):
    module.load_state_dict({k: torch.as_tensor(v) for k, v in
                            entry.get("state_dict", {}).items()})
    return module


def modules_from_checkpoint(checkpoint: Mapping[str, Any]):
    """(sculptor, fuser, photographer) with their state dicts loaded from a
    reference checkpoint dict ``{args, modules: {name: {args, state_dict}}}``;
    the fuser is any of ``fusion.FUSER_TYPES`` by its ``type`` (GRU when a
    legacy checkpoint names none)."""
    checkpoint = patch_legacy_args(checkpoint)
    mods = checkpoint["modules"]
    sculptor = Sculptor(**_filter_args(Sculptor, mods["sculptor"]["args"]))
    fuser_args = dict(mods["fuser"].get("args") or {})
    if fuser_args.get("block_config"):
        fuser_args["block_config"] = _to_block_config(fuser_args["block_config"])
    fuser = fuser_from_checkpoint_args(mods["fuser"].get("type", "GRUFuser"), fuser_args)
    photographer = Photographer(**_filter_args(Photographer,
                                               mods["photographer"]["args"]))
    return tuple(_load(m, mods[name]) for m, name in (
        (sculptor, "sculptor"), (fuser, "fuser"), (photographer, "photographer")))


def discriminator_from_checkpoint(checkpoint: Mapping[str, Any], device="cuda"):
    """The multi-scale discriminator of a checkpoint dict with its state
    dict loaded, on ``device``; None when the checkpoint has none or its
    args say ``no_discriminator``."""
    from ..pggan import MultiScaleDiscriminator

    entry = checkpoint.get("modules", {}).get("discriminator")
    if entry is None or checkpoint.get("args", {}).get("no_discriminator", False):
        return None
    args = dict(entry["args"])
    if args.get("block_config"):
        args["block_config"] = _to_block_config(args["block_config"])
    return _load(MultiScaleDiscriminator(**args, device=device), entry)


def generator_from_checkpoint(checkpoint: Mapping[str, Any]):
    """The IBR generator of a checkpoint dict with its state dict loaded, a
    ``UNet2d(in_channels, out_channels, block_config)``; None when the
    checkpoint has none."""
    gen = checkpoint.get("modules", {}).get("generator")
    if gen is None:
        return None
    args = _filter_args(UNet2d, gen["args"])
    args["block_config"] = _to_block_config(args["block_config"])
    module = UNet2d(**args)
    module.load_state_dict({k: torch.as_tensor(v) for k, v in gen["state_dict"].items()})
    return module
