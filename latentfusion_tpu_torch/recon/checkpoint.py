"""Weights in and out of the port (counterpart of
``latentfusion_tpu/recon/checkpoint.py``).

The port's modules use the reference checkpoint's parameter names, which are
what ``latentfusion_tpu.recon.checkpoint.export_torch_state_dict`` emits:

    JAX   params/image_encoder/down_blocks_0/conv1/weight
    torch image_encoder.down_blocks.0.conv1.module.weight

``from_jax_params`` applies that renaming to JAX parameters given as numpy
arrays keyed by their pytree paths, and ``to_jax_params`` undoes it (the
layouts are the same in both packages); ``load_params_npz`` reads the
distill rigs' enumerated-leaf npz files with numpy alone, naming each leaf
by its pytree path from the companion ``*_keys.json``, and
``save_params_npz`` writes them in JAX's leaf order. ``nest_params`` and
``flatten_params`` move between path keys and the nested dicts of the JAX
trainer's pickled checkpoints.
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


def to_jax_params(state: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port's ``state_dict`` (keys led by a module name, ``sculptor.``,
    ``fuser.``, ...) -> JAX parameters keyed by pytree path in the keys json
    files' form (``"['sculptor']/['params']/['down_blocks_0']/..."``, flax's
    ``params`` level under each module name), in JAX's leaf order (each
    level's keys sorted). ``to_jax_params(from_jax_params(p)) == p`` for
    every tree of the zoo."""
    out = {}
    for key, value in state.items():
        parts = []
        for p in key.split("."):
            if p.isdigit():
                parts[-1] = f"{parts[-1]}_{p}"
            else:
                parts.append(p)
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().float().numpy()
        value = np.asarray(value)
        if len(parts) > 2 and parts[-2:] == ["module", "weight"] and value.ndim >= 2:
            parts = parts[:-2] + ["weight"]
        parts.insert(1, "params")
        out[tuple(parts)] = value
    return {"/".join(f"['{p}']" for p in path): out[path] for path in sorted(out)}


def nest_params(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """Pytree-path keys -> nested dicts."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        *heads, last = _path_parts(key)
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = value
    return tree


def flatten_params(tree: Mapping[str, Any], prefix=()) -> Dict[str, Any]:
    """Nested dicts -> pytree-path keys (the inverse of ``nest_params``)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            out.update(flatten_params(v, prefix + (k,)))
        else:
            out["/".join(f"['{p}']" for p in prefix + (k,))] = v
    return out


def save_params_npz(path, state: Mapping[str, Any], keys_json=None) -> None:
    """Write ``state`` as the JAX rigs' enumerated-leaf npz (leaf ``i`` as
    ``"i"``, in JAX's leaf order) and, with ``keys_json``, its pytree paths."""
    params = to_jax_params(state)
    np.savez(path, **{str(i): v for i, v in enumerate(params.values())})
    if keys_json is not None:
        with open(keys_json, "w") as f:
            json.dump(list(params), f)


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


def reference_entries(module_args: Mapping[str, Mapping[str, Any]], fuser) -> dict:
    """A reference ``.pth``'s module entries without their weights: each of
    ``module_args`` (the JAX modules' ``checkpoint_args()``) as ``{"args":
    ...}``, and the fuser's type, width and cube size."""
    return {**{name: {"args": dict(args)} for name, args in module_args.items()},
            "fuser": {"type": type(fuser).__name__,
                      "args": {"in_channels": getattr(fuser, "in_channels", None),
                               "cube_size": getattr(fuser, "cube_size", 1.0)}}}


def save_reference_checkpoint(path, entries: Mapping[str, Mapping[str, Any]],
                              state_dicts: Mapping[str, Mapping[str, Any]], *, name: str,
                              args: Mapping[str, Any], epoch: int = 0) -> None:
    """Write the reference-schema ``.pth`` (``tools/train_cube_demo.py:185-209``,
    the trainer's export): ``name``, ``epoch``, the run's ``args``, and for
    each module its entry (``reference_entries``) with its state dict on the
    CPU (numpy arrays are taken as tensors). Raises if the write fails."""
    torch.save({"name": name, "epoch": epoch, "meter_hists": {}, "args": dict(args),
                "modules": {
                    module: {**entry, "state_dict": {
                        k: torch.as_tensor(v).detach().cpu().clone()
                        for k, v in state_dicts[module].items()}}
                    for module, entry in entries.items()}},
               path)
