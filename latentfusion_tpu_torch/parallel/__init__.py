"""Process-group parallelism (counterpart of
``latentfusion_tpu/parallel/__init__.py``).

The JAX package shards arrays over a ``jax.sharding.Mesh`` and lets GSPMD
insert the collectives. Here every rank is a process: a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over all the ranks of the
default process group, and the collectives are explicit.

Axes:

- ``data``: the training batch. Each rank takes its slice of every global
  batch and the gradients are averaged over the ranks (``train/step.py``).
- ``hypothesis``: pose hypotheses. Every rank draws the full set from the
  same generator, renders its slice of each object's block, and the
  losses (and, in refinement, the gradients) are gathered, so every rank
  takes the same decisions (``pose/estimation.py``).
- ``fsdp``: parameters and optimizer state sharded ZeRO-3 style on a 2-D
  ``data x fsdp`` mesh by FSDP2's ``fully_shard`` (``shard_fsdp``).
- ``model``: tensor parallelism. Convolution weights are cut on their
  output channels; each rank computes its channels and every layer's output
  is gathered (``shard_tp``, which cuts the weights a rank holds but not
  the operations it does, so that the gathered output is the unsharded
  layer's bits).

The one gather the hypothesis and model axes need is ``all_gather``: an
``all_reduce`` of a zero-filled buffer in which each rank writes its slice.
It is exact (x + 0 = x) and runs on every backend, where gloo carries CUDA
tensors for ``all_reduce`` and ``broadcast`` but not for ``all_gather``,
and NCCL refuses two ranks on one device: two ranks can share one card
over gloo.

The process-group backend follows the device the caller names (NCCL for
``cuda``, gloo for ``cpu``) unless the caller names another. Nothing falls
back to one rank or to the CPU: a mesh with too few ranks raises.
"""
from __future__ import annotations

import functools
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..device import resolve_device

DATA_AXIS = "data"
HYPOTHESIS_AXIS = "hypothesis"
FSDP_AXIS = "fsdp"
MODEL_AXIS = "model"


# ---------------------------------------------------------------- the group
def backend_for(device) -> str:
    """The process-group backend of ``device``: NCCL for CUDA, gloo else."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device="cuda", backend: Optional[str] = None,
                     init_method: str = "env://", rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> Tuple[int, int, torch.device]:
    """Join the default process group that torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) describes, or, with another ``init_method`` (a
    ``tcp://`` or ``file://`` rendezvous), the group of ``world_size``
    ranks in which this one is ``rank``; on ``device`` (the card by
    default; it raises without one unless ``device="cpu"``). The backend
    follows the device unless ``backend`` names one. On CUDA with NCCL each
    rank takes the card of its local rank and raises when there is none.
    Returns (rank, world size, device); a group that is already up is kept,
    but its backend must be the one asked for."""
    device = resolve_device(device)
    backend = backend or backend_for(device)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                               f"not {backend}")
    elif init_method == "env://":
        missing = [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]
        if missing:
            raise RuntimeError(f"init_distributed: {', '.join(missing)} not set; "
                               "launch with torchrun")
        dist.init_process_group(backend, init_method=init_method)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    rank, world = dist.get_rank(), dist.get_world_size()
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        if backend == "nccl" and local >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local} has no card of its own "
                               f"({torch.cuda.device_count()} visible)")
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return rank, world, device


def _world(what: str, n: int) -> int:
    if not dist.is_initialized():
        raise RuntimeError(f"{what}: no process group; call init_distributed first")
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"{what}: requested {n} ranks but the process group has {world} — "
            "refusing to build a degraded mesh")
    if world > n:
        raise RuntimeError(
            f"{what}: requested {n} ranks but the process group has {world}; a "
            "mesh spans every rank (a rank outside it would have nothing to do)")
    return world


def make_mesh(n_devices: Optional[int] = None, axis_name: str = DATA_AXIS, device="cuda"):
    """1-D mesh over the ranks of the default group, named ``axis_name``,
    of ``device``'s type (the card by default; ``device="cpu"`` without
    one). Raises unless the group has exactly ``n_devices`` ranks (default:
    all)."""
    from torch.distributed.device_mesh import DeviceMesh

    device = resolve_device(device)
    n = _world("make_mesh", n_devices or (dist.get_world_size()
                                          if dist.is_initialized() else 1))
    return DeviceMesh(device.type, torch.arange(n), mesh_dim_names=(axis_name,))


def make_mesh_2d(n_data: int, n_fsdp: int, device="cuda"):
    """2-D ``data x fsdp`` mesh (rank = data index * n_fsdp + fsdp index) of
    ``device``'s type. Raises unless the group has exactly ``n_data *
    n_fsdp`` ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    device = resolve_device(device)
    n = _world("make_mesh_2d", n_data * n_fsdp)
    return DeviceMesh(device.type, torch.arange(n).reshape(n_data, n_fsdp),
                      mesh_dim_names=(DATA_AXIS, FSDP_AXIS))


def mesh_rank(mesh) -> Tuple[int, int]:
    """(this rank's index over every axis of ``mesh``, row-major; the
    mesh's size)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not in the mesh")
    shape = tuple(mesh.mesh.shape)
    return int(np.ravel_multi_index(tuple(coord), shape)), int(np.prod(shape))


def mesh_group(mesh):
    """The process group spanning every rank of ``mesh``."""
    return mesh.get_group() if mesh.ndim == 1 else dist.group.WORLD


# ------------------------------------------------------------ collectives
def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) stacked in rank order,
    (size, *x.shape): an ``all_reduce`` of a zero-filled buffer in which
    each rank writes its slice. Exact, and carried by gloo for CUDA
    tensors."""
    rank, size = mesh_rank(mesh)
    buf = x.new_zeros((size, *x.shape))
    buf[rank] = x
    dist.all_reduce(buf, group=mesh_group(mesh))
    return buf


def all_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``mesh`` (a new tensor)."""
    out = x.detach().clone()
    dist.all_reduce(out, group=mesh_group(mesh))
    return out / mesh_rank(mesh)[1]


# ---------------------------------------------------------------- batches
def batch_slice(length: int, rank: int, size: int, microbatches: int = 1) -> torch.Tensor:
    """The indices of rank ``rank`` of ``size``'s slice of a global batch of
    ``length`` (object-major): of each of the ``microbatches`` consecutive
    groups, the rank's consecutive part. Local microbatch i is then the
    rank's part of global microbatch i, as in the JAX step under a sharded
    batch."""
    if length % (size * microbatches):
        raise ValueError(f"a batch of {length} does not split into {microbatches} "
                         f"microbatches over {size} ranks")
    part = length // (size * microbatches)
    idx = torch.arange(length).reshape(microbatches, size, part)
    return idx[:, rank].reshape(-1)


def shard_batch(tree, mesh, microbatches: int = 1):
    """This rank's slice (``batch_slice``) of the leading axis of every
    leaf: tensors, cameras and observations (their frames), in nested
    dicts. A camera of B V cameras for B objects is cut by objects: pass
    the tree whose tensors lead with B, and the cameras follow them."""
    lengths = set()

    def batch_len(t):
        if isinstance(t, Mapping):
            for v in t.values():
                batch_len(v)
        elif isinstance(t, torch.Tensor):
            lengths.add(t.shape[0])

    batch_len(tree)
    b = min(lengths) if lengths else len(tree)
    idx = batch_slice(b, *mesh_rank(mesh), microbatches)

    def take(t):
        if isinstance(t, Mapping):
            return {k: take(v) for k, v in t.items()}
        n = t.shape[0] if isinstance(t, torch.Tensor) else len(t)
        if n % b:
            raise ValueError(f"a leaf of {n} is not a multiple of the batch {b}")
        per = n // b
        rows = (idx[:, None] * per + torch.arange(per)).reshape(-1)
        return t[rows.to(t.device)] if isinstance(t, torch.Tensor) else t[rows]

    return take(tree)


def replicate(tree, mesh, src: int = 0):
    """Broadcast every tensor of ``tree`` (nested dicts, in place) from rank
    ``src`` of ``mesh``; returns the tree."""
    group = mesh_group(mesh)

    def bcast(t):
        if isinstance(t, Mapping):
            for v in t.values():
                bcast(v)
        elif isinstance(t, torch.Tensor):
            # A mesh spans ranks 0..size-1 in order: its index is the global rank.
            dist.broadcast(t, src=src, group=group)

    bcast(tree)
    return tree


# ------------------------------------------------------------------- FSDP
def fsdp_spec(shape: Sequence[int], n_fsdp: int, axis_name: str = FSDP_AXIS,
              min_leaf_size: int = 2 ** 12) -> tuple:
    """The JAX package's ``PartitionSpec`` as a tuple: the largest dim
    divisible by ``n_fsdp`` takes the axis; leaves under ``min_leaf_size``
    elements and leaves with no divisible dim stay whole (``()``)."""
    size = int(np.prod(shape)) if len(shape) else 1
    if size < min_leaf_size:
        return ()
    best = None
    for i, d in enumerate(shape):
        if d % n_fsdp == 0 and (best is None or d > shape[best]):
            best = i
    if best is None:
        return ()
    spec = [None] * len(shape)
    spec[best] = axis_name
    return tuple(spec)


def fsdp_dim(shape: Sequence[int], n_fsdp: int, min_leaf_size: int = 2 ** 12) -> int:
    """The dim ``fully_shard`` cuts a leaf on: ``fsdp_spec``'s. FSDP2 keeps
    no parameter whole, so a leaf that JAX leaves replicated (small, or
    with no divisible dim) is cut on dim 0, where FSDP2 pads uneven shards.
    That changes the layout, not what is computed."""
    spec = fsdp_spec(shape, n_fsdp, FSDP_AXIS, min_leaf_size)
    return spec.index(FSDP_AXIS) if spec else 0


def fsdp_shardings(module: nn.Module, mesh, min_leaf_size: int = 2 ** 12) -> Dict[str, int]:
    """Each parameter's FSDP dim (``fsdp_dim``), by name, for the ``fsdp``
    axis of ``mesh``."""
    n = mesh.size(mesh.mesh_dim_names.index(FSDP_AXIS))
    return {name: fsdp_dim(tuple(p.shape), n, min_leaf_size)
            for name, p in module.named_parameters()}


def shard_fsdp(modules: Mapping[str, nn.Module], mesh, min_leaf_size: int = 2 ** 12):
    """``fully_shard`` each module on ``mesh`` (a ``data x fsdp`` mesh:
    replicated over ``data``, sharded over ``fsdp``), each parameter on its
    ``fsdp_dim``. The optimizer built afterwards over the sharded
    parameters keeps its state sharded alike. FSDP2 averages the gradients
    over every rank of the mesh. Returns the modules."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    n = mesh.size(mesh.mesh_dim_names.index(FSDP_AXIS))

    def placement(param):
        return Shard(fsdp_dim(tuple(param.shape), n, min_leaf_size))

    for module in modules.values():
        if module is not None and any(True for _ in module.parameters()):
            fully_shard(module, mesh=mesh, shard_placement_fn=placement)
    return modules


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every sharded tensor gathered whole (a
    collective under FSDP: every rank calls it)."""
    from torch.distributed.tensor import DTensor

    return {k: v.full_tensor() if isinstance(v, DTensor) else v
            for k, v in module.state_dict().items()}


# ---------------------------------------------------------- tensor parallel
def tp_spec(shape: Sequence[int], n_model: int, axis_name: str = MODEL_AXIS,
            min_leaf_size: int = 2 ** 12) -> tuple:
    """The JAX package's tensor-parallel ``PartitionSpec`` as a tuple: dim
    0 (the out-channels of a ``(out, in, *k)`` weight) takes the axis,
    unless the leaf is under ``min_leaf_size`` elements or dim 0 does not
    divide."""
    size = int(np.prod(shape)) if len(shape) else 1
    if size < min_leaf_size or not shape or shape[0] % n_model != 0:
        return ()
    return (axis_name,)


def tp_shardings(module: nn.Module, mesh, min_leaf_size: int = 2 ** 12) -> Dict[str, tuple]:
    """Each parameter's ``tp_spec`` by name, for the 1-D ``model`` mesh."""
    n = mesh.size()
    return {name: tp_spec(tuple(p.shape), n, mesh.mesh_dim_names[0], min_leaf_size)
            for name, p in module.named_parameters()}


def shard_tp(module: nn.Module, mesh, min_leaf_size: int = 2 ** 12) -> int:
    """Tensor-parallel ``module`` in place: each equalized convolution whose
    weight ``tp_spec`` cuts keeps only this rank's out-channels of its
    weight, and its bias-free output is summed over the ranks after each
    call, before the He constant and the bias. A rank convolves at the
    layer's whole shape, its rows in place and the others zero: cuDNN then
    runs the whole layer's algorithm, so this rank's channels carry the
    unsharded layer's bits, and the sum is ``all_gather``'s (x + 0 = x),
    exact. A convolution of only the rank's channels is another cuDNN
    problem whose sums run in another order, and the flagship decode's depth
    moves by 1.8e-5 of its largest value from that alone. So the weights
    each rank holds are cut, not the operations it does. The bias stays
    whole on every rank even where ``tp_spec`` cuts it (only at a
    ``min_leaf_size`` of its length or less): that changes its layout, not
    what is computed. Layers whose weight stays whole run whole on every
    rank. Returns the number of convolutions cut."""
    from ..modules.equalized import EqualizedConv

    specs = tp_shardings(module, mesh, min_leaf_size)
    rank, size = mesh_rank(mesh)
    group = mesh_group(mesh)
    convs = {name: m for name, m in module.named_modules() if isinstance(m, EqualizedConv)}
    owned = {f"{name}.module.weight" for name in convs} | {f"{name}.bias" for name in convs}
    stray = [k for k, spec in specs.items() if spec and k not in owned]
    if stray:
        raise NotImplementedError(f"shard_tp cuts equalized convolutions only: {stray}")

    def cut_forward(conv, before, after, x, weight, bias):
        full = torch.cat([weight.new_zeros((before, *weight.shape[1:])), weight,
                          weight.new_zeros((after, *weight.shape[1:]))])
        y = type(conv)._conv_forward(conv, x, full, bias)
        dist.all_reduce(y, group=group)
        return y

    count = 0
    for name, conv in convs.items():
        if not specs[f"{name}.module.weight"]:
            continue
        weight = conv.module.weight
        part = weight.shape[0] // size
        conv.module.weight = nn.Parameter(weight.detach()[rank * part:(rank + 1) * part].clone(),
                                          requires_grad=weight.requires_grad)
        # Both of EqualizedConv's dtype paths convolve through _conv_forward.
        conv.module._conv_forward = functools.partial(
            cut_forward, conv.module, rank * part, (size - rank - 1) * part)
        count += 1
    return count


# ------------------------------------------------------------- hypotheses
class HypothesisShard:
    """This rank's part of B object-major blocks of ``n`` hypotheses on a
    1-D mesh: the rank takes positions [r m, (r + 1) m) of every block, m =
    n / size. ``take`` cuts a tree of (B n, ...) leaves to (B m, ...);
    ``gather`` puts the ranks' (B m, ...) results back into (B n, ...)."""

    def __init__(self, mesh, num_objects: int, n: int):
        self.mesh = mesh
        self.rank, self.size = mesh_rank(mesh)
        self.num_objects, self.n = num_objects, n
        self.m = n // self.size
        idx = (torch.arange(num_objects)[:, None] * n + self.rank * self.m
               + torch.arange(self.m)[None])
        self.index = idx.reshape(-1)

    def take(self, x):
        """(B n, ...) -> this rank's (B m, ...): tensors, cameras and
        observations; a leaf of length 1 (a target frame the losses
        broadcast) and None pass through."""
        if x is None or len(x) == 1:
            return x
        if len(x) != self.num_objects * self.n:
            raise ValueError(f"a leaf of {len(x)} is not {self.num_objects} blocks of {self.n}")
        return x[self.index.to(x.device) if isinstance(x, torch.Tensor) else self.index]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' (B m, ...) as (B n, ...)."""
        buf = all_gather(x.reshape(self.num_objects, self.m, *x.shape[1:]), self.mesh)
        buf = buf.movedim(0, 1)  # (B, size, m, ...)
        return buf.reshape(self.num_objects * self.n, *x.shape[1:])
