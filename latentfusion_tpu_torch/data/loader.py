"""Batches of a host dataset on the device (counterpart of
``latentfusion_tpu/data/loader.py``).

Items come from a ``torch.utils.data.DataLoader`` over the dataset: worker
processes, each with its own renderer (the dataset's ``worker_init_fn``),
send items one at a time as tensors in shared memory; the main process
stacks ``batch_size`` of them, from whichever workers are ready, into
pinned memory and copies the batch to the device on a side stream with
``non_blocking=True``, one batch ahead of the one being used. With
``num_workers=0`` items are made inline and deterministically.

``transport="quantized"`` sends float images in [0, 1] (``render``,
``mask``) as uint8 and ``depth`` as float16 from the workers, under a third
of the bytes; the batch widens back to float32 on the device.
"""
from __future__ import annotations

import contextlib
import itertools

import numpy as np
import torch

from ..device import resolve_device

TRANSPORTS = (None, "quantized")


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def collate(items):
    """Stack a list of items (nested dicts of numpy arrays) along a new
    batch axis."""
    first = items[0]
    if isinstance(first, dict):
        return {k: collate([item[k] for item in items]) for k in first}
    return np.stack(items)


def encode_transport(item):
    """Quantise an item for transport: the ``render`` and ``mask`` leaves
    (floats in [0, 1]) to uint8, ``depth`` to float16. uint8 color is within
    1/510 of the float image; float16 depth keeps about 1 mm at 2 m."""
    def enc(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = enc(v)
            elif k in ("render", "mask"):
                out[k] = np.clip(np.round(np.asarray(v, np.float32) * 255.0), 0, 255
                                 ).astype(np.uint8)
            elif k == "depth":
                out[k] = np.asarray(v, np.float16)
            else:
                out[k] = v
        return out

    return enc(item)


def _decode_leaf(x):
    if isinstance(x, np.ndarray):
        if x.dtype == np.uint8:
            return x.astype(np.float32) / 255.0
        return x.astype(np.float32) if x.dtype == np.float16 else x
    if x.dtype == torch.uint8:
        # A tensor divisor: CUDA divides by a Python scalar as a product with
        # its reciprocal, which can round otherwise than numpy's quotient.
        return x.float() / torch.tensor(255.0, device=x.device)
    return x.float() if x.dtype == torch.float16 else x


def decode_transport(batch):
    """Invert ``encode_transport`` (uint8 -> float32 / 255, float16 ->
    float32) on numpy arrays or on tensors where they lie; the same bits
    either way."""
    return tree_map(_decode_leaf, batch)


def to_tensors(batch):
    return tree_map(torch.from_numpy, batch)


def to_device(batch, device, stream=None):
    """Copy a batch of (pinned) host tensors to ``device`` with
    ``non_blocking=True``, on ``stream`` if given."""
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        return tree_map(lambda t: t.to(device, non_blocking=True), batch)


class _Stream(torch.utils.data.IterableDataset):
    """The dataset's items in a worker (or inline), after the dataset's
    ``worker_init_fn`` and, if asked, the quantised transport."""

    def __init__(self, dataset, transport, worker_offset: int = 0):
        super().__init__()
        self.dataset = dataset
        self.transport = transport
        self.worker_offset = worker_offset

    def __iter__(self):
        info = torch.utils.data.get_worker_info()
        self.dataset.worker_init_fn(self.worker_offset + (0 if info is None else info.id))
        for item in self.dataset:
            yield encode_transport(item) if self.transport == "quantized" else item


def _stack(items, pin: bool):
    """Stack a list of items (nested dicts of tensors) along a new batch
    axis, into pinned memory if ``pin``."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([item[k] for item in items], pin) for k in first}
    out = torch.empty((len(items), *first.shape), dtype=first.dtype, pin_memory=pin)
    return torch.stack(items, out=out)


class IterableLoader:
    """Infinite batches of ``batch_size`` items of ``dataset`` on ``device``
    (``device=None``: host numpy batches). On a CUDA device the batches are
    pinned and copied a batch ahead on a side stream; ``transport=
    "quantized"`` widens them there (``decode=False`` keeps host batches
    quantised). Asking for CUDA without a GPU raises.

    In a data-parallel run each rank's loader makes its own slice of every
    global batch (``batch_size`` is the slice's size) from a stream of its
    own: ``rank`` offsets the worker ids the dataset is seeded by (by
    ``max(num_workers, 1)`` a rank), so no two ranks draw the same items."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 0,
                 prefetch_factor: int = 2, device="cuda", transport=None,
                 decode: bool = True, rank: int = 0):
        if transport not in TRANSPORTS:
            raise ValueError(f"unknown transport {transport!r}")
        self.device = None if device is None else resolve_device(device)
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch_factor = prefetch_factor
        self.transport = transport
        self.decode = decode
        self.worker_offset = rank * max(num_workers, 1)
        self._iterator = None

    def shutdown(self):
        """Stop the worker processes."""
        it, self._iterator = self._iterator, None
        if it is not None and hasattr(it, "_shutdown_workers"):
            it._shutdown_workers()

    def _batches(self, pin: bool):
        self.shutdown()
        workers = self.num_workers
        # PyTorch's default start method (fork on Linux): the workers run
        # numpy, the rasterizer and torch on the CPU, never CUDA. Spawned
        # workers here aborted at exit now and then ("terminate called
        # without an active exception") as the loader shut down.
        self._iterator = iter(torch.utils.data.DataLoader(
            _Stream(self.dataset, self.transport, self.worker_offset), batch_size=None,
            num_workers=workers,
            collate_fn=to_tensors, prefetch_factor=self.prefetch_factor if workers else None))
        while True:
            yield _stack(list(itertools.islice(self._iterator, self.batch_size)), pin)

    def __iter__(self):
        quantized = self.transport == "quantized"
        if self.device is None:
            for batch in self._batches(pin=False):
                batch = tree_map(lambda t: t.numpy(), batch)
                yield decode_transport(batch) if quantized and self.decode else batch
        elif self.device.type != "cuda":
            for batch in self._batches(pin=False):
                batch = to_device(batch, self.device)
                yield decode_transport(batch) if quantized else batch
        else:
            yield from self._on_cuda(quantized)

    def _on_cuda(self, quantized: bool):
        stream = torch.cuda.Stream(device=self.device)

        def put(batch):
            with torch.cuda.stream(stream):
                batch = to_device(batch, self.device)
                if quantized:
                    batch = decode_transport(batch)
                done = torch.cuda.Event()
                done.record(stream)
            return batch, done

        batches = self._batches(pin=True)
        pending = put(next(batches))
        for batch in batches:
            (ready, done), pending = pending, put(batch)  # the next copy overlaps this use
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            tree_map(lambda t: t.record_stream(current), ready)
            yield ready
