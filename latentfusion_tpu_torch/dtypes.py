"""The global compute-dtype policy (counterpart of
``latentfusion_tpu/dtypes.py``).

Training under ``--use-amp`` runs the equalized convolutions (and the
factor projections' contractions, which are 1x1 equalized convolutions) in
bfloat16 with fp32 parameters, their outputs, bias included, staying in
bfloat16; K1-fwd reads its volume and stores its samples in the compute
dtype. Everything else runs in the dtype its inputs arrive in. bfloat16
needs no loss scaling. fp32 is the default, and every parity test runs in
it.
"""
from __future__ import annotations

import contextlib

import torch

_NAMES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_COMPUTE_DTYPE = torch.float32


def set_compute_dtype(dtype) -> None:
    """``torch.float32``, ``torch.bfloat16`` or their names."""
    global _COMPUTE_DTYPE
    dtype = _NAMES[dtype] if isinstance(dtype, str) else dtype
    if dtype not in _NAMES.values():
        raise ValueError(f"compute dtype must be float32 or bfloat16, not {dtype}")
    _COMPUTE_DTYPE = dtype


def get_compute_dtype() -> torch.dtype:
    return _COMPUTE_DTYPE


@contextlib.contextmanager
def compute_dtype(dtype=None):
    """Within the block the compute dtype is ``dtype`` (kept as it is when
    None); the one before it is restored on every exit. As a decorator of a
    tool's ``main`` (``@compute_dtype()``) it undoes what ``main`` sets, so
    a caller in the same process keeps its own policy."""
    previous = _COMPUTE_DTYPE
    if dtype is not None:
        set_compute_dtype(dtype)
    try:
        yield
    finally:
        set_compute_dtype(previous)
