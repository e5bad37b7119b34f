"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device`` argument.

    The default is the GPU. Asking for CUDA on a machine without one
    raises: nothing falls back to the CPU unless the caller asks for it.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return device


def synchronize(device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU): host clocks
    around asynchronous GPU calls time the calls only after this."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
