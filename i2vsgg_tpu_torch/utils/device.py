"""Device selection for the port's entry points."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on.

    ``cuda`` (the default) must find a card: with none, this raises rather
    than carrying on quietly on the CPU. ``cpu`` is taken only when the
    caller asks for it, as the tests do. Under torchrun (a process group
    and ``LOCAL_RANK``), ``cuda`` is the rank's card ``cuda:LOCAL_RANK``.
    """
    dev = torch.device(device)
    if (dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in
            os.environ and dist.is_available() and dist.is_initialized()):
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev
