"""Device and shard-backend resolution.

The port runs on the card unless the caller asks for the CPU: the default
device is ``cuda``, and with no CUDA runtime an entry point raises rather
than quietly falling back.  The CPU is reached only by naming it
(``device="cpu"``), which is what the tests do.

Backends follow from the device:

* ``pinned`` (``cuda``) — shard 0 lives in HBM, every slow shard in
  page-locked host memory that the kernels read and write in place
  through unified virtual addressing.
* ``modeled`` (``cpu``) — every shard is a plain host tensor; the tier
  split is accounting only (ledger, telemetry, perfmodel).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

BACKENDS = ("modeled", "pinned")

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless named otherwise.

    Raises when CUDA is asked for (explicitly or by default) and this
    process has no CUDA runtime or card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_backend(backend: Optional[str], device: torch.device) -> str:
    """The shard backend for ``device``; an explicit ``backend`` must agree.

    ``pinned`` needs a CUDA device and ``modeled`` the CPU: there is no
    quiet switch from one to the other."""
    natural = "pinned" if device.type == "cuda" else "modeled"
    if backend is None:
        return natural
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of {BACKENDS}")
    if backend != natural:
        need = "a CUDA device" if backend == "pinned" else "the CPU"
        raise RuntimeError(f"backend {backend!r} needs {need}, got {device}")
    return backend


def shard_storage(ordinal: int, backend: str, device: torch.device) -> dict:
    """``torch.empty`` keyword arguments placing device shard ``ordinal``:
    HBM for the fast shard, pinned host memory for slow shards on the
    ``pinned`` backend; the host for every shard on ``modeled``."""
    if backend == "pinned" and ordinal > 0:
        return {"device": "cpu", "pin_memory": True}
    return {"device": device}


def host_to_device(array, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """``torch.as_tensor(array, dtype=dtype, device=device)`` for host-built
    metadata (maps, segment tables); on a card the copy goes through
    pinned memory and does not make the host wait for the stream."""
    if device.type != "cuda":
        return torch.as_tensor(array, dtype=dtype, device=device)
    host = torch.as_tensor(array).to(dtype)
    return host.pin_memory().to(device, non_blocking=True)


def host_block(nbytes: int, device: torch.device, *,
               zero: bool = True) -> torch.Tensor:
    """``nbytes`` host bytes (a ``uint8`` tensor) for slow-tier state served
    to ``device``: page-locked for a card, pageable for the CPU; zeroed
    unless ``zero=False`` (then it holds what the memory last held).

    The card's block comes from PyTorch's pinned allocator, which rounds
    a request up to a power of two and keeps a freed block for the next
    request that fits.  (Host memory registered in place pins the exact
    size, but the card's kernels read it at a third of the allocator's
    rate: ``tools/offload_probe.py``.)"""
    nbytes = max(int(nbytes), 1)
    if device.type != "cuda":
        return torch.zeros(nbytes, dtype=torch.uint8)
    block = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    return block.zero_() if zero else block
