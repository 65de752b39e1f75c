"""Public wrappers for MEMO's measure-mode probes: sequential loads and
stores over lanes, random-block loads and a dependent pointer chase.

On the card (a CUDA or pinned host table) each launches the CUDA kernel
or raises; the plain version runs only when the table lies in pageable
host memory.  Pinned tables are read and written in place.
``LAUNCHES`` counts kernel launches and nothing else; ``HELD`` keeps a
launch's pinned operands alive until it has run."""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.memo_probe import kernel, ref

#: kernel launches (never bumped by the plain version).
LAUNCHES = common.LaunchCounter()
#: pinned operands of launches that may still be queued.
HELD = common.HostHold()


def _launched(tensors, device: torch.device) -> None:
    LAUNCHES.bump()
    HELD.keep_launched(tensors, device)


def seq_load(x: torch.Tensor, lanes: int) -> torch.Tensor:
    """(lanes,) fp32: each lane's sum of its contiguous slice of ``x``."""
    device = common.card_device(x)
    if device is None:
        return ref.seq_load(x, lanes)
    out = kernel.seq_load(x, lanes, device)
    _launched((x,), device)
    return out


def seq_store(x: torch.Tensor, lanes: int, v) -> torch.Tensor:
    """``x`` with each lane's slice set to ``v[lane]``, in place."""
    device = common.card_device(x)
    if device is None:
        return ref.seq_store(x, lanes, torch.as_tensor(v))
    v = torch.as_tensor(v).to(device=device, dtype=torch.float32)
    kernel.seq_store(x, lanes, v, device)
    _launched((x,), device)
    return x


def random_block_load(x: torch.Tensor, starts, block_elems: int
                      ) -> torch.Tensor:
    """The sum of ``x``'s blocks of ``block_elems`` from ``starts`` (placed
    as ``lax.dynamic_slice`` places them): a scalar for (n,) starts, one a lane for
    (lanes, n), one block of threads a lane on the card."""
    device = common.card_device(x)
    if device is None:
        return ref.random_block_load(x, torch.as_tensor(starts), block_elems)
    starts = torch.as_tensor(starts)
    if not (starts.is_cuda or starts.is_pinned()):
        starts = starts.to(device)
    starts = starts.to(torch.int32).contiguous()
    out = kernel.random_block_load(x, starts, block_elems, device)
    _launched((x, starts), device)
    return out


def pointer_chase(perm: torch.Tensor, steps: int,
                  start: int = 0) -> torch.Tensor:
    """``p = perm[p]`` ``steps`` times from ``start``: the last ``p``,
    0-dim int32."""
    device = common.card_device(perm)
    if device is None:
        return ref.pointer_chase(perm, steps, start)
    out = kernel.pointer_chase(perm, steps, start, device)
    _launched((perm,), device)
    return out
