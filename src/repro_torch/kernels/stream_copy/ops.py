"""Public wrappers for the streaming migration copy: one slab
(:func:`stream_copy`) or a list of segments in one launch
(:func:`stream_copy_segments`).

On the card (a CUDA or pinned host tensor on either side) they launch the
CUDA kernel or raise; routes are HBM->HBM, pinned host->HBM, HBM->pinned
host and pinned->pinned.  The plain versions run only when every tensor
lies in pageable host memory.  ``LAUNCHES`` counts kernel launches and
nothing else; ``HELD`` keeps every pinned operand of a launch alive until
the launch has run, so that a caller may drop it at once (a move's old
shards)."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.kernels.stream_copy import kernel, ref

#: kernel launches (never bumped by the plain version).
LAUNCHES = common.LaunchCounter()
#: pinned operands of launches that may still be queued.
HELD = common.HostHold()


def _launched(tensors, device: torch.device) -> None:
    """Count a launch just queued on ``device``'s current stream and hold
    its pinned operands until it has run."""
    LAUNCHES.bump()
    HELD.keep_launched(tensors, device)


def stream_copy(src: torch.Tensor, *, out_dtype: Optional[torch.dtype] = None,
                out: Optional[torch.Tensor] = None,
                device=None) -> torch.Tensor:
    """A copy of ``src`` cast to ``out_dtype``, written into ``out`` when
    given (which fixes the destination memory), else into a new tensor
    beside ``src``.  ``device`` is the card that copies between pinned
    host tensors (default: the current one); a CUDA tensor fixes it."""
    out_dtype = out.dtype if out is not None else (out_dtype or src.dtype)
    if out is None and (src.is_cuda or src.is_pinned()):
        out = torch.empty(src.shape, dtype=out_dtype,
                          **({"device": src.device} if src.is_cuda
                             else {"pin_memory": True}))
    device = common.card_device(
        *(src,) if out is None else (src, out), device=device)
    if device is None:
        copy = ref.stream_copy(src, out_dtype)
        return copy if out is None else out.copy_(copy)
    if src.numel() == 0:
        return out
    kernel.stream_copy(src, out, device)
    _launched((src, out), device)
    return out


def stream_copy_segments(srcs: Sequence[torch.Tensor],
                         dsts: Sequence[torch.Tensor], segs: np.ndarray, *,
                         device=None) -> None:
    """Every segment of ``segs`` in one launch: row ``i`` (int64 columns
    ``kernel.SRC`` ... ``kernel.COLS``) copies ``rows x cols`` elements of
    base ``srcs[SRC]``, starting ``SRC_OFF`` elements in with rows
    ``SRC_STRIDE`` apart (0 repeats one row), into ``dsts[DST]`` likewise,
    cast to the destinations' dtype.  The bases are contiguous, one dtype
    a side, in HBM or pinned host memory; segments must not overlap a
    source or each other's destinations.  ``device`` as for
    :func:`stream_copy`."""
    live = [t for t in (*srcs, *dsts) if t.numel()]
    device = common.card_device(*live, device=device)
    if device is None:
        ref.stream_copy_segments(srcs, dsts, segs)
    elif kernel.stream_copy_segments(srcs, dsts, segs, device):
        _launched((*srcs, *dsts), device)
