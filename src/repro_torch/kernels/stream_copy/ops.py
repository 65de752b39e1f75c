"""Public wrapper for the streaming migration copy.

On the card (a CUDA or pinned host tensor on either side) it launches the
CUDA kernel or raises; routes are HBM->HBM, pinned host->HBM, HBM->pinned
host and pinned->pinned.  The plain version runs only when both sides lie
in pageable host memory.  ``LAUNCHES`` counts kernel launches and nothing
else."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import common
from repro_torch.kernels.stream_copy import kernel, ref

#: kernel launches (never bumped by the plain version).
LAUNCHES = common.LaunchCounter()


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
    LAUNCHES.bump()
    return out
