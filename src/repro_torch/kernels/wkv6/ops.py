"""Public wrapper for the RWKV6 WKV recurrence.

On the card (any CUDA or pinned host tensor among the arguments) it
launches the CUDA kernel or raises; the plain version runs only when
every tensor lies in pageable host memory.  ``LAUNCHES`` counts kernel
launches and nothing else."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import common
from repro_torch.kernels.wkv6 import kernel, ref

#: kernel launches (never bumped by the plain version).
LAUNCHES = common.LaunchCounter()


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor, *,
         state_out: Optional[torch.Tensor] = None):
    """(B,T,H,hd) r, k, v, w; (H,hd) u; (B,H,hd,hd) state -> (y fp32,
    final state fp32).  Any T >= 1; ``state_out`` may alias ``state``."""
    extra = () if state_out is None else (state_out,)
    device = common.card_device(r, k, v, w, u, state, *extra)
    if device is None:
        return ref.wkv6(r, k, v, w, u, state, state_out=state_out)
    out = kernel.wkv6(r, k, v, w, u, state, state_out, device)
    LAUNCHES.bump()
    return out
