"""Public wrappers for flash-decode attention and the KV append scatter.

On the card (any CUDA or pinned host tensor among the arguments) they
launch the CUDA kernels or raise; the plain versions run only when every
tensor lies in pageable host memory.  ``LAUNCHES`` counts launches of the
attention kernel (either form) and ``APPEND_LAUNCHES`` those of the append
scatter, and nothing else."""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.decode_attention import kernel, ref

#: attention kernel launches, either form (never bumped by the plain version).
LAUNCHES = common.LaunchCounter()
#: append-scatter launches (never bumped by the plain version).
APPEND_LAUNCHES = common.LaunchCounter()


def attend_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid: torch.Tensor):
    """Unnormalised attention over one KV partition: (acc, m, l) in fp32."""
    device = common.card_device(q, k, v, valid)
    if device is None:
        return ref.attend_partial(q, k, v, valid)
    out = kernel.attend_partial(q, k, v, valid, device)
    LAUNCHES.bump()
    return out


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """(B,H,hd) fp32 attention over each row's first ``lengths[b]``
    positions (0 where ``lengths[b] == 0``)."""
    device = common.card_device(q, k, v, lengths)
    if device is None:
        return ref.decode_attention(q, k, v, lengths)
    out = kernel.decode_attention(q, k, v, lengths, device)
    LAUNCHES.bump()
    return out


def kv_append(k_pool: torch.Tensor, v_pool: torch.Tensor, rows: torch.Tensor,
              k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """In place: ``k_pool[b, rows[b]] = k_new[b]`` (and V) for every b whose
    row lies in ``[0, T)``; the others are dropped."""
    device = common.card_device(k_pool, v_pool, rows, k_new, v_new)
    if device is None:
        ref.kv_append(k_pool, v_pool, rows, k_new, v_new)
        return
    kernel.kv_append(k_pool, v_pool, rows, k_new, v_new, device)
    APPEND_LAUNCHES.bump()

