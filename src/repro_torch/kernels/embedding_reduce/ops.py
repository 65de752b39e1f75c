"""Public wrapper for the embedding-bag reduction.

On the card (any CUDA or pinned host tensor among the arguments) it
launches the CUDA kernel or raises; the plain version runs only when
every tensor lies in pageable host memory.  ``LAUNCHES`` counts kernel
launches and nothing else."""
from __future__ import annotations

import torch

from repro_torch.kernels import common
from repro_torch.kernels.embedding_reduce import kernel, ref

#: kernel launches (never bumped by the plain version).
LAUNCHES = common.LaunchCounter()


def embedding_reduce(table: torch.Tensor, indices: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """(V, D) x (B, K) -> (B, D).  Kernel on the card, plain on the CPU."""
    device = common.card_device(table, indices, weights)
    if device is None:
        return ref.embedding_reduce(table, indices, weights)
    out = kernel.embedding_reduce(table, indices, weights, device)
    LAUNCHES.bump()
    return out
