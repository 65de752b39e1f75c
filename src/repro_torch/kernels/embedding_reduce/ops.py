"""Public wrappers for the embedding-bag reduction: the table form and the
routed form over an ``InterleavedTensor``'s page shards.

On the card (any CUDA or pinned host tensor among the arguments) each
launches the CUDA kernel or raises; the plain version runs only when
every tensor lies in pageable host memory.  ``LAUNCHES`` counts kernel
launches of both forms and nothing else; ``STAGED`` counts routed calls
that took the staged path (``kernel.stages``), each of
``kernel.STAGED_KERNELS`` launches."""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.kernels import common
from repro_torch.kernels.embedding_reduce import kernel, ref

#: kernel launches (never bumped by the plain version).
LAUNCHES = common.LaunchCounter()
#: routed calls that took the staged path
STAGED = common.LaunchCounter()
MAX_SHARDS = kernel.MAX_SHARDS


def embedding_reduce(table: torch.Tensor, indices: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """(V, D) x (B, K) -> (B, D).  Kernel on the card, plain on the CPU."""
    device = common.card_device(table, indices, weights)
    if device is None:
        return ref.embedding_reduce(table, indices, weights)
    out = kernel.embedding_reduce(table, indices, weights, device)
    LAUNCHES.bump()
    return out


def bag_reduce_routed(parts: Sequence[torch.Tensor], page_device: torch.Tensor,
                      page_local: torch.Tensor, page_rows: int,
                      indices: torch.Tensor,
                      weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Global (B, K) rows over at most ``MAX_SHARDS`` page shards ->
    (B, D) weighted sums, equal to the per-shard path
    (``ref.reduce_shards`` over table-form reductions) bit for bit.  One
    kernel launch on the card, or the staged path's kernels for a large
    call with a pinned shard; the plain version on the CPU; more shards
    raise on both."""
    if not 1 <= len(parts) <= MAX_SHARDS:
        raise ValueError(f"the routed reduction takes 1 to {MAX_SHARDS} "
                         f"shards; got {len(parts)}")
    tensors = (*parts, page_device, page_local, indices)
    device = common.card_device(
        *tensors, *(() if weights is None else (weights,)))
    if device is None:
        return ref.bag_reduce_routed(parts, page_device, page_local,
                                     page_rows, indices, weights)
    out, launched = kernel.bag_reduce_routed(
        parts, page_device, page_local, page_rows, indices, weights, device)
    LAUNCHES.bump(launched)
    if launched > 1:
        STAGED.bump()
    return out
