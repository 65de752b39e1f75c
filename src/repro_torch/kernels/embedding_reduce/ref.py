"""Plain PyTorch version of the embedding-bag reduction (DLRM §5.2 workload).

``embedding_reduce`` repeats the kernel's arithmetic: an fp32 sum over
``k`` in order, one multiply and one add per lookup (each rounded), then a
cast to the table dtype, so fp32 results are bit-identical to the
kernel's.  It does not use ``.sum(1)``, whose order differs.

``bag_reduce_routed`` is the routed form over the page shards of an
``InterleavedTensor``: ``route`` maps global rows to (shard, local row),
and ``reduce_shards`` runs one table-form reduction per shard (lookups
another shard owns weigh 0) and sums the partials in shard order.  The
tensor's own routing and its per-shard path are these two functions."""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def embedding_reduce(table: torch.Tensor, indices: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """table: (V, D); indices, weights: (B, K) -> (B, D) weighted sums."""
    B, K = indices.shape
    acc = torch.zeros((B,) + tuple(table.shape[1:]), dtype=torch.float32,
                      device=table.device)
    w = weights.to(torch.float32)
    for k in range(K):
        rows = table.index_select(0, indices[:, k]).to(torch.float32)
        acc = acc + rows * w[:, k].reshape((B,) + (1,) * (rows.ndim - 1))
    return acc.to(table.dtype)


def route(idx: torch.Tensor, page_device: torch.Tensor,
          page_local: torch.Tensor,
          page_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Global row -> (owning shard, local row), on the maps' device.  The
    page is the floor of ``idx / page_rows`` and the offset is taken from
    it before out-of-range pages clip to the first or last page."""
    idx = idx.to(device=page_device.device, dtype=torch.int64)
    page = torch.div(idx, page_rows, rounding_mode="floor")
    offset = idx - page * page_rows
    page = page.clamp(0, page_device.shape[0] - 1)
    return page_device[page], page_local[page] * page_rows + offset


def reduce_shards(parts: Sequence[torch.Tensor], dev: torch.Tensor,
                  local: torch.Tensor, weights: torch.Tensor,
                  reduce_fn: Callable) -> torch.Tensor:
    """One ``reduce_fn(table, indices, weights)`` per shard of rows, each
    lookup weighted by 0 outside its owner, partials summed in shard order
    (shards of 0 rows skipped)."""
    out = None
    for i, part in enumerate(parts):
        if part.shape[0] == 0:
            continue
        w_i = torch.where(dev == i, weights, 0).to(part.dtype)
        local_i = local.clamp(max=part.shape[0] - 1)
        partial = reduce_fn(part, local_i, w_i)
        out = partial if out is None else out + partial
    if out is None:  # zero-row tensor
        out = torch.zeros((dev.shape[0],) + tuple(parts[0].shape[1:]),
                          dtype=parts[0].dtype, device=dev.device)
    return out


def bag_reduce_routed(parts: Sequence[torch.Tensor], page_device: torch.Tensor,
                      page_local: torch.Tensor, page_rows: int,
                      indices: torch.Tensor,
                      weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, K) global rows over the shards -> (B, *feature) weighted sums
    (``weights=None``: all ones)."""
    if weights is None:
        weights = torch.ones(indices.shape, dtype=parts[0].dtype,
                             device=page_device.device)
    dev, local = route(indices, page_device, page_local, page_rows)
    return reduce_shards(parts, dev, local, weights, embedding_reduce)
