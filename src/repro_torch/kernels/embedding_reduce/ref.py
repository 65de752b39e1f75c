"""Plain PyTorch version of the embedding-bag reduction (DLRM §5.2 workload).

It repeats the kernel's arithmetic: an fp32 sum over ``k`` in order, one
multiply and one add per lookup (each rounded), then a cast to the table
dtype, so fp32 results are bit-identical to the kernel's.  It does not use
``.sum(1)``, whose order differs."""
from __future__ import annotations

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
