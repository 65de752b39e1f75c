"""The DLRM embedding reduction, plainly: a bag's sum is the sum of its
rows, gathered from the whole table, in float64."""
from __future__ import annotations

import torch


def bag_sums(table: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """table (rows, dim); indices (bags, lookups) global rows -> (bags,
    dim) float64 sums."""
    rows = table.index_select(0, indices.reshape(-1).long())
    return rows.to(torch.float64).view(*indices.shape, -1).sum(1)


def relative_gap(got: list, want: list) -> float:
    """Largest |got - want| over every element, over the root mean square
    of ``want``: one number for many bags, scaled to what a sum holds."""
    worst, sumsq, n = 0.0, 0.0, 0
    for g, w in zip(got, want):
        worst = max(worst, float((g.to(torch.float64) - w).abs().max()))
        sumsq += float((w * w).sum())
        n += w.numel()
    return worst / max((sumsq / max(n, 1)) ** 0.5, 1e-300)
