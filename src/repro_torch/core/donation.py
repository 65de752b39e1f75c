"""In-place shard updates for tier actuation, and the full-copy counter.

A stable-path repartition plans, ships and re-indexes in O(Δ); what is
left is writing the moved rows into the receiving shard.  Without
donation that write goes to a fresh copy of the whole shard (the parent
tensor stays valid), which is what ``FULL_SHARD_COPIES`` counts.  When the
caller provably drops the parent tensor — the Caption actuation pattern
``it = it.repartition_weights(..., donate=True)`` — the copy is pure
waste: :func:`donated_update` writes the rows into the receiving shard in
place (``index_copy_`` / ``index_add_``), so the shard keeps its storage
and its ``data_ptr()``.

DONATION CONTRACT: passing ``donate=True`` anywhere upstream asserts that
the parent object — and any ancestor sharing the receiving shards — is
dead after the call: its shards now hold the child's data.

Staging data must be a copy, never a view of the receiving shard, or the
in-place write could clobber rows it still has to read.
"""
from __future__ import annotations

import torch


class CopyCounter:
    """Counts full receiving-shard materializations (bench/test probe)."""

    __slots__ = ("count",)

    def __init__(self) -> None:
        self.count = 0

    def bump(self, n: int = 1) -> None:
        self.count += n

    def reset(self) -> int:
        out, self.count = self.count, 0
        return out


#: full copy-on-write shard materializations since last reset — the
#: quantity the donated path eliminates on the stable path.
FULL_SHARD_COPIES = CopyCounter()


def donated_update(part: torch.Tensor, rows: torch.Tensor,
                   values: torch.Tensor, op: str = "set") -> torch.Tensor:
    """In place: ``part[rows] = values`` (``op="set"``, distinct rows) or
    ``part[rows] += values`` (``op="add"``, duplicates accumulate).

    ``rows`` (int64) and ``values`` must lie beside ``part``; rows at or
    past ``part.shape[0]`` are dropped, as the reference's scatter drops
    them.  Returns ``part`` itself."""
    rows = rows.to(device=part.device, dtype=torch.int64)
    values = values.to(device=part.device, dtype=part.dtype)
    keep = rows < part.shape[0]
    if not bool(keep.all()):
        rows, values = rows[keep], values[keep]
    if op == "set":
        return part.index_copy_(0, rows, values)
    if op == "add":
        return part.index_add_(0, rows, values)
    raise ValueError(f"unknown op {op!r}")
