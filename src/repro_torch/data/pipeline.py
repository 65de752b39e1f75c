"""Deterministic sharded token pipeline.

Batches are a pure function of (seed, step, shard) — so a restarted or
re-sharded worker reproduces the exact stream with no cursor files,
which is what makes the fault-tolerance test bit-exact.  Sources:
``synthetic`` (Zipf-ish token distribution) or a binary token file
(np.memmap).  Host-side prefetch uses the mover's double_buffer.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.core.mover import double_buffer


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int  # per-shard batch
    seq: int
    seed: int = 0
    shard_id: int = 0
    num_shards: int = 1
    path: Optional[str] = None  # binary uint32 token file; None = synthetic
    zipf_a: float = 1.2


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._mm = None
        if cfg.path is not None:
            self._mm = np.memmap(cfg.path, dtype=np.uint32, mode="r")
            if len(self._mm) < cfg.seq + 1:
                raise ValueError("token file shorter than one sequence")

    def batch_at(self, step: int) -> dict:
        """The batch for global ``step`` on this shard (pure function)."""
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, c.shard_id])
        )
        if self._mm is None:
            # Zipf-ish synthetic tokens, clipped into vocab
            raw = rng.zipf(c.zipf_a, size=(c.batch, c.seq + 1))
            toks = (raw - 1) % c.vocab
        else:
            max_start = len(self._mm) - (c.seq + 1)
            starts = rng.integers(0, max_start + 1, size=c.batch)
            toks = np.stack([self._mm[s : s + c.seq + 1] for s in starts])
            toks = toks % c.vocab
        toks = toks.astype(np.int32)
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:],
            "mask": np.ones((c.batch, c.seq), np.float32),
        }

    def iter_from(self, start_step: int = 0, prefetch: bool = True) -> Iterator[dict]:
        steps = _count_from(start_step)
        if prefetch:
            yield from double_buffer(steps, self.batch_at)
        else:
            for s in steps:
                yield self.batch_at(s)


def _count_from(start: int):
    s = start
    while True:
        yield s
        s += 1
