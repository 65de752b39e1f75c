"""The one generator of every cell's inputs, driven by the traffic file's
parameters and the run's seed.  Everything is drawn on the device, in a
few large calls; the same seed gives the same inputs.

* Bag lookups (DLRM): ``bags`` bags of ``lookups`` rows a batch over a
  table of ``n_keys`` keys of ``rows_per_key`` rows.  ``distribution``
  ``zipf``: keys Zipf(``zipf_alpha``) over a random permutation of the
  keys, a uniform row within the key; ``uniform``: rows uniform over the
  whole table.
* Token batches (training): ``batch`` rows of ``seq + 1`` tokens uniform
  over the vocabulary, inputs and next-token labels, one independent
  draw a step.
"""
from __future__ import annotations

import torch

from cxlbench.common import generator

#: input streams of a run (see ``common.generator``)
STREAM_KEY_ORDER, STREAM_BAGS, STREAM_TOKENS = 1, 2, 1000
#: batches drawn at once (bounds the temporaries to ~100 MB)
CHUNK_BATCHES = 16


class BagTraffic:
    """Batches of bag lookups, int32 global rows of shape (n, bags,
    lookups); :meth:`draw` continues one stream."""

    def __init__(self, traffic: dict, *, n_keys: int, rows_per_key: int,
                 lookups: int, seed: int, device: torch.device):
        self.kind = traffic["distribution"]
        if self.kind not in ("zipf", "uniform"):
            raise ValueError(f"unknown distribution {self.kind!r}")
        self.bags = int(traffic["bags"])
        self.lookups = int(lookups)
        self.n_keys, self.rows_per_key = int(n_keys), int(rows_per_key)
        self.device = device
        self.gen = generator(seed, STREAM_BAGS, device)
        if self.kind == "zipf":
            g = generator(seed, STREAM_KEY_ORDER, device)
            self.perm = torch.randperm(self.n_keys, generator=g, device=device)
            ranks = torch.arange(self.n_keys, dtype=torch.float64,
                                 device=device)
            p = (1.0 + ranks) ** -float(traffic["zipf_alpha"])
            self.cdf = torch.cumsum(p / p.sum(), 0)

    def draw(self, n_batches: int) -> torch.Tensor:
        out = torch.empty((n_batches, self.bags, self.lookups),
                          dtype=torch.int32, device=self.device)
        for lo in range(0, n_batches, CHUNK_BATCHES):
            shape = (min(CHUNK_BATCHES, n_batches - lo), self.bags,
                     self.lookups)
            out[lo:lo + shape[0]] = self._rows(shape)
        return out

    def _rows(self, shape) -> torch.Tensor:
        g, dev = self.gen, self.device
        if self.kind == "uniform":
            return torch.randint(0, self.n_keys * self.rows_per_key, shape,
                                 generator=g, device=dev, dtype=torch.int64)
        u = torch.rand(shape, generator=g, device=dev, dtype=torch.float64)
        rank = torch.clamp_max(torch.searchsorted(self.cdf, u),
                               self.n_keys - 1)
        within = torch.randint(0, self.rows_per_key, shape, generator=g,
                               device=dev, dtype=torch.int64)
        return self.perm[rank] * self.rows_per_key + within


def token_batch(seed: int, step: int, *, batch: int, seq: int, vocab: int,
                device: torch.device) -> dict:
    """Step ``step``'s batch (steps count from 0): ``tokens`` and
    ``labels`` (batch, seq) int64, the labels the tokens shifted by one."""
    g = generator(seed, STREAM_TOKENS + step, device)
    toks = torch.randint(0, vocab, (batch, seq + 1), generator=g,
                         device=device, dtype=torch.int64)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
