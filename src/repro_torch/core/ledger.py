"""Per-tier capacity accounting.

XLA's ``memory_analysis()`` proves the device-resident side of a program
fits; the ledger proves the *framework-managed* (staged host) side fits,
and produces the combined per-tier report used in EXPERIMENTS.md
§Dry-run.  Every planner decision registers its buffers here.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from repro_torch.core.tiers import TierTopology


class CapacityError(RuntimeError):
    pass


@dataclasses.dataclass
class LedgerEntry:
    buffer: str
    tier: str
    nbytes: int
    note: str = ""


class TierLedger:
    def __init__(self, topology: TierTopology):
        self.topology = topology
        self.entries: list[LedgerEntry] = []

    def register(self, buffer: str, tier: str, nbytes: int, note: str = "",
                 *, strict: bool = True) -> LedgerEntry:
        if nbytes < 0:
            raise ValueError("nbytes must be >= 0")
        self.topology.by_name(tier)  # validate tier exists
        e = LedgerEntry(buffer, tier, int(nbytes), note)
        self.entries.append(e)
        if strict:
            try:
                self.check(tiers=(tier,))
            except CapacityError:
                self.entries.pop()
                raise
        return e

    def release(self, buffer: str) -> int:
        freed = sum(e.nbytes for e in self.entries if e.buffer == buffer)
        self.entries = [e for e in self.entries if e.buffer != buffer]
        return freed

    def used(self, tier: str) -> int:
        return sum(e.nbytes for e in self.entries if e.tier == tier)

    def free(self, tier: str) -> int:
        return self.topology.by_name(tier).capacity_bytes - self.used(tier)

    def check(self, tiers=None) -> None:
        for t in self.topology.tiers:
            if tiers is not None and t.name not in tiers:
                continue
            if self.used(t.name) > t.capacity_bytes:
                raise CapacityError(
                    f"tier {t.name}: {self.used(t.name)/2**30:.2f} GiB used "
                    f"> {t.capacity_bytes/2**30:.2f} GiB capacity"
                )

    def per_buffer(self) -> dict[str, dict[str, int]]:
        out: dict[str, dict[str, int]] = defaultdict(lambda: defaultdict(int))
        for e in self.entries:
            out[e.buffer][e.tier] += e.nbytes
        return {k: dict(v) for k, v in out.items()}

    def report(self) -> str:
        lines = ["tier        used(GiB)  cap(GiB)  util"]
        for t in self.topology.tiers:
            used = self.used(t.name)
            lines.append(
                f"{t.name:<11s} {used/2**30:9.3f} {t.capacity_bytes/2**30:9.2f}"
                f"  {used/t.capacity_bytes*100:5.1f}%"
            )
        return "\n".join(lines)
