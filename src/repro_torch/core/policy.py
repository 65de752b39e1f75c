"""Placement policies: the numactl / Linux-mempolicy analogue.

The paper drives all of its application studies (§5) through numactl's
``membind`` / ``preferred`` / ``interleave`` modes plus the then-new
kernel patch for **weighted (N:M) interleaving** across memory nodes
[Weiner, 30].  ``MemPolicy`` reproduces that interface at the framework
level: a policy maps the pages of one logical buffer onto tiers.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Sequence

import numpy as np


def largest_remainder_split(quotas: Sequence[float], units: int,
                            caps: Sequence[int] | None = None
                            ) -> tuple[list[int], int]:
    """Split ``units`` integer slots across buckets with real quotas.

    Floor each quota, then deal the remaining slots one at a time in
    descending fractional-remainder order (cycling), skipping buckets at
    their ``caps``.  The one rounding discipline shared by the N:M policy
    builder, the planner's capacity-aware quantizer, and the minimal-move
    page targets — three hand-rolled copies WILL drift apart.  Returns
    ``(counts, shortfall)``; shortfall > 0 only when every bucket is
    capped."""
    n = len(quotas)
    if n == 0 or units <= 0:
        return [0] * n, max(units, 0)
    base = [int(q) for q in quotas]
    if sum(base) > units:
        # Quotas over-promise (e.g. clamped inputs): rebase proportionally.
        total_q = sum(quotas) or 1.0
        quotas = [q * units / total_q for q in quotas]
        base = [int(q) for q in quotas]
    if caps is not None:
        base = [min(b, c) for b, c in zip(base, caps)]
    order = sorted(range(n), key=lambda i: quotas[i] - base[i], reverse=True)
    need = units - sum(base)
    while need > 0:
        progressed = False
        for i in order:
            if need <= 0:
                break
            if caps is not None and base[i] + 1 > caps[i]:
                continue
            base[i] += 1
            need -= 1
            progressed = True
        if not progressed:
            break
    return base, need


class PolicyKind(enum.Enum):
    MEMBIND = "membind"  # all pages on one tier
    PREFERRED = "preferred"  # fill preferred tier, overflow to next
    INTERLEAVE = "interleave"  # round-robin 1:1
    WEIGHTED_INTERLEAVE = "weighted"  # N:M round-robin (kernel patch analogue)


class BufferClass(enum.Enum):
    """Named buffer classes the planner knows how to reason about."""

    PARAMS = "params"
    GRADS = "grads"
    OPT_STATE = "opt_state"
    KV_CACHE = "kv_cache"
    EMBEDDING = "embedding"
    ACTIVATION = "activation"
    RECURRENT_STATE = "recurrent_state"
    DATA = "data"


@dataclasses.dataclass(frozen=True)
class MemPolicy:
    """Page placement policy over an ordered list of tier names.

    ``weights[i]`` pages go to ``tiers[i]`` per round-robin cycle — the
    N:M interleave of the paper (e.g. DRAM:CXL = 30:1 is 3.23% on CXL).
    """

    kind: PolicyKind
    tiers: tuple[str, ...]
    weights: tuple[int, ...] = ()

    def __post_init__(self):
        if self.kind == PolicyKind.WEIGHTED_INTERLEAVE:
            if len(self.weights) != len(self.tiers):
                raise ValueError("weighted interleave needs one weight per tier")
            if any(w < 0 for w in self.weights) or sum(self.weights) == 0:
                raise ValueError("weights must be non-negative, not all zero")

    @staticmethod
    def membind(tier: str) -> "MemPolicy":
        return MemPolicy(PolicyKind.MEMBIND, (tier,))

    @staticmethod
    def preferred(tier: str, fallback: str) -> "MemPolicy":
        return MemPolicy(PolicyKind.PREFERRED, (tier, fallback))

    @staticmethod
    def interleave(tiers: Sequence[str]) -> "MemPolicy":
        return MemPolicy(PolicyKind.INTERLEAVE, tuple(tiers))

    @staticmethod
    def weighted(tiers: Sequence[str], weights: Sequence[int]) -> "MemPolicy":
        return MemPolicy(
            PolicyKind.WEIGHTED_INTERLEAVE, tuple(tiers), tuple(int(w) for w in weights)
        )

    @staticmethod
    def from_slow_fraction(fast: str, slow: str, fraction: float,
                           denominator: int = 64,
                           round_up: bool = False) -> "MemPolicy":
        """Build the N:M policy closest to placing ``fraction`` on ``slow``.

        Uses the smallest denominator within tolerance so short page runs
        still realize the ratio (a 64-long blocky cycle would leave an
        8-page cache entirely on the fast tier at 50%).  ``round_up``
        guarantees slow_fraction >= fraction (capacity spills must never
        under-shoot)."""
        if fraction <= 0.0:
            return MemPolicy.membind(fast)
        if fraction >= 1.0:
            return MemPolicy.membind(slow)
        import math
        from fractions import Fraction
        if round_up:
            fr = Fraction(math.ceil(fraction * denominator - 1e-12),
                          denominator)
        else:
            fr = Fraction(fraction).limit_denominator(denominator)
        if fr.numerator == 0:
            fr = Fraction(1, denominator)
        m, d = fr.numerator, fr.denominator
        if d == m:
            return MemPolicy.membind(slow)
        return MemPolicy.weighted((fast, slow), (d - m, m))

    @staticmethod
    def from_tier_fractions(fast: str, devices: Sequence[str],
                            fractions: Sequence[float],
                            denominator: int = 64,
                            exact: bool = False) -> "MemPolicy":
        """N-device weighted interleave from a per-device fraction vector.

        ``fractions[i]`` of pages land on ``devices[i]``; the fast tier
        gets the remainder.  By default the TOTAL slow share picks the
        smallest cycle within ``denominator`` (same discipline as
        :meth:`from_slow_fraction`: a 64-long blocky cycle would leave a
        32-page buffer entirely on the fast tier at 30%), and the cycle's
        slow slots split across devices by largest remainder.  ``exact``
        keeps the full ``denominator`` cycle so each device's fraction is
        represented to 1/denominator (the planner's capacity-quantized
        path, where buffers have thousands of pages)."""
        if len(devices) != len(fractions):
            raise ValueError("one fraction per device")
        fr = [min(max(float(f), 0.0), 1.0) for f in fractions]
        total = sum(fr)
        if total > 1.0 + 1e-9:
            raise ValueError(f"device fractions sum to {total:.3f} > 1")
        total = min(total, 1.0)
        if not devices:
            return MemPolicy.membind(fast)
        if total <= 0.0:
            # All-fast, but keep every device in the policy (zero-
            # weighted): membind would lose the device vocabulary, and a
            # fast name outside the well-known list would then be
            # misread as a slow device downstream.
            return MemPolicy.weighted((fast,) + tuple(devices),
                                      (1,) + (0,) * len(devices))
        from fractions import Fraction
        n_active = sum(1 for f in fr if f > 0)
        if exact:
            cycle, units = denominator, int(round(total * denominator))
        else:
            ft = Fraction(total).limit_denominator(denominator)
            if ft.numerator == 0:
                ft = Fraction(1, denominator)
            cycle, units = ft.denominator, ft.numerator
            if units < n_active:
                # Stretch the cycle so every active device owns at least
                # one slot — unless that would blow past the denominator
                # (then small devices must round away regardless).
                k = -(-n_active // units)
                if cycle * k <= denominator:
                    cycle, units = cycle * k, units * k
        units = max(units, 1)
        # Largest-remainder split of the cycle's slow slots across devices.
        base, _ = largest_remainder_split([f / total * units for f in fr],
                                          units)
        w_fast = cycle - units
        # Every tier stays in the policy — zero-weighted if it gets no
        # pages.  Dropping them would (a) let a full offload misread the
        # first slow device as the fast home and (b) shift device
        # ordinals out of topology order, so a later weight-vector
        # repartition would relabel pages onto the wrong device.
        tiers = (fast,) + tuple(devices)
        weights = (w_fast,) + tuple(base)
        return MemPolicy.weighted(tiers, weights)

    def tier_fractions(self) -> dict[str, float]:
        """Per-tier page share this policy realizes (by tier name)."""
        if self.kind in (PolicyKind.MEMBIND, PolicyKind.PREFERRED):
            return {self.tiers[0]: 1.0}
        if self.kind == PolicyKind.INTERLEAVE:
            out: dict[str, float] = {}
            for t in self.tiers:
                out[t] = out.get(t, 0.0) + 1.0 / len(self.tiers)
            return out
        total = sum(self.weights)
        out = {}
        for t, w in zip(self.tiers, self.weights):
            out[t] = out.get(t, 0.0) + w / total
        return out

    def slow_fraction(self, fast: str | None = None, *,
                      n_pages: int | None = None,
                      page_bytes: int | None = None,
                      ledger=None) -> float:
        """Fraction of pages landing beyond the ``fast`` tier.

        ``fast`` defaults to the policy's first tier; pass the topology's
        fast-tier name to get the fraction relative to it (so
        ``membind(slow)`` correctly reports 1.0).

        ``PREFERRED`` is capacity-dependent: pages fill the preferred
        tier and *overflow to the fallback*.  Pass ``n_pages`` +
        ``page_bytes`` + a ``ledger`` (TierLedger: knows free capacity per
        tier) to get the capacity-aware fraction; without them the
        optimistic no-overflow answer is returned.
        """
        fast = fast if fast is not None else self.tiers[0]
        if self.kind == PolicyKind.MEMBIND:
            return 0.0 if self.tiers[0] == fast else 1.0
        if self.kind == PolicyKind.PREFERRED:
            on_preferred = 1.0
            if (n_pages and page_bytes and ledger is not None):
                fit = max(0, int(ledger.free(self.tiers[0]))) // page_bytes
                on_preferred = min(n_pages, fit) / n_pages
            frac = 0.0
            if self.tiers[0] != fast:
                frac += on_preferred
            if len(self.tiers) > 1 and self.tiers[1] != fast:
                frac += 1.0 - on_preferred
            return frac
        if self.kind == PolicyKind.INTERLEAVE:
            on_fast = sum(1 for t in self.tiers if t == fast)
            return (len(self.tiers) - on_fast) / len(self.tiers)
        total = sum(self.weights)
        on_fast = sum(w for t, w in zip(self.tiers, self.weights) if t == fast)
        return (total - on_fast) / total

    def assign_pages(self, n_pages: int) -> np.ndarray:
        """page -> tier-ordinal assignment (int8), round-robin semantics.

        Matches the kernel patch: each cycle places ``weights[i]``
        consecutive pages on tier ``i``.
        """
        if n_pages < 0:
            raise ValueError("n_pages must be >= 0")
        if self.kind in (PolicyKind.MEMBIND, PolicyKind.PREFERRED):
            return np.zeros(n_pages, dtype=np.int8)
        if self.kind == PolicyKind.INTERLEAVE:
            return (np.arange(n_pages) % len(self.tiers)).astype(np.int8)
        cycle = np.concatenate(
            [np.full(w, i, dtype=np.int8) for i, w in enumerate(self.weights) if w > 0]
        )
        reps = -(-n_pages // len(cycle))
        return np.tile(cycle, reps)[:n_pages]

    _FAST_NAMES = ("fast", "hbm", "dram", "device", "ddr5-l8", "snc-2ch")

    def page_is_slow(self, n_pages: int) -> np.ndarray:
        """page -> bool slow-tier map (resolves ordinals via tier NAMES,
        so membind('slow') correctly lands every page on the slow tier)."""
        assign = self.assign_pages(n_pages)
        slow_ord = np.array([t.lower() not in self._FAST_NAMES
                             for t in self.tiers], dtype=bool)
        return slow_ord[np.minimum(assign, len(self.tiers) - 1)]

    def page_counts(self, n_pages: int) -> dict[str, int]:
        assign = self.assign_pages(n_pages)
        return {
            t: int((assign == i).sum())
            for i, t in enumerate(self.tiers)
        }
