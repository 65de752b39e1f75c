"""Warm-start memo: workload fingerprint -> converged Caption weights.

The paper's Caption loop (§7) converges by walking the slow-share
simplex from a cold prior — every probe epoch spent off the optimum is
regret paid in real bandwidth.  But production traffic recurs: the same
DLRM embedding mix, the same decode batch shape, the same topology.
This module gives the controller a memory: when a walk converges, the
converged weight vector is filed under a *workload fingerprint* built
from ``AccessProfile``-style features of the epoch telemetry (read/write
ratio against the slow pool, slow-route bandwidth, writer parallelism)
plus the topology signature.  A later run that fingerprints the same
workload seeds :class:`~repro_torch.core.caption.CaptionController` at the
remembered optimum and enters MEASURE directly, skipping the walk.

Invalidation is structural, not temporal:

  * the **topology signature** (device names + load bandwidths) is part
    of the key — a hot-removed device or a different device mix can
    never resurrect weights measured against hardware that is gone;
  * the **drift signature** is checked at lookup: the entry remembers
    the raw slow-route bandwidth it fingerprinted at, and a candidate
    whose route bandwidth deviates beyond ``drift_threshold`` misses
    (same quantized bucket or not) — the §7 drift rule applied to the
    memo itself.

The store is a flat JSON file (``--memo-path`` in the serve/train
drivers): human-inspectable, safe to delete, empty-on-missing.  This is
deliberately separate machinery from :mod:`repro_torch.core.memo`, which is
the paper's MEMO *bandwidth microbenchmark*; the two share only a name
lineage.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional, Sequence

from repro_torch.core.tiers import TierTopology


def topology_signature(topology: TierTopology) -> str:
    """Stable identity of the device mix the weights were measured on.

    Names plus load bandwidths: a renamed device, a different CXL mix,
    or a degraded preset all produce a different signature (and so a
    different fingerprint key)."""
    parts = [f"{t.name}@{t.load_bw:.3g}" for t in topology.devices]
    return "+".join(parts)


@dataclasses.dataclass(frozen=True)
class WorkloadFingerprint:
    """AccessProfile-style identity of one epoch window's workload.

    Raw feature values are carried alongside so the memo can apply the
    drift check at lookup; :meth:`key` quantizes them into coarse
    buckets so *equivalent* windows (same workload, ordinary sampling
    jitter) collapse onto the same entry."""

    topology: str
    #: written / (read + written) bytes against the slow pool.
    write_ratio: float = 0.0
    #: slow-route bandwidth (bytes/s, both directions).
    slow_bw: float = 0.0
    #: writer parallelism (peak concurrent writers this window).
    parallelism: float = 0.0
    #: boundedness class of the buffer (§6.1 taxonomy).
    boundedness: str = "bandwidth"

    def key(self) -> str:
        """Quantized store key: eighth-steps of write ratio, log2 buckets
        of bandwidth and parallelism."""
        wr = int(round(min(max(self.write_ratio, 0.0), 1.0) * 8))
        bw = int(math.log2(self.slow_bw)) if self.slow_bw >= 1.0 else -1
        par = (int(math.log2(self.parallelism))
               if self.parallelism >= 1.0 else -1)
        return f"{self.topology}|wr{wr}|bw{bw}|par{par}|{self.boundedness}"


def fingerprint_metrics(metrics, topology: TierTopology,
                        boundedness: str = "bandwidth"
                        ) -> WorkloadFingerprint:
    """Fingerprint one :class:`~repro_torch.core.caption.EpochMetrics`."""
    return WorkloadFingerprint(
        topology=topology_signature(topology),
        write_ratio=float(metrics.write_ratio),
        slow_bw=float(metrics.slow_bw),
        parallelism=float(metrics.writer_concurrency),
        boundedness=boundedness,
    )


def fingerprint_counters(counters, topology: TierTopology,
                         slow=None, boundedness: str = "bandwidth"
                         ) -> WorkloadFingerprint:
    """Fingerprint a raw :class:`~repro_torch.core.telemetry.EpochCounters`
    window (the telemetry-side twin of :func:`fingerprint_metrics`)."""
    feats = counters.workload_features(
        slow if slow is not None else topology.slow_names)
    return WorkloadFingerprint(
        topology=topology_signature(topology),
        write_ratio=feats["write_ratio"],
        slow_bw=feats["slow_bw"],
        parallelism=feats["parallelism"],
        boundedness=boundedness,
    )


class WarmStartMemo:
    """Persistable fingerprint -> converged-weights store.

    ``lookup`` returns the remembered per-device weight vector or None;
    ``record`` files/refreshes an entry.  ``hits``/``misses``/
    ``drift_misses`` count lookup outcomes for driver logging."""

    def __init__(self, entries: Optional[dict] = None, *,
                 drift_threshold: float = 0.5):
        if drift_threshold < 0:
            raise ValueError("drift_threshold must be >= 0")
        self.drift_threshold = drift_threshold
        self._entries: dict[str, dict] = dict(entries or {})
        self.hits = 0
        self.misses = 0
        self.drift_misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def entries(self) -> dict[str, dict]:
        return dict(self._entries)

    def record(self, fp: WorkloadFingerprint,
               weights: Sequence[float]) -> None:
        """File ``weights`` as the converged answer for ``fp`` (an
        existing entry for the same key is refreshed)."""
        self._entries[fp.key()] = {
            "weights": [float(w) for w in weights],
            "topology": fp.topology,
            "write_ratio": float(fp.write_ratio),
            "slow_bw": float(fp.slow_bw),
            "parallelism": float(fp.parallelism),
            "boundedness": fp.boundedness,
            "hits": self._entries.get(fp.key(), {}).get("hits", 0),
        }

    def lookup(self, fp: WorkloadFingerprint
               ) -> Optional[tuple[float, ...]]:
        """Remembered weights for ``fp``, or None.

        Misses on an unknown key, on a topology-signature mismatch, and
        on a drift-signature mismatch (raw slow-route bandwidth deviating
        beyond ``drift_threshold`` from the recorded one — within-bucket
        drift must not resurrect a stale operating point)."""
        e = self._entries.get(fp.key())
        if e is None or e.get("topology") != fp.topology:
            self.misses += 1
            return None
        held = float(e.get("slow_bw", 0.0))
        ref = max(held, fp.slow_bw)
        if ref > 0 and abs(fp.slow_bw - held) / ref > self.drift_threshold:
            self.drift_misses += 1
            self.misses += 1
            return None
        e["hits"] = int(e.get("hits", 0)) + 1
        self.hits += 1
        return tuple(float(w) for w in e["weights"])

    # -- persistence ---------------------------------------------------------
    def to_json(self) -> dict:
        return {"version": 1, "drift_threshold": self.drift_threshold,
                "entries": self._entries}

    @classmethod
    def from_json(cls, payload: dict) -> "WarmStartMemo":
        return cls(payload.get("entries", {}),
                   drift_threshold=float(
                       payload.get("drift_threshold", 0.5)))

    def save(self, path: str) -> None:
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str, *,
             drift_threshold: Optional[float] = None) -> "WarmStartMemo":
        """Load a memo; a missing or unreadable file is an empty memo
        (the cold-start case must never crash the driver)."""
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            return cls(drift_threshold=(0.5 if drift_threshold is None
                                        else drift_threshold))
        memo = cls.from_json(payload)
        if drift_threshold is not None:
            memo.drift_threshold = drift_threshold
        return memo
