"""Hotness-driven semantic tiering.

The port of ``repro.core.hotness``.  The page machinery below this
module is address-blind: a Zipf-hot embedding row or a heavily routed
MoE expert is as likely to sit on the slow tier as a cold one.  This
module places by what a page holds:

* :class:`HotnessLedger` — EWMA-decayed per-key access counters, fed
  from MoE router dispatch counts (``aux["expert_counts"]`` of
  :mod:`repro_torch.models.moe`) and embedding lookup indices;
  :meth:`~HotnessLedger.topk_split` ranks keys hottest first.
* :class:`SemanticTensor` — a view over
  :class:`~repro_torch.core.interleave.InterleavedTensor` that groups
  rows into placement keys of ``rows_per_key`` rows.  A key's pages are
  contiguous, so a promotion or demotion rides the tensor's O(Δ)
  run-coalesced move (on the card: ``stream_copy`` segment lists, shard
  storage kept under ``headroom``).
* :class:`HotSetCoordinator` — the hot-set size as a Caption walk
  coordinate: the controller's slow-share vector read semantically, and
  hot-set membership drift re-opening a converged walk.

The ledger is numpy on the host, as in the reference; a lookup's indices
are recorded when the data plane sees them (a card tensor is copied back
for that, so a hot loop records from the host-side indices it made).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.interleave import (InterleavedTensor,
                                         _ExplicitAssignment,
                                         _policy_device_map)
from repro_torch.core.policy import MemPolicy, largest_remainder_split
from repro_torch.core.telemetry import GLOBAL_TELEMETRY, Telemetry
from repro_torch.device import DeviceLike


class HotnessLedger:
    """EWMA-decayed per-key access-frequency counters.

    Traffic goes into the current epoch (:meth:`record` for count vectors
    such as the MoE router's dispatch histogram, :meth:`record_keys` /
    :meth:`record_rows` for index streams); :meth:`tick` folds the epoch
    into the EWMA (``ewma = decay * ewma + epoch``), so a key no longer
    accessed cools at ``decay`` per epoch.  :meth:`scores` includes the
    open epoch."""

    def __init__(self, n_keys: int, *, decay: float = 0.8):
        if n_keys <= 0:
            raise ValueError("n_keys must be positive")
        if not 0.0 <= decay < 1.0:
            raise ValueError("decay must be in [0, 1)")
        self.n_keys = int(n_keys)
        self.decay = float(decay)
        self._ewma = np.zeros(self.n_keys, np.float64)
        self._epoch = np.zeros(self.n_keys, np.float64)
        self.epochs = 0
        self.total_observed = 0.0
        #: hot-set reference for drift detection (see :meth:`mark`).
        self._marked: Optional[frozenset] = None

    # -- feeding -------------------------------------------------------------
    def record(self, counts) -> None:
        """Add a per-key count vector (e.g. MoE ``aux["expert_counts"]``)."""
        if isinstance(counts, torch.Tensor):
            counts = counts.detach().cpu().numpy()
        c = np.asarray(counts, np.float64).reshape(-1)
        if c.shape != (self.n_keys,):
            raise ValueError(
                f"count vector has {c.shape[0]} entries, ledger has "
                f"{self.n_keys} keys")
        self._epoch += c

    def record_keys(self, keys, weights=None) -> None:
        """Add an access stream of key ids."""
        k = _host(keys).reshape(-1)
        if k.size == 0:
            return
        if k.min() < 0 or k.max() >= self.n_keys:
            raise ValueError("key id out of range")
        w = (np.ones(k.size, np.float64) if weights is None
             else _host(weights).astype(np.float64).reshape(-1))
        np.add.at(self._epoch, k, w)

    def record_rows(self, rows, rows_per_key: int) -> None:
        """Add a row-index stream, each row counted to its owning key."""
        r = _host(rows).reshape(-1)
        if r.size == 0:
            return
        self.record_keys(r // int(rows_per_key))

    def tick(self) -> float:
        """Close the epoch: decay the EWMA and fold the epoch in.  Returns
        the traffic observed this epoch."""
        observed = float(self._epoch.sum())
        self._ewma = self.decay * self._ewma + self._epoch
        self._epoch = np.zeros(self.n_keys, np.float64)
        self.epochs += 1
        self.total_observed += observed
        return observed

    # -- ranking -------------------------------------------------------------
    def scores(self) -> np.ndarray:
        """Current per-key hotness (EWMA + the open epoch)."""
        return self._ewma + self._epoch

    def rank(self) -> np.ndarray:
        """Key ids hottest first (stable: ties keep id order)."""
        return np.argsort(-self.scores(), kind="stable")

    def topk_split(self, n_hot: int) -> tuple[np.ndarray, np.ndarray]:
        """(hot keys, cold keys): the ``n_hot`` hottest and the rest, both
        hottest first."""
        n_hot = int(np.clip(n_hot, 0, self.n_keys))
        r = self.rank()
        return r[:n_hot], r[n_hot:]

    def traffic_share(self, keys) -> float:
        """Share of the observed traffic that ``keys`` took."""
        s = self.scores()
        total = float(s.sum())
        if total <= 0:
            return 0.0
        return float(s[np.asarray(keys, np.int64)].sum()) / total

    # -- hot-set drift -------------------------------------------------------
    def mark(self, n_hot: int) -> None:
        """Remember the current top-``n_hot`` set as the drift reference."""
        hot, _ = self.topk_split(n_hot)
        self._marked = frozenset(int(k) for k in hot)

    def drift(self) -> float:
        """Share of the marked hot set no longer in the top-k (0.0 when
        nothing is marked)."""
        if not self._marked:
            return 0.0
        hot, _ = self.topk_split(len(self._marked))
        still = len(self._marked.intersection(int(k) for k in hot))
        return 1.0 - still / len(self._marked)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def semantic_assignment(n_keys: int, pages_per_key: int,
                        hot_keys: np.ndarray, cold_keys: np.ndarray,
                        weights: Sequence[float]) -> np.ndarray:
    """Page -> device-ordinal map from a hot/cold key split.

    Hot keys pin to the fast tier (device 0).  Cold keys are dealt across
    the slow devices in rank order with largest-remainder quotas in
    proportion to ``weights``, interleaved so consecutive cold keys
    alternate devices.  Key ``k`` owns pages ``[k*ppk, (k+1)*ppk)``."""
    key_dev = np.zeros(n_keys, np.int8)
    n_cold = len(cold_keys)
    if n_cold:
        w = np.maximum(np.asarray(list(weights), np.float64), 0.0)
        if w.sum() <= 0:
            w = np.ones(len(w) or 1)
        quotas, _ = largest_remainder_split(
            (w / w.sum() * n_cold).tolist(), n_cold)
        # device d takes quotas[d] evenly spaced picks over the cold ranks
        order_pos = np.concatenate([
            (np.arange(q) + 0.5) / q for q in quotas if q > 0
        ]) if any(q > 0 for q in quotas) else np.zeros(0)
        order_dev = np.concatenate([
            np.full(q, d + 1, np.int8) for d, q in enumerate(quotas) if q > 0
        ]) if any(q > 0 for q in quotas) else np.zeros(0, np.int8)
        dealt = order_dev[np.argsort(order_pos, kind="stable")]
        key_dev[np.asarray(cold_keys, np.int64)] = dealt
    key_dev[np.asarray(hot_keys, np.int64)] = 0
    return np.repeat(key_dev, int(pages_per_key))


def _cold_weights(weights: tuple[float, ...]) -> tuple[float, ...]:
    """A Caption slow-share vector as relative cold-deal quotas (all zero:
    an even split)."""
    total = sum(weights)
    if total <= 0:
        return tuple(1.0 for _ in weights) or (1.0,)
    return tuple(w / total for w in weights)


@dataclasses.dataclass
class SemanticTensor:
    """Hotness-aware placement view over an :class:`InterleavedTensor`.

    Rows are grouped into keys of ``rows_per_key`` rows, each owning
    ``rows_per_key / page_rows`` contiguous pages.  Data-plane calls
    (gather, scatter, bag_reduce) go to the tensor and record the touched
    keys in the ledger.  :meth:`retier` re-plans from the ledger's ranking
    under a Caption weight vector and moves only the changed pages."""

    it: InterleavedTensor
    rows_per_key: int
    ledger: HotnessLedger
    #: logical (un-padded) row count of the source array.
    logical_rows: int
    #: actuation summary of the last :meth:`retier` call.
    last_retier: dict = dataclasses.field(default_factory=dict)

    # -- construction --------------------------------------------------------
    @classmethod
    def from_array(cls, array, *, rows_per_key: int,
                   weights: Sequence[float],
                   device_names: Sequence[str] = ("fast", "slow"),
                   page_rows: Optional[int] = None,
                   placement: str = "blind",
                   ledger: Optional[HotnessLedger] = None,
                   decay: float = 0.8, headroom: int = 0,
                   backend: Optional[str] = None,
                   device: DeviceLike = None) -> "SemanticTensor":
        """Page ``array`` (a tensor or a numpy array) with slow-share
        ``weights`` (one per slow device of ``device_names[1:]``; the fast
        tier keeps the rest), on ``device`` (``cuda`` unless told
        ``"cpu"``; the backend follows).

        ``placement="blind"`` starts address-blind — the N:M interleave in
        key order; ``"semantic"`` places by the ledger's ranking at once."""
        rows_per_key = int(rows_per_key)
        page_rows = int(page_rows or rows_per_key)
        if rows_per_key % page_rows:
            raise ValueError("rows_per_key must be a multiple of page_rows")
        if not isinstance(array, torch.Tensor):
            array = torch.from_numpy(np.ascontiguousarray(array))
        rows = array.shape[0]
        n_keys = max(1, math.ceil(rows / rows_per_key))
        pad = n_keys * rows_per_key - rows
        if pad:
            array = torch.cat([array, torch.zeros(
                (pad,) + tuple(array.shape[1:]), dtype=array.dtype,
                device=array.device)])
        led = ledger or HotnessLedger(n_keys, decay=decay)
        if led.n_keys != n_keys:
            raise ValueError(
                f"ledger has {led.n_keys} keys, tensor has {n_keys}")
        ppk = rows_per_key // page_rows
        names = tuple(device_names)
        n_pages = n_keys * ppk
        if placement == "semantic":
            assign = cls._plan(led, n_keys, ppk, tuple(weights))
        elif placement == "blind":
            # the N:M interleave in key order (smallest cycle), what the
            # page machinery does without this layer
            pol = MemPolicy.from_tier_fractions(
                names[0], list(names[1:]), list(weights))
            key_assign, _ = _policy_device_map(pol, n_keys)
            assign = np.repeat(np.asarray(key_assign, np.int8), ppk)
        else:
            raise ValueError(f"unknown placement {placement!r}")
        it = InterleavedTensor.from_array(
            array, _ExplicitAssignment(assign[:n_pages], names), page_rows,
            headroom=headroom, backend=backend, device=device)
        st = cls(it=it, rows_per_key=rows_per_key, ledger=led,
                 logical_rows=rows)
        led.mark(st.hot_keys())
        return st

    # -- derived -------------------------------------------------------------
    @property
    def n_keys(self) -> int:
        return self.ledger.n_keys

    @property
    def pages_per_key(self) -> int:
        return self.rows_per_key // self.it.page_rows

    def key_device(self) -> np.ndarray:
        """(n_keys,) device of each key's first page."""
        dev, _ = self.it._host_map()
        return dev[:: self.pages_per_key].copy()

    def hot_keys(self) -> int:
        """Keys on the fast tier."""
        return int((self.key_device() == 0).sum())

    def hot_traffic_share(self) -> float:
        """Observed traffic share of the keys on the fast tier."""
        return self.ledger.traffic_share(np.nonzero(self.key_device() == 0)[0])

    # -- data plane ----------------------------------------------------------
    def gather_rows(self, idx) -> torch.Tensor:
        self.ledger.record_rows(idx, self.rows_per_key)
        return self.it.gather_rows(idx)

    def update_rows(self, idx, values, *, donate: bool = False
                    ) -> "SemanticTensor":
        self.ledger.record_rows(idx, self.rows_per_key)
        return dataclasses.replace(
            self, it=self.it.update_rows(idx, values, donate=donate))

    def bag_reduce(self, indices, weights=None, reduce_fn=None
                   ) -> torch.Tensor:
        """Embedding-bag sums through the semantic layout; the looked-up
        rows feed the ledger."""
        self.ledger.record_rows(indices, self.rows_per_key)
        return self.it.bag_reduce(indices, weights, reduce_fn=reduce_fn)

    def to_array(self) -> torch.Tensor:
        return self.it.to_array()[: self.logical_rows]

    # -- placement -----------------------------------------------------------
    @staticmethod
    def _plan(ledger: HotnessLedger, n_keys: int, ppk: int,
              weights: tuple[float, ...]) -> np.ndarray:
        slow_share = min(max(sum(weights), 0.0), 1.0)
        n_hot = n_keys - int(round(slow_share * n_keys))
        hot, cold = ledger.topk_split(n_hot)
        return semantic_assignment(n_keys, ppk, hot, cold,
                                   _cold_weights(weights))

    def plan_assignment(self, weights: Sequence[float]) -> np.ndarray:
        """The page -> device map :meth:`retier` would actuate."""
        return self._plan(self.ledger, self.n_keys, self.pages_per_key,
                          tuple(weights))

    def retier(self, weights: Sequence[float], *, mover=None,
               telemetry: Telemetry = GLOBAL_TELEMETRY,
               source: Optional[str] = "hotness", lane: Optional[int] = None,
               donate: bool = False) -> "SemanticTensor":
        """Re-place by the current ranking under ``weights``: the hottest
        keys fill the fast share ``1 - sum(weights)``, the cold ones are
        dealt across the slow devices.  Only changed pages move — whole
        keys, as contiguous runs — through
        :meth:`InterleavedTensor.reassign_pages`.  A plan equal to the
        current map returns ``self``."""
        new_dev = self.plan_assignment(weights)
        old_dev, _ = self.it._host_map()
        moved = np.nonzero(new_dev != old_dev)[0]
        if moved.size == 0:
            self.ledger.mark(self.hot_keys())
            return self
        promoted = int((new_dev[moved] == 0).sum())
        demoted = int((old_dev[moved] == 0).sum())
        it2 = self.it.reassign_pages(new_dev, mover=mover,
                                     telemetry=telemetry, source=source,
                                     lane=lane, donate=donate)
        telemetry.record_semantic(promoted, demoted, source=source)
        moved_keys = int(np.unique(moved // self.pages_per_key).size)
        out = dataclasses.replace(
            self, it=it2,
            last_retier={"moved_pages": int(moved.size),
                         "moved_keys": moved_keys,
                         "promoted_pages": promoted,
                         "demoted_pages": demoted})
        out.ledger.mark(out.hot_keys())
        return out

    def drift(self) -> float:
        """Hot-set membership drift since the last actuated placement."""
        return self.ledger.drift()

    def placement_report(self) -> str:
        """Placement summary: keys, pages and traffic share a device."""
        dev = self.key_device()
        s = self.ledger.scores()
        total = max(float(s.sum()), 1e-12)
        lines = [f"{'device':<12s} {'keys':>6s} {'pages':>7s} "
                 f"{'traffic%':>9s}"]
        fr = self.it.device_fractions()
        for i, name in enumerate(self.it.device_names):
            keys = np.nonzero(dev == i)[0]
            lines.append(
                f"{name:<12s} {keys.size:>6d} "
                f"{int(round(fr.get(name, 0.0) * self.it.n_pages)):>7d} "
                f"{100 * float(s[keys].sum()) / total:>8.1f}%")
        return "\n".join(lines)


class HotSetCoordinator:
    """Caption glue: the hot-set size as a walked coordinate.

    Each :meth:`epoch` closes the ledger epoch; while the controller is
    converged, compares the hot set against a snapshot taken when it
    converged and re-opens the walk past ``drift_threshold``; else feeds
    the metrics to the controller; then actuates the decided weights
    through :meth:`SemanticTensor.retier` and reports the achieved
    shares back."""

    def __init__(self, st: SemanticTensor, controller, *, mover=None,
                 telemetry: Telemetry = GLOBAL_TELEMETRY,
                 drift_threshold: float = 0.5,
                 source: str = "hotness", donate: bool = False):
        self.st = st
        self.controller = controller
        self.mover = mover
        self.telemetry = telemetry
        self.drift_threshold = float(drift_threshold)
        self.source = source
        self.donate = donate
        self.reopens = 0
        #: hot-set membership at the moment the walk converged.
        self._converged_hot: Optional[frozenset] = None

    def _snapshot(self) -> None:
        hot, _ = self.st.ledger.topk_split(self.st.hot_keys())
        self._converged_hot = frozenset(int(k) for k in hot)

    def drift(self) -> float:
        """Hot-set churn since the walk converged (0.0 while walking)."""
        ref = self._converged_hot
        if not ref:
            return 0.0
        hot, _ = self.st.ledger.topk_split(len(ref))
        return 1.0 - len(ref.intersection(int(k) for k in hot)) / len(ref)

    def epoch(self, metrics):
        """Feed one epoch's ``EpochMetrics``; returns the controller's
        Decision after actuation."""
        self.st.ledger.tick()
        ctl = self.controller
        if ctl.converged:
            if self._converged_hot is None:
                self._snapshot()
            churn = self.drift()
            if churn > self.drift_threshold:
                decision = ctl.reopen(
                    f"hot-set drift: {churn * 100:.0f}% of the converged "
                    "hot set fell out of the top-k")
                self.reopens += 1
                self._converged_hot = None
            else:
                decision = ctl.observe(metrics)
        else:
            self._converged_hot = None
            decision = ctl.observe(metrics)
            if ctl.converged:
                # snapshot at the transition, before later traffic
                self._snapshot()
        self.st = self.st.retier(
            decision.weights, mover=self.mover, telemetry=self.telemetry,
            source=self.source, donate=self.donate)
        ctl.actuated_weights(self.st.it.weights())
        return decision
