"""Caption (§7): feedback-driven dynamic tiering via counter sampling.

The paper's headline proposal: instead of committing to one static
interleave ratio, sample hardware counters every epoch and *converge*
to an empirically favorable slow-tier percentage (up to +24% for
bandwidth-bound apps, Fig. 11).  ``CaptionController`` is that loop as
a small state machine over :class:`~repro_torch.core.telemetry.EpochCounters`
style samples:

  PROBE    perturb the slow-tier weight vector by one hill-climbing
           step on the active device's coordinate;
  MEASURE  hold the candidate for ``probe_epochs`` windows, smoothing
           the throughput signal with an EWMA (Caption's measurement
           module — one noisy PMU window never decides anything);
  ADJUST   compare against the previous operating point with a
           hysteresis band: keep climbing on improvement, back off and
           halve the step on regression, declare the coordinate done
           when the step underflows.

On an N-slow-device topology (the paper's CXL-A/B/C pool) the
controller walks the weight vector on the simplex by round-robin
coordinate descent: each device's share is hill-climbed in turn with
the same machinery, and the loop converges once a full pass over every
device moves nothing.  With one slow device this degenerates exactly to
the scalar ``slow_fraction`` walk.

The §6 guardrails are first-class (applied per active device):
  * latency-bound profiles never gain slow-tier pages (Fig. 7: any CXL
    fraction hurts a µs-SLO app) — the controller only walks toward the
    fast tier;
  * write-heavy epochs damp the step toward a slow device by THAT
    device's store/load bandwidth ratio (RFO doubles temporal-store
    traffic, and the three devices RFO differently);
  * epochs that exceed the writer limit freeze growth of the slow
    share (concurrent writers collapse the CXL controller, Fig. 3);
  * the capacity floor from the static plan is a hard lower bound — the
    controller can tune *how much more* than the spill minimum lives on
    the slow tier, never less than fits.

Workload shifts re-open a converged loop: while ``CONVERGED`` the
controller tracks the EWMA slow-route bandwidth, and a relative drift
beyond ``CaptionConfig.drift_threshold`` resets the walk (fresh step,
fresh baseline) — the counters said the workload changed, so the old
operating point is no longer evidence.

The static planner supplies the *initial* state (``from_plan``), so the
one-shot §6 plan is the cold-start prior, not the final answer.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import TYPE_CHECKING, Optional, Sequence

from repro_torch.core.classifier import (AccessProfile, Boundedness,
                                   classify_pool)
from repro_torch.core.tiers import TierTopology

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.planner import Plan
    from repro_torch.core.warmstart import WarmStartMemo


class Phase(enum.Enum):
    WARMUP = "warmup"  # first operating point, no comparison baseline yet
    MEASURE = "measure"  # accumulating epochs at the current fraction
    ADJUST = "adjust"  # a decision was taken this epoch
    CONVERGED = "converged"  # step underflowed; holding


@dataclasses.dataclass(frozen=True)
class CaptionConfig:
    """Knobs of the control loop (documented in ROADMAP.md)."""

    #: application steps per observation epoch (the PMU window length).
    epoch_steps: int = 16
    #: epochs to hold each candidate fraction before judging it.
    probe_epochs: int = 2
    #: initial hill-climbing step, in slow-fraction points.
    step: float = 0.05
    #: convergence threshold: the walk stops once the step halves below.
    min_step: float = 0.01
    #: relative throughput change that counts as signal (hysteresis band).
    hysteresis: float = 0.02
    #: EWMA smoothing factor for the throughput signal.
    ewma_alpha: float = 0.5
    #: hard ceiling on the total slow-tier fraction (sum of weights).
    max_fraction: float = 0.95
    #: writer-concurrency limit; above it the slow fraction cannot grow.
    writer_limit: int = 2
    #: fast-tier pressure above which pages are not pulled back fast.
    pressure_high: float = 0.95
    #: damp growth steps by write share (RFO/store-bandwidth guardrail).
    write_damp: bool = True
    #: relative EWMA slow-route bandwidth drift that re-opens a CONVERGED
    #: walk (workload-shift re-probing); 0 disables.
    drift_threshold: float = 0.35
    #: paired probe duels per candidate point (noise-robust probing):
    #: the controller alternates ``probe_epochs``-long stints at the
    #: incumbent w and the candidate w±δ, and accepts the candidate only
    #: on a significant majority of duel wins.  0 keeps the legacy
    #: single-sample accept/reject.
    duel_count: int = 0
    #: adaptive step sizing: multiplier applied to the step after
    #: consecutive duel wins (1.0 disables expansion).  Rejections halve
    #: the step as always (expand on wins, shrink on reversals).
    step_expand: float = 2.0
    #: ceiling for the adaptively expanded step (the walk never probes
    #: coarser than this, whatever the win streak).
    max_step: float = 0.2

    def __post_init__(self):
        if self.epoch_steps < 1:
            raise ValueError("epoch_steps must be >= 1")
        if self.probe_epochs < 1:
            raise ValueError("probe_epochs must be >= 1")
        if not 0.0 < self.step <= 1.0:
            raise ValueError("step must be in (0, 1]")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        if not 0.0 <= self.max_fraction <= 1.0:
            raise ValueError("max_fraction must be in [0, 1]")
        if self.drift_threshold < 0.0:
            raise ValueError("drift_threshold must be >= 0")
        if self.duel_count < 0:
            raise ValueError("duel_count must be >= 0")
        if self.step_expand < 1.0:
            raise ValueError("step_expand must be >= 1")
        if self.max_step <= 0.0:
            raise ValueError("max_step must be > 0")


@dataclasses.dataclass(frozen=True)
class EpochMetrics:
    """What one epoch tells the controller (derived from EpochCounters).

    ``write_ratio`` and ``slow_bw`` stay as POOL AGGREGATES for
    back-compat (every pre-split constructor call keeps meaning what it
    meant); the per-device vectors carry the same quantities split per
    slow device, so one device's write storm no longer damps growth
    toward all of them and the drift detector can tell WHICH device's
    route shifted.  Use :meth:`write_ratio_for` / :meth:`slow_bw_for`,
    which fall back to the aggregate when the split is absent (hand-built
    metrics in older tests/benchmarks)."""

    #: application progress per second (tokens/s, samples/s, steps/s...).
    throughput: float
    #: written / (read + written) bytes this epoch (whole slow pool).
    write_ratio: float = 0.0
    #: peak concurrent writers into the slow tier this epoch.
    writer_concurrency: int = 0
    #: fast-tier occupancy in [0, 1].
    fast_pressure: float = 0.0
    #: observed slow-route bandwidth this epoch (bytes/s, both directions)
    #: — the workload-shift drift signal (whole slow pool).
    slow_bw: float = 0.0
    #: per-device write ratio: {device name: written/(read+written)}.
    device_write_ratio: dict[str, float] = dataclasses.field(
        default_factory=dict)
    #: per-device slow-route bandwidth (bytes/s, both directions).
    device_slow_bw: dict[str, float] = dataclasses.field(
        default_factory=dict)

    def write_ratio_for(self, name: Optional[str]) -> float:
        """Device ``name``'s write ratio; the pool aggregate when the
        split was not populated (or no name is known)."""
        if name is not None and name in self.device_write_ratio:
            return self.device_write_ratio[name]
        return self.write_ratio

    def slow_bw_for(self, name: Optional[str]) -> float:
        if name is not None and name in self.device_slow_bw:
            return self.device_slow_bw[name]
        return self.slow_bw

    @staticmethod
    def from_counters(counters, *, throughput: float,
                      slow_name="slow") -> "EpochMetrics":
        """Derive the guardrail inputs from an EpochCounters window.

        ``slow_name`` is one tier name or a sequence of them (multi-device
        topologies get both the pool aggregate and the per-device split)."""
        names = ((slow_name,) if isinstance(slow_name, str)
                 else tuple(slow_name))
        dt = max(counters.seconds, 1e-9)
        dev_wr: dict[str, float] = {}
        dev_bw: dict[str, float] = {}
        into_slow = from_slow = 0
        for n in names:
            into = counters.bytes_into(n)
            out = counters.bytes_from(n)
            tot = into + out
            dev_wr[n] = into / tot if tot else 0.0
            dev_bw[n] = tot / dt
            into_slow += into
            from_slow += out
        total = into_slow + from_slow
        return EpochMetrics(
            throughput=throughput,
            write_ratio=into_slow / total if total else 0.0,
            writer_concurrency=int(
                counters.gauges.get("writer_concurrency", 0)),
            fast_pressure=float(counters.gauges.get("fast_pressure", 0.0)),
            slow_bw=total / dt,
            device_write_ratio=dev_wr,
            device_slow_bw=dev_bw,
        )


def window_metrics(window, throughput: float, *, mover=None,
                   fast_pressure: Optional[float] = None,
                   slow_name=None, seconds: Optional[float] = None):
    """Close an EpochWindow into controller inputs — the one place the
    gauge publication / tick / metric-derivation glue lives (shared by
    CaptionController.observe_window and CaptionArbiter.observe_window,
    so the two paths can never derive from different route keys).
    Returns (metrics, counters, resolved slow tier name(s))."""
    if fast_pressure is not None:
        window.gauge("fast_pressure", fast_pressure)
    if mover is not None:
        names = mover.topology.slow_names
        if len(names) > 1:
            # The §6 writer limit is per controller (Fig. 3 collapse is
            # per device): one writer on each of three devices is fine,
            # so gauge the WORST single device, not the pool total.
            peak = max(mover.take_peak_writers(n) for n in names)
        else:
            peak = mover.take_peak_writers()
        window.gauge("writer_concurrency", peak)
        if slow_name is None and names:
            slow_name = names[0] if len(names) == 1 else names
    slow_name = slow_name if slow_name is not None else "slow"
    counters = window.tick(seconds=seconds)
    metrics = EpochMetrics.from_counters(
        counters, throughput=throughput, slow_name=slow_name)
    return metrics, counters, slow_name


@dataclasses.dataclass(frozen=True)
class Decision:
    """Outcome of one observed epoch."""

    fraction: float
    changed: bool
    phase: Phase
    reason: str
    #: per-slow-device target shares (sum == fraction); single-element on
    #: a two-device topology.
    weights: tuple[float, ...] = ()


class CaptionController:
    """Hill-climbing slow-share controller with hysteresis (§7).

    Scalar on a two-device topology; round-robin coordinate descent over
    the per-device weight vector on an N-device pool."""

    def __init__(
        self,
        topology: TierTopology,
        config: Optional[CaptionConfig] = None,
        *,
        initial_fraction: float = 0.0,
        min_fraction: float = 0.0,
        boundedness: Boundedness = Boundedness.BANDWIDTH_BOUND,
        initial_weights: Optional[Sequence[float]] = None,
        min_weights: Optional[Sequence[float]] = None,
    ):
        self.topology = topology
        self.cfg = config or CaptionConfig()
        self.boundedness = boundedness
        self.n_slow = max(topology.n_slow, 1)
        self.min_fraction = min(max(min_fraction, 0.0), self.cfg.max_fraction)
        if initial_weights is None:
            f = min(max(initial_fraction, self.min_fraction),
                    self.cfg.max_fraction)
            initial_weights = self._spread(f)
        if len(initial_weights) != self.n_slow:
            raise ValueError(
                f"initial_weights needs {self.n_slow} entries")
        self.min_weights = tuple(
            min(max(w, 0.0), 1.0)
            for w in (min_weights or (0.0,) * self.n_slow))
        self.weights = [max(float(w), mw) for w, mw
                        in zip(initial_weights, self.min_weights)]
        # Explicit weight vectors honor the same hard ceiling the scalar
        # prior always did (a full capacity spill can seed at 1.0).
        total = sum(self.weights)
        if total > self.cfg.max_fraction:
            scale = (self.cfg.max_fraction / total
                     if self.cfg.max_fraction > 0 else 0.0)
            self.weights = [w * scale for w in self.weights]
        self.phase = Phase.WARMUP
        # Latency-bound state starts walking home to the fast tier; anything
        # else probes toward the slow tier from its static prior.
        self._dir = -1.0 if self.latency_bound else 1.0
        self._step = self.cfg.step
        #: step each coordinate walk restarts from; halves every full pass
        #: over the devices (annealing), so late passes probe gently and
        #: the stale test below can see the walk has stopped making
        #: progress.
        self._restart_step = self.cfg.step
        self._growth_gate = None  # fleet-level gate (CaptionArbiter)
        self._ewma: Optional[float] = None
        self._epochs_here = 0
        #: last operating point: (weights tuple, smoothed throughput).
        self._prev: Optional[tuple[tuple[float, ...], float]] = None
        self._coord = 0  # active slow device (coordinate descent)
        self._coord_start = self.weights[0]
        self._stale = 0  # consecutive coords that converged without moving
        self._hold_bw: Optional[float] = None  # drift reference (CONVERGED)
        self._hold_bw_dev: dict[str, float] = {}  # per-device references
        #: active duel: incumbent/candidate points + their stint samples.
        self._duel: Optional[dict] = None
        self._duel_wins = 0  # consecutive accepted duels (step expansion)
        self._duel_rejects = 0  # consecutive rejected duels (shrink patience)
        self._duel_losses = 0  # consecutive significant losses (reversal)
        #: EWMA marginal utility: Δthroughput per Δslow-fraction, from
        #: recent duel outcomes / accepted moves (arbiter joint rounds).
        self._utility: Optional[float] = None
        self._memo: Optional["WarmStartMemo"] = None
        self._memo_fp = None  # fingerprint of the workload being walked
        self._memo_checked = False
        self._confirm_hold = False  # warm-started: one stint, then hold
        self.history: list[Decision] = []

    def _spread(self, fraction: float) -> tuple[float, ...]:
        """Distribute a scalar fraction across the slow devices,
        bandwidth-proportionally (the Fig. 10 best-static-ratio prior)."""
        if self.n_slow == 1:
            return (fraction,)
        bw = self.topology.bandwidth_weights()
        if len(bw) != self.n_slow:
            bw = (1.0 / self.n_slow,) * self.n_slow
        return tuple(fraction * b for b in bw)

    # -- derived -------------------------------------------------------------
    @property
    def fraction(self) -> float:
        """Total slow-tier share (sum of the per-device weights)."""
        return float(sum(self.weights))

    @property
    def latency_bound(self) -> bool:
        return self.boundedness == Boundedness.LATENCY_BOUND

    @property
    def converged(self) -> bool:
        return self.phase == Phase.CONVERGED

    @property
    def active_slow_device(self) -> Optional[str]:
        """Name of the device whose share is being probed (arbiter gating)."""
        if self.topology.slows:
            return self.topology.slows[self._coord].name
        return None

    def headroom_pages(self, n_pages: int) -> int:
        """Shard capacity padding (pages) that keeps the WHOLE walk
        shape-stable.

        The walk is bounded: no device's share — and no slow pool's
        total — can exceed ``cfg.max_fraction``, and the fast tier can
        reclaim at most the initial slow share.  A shard padded by
        ``ceil(max_fraction * n_pages)`` pages therefore absorbs every
        actuation the controller can ever request, so a consumer built
        with this headroom (``InterleavedTensor.from_array(...,
        headroom=...)``, ``TieredKVCache.create(...,
        slow_headroom=...)``) never changes shape mid-walk: every shard
        keeps its storage (``data_ptr``) across all probe epochs."""
        return int(math.ceil(self.cfg.max_fraction * max(n_pages, 0)))

    @classmethod
    def from_plan(cls, plan: "Plan", buffer: str, topology: TierTopology,
                  config: Optional[CaptionConfig] = None
                  ) -> "CaptionController":
        """Seed the loop with the static planner's decision for ``buffer``:
        its per-device fractions are the cold-start prior, its capacity
        spill is the floor, and its boundedness selects the latency
        guardrail."""
        d = plan.decisions[buffer]
        weights = None
        if topology.slows and d.device_fractions:
            weights = tuple(d.device_fractions.get(t.name, 0.0)
                            for t in topology.slows)
        return cls(
            topology, config,
            initial_fraction=d.slow_fraction,
            min_fraction=d.min_slow_fraction,
            boundedness=d.boundedness,
            initial_weights=weights,
        )

    @classmethod
    def from_profile(cls, profile: AccessProfile, topology: TierTopology,
                     config: Optional[CaptionConfig] = None, *,
                     initial_fraction: float = 0.0,
                     min_fraction: float = 0.0) -> "CaptionController":
        """Seed the loop straight from a buffer's :class:`AccessProfile`
        — the §6.1 taxonomy applied on the controller-seeding path.

        The profile is classified against the ACTIVE slow tier; a
        LATENCY_BOUND verdict gets fast-pin seeding automatically (zero
        initial share, zero slow floor — Fig. 7: any slow fraction hurts
        a µs-SLO buffer), and the latency guardrail then keeps the walk
        monotone toward fast.  Anything else keeps the caller's prior.
        The drivers use this so a serving KV cache or optimizer state is
        never cold-started onto a tier its access pattern cannot
        amortize."""
        bd = classify_pool(profile, topology)
        if bd == Boundedness.LATENCY_BOUND:
            initial_fraction = 0.0
            min_fraction = 0.0
        return cls(topology, config,
                   initial_fraction=initial_fraction,
                   min_fraction=min_fraction, boundedness=bd)

    # -- warm-start memo -----------------------------------------------------
    def attach_memo(self, memo: "WarmStartMemo") -> None:
        """Attach a :class:`~repro_torch.core.warmstart.WarmStartMemo`.

        The first observed epoch fingerprints the workload (telemetry
        features + topology signature); on a memo hit the controller
        seeds at the remembered weight vector and enters MEASURE
        directly — one confirmation stint, then hold — skipping the
        walk.  On a miss the walk runs cold and the converged weights
        are filed under the fingerprint for next time.  Topology changes
        (hot remove/add) and drift re-probes reset the fingerprint, so a
        re-opened walk re-files under the workload it actually measured."""
        self._memo = memo
        self._memo_fp = None
        self._memo_checked = False

    def _memo_probe(self, metrics: EpochMetrics) -> Optional[Decision]:
        """First-epoch memo check: fingerprint, look up, maybe warm-start."""
        from repro_torch.core.warmstart import fingerprint_metrics
        self._memo_checked = True
        self._memo_fp = fingerprint_metrics(
            metrics, self.topology, boundedness=self.boundedness.value)
        remembered = self._memo.lookup(self._memo_fp)
        if remembered is None or len(remembered) != self.n_slow:
            return None
        target = [min(max(w, mw), 1.0)
                  for w, mw in zip(remembered, self.min_weights)]
        total = sum(target)
        if total > self.cfg.max_fraction > 0:
            target = [w * self.cfg.max_fraction / total for w in target]
        elif total < self.min_fraction:
            # The capacity floor outranks the memory: what does not fit
            # fast must stay placed, remembered optimum or not.
            if total > 0:
                target = [w * self.min_fraction / total for w in target]
            else:
                target = list(self._spread(self.min_fraction))
        self._confirm_hold = True
        return self._move_to(
            tuple(target), Phase.MEASURE,
            f"warm-start: memo hit -> {sum(target):.3f} "
            "(MEASURE, walk skipped)")

    # -- the loop ------------------------------------------------------------
    def observe_window(self, window, throughput: float, *,
                       mover=None, fast_pressure: Optional[float] = None,
                       slow_name=None,
                       seconds: Optional[float] = None) -> Decision:
        """One epoch straight from an EpochWindow: publish the standard
        gauges, close the window, derive metrics, decide.  The shared
        glue for every integration point (serving engine, train driver)."""
        metrics, _, _ = window_metrics(
            window, throughput, mover=mover, fast_pressure=fast_pressure,
            slow_name=slow_name, seconds=seconds)
        return self.observe(metrics)

    def set_growth_gate(self, gate) -> None:
        """Install a fleet-level growth gate (see core/arbiter.py).

        ``gate(controller, metrics) -> (scale, note)`` is consulted
        whenever a positive slow-share step is about to be taken; the
        returned multiplier in [0, 1] clips the step (0 freezes growth).
        A single buffer optimizing locally cannot see the *other* writers
        sharing the slow-tier links — the gate is where that global view
        (the per-device bandwidth budgets) vetoes local greed."""
        self._growth_gate = gate

    def actuated(self, fraction: float) -> None:
        """Feed back what the actuator actually achieved (scalar form).

        Page-granular actuation rounds the requested fraction (a step
        smaller than one page moves nothing); the walk must continue from
        the real operating point, not the phantom request, or throughput
        measurements get attributed to fractions the system never ran.
        The scalar is redistributed over the devices in the current
        proportions (use :meth:`actuated_weights` when the actuator knows
        the per-device outcome)."""
        f = float(fraction)
        total = self.fraction
        if total > 1e-12:
            self.weights = [w * f / total for w in self.weights]
        else:
            self.weights = list(self._spread(f))

    def actuated_weights(self, weights: Sequence[float]) -> None:
        """Feed back the per-device shares the actuator actually achieved."""
        if len(weights) != self.n_slow:
            raise ValueError(f"need {self.n_slow} weights")
        self.weights = [float(w) for w in weights]

    # -- elastic topology (hot-remove / hot-add) -----------------------------
    def remove_device(self, name: str) -> None:
        """Hot-remove slow device ``name`` from the walk.

        The weight simplex loses the coordinate, the total slow share is
        preserved, and the surviving devices are re-seeded bandwidth-
        proportionally (the Fig. 10 best-static-ratio prior, same as a
        cold start on the shrunken topology).  The walk re-opens: the old
        operating point measured a pool that no longer exists."""
        names = self.topology.slow_names
        if name not in names:
            raise KeyError(name)
        if len(names) <= 1:
            raise ValueError("cannot remove the last slow device")
        i = names.index(name)
        total = self.fraction
        self.topology = self.topology.remove_device(name)
        self.n_slow = self.topology.n_slow
        self.min_weights = tuple(w for j, w in enumerate(self.min_weights)
                                 if j != i)
        bw = self.topology.bandwidth_weights()
        self.weights = [max(total * b, mw)
                        for b, mw in zip(bw, self.min_weights)]
        over = sum(self.weights)
        if over > self.cfg.max_fraction > 0:
            self.weights = [w * self.cfg.max_fraction / over
                            for w in self.weights]
        self._reopen()

    def add_device(self, spec, *, initial_weight: float = 0.0) -> None:
        """Hot-add a slow device (a TierSpec or a name the topology can
        promote from ``extra`` / the registry).

        The survivors keep their converged shares — re-probing starts
        from the converged point, not a cold restart — and the newcomer
        enters at ``initial_weight`` with the walk re-opened on ITS
        coordinate, so the next probe climbs the new device first."""
        self.topology = self.topology.add_device(spec)
        self.n_slow = self.topology.n_slow
        self.min_weights = self.min_weights + (0.0,)
        self.weights = list(self.weights) + [
            min(max(float(initial_weight), 0.0), self.cfg.max_fraction)]
        self._reopen()
        self._coord = self.n_slow - 1
        self._coord_start = self.weights[self._coord]

    def observe(self, metrics: EpochMetrics) -> Decision:
        """Feed one epoch; returns the (possibly updated) target weights."""
        a = self.cfg.ewma_alpha
        self._ewma = (metrics.throughput if self._ewma is None
                      else a * metrics.throughput + (1 - a) * self._ewma)
        self._epochs_here += 1
        if self._memo is not None and not self._memo_checked:
            warm = self._memo_probe(metrics)
            if warm is not None:
                return warm
        if self.phase == Phase.CONVERGED:
            drifted = self._check_drift(metrics)
            if drifted is not None:
                return drifted
            return self._emit(False, "converged; holding")
        if self._epochs_here < self.cfg.probe_epochs:
            return self._emit(False, "measuring", phase=Phase.MEASURE)
        return self._adjust(metrics)

    # -- workload-shift re-probing -------------------------------------------
    def _check_drift(self, metrics: EpochMetrics) -> Optional[Decision]:
        """While CONVERGED, watch the EWMA slow-route bandwidth; a drift
        beyond ``drift_threshold`` re-opens the walk (the §7 follow-up:
        Caption must notice the workload changed under it).

        With the per-device split each device's route is tracked against
        its own hold reference, so the detector names WHICH device
        shifted and a compensating shift (one route up, another down,
        aggregate flat) still re-opens the walk."""
        if self.cfg.drift_threshold <= 0:
            return None
        # Per-device references when the split is populated; otherwise the
        # aggregate route (hand-built metrics, single-device topologies).
        samples = (dict(metrics.device_slow_bw) or
                   {"<pool>": metrics.slow_bw})
        if self._hold_bw is None:
            self._hold_bw = metrics.slow_bw
            self._hold_bw_dev = dict(samples)
            return None
        worst_rel, worst_dev = 0.0, None
        for name, bw in samples.items():
            held = self._hold_bw_dev.get(name)
            if held is None:  # route appeared mid-hold (elastic add)
                self._hold_bw_dev[name] = bw
                continue
            rel = abs(bw - held) / max(held, 1.0)
            if rel > worst_rel:
                worst_rel, worst_dev = rel, name
        if worst_rel <= self.cfg.drift_threshold:
            a = self.cfg.ewma_alpha
            self._hold_bw = (a * metrics.slow_bw
                             + (1 - a) * self._hold_bw)
            for name, bw in samples.items():
                self._hold_bw_dev[name] = (
                    a * bw + (1 - a) * self._hold_bw_dev[name])
            return None
        self._reopen()
        where = "" if worst_dev in (None, "<pool>") else f" on {worst_dev}"
        return self._emit(
            False,
            f"route-bw drift {worst_rel*100:+.0f}%{where}: workload "
            "shift, re-probing",
            phase=Phase.MEASURE)

    def reopen(self, reason: str) -> Decision:
        """Re-open the walk on an EXTERNAL drift signal.

        The route-bandwidth drift detector above is the controller's own
        re-open trigger; semantic layers have their own notion of the
        workload shifting under a converged walk — hot-set membership
        churn in ``core/hotness.py`` is the canonical caller — and this
        is their public entry: reset the walk exactly like a bandwidth
        drift re-probe and emit the (unchanged-weights) MEASURE decision
        so the history records why."""
        self._reopen()
        return self._emit(False, f"re-opened: {reason}", phase=Phase.MEASURE)

    def _reopen(self) -> None:
        """Reset the walk state for a fresh convergence run."""
        self.phase = Phase.WARMUP
        self._step = self.cfg.step
        self._restart_step = self.cfg.step
        self._dir = -1.0 if self.latency_bound else 1.0
        self._prev = None
        self._ewma = None
        self._epochs_here = 0
        self._stale = 0
        self._coord = 0
        self._coord_start = self.weights[0]
        self._hold_bw = None
        self._hold_bw_dev = {}
        self._duel = None
        self._duel_wins = 0
        self._duel_rejects = 0
        self._duel_losses = 0
        self._confirm_hold = False
        # The workload (or topology) changed under us: the next observe
        # re-fingerprints, so the memo files the walk under what it
        # actually measured — and may warm-start if the NEW workload is
        # itself a remembered one.
        self._memo_fp = None
        self._memo_checked = False

    # -- the hill-climb ------------------------------------------------------
    def _adjust(self, metrics: EpochMetrics) -> Decision:
        if self._confirm_hold:
            # Warm-started from the memo: the remembered optimum measured
            # one full stint without surprises — hold (drift re-probing
            # guards staleness from here, exactly like a walked optimum).
            self._confirm_hold = False
            return self._move_to(tuple(self.weights), Phase.CONVERGED,
                                 "warm-start confirmed; holding")
        if self.cfg.duel_count > 0:
            return self._adjust_duel(metrics)
        cur_t = float(self._ewma)
        c = self._coord
        reason = ""
        if self._prev is not None:
            prev_w, prev_t = self._prev
            rel = (cur_t - prev_t) / max(abs(prev_t), 1e-12)
            self._note_utility(sum(prev_w), prev_t, self.fraction, cur_t)
            if rel < -self.cfg.hysteresis:
                # Regression: back off to the better point, reverse, shrink.
                # A latency-bound buffer may only ever revert DOWNWARD (the
                # monotone guardrail beats the hill-climber's memory).
                self._dir, self._step = -self._dir, self._step / 2
                back = (tuple(min(p, w) for p, w
                              in zip(prev_w, self.weights))
                        if self.latency_bound else prev_w)
                if self._step < self.cfg.min_step:
                    return self._finish_coord(
                        back, "regressed; step underflow -> hold at "
                        f"{sum(back):.3f}")
                return self._move_to(back, Phase.ADJUST,
                                     f"regressed {rel*100:+.1f}%; revert + "
                                     "reverse")
            if rel <= self.cfg.hysteresis:
                # Flat within hysteresis: the gradient is gone; shrink.
                self._step /= 2
                if self._step < self.cfg.min_step:
                    return self._finish_coord(tuple(self.weights),
                                              "flat; coordinate done")
                reason = f"flat ({rel*100:+.1f}%); refining"
            else:
                reason = f"improved {rel*100:+.1f}%; continue"
        else:
            reason = "cold start; probing"

        delta = self._dir * self._step
        delta, guard = self._guardrails(delta, metrics)
        target = list(self.weights)
        target[c] = self._clamp_coord(c, self.weights[c] + delta)
        if guard:
            reason = f"{reason} [{guard}]"
        if abs(target[c] - self.weights[c]) <= 1e-12:
            # Pinned against a bound or frozen by a guardrail; if the walk
            # cannot move this coordinate it is done here.
            if self._at_bound():
                return self._finish_coord(tuple(self.weights),
                                          reason + "; immovable")
            return self._move_to(tuple(target), Phase.ADJUST,
                                 reason + "; immovable")
        return self._move_to(tuple(target), Phase.ADJUST, reason)

    # -- noise-robust probing: paired duels ----------------------------------
    def _adjust_duel(self, metrics: EpochMetrics) -> Decision:
        """Dueling replacement for the single-sample accept/reject.

        A candidate point w±δ is judged by ``duel_count`` PAIRED stints:
        the controller alternates ``probe_epochs``-long holds at the
        incumbent and the candidate, compares each pair, and accepts
        only on a significant majority of wins — one lucky (or noisy)
        window never moves the operating point.  The step expands on
        consecutive accepted duels and shrinks on rejections (adaptive
        step sizing), bounded by ``max_step``/``min_step``."""
        cur_t = float(self._ewma)
        n = self.cfg.duel_count
        d = self._duel
        if d is not None:
            if d["at"] == "cand":
                d["cand_t"].append(cur_t)
                if len(d["cand_t"]) >= n:
                    return self._duel_decide()
                d["at"] = "base"
                return self._move_to(
                    d["base_w"], Phase.ADJUST,
                    f"duel {len(d['cand_t']) + 1}/{n}: re-measure incumbent")
            d["base_t"].append(cur_t)
            d["at"] = "cand"
            return self._move_to(
                d["cand_w"], Phase.ADJUST,
                f"duel {len(d['cand_t']) + 1}/{n}: probe candidate")
        # Fresh duel: the stint just measured is the incumbent's first
        # sample; pick the candidate exactly like the legacy climb does.
        c = self._coord
        delta = self._dir * self._step
        delta, guard = self._guardrails(delta, metrics)
        target = list(self.weights)
        target[c] = self._clamp_coord(c, self.weights[c] + delta)
        reason = f"duel 1/{n}: probe candidate"
        if guard:
            reason = f"{reason} [{guard}]"
        if abs(target[c] - self.weights[c]) <= 1e-12:
            # Pinned/frozen: no candidate to duel.  Without the legacy
            # flat-shrink (duels never consult _prev) the step must decay
            # here, or a guardrail-frozen coordinate would spin forever.
            self._step /= 2
            if self._at_bound() or self._step < self.cfg.min_step:
                return self._finish_coord(tuple(self.weights),
                                          reason + "; immovable")
            return self._move_to(tuple(self.weights), Phase.ADJUST,
                                 reason + "; immovable")
        self._duel = {"base_w": tuple(self.weights),
                      "cand_w": tuple(target),
                      "base_t": [cur_t], "cand_t": [], "at": "cand"}
        return self._move_to(tuple(target), Phase.ADJUST, reason)

    def _duel_decide(self) -> Decision:
        """All paired stints are in: the candidate must beat the
        incumbent on the PAIRED MEAN beyond the hysteresis band (noise
        averages down across the duels where a single sample cannot),
        and a significant majority of individual losses reverses the
        walk direction."""
        d, self._duel = self._duel, None
        wins = losses = 0
        rels = []
        for b, c in zip(d["base_t"], d["cand_t"]):
            rel = (c - b) / max(abs(b), 1e-12)
            rels.append(rel)
            if rel > self.cfg.hysteresis:
                wins += 1
            elif rel < -self.cfg.hysteresis:
                losses += 1
        n = len(d["cand_t"])
        mean_rel = sum(rels) / n
        base_w, cand_w = d["base_w"], d["cand_w"]
        self._note_utility(sum(base_w), sum(d["base_t"]) / len(d["base_t"]),
                           sum(cand_w), sum(d["cand_t"]) / n)
        tag = f"duel {wins}W-{losses}L/{n} mean {mean_rel*100:+.1f}%"
        if mean_rel > self.cfg.hysteresis and wins >= losses:
            # Significant paired win: commit the candidate; consecutive
            # wins expand the step (a clean gradient deserves coarser
            # probes).
            self._duel_wins += 1
            self._duel_rejects = 0
            self._duel_losses = 0
            if self._duel_wins >= 2 and self.cfg.step_expand > 1.0:
                cap = max(self.cfg.max_step, self.cfg.step)
                self._step = min(self._step * self.cfg.step_expand, cap)
                tag += f"; step up to {self._step:.3f}"
            return self._move_to(cand_w, Phase.ADJUST, tag + "; accept")
        self._duel_wins = 0
        sig_loss = (mean_rel < -self.cfg.hysteresis
                    and losses >= (n + 1) // 2)
        self._duel_losses = self._duel_losses + 1 if sig_loss else 0
        self._duel_rejects += 1
        if self._duel_losses >= 2:
            # TWO consecutive significant majority losses: real gradient
            # pointing the other way (a true overshoot loses every duel;
            # a single loss can be a noise blip) — reverse and shrink.
            self._dir = -self._dir
            self._duel_losses = 0
            self._duel_rejects = 0
            self._step /= 2
            if self._step < self.cfg.min_step:
                return self._finish_coord(base_w, tag + "; step underflow")
            return self._move_to(base_w, Phase.ADJUST,
                                 tag + "; confirmed loss, reverse")
        # A tie (or one loss) is not yet gradient: retry once at the same
        # step before shrinking (shrink patience).  A single unlucky duel
        # would otherwise halve the step, weaken the next duel's signal,
        # and spiral to a premature hold; a true peak still rejects twice
        # in a row and converges.
        if self._duel_rejects < 2:
            return self._move_to(base_w, Phase.ADJUST, tag + "; reject (retry)")
        self._duel_rejects = 0
        self._step /= 2
        if self._step < self.cfg.min_step:
            return self._finish_coord(base_w, tag + "; step underflow")
        return self._move_to(base_w, Phase.ADJUST, tag + "; reject")

    def _note_utility(self, prev_f: float, prev_t: float,
                      cur_f: float, cur_t: float) -> None:
        """EWMA the measured marginal utility (Δthroughput/Δfraction) —
        the controller's contribution to the arbiter's joint rounds."""
        df = cur_f - prev_f
        if abs(df) <= 1e-9:
            return
        u = (cur_t - prev_t) / df
        self._utility = (u if self._utility is None
                         else 0.5 * u + 0.5 * self._utility)

    # -- arbiter joint rounds (propose/commit) -------------------------------
    def propose_growth(self) -> float:
        """Slow-share growth this buffer would take next on its active
        coordinate, in fraction points (the PROPOSE half of the
        arbiter's joint round).  Zero while converged, mid-duel,
        walking down, or latency-bound — those states have no growth
        appetite to coordinate."""
        if (self.converged or self.latency_bound or self._duel is not None
                or self._confirm_hold or self._dir <= 0):
            return 0.0
        c = self._coord
        target = self._clamp_coord(c, self.weights[c] + self._step)
        return max(target - self.weights[c], 0.0)

    def marginal_utility(self) -> float:
        """Recent Δthroughput per Δslow-fraction (>= 0); 0 when the walk
        has not yet measured a move."""
        return max(self._utility or 0.0, 0.0)

    def commit_joint(self, delta: float) -> Decision:
        """COMMIT an arbiter-granted joint move: apply ``delta`` on the
        active coordinate (clamped to the same bounds the walk honors)
        and keep measuring from the new point.

        A grant is evidence of budget headroom, so the probe step is
        restored to at least its initial size — the walk only anneals to
        convergence once grants stop coming.  A bad grant is not
        terminal either: the next measured stint sees the regression and
        the local climb reverts it (shrink steps are never gated)."""
        if self._duel is not None or self.latency_bound:
            return self._emit(False, "joint grant ignored (mid-duel or "
                                     "latency-bound)")
        c = self._coord
        target = list(self.weights)
        target[c] = self._clamp_coord(c, self.weights[c] + float(delta))
        if abs(target[c] - self.weights[c]) <= 1e-12:
            return self._emit(False, "joint grant clamped to no-op")
        self._step = max(self._step, self.cfg.step)
        return self._move_to(
            tuple(target), Phase.ADJUST,
            f"arbiter joint grant {target[c] - self.weights[c]:+.3f} "
            f"on {self.active_slow_device or 'slow'}")

    def _clamp_coord(self, c: int, value: float) -> float:
        """Clamp one coordinate to its floor, the simplex ceiling, and the
        total-fraction floor (the capacity spill must stay placed)."""
        others = self.fraction - self.weights[c]
        lo = max(self.min_weights[c], self.min_fraction - others)
        hi = max(lo, self.cfg.max_fraction - others)
        return min(max(value, lo), hi)

    def _guardrails(self, delta: float, m: EpochMetrics) -> tuple[float, str]:
        notes = []
        if self.latency_bound and delta > 0:
            # Guideline 5 / Fig. 7: never grow the slow share of a
            # latency-bound buffer.
            delta = 0.0
            notes.append("latency-bound: growth pinned")
        if delta > 0 and m.writer_concurrency > self.cfg.writer_limit:
            delta = 0.0
            notes.append(
                f"writers {m.writer_concurrency} > {self.cfg.writer_limit}")
        if delta > 0 and self.cfg.write_damp:
            dev = self._active_spec()
            # The damp is per ACTIVE device: only ITS write share matters
            # (a write storm on CXL-B must not damp growth toward CXL-A).
            wr = m.write_ratio_for(dev.name if dev is not None else None)
            if dev is not None and wr > 0:
                damp = 1.0 - wr * (1.0 - dev.store_bw / dev.load_bw)
                delta *= max(damp, 0.0)
                if damp < 1.0:
                    notes.append(f"write-damped x{damp:.2f}")
        if delta > 0 and self._growth_gate is not None:
            scale, note = self._growth_gate(self, m)
            delta *= min(max(scale, 0.0), 1.0)
            if note:
                notes.append(note)
        if delta < 0 and m.fast_pressure >= self.cfg.pressure_high:
            delta = 0.0
            notes.append(
                f"fast pressure {m.fast_pressure:.2f}: shrink frozen")
        return delta, "; ".join(notes)

    def _active_spec(self):
        """TierSpec of the device whose coordinate is being walked."""
        if self.topology.slows:
            return self.topology.slows[min(self._coord,
                                           len(self.topology.slows) - 1)]
        return self.topology.slow

    def _at_bound(self) -> bool:
        c = self._coord
        w = self.weights[c]
        lo = max(self.min_weights[c],
                 self.min_fraction - (self.fraction - w))
        hi = self.cfg.max_fraction - (self.fraction - w)
        return (w <= lo + 1e-12 and self._dir < 0) or (
            w >= hi - 1e-12 and self._dir > 0)

    def _finish_coord(self, weights: tuple[float, ...], reason: str
                      ) -> Decision:
        """This coordinate's walk ended: converge (single device or a full
        stale pass) or hand the walk to the next device."""
        self._duel_wins = 0
        self._duel_rejects = 0
        self._duel_losses = 0
        if self.n_slow == 1:
            return self._move_to(weights, Phase.CONVERGED, reason)
        # "Moved" means net progress beyond the walk's own probe
        # granularity — the excursion-and-revert dance around an optimum
        # displaces by up to half the restart step without meaning it.
        moved = (abs(weights[self._coord] - self._coord_start)
                 > max(self.cfg.min_step, self._restart_step / 2) + 1e-12)
        self._stale = 0 if moved else self._stale + 1
        if self._stale >= self.n_slow:
            return self._move_to(weights, Phase.CONVERGED,
                                 reason + "; all devices stale")
        out = self._move_to(weights, Phase.ADJUST,
                            reason + "; next device")
        self._coord = (self._coord + 1) % self.n_slow
        if self._coord == 0:  # a full pass ended: anneal the probe step
            self._restart_step = max(2 * self.cfg.min_step,
                                     self._restart_step / 2)
        self._coord_start = self.weights[self._coord]
        self._step = self._restart_step
        self._dir = -1.0 if self.latency_bound else 1.0
        self._prev = None  # fresh baseline for the new coordinate
        return out

    def _move_to(self, weights: tuple[float, ...], phase: Phase,
                 reason: str) -> Decision:
        changed = any(abs(a - b) > 1e-12
                      for a, b in zip(weights, self.weights))
        # A joint grant can land before this stint measured anything; a
        # missing EWMA means there is no baseline worth remembering.
        self._prev = (None if self._ewma is None
                      else (tuple(self.weights), float(self._ewma)))
        self.weights = list(weights)
        self.phase = phase
        self._ewma = None
        self._epochs_here = 0
        if phase == Phase.CONVERGED:
            self._hold_bw = None  # fresh drift reference at the hold point
            self._hold_bw_dev = {}
            if self._memo is not None and self._memo_fp is not None:
                # File (or refresh) the converged answer under the
                # fingerprint taken when this walk opened.
                self._memo.record(self._memo_fp, tuple(self.weights))
        return self._emit(changed, reason, phase=phase)

    def _emit(self, changed: bool, reason: str,
              phase: Optional[Phase] = None) -> Decision:
        if phase is not None:
            self.phase = phase
        d = Decision(self.fraction, changed, self.phase, reason,
                     weights=tuple(self.weights))
        self.history.append(d)
        return d
