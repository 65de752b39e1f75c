"""CaptionArbiter — a fleet-level control plane over per-buffer Caption loops.

The paper's contention findings (§3, Fig. 3) are about a *shared*
resource: a handful of concurrent writers collapses the CXL controller,
and per-link bandwidth is one pool that independent agents will
oversubscribe.  After PR 2 every tiered buffer (weights, KV cache,
optimizer state) ran its own :class:`~repro_torch.core.caption.CaptionController`
— N local optimizers, each blind to the traffic the others push onto the
same slow tier.  ``CaptionArbiter`` turns those into one coordinated
subsystem:

  * it owns a **global slow-tier write-bandwidth budget** (bytes/s);
  * every per-buffer controller **registers** with it, and each epoch the
    arbiter collects that buffer's *billed* slow-tier traffic from the
    :class:`~repro_torch.core.telemetry.EpochWindow` source-attributed route
    counters;
  * it **grants** each buffer a bandwidth share — latency-bound buffers
    are served first in full (Fig. 7: they should not be on the slow
    tier at all, so what little floor-forced traffic they have has
    absolute priority), the rest split the remainder proportionally to
    ``share x demand`` with a **starvation floor** so no buffer is
    squeezed to zero by a louder neighbor;
  * growth steps are **gated** (a buffer at/over its grant cannot grow
    its slow fraction) and over-budget operating points are **clipped**
    (fraction scaled back toward its grant, never below the capacity
    floor), so the *sum* of slow-tier writes converges under budget.

The per-buffer controllers keep doing the §7 hill-climb; the arbiter
only vetoes/clips — local search under a global constraint.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.caption import (CaptionController, Decision, EpochMetrics,
                                window_metrics)
from repro_torch.core.tiers import TierTopology


@dataclasses.dataclass(frozen=True)
class ArbiterConfig:
    """Knobs of the global budget (documented in ROADMAP.md)."""

    #: aggregate slow-tier write-bandwidth budget (bytes/s). The natural
    #: setting is the sum of the slow devices' nt-store bandwidths (or
    #: their link bandwidths).
    slow_bw_budget: float
    #: minimum share of the budget reserved for every registered
    #: bandwidth-class buffer (starvation floor), in [0, 1/n_buffers].
    starvation_floor: float = 0.05
    #: relative overshoot of the aggregate budget tolerated before
    #: operating points are clipped back toward their grants.
    slack: float = 0.05
    #: EWMA smoothing for per-buffer demand (one noisy window never clips).
    ewma_alpha: float = 0.5
    #: per-slow-device write-bandwidth budgets (bytes/s, by tier name).
    #: The paper's devices collapse independently (Fig. 3 is per
    #: controller), so each device carries its own ceiling; None keeps the
    #: single aggregate pool of the two-device era.
    device_budgets: Optional[dict[str, float]] = None
    #: coordinated growth: freeze every buffer's unilateral slow-share
    #: growth and grant it through :meth:`CaptionArbiter.joint_move`
    #: propose/commit rounds instead (clipping independent greed is
    #: replaced by a marginal-utility-ordered joint allocation under the
    #: same budgets).  Shrink steps stay local either way.
    joint_moves: bool = False

    def __post_init__(self):
        if self.slow_bw_budget <= 0:
            raise ValueError("slow_bw_budget must be > 0")
        if not 0.0 <= self.starvation_floor < 1.0:
            raise ValueError("starvation_floor in [0, 1)")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha in (0, 1]")
        if self.device_budgets is not None:
            if any(v <= 0 for v in self.device_budgets.values()):
                raise ValueError("device budgets must be > 0")


def budgeted_config(topology: TierTopology,
                    slow_budget: float) -> Optional[ArbiterConfig]:
    """ArbiterConfig for an explicit scalar budget (the drivers'
    ``--slow-budget``): on a multi-device topology the per-device
    ceilings survive, scaled nt-store-proportionally so they sum to the
    given budget — a scalar budget must not silently disable per-device
    enforcement.  Returns None (the defaults) for a non-positive budget."""
    if slow_budget <= 0:
        return None
    if topology.n_slow > 1:
        nts = {t.name: t.nt_store_bw for t in topology.slows}
        total = sum(nts.values())
        return ArbiterConfig(
            slow_bw_budget=slow_budget,
            device_budgets={k: v / total * slow_budget
                            for k, v in nts.items()})
    return ArbiterConfig(slow_bw_budget=slow_budget)


@dataclasses.dataclass
class _Entry:
    name: str
    controller: CaptionController
    share: float = 1.0
    demand_bw: float = 0.0  # EWMA of billed slow-tier write bandwidth
    grant_bw: float = 0.0
    epochs: int = 0
    #: EWMA of billed write bandwidth per slow device (by tier name).
    demand_dev: dict[str, float] = dataclasses.field(default_factory=dict)


class CaptionArbiter:
    """Owns the slow-tier bandwidth budgets; registers per-buffer loops."""

    def __init__(self, topology: TierTopology,
                 config: Optional[ArbiterConfig] = None):
        if config is None:
            slows = topology.slows or (topology.fast,)
            budgets = {t.name: t.nt_store_bw for t in slows}
            config = ArbiterConfig(
                slow_bw_budget=sum(budgets.values()),
                device_budgets=budgets if len(budgets) > 1 else None)
        self.topology = topology
        self.cfg = config
        self._entries: dict[str, _Entry] = {}
        self.history: list[dict] = []

    # -- registration --------------------------------------------------------
    def register(self, name: str, controller: CaptionController,
                 *, share: float = 1.0) -> CaptionController:
        """Register a per-buffer controller under the global budget.

        Installs the growth gate on the controller and returns it (so
        ``arbiter.register("kv", CaptionController(...))`` reads fluently).
        """
        if name in self._entries:
            raise ValueError(f"buffer {name!r} already registered")
        if share <= 0:
            raise ValueError("share must be > 0")
        entry = _Entry(name=name, controller=controller, share=share)
        controller.set_growth_gate(self._gate(name))
        self._entries[name] = entry
        self._recompute_grants()
        return controller

    def controller(self, name: str) -> CaptionController:
        return self._entries[name].controller

    # -- elastic topology ----------------------------------------------------
    def remove_device(self, name: str) -> None:
        """Hot-remove slow device ``name`` from the budget pool: drop its
        per-device ceiling, forget its billed demand (a dead device's
        EWMA must not keep gating survivors' growth), and recompute the
        grants over the shrunken topology."""
        self.topology = self.topology.remove_device(name)
        if self.cfg.device_budgets and name in self.cfg.device_budgets:
            budgets = {k: v for k, v in self.cfg.device_budgets.items()
                       if k != name}
            self.cfg = dataclasses.replace(self.cfg,
                                           device_budgets=budgets or None)
        for e in self._entries.values():
            e.demand_dev.pop(name, None)
        self._recompute_grants()

    def add_device(self, spec) -> None:
        """Hot-add a slow device (TierSpec or name): extend the per-device
        budgets with its nt-store bandwidth (the natural ceiling) and
        recompute grants."""
        self.topology = self.topology.add_device(spec)
        added = self.topology.slows[-1]
        if self.cfg.device_budgets is not None:
            budgets = dict(self.cfg.device_budgets)
            budgets.setdefault(added.name, added.nt_store_bw)
            self.cfg = dataclasses.replace(self.cfg, device_budgets=budgets)
        self._recompute_grants()

    @property
    def buffers(self) -> tuple[str, ...]:
        return tuple(self._entries)

    # -- accounting ----------------------------------------------------------
    def aggregate_demand_bw(self) -> float:
        return sum(e.demand_bw for e in self._entries.values())

    def grants(self) -> dict[str, float]:
        return {n: e.grant_bw for n, e in self._entries.items()}

    def demands(self) -> dict[str, float]:
        return {n: e.demand_bw for n, e in self._entries.items()}

    def device_demands(self) -> dict[str, float]:
        """Aggregate billed write bandwidth per slow device (all buffers)."""
        out: dict[str, float] = {}
        for e in self._entries.values():
            for dev, bw in e.demand_dev.items():
                out[dev] = out.get(dev, 0.0) + bw
        return out

    def _bill(self, name: str, slow_bw: float,
              device_bw: Optional[dict[str, float]] = None) -> None:
        e = self._entries[name]
        a = self.cfg.ewma_alpha
        e.demand_bw = (slow_bw if e.epochs == 0
                       else a * slow_bw + (1 - a) * e.demand_bw)
        if device_bw is not None:
            for dev, bw in device_bw.items():
                prev = e.demand_dev.get(dev)
                e.demand_dev[dev] = (bw if prev is None or e.epochs == 0
                                     else a * bw + (1 - a) * prev)
        e.epochs += 1
        self._recompute_grants()

    def _recompute_grants(self) -> None:
        """Split the budget: latency-bound first in full, then the floor,
        then proportional to ``share x demand`` (weighted max-min)."""
        entries = list(self._entries.values())
        if not entries:
            return
        budget = self.cfg.slow_bw_budget
        lat = [e for e in entries if e.controller.latency_bound]
        rest = [e for e in entries if not e.controller.latency_bound]
        remaining = budget
        for e in lat:  # absolute priority (Fig. 7)
            e.grant_bw = min(e.demand_bw, remaining)
            remaining -= e.grant_bw
        if not rest:
            return
        floor = min(self.cfg.starvation_floor * budget,
                    remaining / len(rest))
        extra = remaining - floor * len(rest)
        weights = [e.share * max(e.demand_bw, 1e-12) for e in rest]
        total_w = sum(weights)
        for e, w in zip(rest, weights):
            e.grant_bw = floor + extra * w / total_w

    # -- the gate + clip -----------------------------------------------------
    def _gate(self, name: str):
        def gate(ctl: CaptionController, metrics: EpochMetrics
                 ) -> tuple[float, str]:
            if self.cfg.joint_moves:
                # Growth is coordinated: buffers propose, joint_move
                # commits.  Local climbs keep full authority to shrink.
                return 0.0, "arbiter: joint-move round"
            e = self._entries[name]
            total = self.aggregate_demand_bw()
            budget = self.cfg.slow_bw_budget
            # Per-device enforcement: the device whose share the controller
            # is about to grow must itself have headroom — a quiet CXL-B
            # cannot excuse pushing more writers onto a saturated CXL-A.
            dev = getattr(ctl, "active_slow_device", None)
            if dev is not None and self.cfg.device_budgets:
                dev_budget = self.cfg.device_budgets.get(dev)
                if dev_budget:
                    dev_total = self.device_demands().get(dev, 0.0)
                    if dev_total >= dev_budget:
                        return 0.0, (f"arbiter: device {dev} at budget "
                                     f"({dev_total:.3g}>="
                                     f"{dev_budget:.3g} B/s)")
            if total > budget:
                return 0.0, (f"arbiter: fleet over budget "
                             f"({total:.3g}>{budget:.3g} B/s)")
            if e.grant_bw > 0 and e.demand_bw >= e.grant_bw:
                return 0.0, (f"arbiter: at grant "
                             f"({e.demand_bw:.3g}>={e.grant_bw:.3g} B/s)")
            if e.grant_bw > 0:
                # Taper growth as the buffer approaches its grant so the
                # fleet glides into the budget instead of slamming it.
                headroom = 1.0 - e.demand_bw / e.grant_bw
                if headroom < 0.5:
                    return 2 * headroom, f"arbiter: taper x{2*headroom:.2f}"
            return 1.0, ""
        return gate

    def _clip(self, name: str, decision: Decision) -> Decision:
        """Scale an over-budget buffer's operating point back toward its
        grant (never below the capacity floor — the starvation guarantee
        in fraction space)."""
        e = self._entries[name]
        total = self.aggregate_demand_bw()
        budget = self.cfg.slow_bw_budget
        if (total <= budget * (1.0 + self.cfg.slack)
                or e.demand_bw <= e.grant_bw
                or e.grant_bw <= 0):
            return self._clip_devices(name, decision)
        ctl = e.controller
        scale = e.grant_bw / e.demand_bw
        target = max(ctl.min_fraction, decision.fraction * scale)
        if target >= decision.fraction - 1e-12:
            return self._clip_devices(name, decision)
        ctl.actuated(target)
        return self._clip_devices(name, dataclasses.replace(
            decision, fraction=target, changed=True,
            weights=tuple(ctl.weights),
            reason=(decision.reason
                    + f" [arbiter clip x{scale:.2f} -> {target:.3f}]")))

    def _clip_devices(self, name: str, decision: Decision) -> Decision:
        """Per-device over-budget clip: scale this buffer's share of a
        saturated device back toward that device's budget, leaving its
        shares on devices with headroom untouched (never dropping the
        total below the capacity floor)."""
        if not self.cfg.device_budgets:
            return decision
        e = self._entries[name]
        ctl = e.controller
        names = self.topology.slow_names
        weights = list(decision.weights)
        if len(weights) != len(names) or not weights:
            return decision
        dev_totals = self.device_demands()
        clipped = []
        for i, dev in enumerate(names):
            dev_budget = self.cfg.device_budgets.get(dev)
            if not dev_budget or weights[i] <= 0:
                continue
            dev_total = dev_totals.get(dev, 0.0)
            mine = e.demand_dev.get(dev, 0.0)
            if dev_total <= dev_budget * (1.0 + self.cfg.slack) or mine <= 0:
                continue
            scale = dev_budget / dev_total
            floor_slack = sum(weights) - ctl.min_fraction
            cut = min(weights[i] * (1.0 - scale), max(floor_slack, 0.0))
            if cut <= 1e-12:
                continue
            weights[i] -= cut
            clipped.append(f"{dev} x{scale:.2f}")
        if not clipped:
            return decision
        ctl.actuated_weights(weights)
        return dataclasses.replace(
            decision, fraction=sum(weights), weights=tuple(weights),
            changed=True,
            reason=decision.reason + f" [device clip {', '.join(clipped)}]")

    # -- joint moves (propose/commit) ----------------------------------------
    def _growth_cost_bw(self, e: _Entry) -> float:
        """Estimated slow-tier write-bandwidth cost of one slow-fraction
        point for buffer ``e`` — its billed demand scaled by its current
        share.  A cold buffer (nothing billed yet, or a ~zero fraction)
        borrows the fleet average; with no evidence at all, one fraction
        point is conservatively priced at the whole budget, so the first
        round still grants but cannot blow through the ceiling."""
        f = e.controller.fraction
        if e.demand_bw > 0 and f > 1e-3:
            return e.demand_bw / f
        known = [x.demand_bw / x.controller.fraction
                 for x in self._entries.values()
                 if x.demand_bw > 0 and x.controller.fraction > 1e-3]
        if known:
            return sum(known) / len(known)
        return self.cfg.slow_bw_budget

    def joint_move(self, utilities: Optional[dict[str, float]] = None
                   ) -> dict[str, float]:
        """One propose/commit round of coordinated growth.

        PROPOSE: every registered buffer reports the slow-share step it
        would take next (:meth:`CaptionController.propose_growth`) and
        its marginal utility — Δthroughput per Δfraction from its recent
        duel outcomes / accepted moves, overridable per buffer via
        ``utilities`` (e.g. a perfmodel estimate).  COMMIT: proposals
        are granted in utility-per-bandwidth-cost order against the
        remaining budget headroom (global and per device), partially
        when headroom runs short, and applied with
        :meth:`CaptionController.commit_joint`.

        This replaces clip-the-greedy coordination: instead of every
        buffer growing independently and the over-budget ones being
        scaled back after the fact, the fleet's growth is allocated
        where a byte of slow-tier bandwidth buys the most throughput.
        Returns {buffer: granted fraction points} (committed proposals
        only)."""
        headroom = self.cfg.slow_bw_budget - self.aggregate_demand_bw()
        dev_free: dict[str, float] = {}
        if self.cfg.device_budgets:
            dev_demand = self.device_demands()
            dev_free = {d: max(b - dev_demand.get(d, 0.0), 0.0)
                        for d, b in self.cfg.device_budgets.items()}
        proposals = []
        for name, e in self._entries.items():
            want = e.controller.propose_growth()
            if want <= 1e-12:
                continue
            u = (utilities or {}).get(name, e.controller.marginal_utility())
            cost = max(self._growth_cost_bw(e), 1e-12)
            proposals.append((u / cost, name, want, cost, e.controller))
        grants: dict[str, float] = {}
        headroom = max(headroom, 0.0)
        for _, name, want, cost, ctl in sorted(
                proposals, key=lambda p: (-p[0], p[1])):
            afford = headroom / cost
            dev = ctl.active_slow_device
            if dev in dev_free:
                afford = min(afford, dev_free[dev] / cost)
            granted = min(want, max(afford, 0.0))
            if granted <= 1e-12:
                continue
            decision = ctl.commit_joint(granted)
            if not decision.changed:
                continue
            grants[name] = granted
            headroom -= granted * cost
            if dev in dev_free:
                dev_free[dev] = max(dev_free[dev] - granted * cost, 0.0)
        self.history.append({
            "joint_grants": dict(grants),
            "headroom_bw": headroom,
            "aggregate_bw": self.aggregate_demand_bw(),
        })
        return grants

    # -- the loop ------------------------------------------------------------
    def observe(self, name: str, metrics: EpochMetrics, *,
                slow_bw: Optional[float] = None,
                device_bw: Optional[dict[str, float]] = None) -> Decision:
        """One epoch for buffer ``name``: bill its slow-tier bandwidth
        (aggregate and per device), recompute grants, run its controller,
        clip if over budget."""
        if slow_bw is not None:
            self._bill(name, slow_bw, device_bw)
        decision = self._entries[name].controller.observe(metrics)
        decision = self._clip(name, decision)
        self.history.append({
            "buffer": name, "fraction": decision.fraction,
            "demand_bw": self._entries[name].demand_bw,
            "grant_bw": self._entries[name].grant_bw,
            "aggregate_bw": self.aggregate_demand_bw(),
            "reason": decision.reason,
        })
        return decision

    def observe_window(self, name: str, window, throughput: float, *,
                       mover=None, fast_pressure: Optional[float] = None,
                       slow_name=None,
                       seconds: Optional[float] = None) -> Decision:
        """The EpochWindow glue, source-billed: closes ``window``, derives
        the buffer's metrics (same shared glue as
        ``CaptionController.observe_window``), and bills its slow-tier
        writes — per device — from the source-attributed route counters.
        Only when the window saw NO attribution at all (single-buffer
        legacy telemetry) do the raw route bytes stand in — a window with
        co-tenant attribution must never bill a quiet buffer its
        neighbors' bytes."""
        metrics, counters, slow_name = window_metrics(
            window, throughput, mover=mover, fast_pressure=fast_pressure,
            slow_name=slow_name, seconds=seconds)
        names = ((slow_name,) if isinstance(slow_name, str)
                 else tuple(slow_name))
        dt = max(counters.seconds, 1e-9)
        per_dev = {n: counters.bytes_into(n, source=name) for n in names}
        per_dev_out = {n: counters.bytes_from(n, source=name) for n in names}
        billed = sum(per_dev.values())
        if billed == 0 and not any(counters.source_route_bytes.values()):
            # This window saw no attributed bytes at all (zero-delta keys
            # from past epochs don't count): legacy single-buffer telemetry,
            # bill the raw route bytes.
            per_dev = {n: counters.bytes_into(n) for n in names}
            per_dev_out = {n: counters.bytes_from(n) for n in names}
            billed = sum(per_dev.values())
        # The drift signal must also be THIS buffer's traffic: raw route
        # bytes would let a co-tenant's ramp-up spuriously re-open a quiet
        # buffer's converged walk.  The per-device vectors get the same
        # source-billed treatment so the guardrails' split stays coherent.
        dev_bw = {}
        dev_wr = {}
        for n in names:
            tot = per_dev[n] + per_dev_out[n]
            dev_bw[n] = per_dev[n] / dt
            dev_wr[n] = per_dev[n] / tot if tot else 0.0
        metrics = dataclasses.replace(
            metrics, slow_bw=billed / dt, device_slow_bw=dev_bw,
            device_write_ratio=dev_wr)
        return self.observe(
            name, metrics, slow_bw=billed / dt,
            device_bw={n: b / dt for n, b in per_dev.items()})

    def actuated(self, name: str, fraction: float) -> None:
        """Feed back what the buffer's actuator actually achieved."""
        self._entries[name].controller.actuated(fraction)
