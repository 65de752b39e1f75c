"""Bandwidth-aware placement planner — the paper's guidelines, mechanized.

Given the access profile of every named buffer in a training/serving
step and a tier topology (one fast tier + N slow devices), produce a
placement plan that applies §6:

  1. latency-bound buffers (µs-SLO state, recurrent state, pointer-chase
     structures) are *pinned to the fast tier* (guideline: "avoid running
     µs-latency state entirely on CXL");
  2. if everything fits in the fast tier and the fast tier is not
     bandwidth-saturated, everything stays fast (Fig. 7: interleaving
     cannot beat pure DRAM for a latency-bound app);
  3. capacity overflow spills the *coldest tolerant* buffers (lowest
     bytes-touched-per-step per resident byte) to the slow devices in
     order via weighted N:M interleave;
  4. if the fast tier is bandwidth-bound (streamed bytes/step over fast
     bandwidth exceeds compute time), shift streaming bytes to the slow
     devices until per-step transfer times equalize — the Fig. 9 SNC
     result (+11% at 20% CXL) generalized:
        x* = (F*Bs - S*Bf) / (Bf + Bs)   bytes/step moved to slow,
     with ``Bs`` the *aggregate* slow bandwidth and the moved bytes
     split across devices proportional to each device's effective
     bandwidth (Fig. 10: the best static interleave ratio tracks the
     devices' relative bandwidths);
  5. write-heavy buffers have their slow fraction damped by the
     store/load bandwidth ratio and the writer limit (guideline: limit
     concurrent writers; RFO doubles temporal-store traffic);
  6. optionally, the plan is reconciled with the arbiter's bandwidth
     budget *up front* (``write_budget_bw``): when the aggregate
     slow-tier write demand exceeds the budget, the voluntary share of
     every buffer's slow fraction is scaled under it at plan time —
     starting the Caption fleet inside the feasible region instead of
     letting the arbiter clip from a bad start.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.classifier import AccessProfile, Boundedness, classify
from repro_torch.core.ledger import TierLedger
from repro_torch.core.policy import (BufferClass, MemPolicy,
                               largest_remainder_split)
from repro_torch.core.tiers import OpClass, TierTopology


@dataclasses.dataclass(frozen=True)
class BufferReq:
    """One logical buffer the planner must place."""

    name: str
    klass: BufferClass
    nbytes: int
    profile: AccessProfile
    #: hard pin (e.g. staging buffers, decode state)
    pin_fast: bool = False
    #: page size for the interleave policy this buffer will use
    page_bytes: int = 2 * 1024 * 1024


@dataclasses.dataclass
class Decision:
    buffer: str
    policy: MemPolicy
    slow_fraction: float
    boundedness: Boundedness
    reason: str
    #: capacity floor: the slow fraction forced by fast-tier overflow.  A
    #: dynamic controller (core/caption.py) may tune the fraction but can
    #: never go below this without re-overflowing the fast tier.
    min_slow_fraction: float = 0.0
    #: per-slow-device page shares (by device name, summing to
    #: ``slow_fraction``) — the Caption weight-vector seed on an
    #: N-device topology.
    device_fractions: dict[str, float] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class Plan:
    decisions: dict[str, Decision]
    ledger: TierLedger
    est_fast_seconds: float
    est_slow_seconds: float
    est_step_seconds: float
    notes: list[str]

    def slow_fraction(self, name: str) -> float:
        return self.decisions[name].slow_fraction

    def report(self) -> str:
        lines = [
            f"{'buffer':<28s} {'class':<12s} {'bound':<10s} {'slow%':>6s}  reason"
        ]
        for d in self.decisions.values():
            lines.append(
                f"{d.buffer:<28s} {'':<12s} {d.boundedness.value:<10s}"
                f" {d.slow_fraction*100:5.1f}%  {d.reason}"
            )
        lines.append(self.ledger.report())
        lines.append(
            f"est step: fast {self.est_fast_seconds*1e3:.3f} ms / "
            f"slow {self.est_slow_seconds*1e3:.3f} ms / "
            f"total {self.est_step_seconds*1e3:.3f} ms"
        )
        return "\n".join(lines)


_LATENCY_CLASSES = {BufferClass.RECURRENT_STATE}


def _quantize_device_fractions(fr: dict, nbytes: int, free: dict,
                               denom: int = 64) -> dict:
    """Quantize per-device fractions onto the N:M cycle, rounding the
    TOTAL up (a capacity spill must never under-shoot the fast tier's
    room) and placing the round-up quanta only on devices with free
    capacity (largest fractional remainder first)."""
    import math
    total = min(sum(fr.values()), 1.0)
    if total <= 0:
        return {}
    q = 1.0 / denom
    want_units = min(math.ceil(total * denom - 1e-9), denom)
    names = list(fr)
    caps = [max(int((free.get(d, float("inf")) + 1e-9) / (q * nbytes)), 0)
            if nbytes else want_units for d in names]
    caps = [max(c, int(fr[d] * denom)) for c, d in zip(caps, names)]
    base, short = largest_remainder_split(
        [fr[d] * denom for d in names], want_units, caps)
    if short:  # nowhere with room: place anyway, let the ledger surface it
        i = max(range(len(names)), key=lambda j: free.get(names[j], 0.0))
        base[i] += short
    return {d: u * q for d, u in zip(names, base) if u > 0}


def plan(
    buffers: Sequence[BufferReq],
    topology: TierTopology,
    *,
    compute_seconds: float,
    reserve_fast_bytes: int = 0,
    fast_name: Optional[str] = None,
    slow_name: Optional[str] = None,
    write_budget_bw: Optional[float] = None,
) -> Plan:
    fast = topology.fast
    slows = topology.slows
    slow = topology.slow
    fast_name = fast_name or fast.name
    slow_name = slow_name or (slow.name if slow else fast.name)
    notes: list[str] = []
    ledger = TierLedger(topology)
    if reserve_fast_bytes:
        ledger.register("__reserved__", fast_name, reserve_fast_bytes,
                        note="activations/temps (XLA)", strict=False)

    #: per-buffer per-device fraction (device tier name -> share).
    dev_frac: dict[str, dict[str, float]] = {b.name: {} for b in buffers}
    bound: dict[str, Boundedness] = {}
    reason: dict[str, str] = {}
    tolerant: list[BufferReq] = []

    def frac_of(name: str) -> float:
        return sum(dev_frac[name].values())

    for b in buffers:
        bd = classify(b.profile, slow if slow else fast)
        bound[b.name] = bd
        if b.pin_fast or b.klass in _LATENCY_CLASSES or bd == Boundedness.LATENCY_BOUND:
            reason[b.name] = "latency-bound/pinned -> fast tier (guideline 5)"
        else:
            reason[b.name] = "fits fast"
            tolerant.append(b)

    if not slows:
        return _finalize(buffers, dev_frac, bound, reason,
                         {b.name: 0.0 for b in buffers}, ledger, topology,
                         fast_name, compute_seconds, notes)

    # --- step 3: capacity -----------------------------------------------
    fast_cap = fast.capacity_bytes - reserve_fast_bytes
    total_fast = sum(b.nbytes for b in buffers)
    if total_fast > fast_cap:
        notes.append(
            f"fast-tier overflow: {total_fast/2**30:.1f} GiB demand vs "
            f"{fast_cap/2**30:.1f} GiB; spilling coldest tolerant buffers"
        )
        overflow = total_fast - fast_cap
        slow_free = {t.name: float(t.capacity_bytes) for t in slows}
        # coldest first: bytes touched per step per resident byte; devices
        # fill in declaration order (the operator lists the preferred —
        # fastest — device first).
        for b in sorted(tolerant, key=lambda b: b.profile.bytes_per_step / max(b.nbytes, 1)):
            if overflow <= 0:
                break
            for t in slows:
                if overflow <= 0 or slow_free[t.name] <= 0:
                    continue
                move = min(b.nbytes * (1.0 - frac_of(b.name)), overflow,
                           slow_free[t.name])
                if move <= 0:
                    continue
                share = move / b.nbytes
                dev_frac[b.name][t.name] = (
                    dev_frac[b.name].get(t.name, 0.0) + share)
                overflow -= move
                slow_free[t.name] -= move
            if frac_of(b.name) > 0:
                reason[b.name] = (
                    f"capacity spill: {frac_of(b.name)*b.nbytes/2**30:.2f} "
                    f"GiB -> {'+'.join(dev_frac[b.name])} (guideline 4)")
        if overflow > 0:
            # Even the slow devices cannot absorb it; surface as failure.
            raise MemoryError(
                f"placement infeasible: {overflow/2**30:.2f} GiB cannot be "
                "placed after spilling all tolerant buffers"
            )

    # Everything placed so far is there because it must be (capacity); the
    # bandwidth-balancing step below only ever adds voluntary slow share.
    floor = {b.name: frac_of(b.name) for b in buffers}

    # --- step 4: bandwidth balancing --------------------------------------
    bw_weights = topology.bandwidth_weights(OpClass.LOAD)
    agg_slow_bw = sum(topology.effective_bw(t) for t in slows)
    rfo_avg = sum(t.rfo_traffic_multiplier * w
                  for t, w in zip(slows, bw_weights))
    store_ratio = sum(t.store_bw / t.load_bw * w
                      for t, w in zip(slows, bw_weights))

    def stream_bytes(on_slow: bool) -> float:
        total = 0.0
        for b in buffers:
            f = frac_of(b.name)
            share = f if on_slow else (1.0 - f)
            w_mult = 1.0 if b.profile.bytes_written_per_step == 0 else (
                rfo_avg if on_slow else 1.0
            )
            total += share * (
                b.profile.bytes_read_per_step
                + b.profile.bytes_written_per_step * w_mult
            )
        return total

    fast_time = stream_bytes(False) / fast.load_bw
    slow_time = stream_bytes(True) / agg_slow_bw
    if fast_time > compute_seconds and fast_time > slow_time:
        # Fast tier is the bottleneck: shift streaming bytes until the
        # tiers' transfer times equalize (or tolerance runs out).
        F, S = stream_bytes(False), stream_bytes(True)
        x_star = (F * agg_slow_bw - S * fast.load_bw) / (fast.load_bw + agg_slow_bw)
        moved = 0.0
        notes.append(
            f"fast tier bandwidth-bound ({fast_time*1e3:.2f} ms > compute "
            f"{compute_seconds*1e3:.2f} ms); target shift {x_star/2**30:.2f} GiB/step"
        )
        # hottest *streaming* buffers move first: they carry bytes/step
        # with the least capacity cost.
        for b in sorted(
            tolerant,
            key=lambda b: -(b.profile.bytes_per_step / max(b.nbytes, 1)),
        ):
            if moved >= x_star:
                break
            if bound[b.name] != Boundedness.BANDWIDTH_BOUND:
                continue
            movable = (1.0 - frac_of(b.name)) * b.profile.bytes_per_step
            # guideline: damp write-heavy spills by writer limits + RFO
            w = b.profile.bytes_written_per_step / max(b.profile.bytes_per_step, 1)
            damp = 1.0 - w * (1.0 - store_ratio)
            take = min(movable * damp, x_star - moved)
            if take <= 0:
                continue
            df = take / max(b.profile.bytes_per_step, 1)
            # Fig. 10 seeding: split the voluntary share across devices
            # proportional to their effective bandwidth.
            for t, bw_w in zip(slows, bw_weights):
                dev_frac[b.name][t.name] = (
                    dev_frac[b.name].get(t.name, 0.0) + df * bw_w)
            reason[b.name] = (
                f"bandwidth balance: +{df*100:.1f}% -> "
                f"{'+'.join(t.name for t in slows)} (Fig.9/10 regime)"
            )
            moved += take

    # --- step 6: arbiter-aware seeding ------------------------------------
    if write_budget_bw is not None and write_budget_bw > 0:
        step_s = max(compute_seconds, 1e-9)
        def write_rate(b: BufferReq, f: float) -> float:
            return f * b.profile.bytes_written_per_step * rfo_avg / step_s
        total_rate = sum(write_rate(b, frac_of(b.name)) for b in buffers)
        if total_rate > write_budget_bw:
            floor_rate = sum(write_rate(b, floor[b.name]) for b in buffers)
            vol_rate = total_rate - floor_rate
            scale = max(0.0, (write_budget_bw - floor_rate)
                        / max(vol_rate, 1e-12))
            scale = min(scale, 1.0)
            for b in buffers:
                f = frac_of(b.name)
                if f <= floor[b.name] + 1e-12:
                    continue
                keep = (floor[b.name] + (f - floor[b.name]) * scale) / f
                dev_frac[b.name] = {d: v * keep
                                    for d, v in dev_frac[b.name].items()}
                reason[b.name] += f" [budget-seeded x{scale:.2f}]"
            notes.append(
                f"arbiter-aware seeding: slow write demand "
                f"{total_rate:.3g} B/s > budget {write_budget_bw:.3g} B/s; "
                f"voluntary slow share scaled x{scale:.2f} at plan time")

    return _finalize(buffers, dev_frac, bound, reason, floor, ledger,
                     topology, fast_name, compute_seconds, notes,
                     slow_name=slow_name)


def hot_set_seed(scores, topology: TierTopology, *,
                 fast_budget_fraction: float = 0.5,
                 target_hot_traffic: float = 0.8) -> tuple[float, ...]:
    """Caption weight-vector seed for a SEMANTIC buffer (core/hotness.py).

    Given per-key hotness ``scores`` (a :class:`HotnessLedger`'s view),
    find the smallest hot-set fraction whose keys carry
    ``target_hot_traffic`` of the observed traffic — the knee of the
    skew CDF — capped by the fast tier's page budget, and split the
    cold remainder across the slow devices proportional to their
    effective bandwidth (the Fig. 10 best-static-ratio prior).  The
    returned tuple is the per-slow-device share vector a
    :class:`~repro_torch.core.caption.CaptionController` walks from; with no
    observed traffic (cold start) the whole budget seeds hot."""
    s = np.sort(np.asarray(scores, np.float64))[::-1]
    n = max(s.size, 1)
    total = float(s.sum())
    budget = min(max(float(fast_budget_fraction), 0.0), 1.0)
    if total <= 0:
        hot_frac = budget
    else:
        cum = np.cumsum(s) / total
        knee = int(np.searchsorted(cum, min(max(target_hot_traffic, 0.0),
                                            1.0))) + 1
        hot_frac = min(knee / n, budget)
    cold = 1.0 - hot_frac
    slows = topology.slows
    if not slows:
        return ()
    bw = topology.bandwidth_weights(OpClass.LOAD)
    return tuple(cold * w for w in bw)


def _finalize(buffers, dev_frac, bound, reason, floor, ledger, topology,
              fast_name, compute_seconds, notes,
              slow_name: Optional[str] = None) -> Plan:
    fast = topology.fast
    slows = topology.slows
    decisions = {}
    fast_stream = 0.0
    slow_stream = {t.name: 0.0 for t in slows}
    two_device = len(slows) <= 1
    for b in buffers:
        fr = dev_frac[b.name]
        f = sum(fr.values())
        if two_device:
            # Two-device compatibility: keep the legacy round-up N:M policy
            # (capacity spills must never under-shoot) and honor a
            # slow_name override.
            sname = slow_name or (slows[0].name if slows else fast_name)
            policy = MemPolicy.from_slow_fraction(fast_name, sname, f,
                                                 round_up=True)
            f_eff = policy.slow_fraction(fast_name)
            eff_fr = {sname: f_eff} if f_eff > 0 else {}
        else:
            names = [t.name for t in slows]
            free = {t.name: t.capacity_bytes - ledger.used(t.name)
                    for t in slows}
            eff_fr = _quantize_device_fractions(
                {n: fr.get(n, 0.0) for n in names}, b.nbytes, free)
            policy = MemPolicy.from_tier_fractions(
                fast_name, names, [eff_fr.get(n, 0.0) for n in names],
                exact=True)
            f_eff = sum(eff_fr.values())
        decisions[b.name] = Decision(
            b.name, policy, f_eff, bound[b.name], reason[b.name],
            min_slow_fraction=floor.get(b.name, 0.0),
            device_fractions=eff_fr)
        ledger.register(b.name, fast_name, int(b.nbytes * (1 - f_eff)),
                        strict=False)
        for dname, share in eff_fr.items():
            ledger.register(b.name, dname, int(b.nbytes * share),
                            strict=False)
        fast_stream += (1 - f_eff) * b.profile.bytes_per_step
        for t in slows:
            share = eff_fr.get(t.name, 0.0)
            if share <= 0:
                continue
            w_mult = t.rfo_traffic_multiplier
            slow_stream[t.name] += share * (
                b.profile.bytes_read_per_step
                + b.profile.bytes_written_per_step * w_mult)
    ledger.check()
    est_fast = fast_stream / fast.load_bw
    # Devices stream in parallel: the slow-side time is the slowest device.
    est_slow = max(
        (slow_stream[t.name] / topology.effective_bw(t) for t in slows),
        default=0.0)
    return Plan(
        decisions=decisions,
        ledger=ledger,
        est_fast_seconds=est_fast,
        est_slow_seconds=est_slow,
        est_step_seconds=max(compute_seconds, est_fast, est_slow),
        notes=notes,
    )
