"""Analytical performance model calibrated to the paper's measurements.

Encodes the characterization facts (DESIGN.md F1-F5) as closed-form
curves over :class:`~repro_torch.core.tiers.TierSpec`:

* stream-count contention (Fig. 3): linear ramp to ``peak_streams``,
  plateau, then collapse by ``collapse_factor`` beyond
  ``collapse_streams`` (CXL controller-buffer interference);
* random-block efficiency (Fig. 5): converges to sequential bandwidth as
  the block size grows past the latency-bandwidth product;
* RFO traffic doubling for temporal stores to far tiers (Fig. 2/F3);
* DSA-style offloaded bulk movement (Fig. 4b): per-descriptor offload
  latency amortized by batching, hidden entirely by asynchrony.

The planner consumes these curves; MEMO (``core/memo.py``) validates the
model's *shape* against real measurements on the running host.
"""
from __future__ import annotations

import dataclasses
import math

from typing import Optional

from repro_torch.core.tiers import OpClass, TierSpec


# ---------------------------------------------------------------------------
# Fault-injection degradations (emucxl-style): per-device bandwidth/latency
# multipliers applied at every model entry point, so a degraded device is
# slower everywhere at once — mover execution timing (bulk_move_cost), the
# serving engine's modeled step seconds (stream_bandwidth), and the closed-
# loop benchmark throughput models (random_block_bandwidth).  The slowdown
# therefore shows up in telemetry-billed bandwidths, which is exactly the
# EWMA drift signal that re-opens a converged Caption walk.
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Degradation:
    """Multipliers applied to one device: bw scales down, latency up."""

    bw_scale: float = 1.0
    latency_scale: float = 1.0


_DEGRADATIONS: dict[str, Degradation] = {}


def set_degradation(name: str, *, bw_scale: float = 1.0,
                    latency_scale: float = 1.0) -> None:
    """Install (or clear, at 1.0/1.0) a degradation for device ``name``."""
    if bw_scale <= 0 or latency_scale <= 0:
        raise ValueError("degradation scales must be > 0")
    if bw_scale == 1.0 and latency_scale == 1.0:
        _DEGRADATIONS.pop(name, None)
    else:
        _DEGRADATIONS[name] = Degradation(bw_scale, latency_scale)


def clear_degradations(name: Optional[str] = None) -> None:
    if name is None:
        _DEGRADATIONS.clear()
    else:
        _DEGRADATIONS.pop(name, None)


def degradation(name: str) -> Optional[Degradation]:
    return _DEGRADATIONS.get(name)


def _eff(tier: TierSpec) -> TierSpec:
    """The spec as currently seen: injected degradations applied.

    Only the public entry points call this (internal helpers take the
    already-degraded spec), so multipliers never compound."""
    d = _DEGRADATIONS.get(tier.name)
    if d is None:
        return tier
    return dataclasses.replace(
        tier,
        load_bw=tier.load_bw * d.bw_scale,
        store_bw=tier.store_bw * d.bw_scale,
        nt_store_bw=tier.nt_store_bw * d.bw_scale,
        load_latency_ns=tier.load_latency_ns * d.latency_scale,
        chase_latency_ns=tier.chase_latency_ns * d.latency_scale,
    )


def stream_bandwidth(tier: TierSpec, op: OpClass, n_streams: int) -> float:
    """Aggregate bandwidth (bytes/s) for ``n_streams`` concurrent streams.

    Reproduces the paper's Fig. 3 shapes: DDR5-L8 load ramps ~linearly to
    26 threads @ 221 GB/s; CXL load peaks near 8 threads then drops past
    12; CXL nt-store peaks at 2 threads then collapses.
    """
    return _stream_bandwidth(_eff(tier), op, n_streams)


def _stream_bandwidth(tier: TierSpec, op: OpClass, n_streams: int) -> float:
    if n_streams <= 0:
        return 0.0
    peak = tier.peak_bw(op)
    p = tier.peak_streams(op)
    c = tier.collapse_streams(op)
    if n_streams <= p:
        # Single-stream bandwidth is latency-bound: one cacheline-ish burst
        # per round trip, but streams overlap; model a concave ramp.
        ramp = n_streams / p
        return peak * min(1.0, ramp ** 0.85)
    if n_streams <= c:
        return peak
    # Collapse region: interference degrades throughput toward
    # collapse_factor * peak (and keeps degrading slowly).
    over = n_streams - c
    floor = peak * tier.collapse_factor
    decay = math.exp(-over / max(c, 1))
    return floor + (peak - floor) * decay


def random_block_bandwidth(
    tier: TierSpec, op: OpClass, block_bytes: int, n_streams: int
) -> float:
    """Fig. 5: random block access converges to sequential as blocks grow.

    Each random block pays one dependent-access latency, then streams at
    the sequential rate; efficiency = stream_time / (latency + stream_time).
    """
    tier = _eff(tier)
    seq = _stream_bandwidth(tier, op, n_streams)
    if seq <= 0.0:
        return 0.0
    per_stream = seq / n_streams
    lat_s = tier.load_latency_ns * 1e-9
    stream_t = block_bytes / per_stream
    eff = stream_t / (lat_s + stream_t)
    return seq * eff


def store_traffic_bytes(tier: TierSpec, nbytes: int, op: OpClass) -> int:
    """Actual bytes moved over the tier's link for a logical store.

    Temporal stores to far tiers fetch the line first (RFO / fetch-modify-
    flush), doubling the traffic; nt-stores write through once.
    """
    if op == OpClass.STORE:
        return int(nbytes * tier.rfo_traffic_multiplier)
    return int(nbytes)


@dataclasses.dataclass(frozen=True)
class MoveCost:
    """Cost breakdown for one bulk transfer (the DSA-analogue engine)."""

    seconds: float
    wire_bytes: int
    offload_overhead_s: float
    stream_seconds: float


# Per-descriptor offload costs for the mover, calibrated to Fig. 4b: a
# non-batched synchronous offload matches plain copy throughput; batching
# (16/128) and asynchrony each buy large wins.
DSA_DESCRIPTOR_OVERHEAD_S = 0.8e-6  # submit + completion poll, per descriptor
DSA_BATCH_OVERHEAD_S = 1.2e-6  # per batch submission


def bulk_move_cost(
    src: TierSpec,
    dst: TierSpec,
    nbytes: int,
    *,
    n_descriptors: int = 1,
    batch_size: int = 1,
    asynchronous: bool = False,
    op: OpClass = OpClass.NT_STORE,
    n_streams: int = 1,
) -> MoveCost:
    """Time to move ``nbytes`` from ``src`` to ``dst`` via the bulk engine.

    The route bandwidth is the min of the source load path, destination
    store path, and any intervening link (paper Fig. 4a: C2C is the
    slowest route because both sides cross the same link).
    """
    src, dst = _eff(src), _eff(dst)
    read_bw = _stream_bandwidth(src, OpClass.LOAD, n_streams)
    write_bw = _stream_bandwidth(dst, op, n_streams)
    if src.name == dst.name and src.link_bw is not None:
        # C2C: one far device serves both sides — controller + link are
        # shared, so read and write serialize (paper Fig. 4a: C2C slowest).
        route = min(1.0 / (1.0 / read_bw + 1.0 / write_bw), src.link_bw / 2)
    else:
        route = min(read_bw, write_bw)
        for t in (src, dst):
            if t.link_bw is not None:
                route = min(route, t.link_bw)
    wire = store_traffic_bytes(dst, nbytes, op)
    stream_s = wire / route
    n_batches = math.ceil(n_descriptors / max(batch_size, 1))
    overhead = (
        n_batches * DSA_BATCH_OVERHEAD_S + n_descriptors * DSA_DESCRIPTOR_OVERHEAD_S
    )
    if asynchronous:
        # Descriptor submission pipelines behind the wire time.
        total = max(stream_s, overhead) + DSA_BATCH_OVERHEAD_S
    else:
        total = stream_s + overhead
    return MoveCost(
        seconds=total,
        wire_bytes=wire,
        offload_overhead_s=overhead,
        stream_seconds=stream_s,
    )


def pipelined_move_cost(
    src: TierSpec,
    dst: TierSpec,
    nbytes: int,
    *,
    block_bytes: int = 1 << 20,
    n_descriptors: int = 1,
    batch_size: int = 1,
    asynchronous: bool = False,
    op: OpClass = OpClass.NT_STORE,
    n_streams: int = 1,
) -> MoveCost:
    """Staged double-buffered migration (the ``stream_copy`` kernel path).

    The transfer goes src -> staging -> dst in ``block_bytes`` chunks
    with the two DMA legs overlapped: chunk i's copy-out rides under
    chunk i+1's copy-in, so the stream time is max(read leg, write leg)
    plus one chunk of pipeline fill/drain — NOT the read+write sum a
    naive staged copy pays.  Relative to :func:`bulk_move_cost` (a
    direct single-leg DMA at the route bandwidth) the only extra cost
    is that fill/drain ramp, which shrinks with ``block_bytes``.
    """
    eff_src, eff_dst = _eff(src), _eff(dst)
    read_bw = _stream_bandwidth(eff_src, OpClass.LOAD, n_streams)
    write_bw = _stream_bandwidth(eff_dst, op, n_streams)
    wire = store_traffic_bytes(eff_dst, nbytes, op)
    if eff_src.name == eff_dst.name and eff_src.link_bw is not None:
        # C2C: both legs cross one shared controller/link — no overlap win.
        route = min(1.0 / (1.0 / read_bw + 1.0 / write_bw),
                    eff_src.link_bw / 2)
        stream_s = wire / route
    else:
        link = min((t.link_bw for t in (eff_src, eff_dst)
                    if t.link_bw is not None), default=float("inf"))
        read_s = wire / min(read_bw, link)
        write_s = wire / min(write_bw, link)
        block = min(max(block_bytes, 1), wire) if wire else 0
        fill = block / min(read_bw, link) + block / min(write_bw, link)
        stream_s = max(read_s, write_s) + fill
    n_batches = math.ceil(n_descriptors / max(batch_size, 1))
    overhead = (
        n_batches * DSA_BATCH_OVERHEAD_S + n_descriptors * DSA_DESCRIPTOR_OVERHEAD_S
    )
    if asynchronous:
        total = max(stream_s, overhead) + DSA_BATCH_OVERHEAD_S
    else:
        total = stream_s + overhead
    return MoveCost(
        seconds=total,
        wire_bytes=wire,
        offload_overhead_s=overhead,
        stream_seconds=stream_s,
    )


@dataclasses.dataclass(frozen=True)
class OverlapCost:
    """Hidden-vs-exposed split of a migration overlapped with compute.

    ``hidden_s`` rides under concurrent decode steps (free); ``exposed_s``
    is the tail that still stalls the issuing thread.  ``exposed_fraction``
    is what the serving engine's modeled step time actually pays.
    """

    move_s: float
    compute_s: float
    hidden_s: float
    exposed_s: float

    @property
    def exposed_fraction(self) -> float:
        return self.exposed_s / self.move_s if self.move_s > 0 else 0.0


def overlap_cost(move_s: float, compute_s: float) -> OverlapCost:
    """Split a migration's ``move_s`` into hidden/exposed time given
    ``compute_s`` of concurrent decode compute it can hide under.

    The async mover issues descriptors non-blocking and drains completions
    at epoch boundaries, so up to ``compute_s`` of wire time overlaps
    decode; only the remainder is exposed as a stall (the emucxl-style
    overlap the paper's DSA asynchrony result, Fig. 4b, predicts).
    """
    move_s = max(float(move_s), 0.0)
    compute_s = max(float(compute_s), 0.0)
    hidden = min(move_s, compute_s)
    return OverlapCost(move_s=move_s, compute_s=compute_s,
                       hidden_s=hidden, exposed_s=move_s - hidden)


def chase_seconds(tier: TierSpec, n_hops: int) -> float:
    """Dependent pointer-chase time (Fig. 2 ptr-chase)."""
    return n_hops * _eff(tier).chase_latency_ns * 1e-9


def effective_latency_amortized(
    tier: TierSpec, compute_ns_between_accesses: float
) -> float:
    """Perceived extra latency per access when computation interleaves.

    The paper's DSB finding (F8): ms-level layered computation amortizes
    the slow tier's extra latency. Returns the visible slowdown factor.
    """
    extra = _eff(tier).chase_latency_ns
    return 1.0 + extra / max(compute_ns_between_accesses + extra, 1e-9)
