"""Fig. 10 — DeathStarBench microservices + §6 bandwidth expansion.

Part 1 (tail latency): request = chain of compute stages (nginx/RPC/ML,
ms-scale) + database stages whose latency depends on where the
storage/caching tier lives.  Validates F8: compose-post (db-heavy)
shows a visible tail gap with storage on CXL; read-user-timeline
(front-end-heavy) shows ~none; the mixed workload saturates at a
similar point either way — so ms-latency layered services are the right
offloading candidates (§6).

Part 2 (bandwidth expansion): the paper's interleave-ratio sweep on a
multi-device pool.  A bandwidth-bound streaming workload over a
DDR + CXL-A + CXL-B topology, swept across page-interleave weight
vectors: throughput peaks when the ratio matches each device's relative
bandwidth — **bandwidth-proportional weighted interleaving beats
uniform interleaving beats any single device** (the §6/Fig. 10
ordering).  Uniform round-robin serializes on the slowest device;
membind leaves the other links idle.

The actuation-cost section reshapes a real 3-device ``InterleavedTensor``
(on the card an HBM shard and two pinned host shards, moved by
``stream_copy`` through the default ``BulkMover``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.benchmarks.common import launch_bound
from repro_torch.core import perfmodel
from repro_torch.core.interleave import InterleavedTensor
from repro_torch.core.mover import BulkMover
from repro_torch.core.policy import MemPolicy
from repro_torch.core.telemetry import Telemetry
from repro_torch.core.tiers import (CXL_A, CXL_B, DDR5_L8, OpClass, TierTopology,
                                    paper_topology)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.stream_copy import ops as sc_ops

# stage profiles: (compute_ms, db_dependent_accesses)
WORKLOADS = {
    "compose_post": {"compute_ms": 1.2, "db_hops": 4000, "db_bytes": 64 << 10},
    "read_user_timeline": {"compute_ms": 3.0, "db_hops": 400, "db_bytes": 16 << 10},
}
MIX = (("read_user_timeline", 0.9), ("compose_post", 0.1))  # home~user tl.


def request_ms(topo, wl: dict, storage_tier) -> float:
    chase_ms = wl["db_hops"] * storage_tier.chase_latency_ns * 1e-6
    read_ms = wl["db_bytes"] / storage_tier.load_bw * 1e3
    return wl["compute_ms"] + chase_ms + read_ms


# ---------------------------------------------------------------------------
# Part 2: weighted-interleave bandwidth expansion on a device mix.
# The fast tier is the SNC-clipped DDR node (the paper's saturated-DRAM
# regime — expansion only pays once the fast tier is the bottleneck).
# ---------------------------------------------------------------------------
def expansion_topology() -> TierTopology:
    snc = dataclasses.replace(DDR5_L8, name="snc-2ch", load_bw=55e9,
                              load_peak_streams=12)
    return TierTopology(fast=snc, slows=(CXL_A, CXL_B))


def _device_bw(tier) -> float:
    """Saturated streaming bandwidth of one device (its own channel)."""
    return perfmodel.stream_bandwidth(tier, OpClass.LOAD,
                                      tier.load_peak_streams)


def aggregate_bw(topo: TierTopology, weights: tuple[float, ...]) -> float:
    """Effective streaming bandwidth of a page-interleave weight vector.

    Devices stream concurrently; total time for B bytes is set by the
    device that takes longest on its share, so the effective bandwidth is
    ``1 / max_i(w_i / bw_i)`` — maximized when w_i tracks bw_i (the
    paper's best static ratio)."""
    shares = (1.0 - sum(weights),) + tuple(weights)
    devs = (topo.fast,) + topo.slows
    worst = max(w / _device_bw(d) for w, d in zip(shares, devs) if w > 0)
    return 1.0 / worst


def run_expansion(device: DeviceLike = None,
                  payload: Optional[dict] = None) -> list[str]:
    rows = []
    topo = expansion_topology()
    devs = (topo.fast,) + topo.slows
    bws = [_device_bw(d) for d in devs]

    # Single-device baselines (membind each device).
    singles = {}
    for i, d in enumerate(devs):
        w = [0.0] * len(topo.slows)
        if i > 0:
            w[i - 1] = 1.0
        singles[d.name] = aggregate_bw(topo, tuple(w))
        rows.append(f"fig10/expansion/single/{d.name},0,"
                    f"bw={singles[d.name]/1e9:.1f}GB/s")
    best_single = max(singles.values())

    # Uniform round-robin (the numactl --interleave default).
    n = len(devs)
    uniform = aggregate_bw(topo, (1.0 / n,) * len(topo.slows))
    rows.append(f"fig10/expansion/uniform,0,bw={uniform/1e9:.1f}GB/s")

    # Interleave-ratio sweep: slide the slow share, split across the CXL
    # devices proportional to their bandwidth, and find the peak.
    bw_w = topo.bandwidth_weights()
    sweep_best, sweep_best_s = 0.0, 0.0
    for s in np.linspace(0.0, 0.8, 81):
        w = tuple(float(s) * x for x in bw_w)
        bw = aggregate_bw(topo, w)
        if bw > sweep_best:
            sweep_best, sweep_best_s = bw, float(s)
    rows.append(f"fig10/expansion/sweep_peak,0,slow_share={sweep_best_s:.2f}"
                f";bw={sweep_best/1e9:.1f}GB/s")

    # Bandwidth-proportional weights (the analytic optimum).
    total = sum(bws)
    prop = tuple(b / total for b in bws[1:])
    weighted = aggregate_bw(topo, prop)
    rows.append(f"fig10/expansion/weighted,0,w={','.join(f'{x:.2f}' for x in prop)}"
                f";bw={weighted/1e9:.1f}GB/s")

    # The paper's Fig. 10 ordering: weighted >= uniform >= best single.
    assert weighted >= uniform >= best_single, (weighted, uniform, best_single)
    # ... and the proportional point is (near) the sweep's peak, which
    # expands bandwidth to ~the sum of the devices.
    assert weighted >= 0.99 * sweep_best, (weighted, sweep_best)
    assert weighted >= 0.95 * total, (weighted, total)
    rows.append(f"fig10/claim/expansion_ordering,0,"
                f"weighted={weighted/1e9:.0f}>=uniform={uniform/1e9:.0f}"
                f">=single={best_single/1e9:.0f}GB/s")
    rows.extend(run_actuation_cost(topo, prop, device, payload))
    return rows


def run_actuation_cost(topo: TierTopology, weights: tuple[float, ...],
                       device: DeviceLike = None,
                       payload: Optional[dict] = None) -> list[str]:
    """Reaching the weighted-interleave point on a REAL paged tensor:
    the uniform -> bandwidth-proportional reshape moves only the delta
    pages and drains O(runs) coalesced mover descriptors, so adopting
    the Fig. 10 optimum costs page-delta traffic, not a rebuild."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    n_pages = 1024
    it = InterleavedTensor.from_array(
        rng.normal(size=(n_pages * 16, 16)).astype(np.float32),
        MemPolicy.from_tier_fractions(
            topo.fast.name, tuple(t.name for t in topo.slows),
            (1.0 / 3, 1.0 / 3)),
        page_rows=16, headroom=n_pages // 4, device=device)
    ref = it.to_array().cpu().numpy()
    tel = Telemetry()
    page_bytes = 16 * it.row_bytes
    with BulkMover(topo, asynchronous=True, batch_size=16,
                   telemetry=tel, device=device) as mover:
        before = it.page_device.cpu().numpy().copy()
        n0 = sc_ops.LAUNCHES.count
        it = it.repartition_weights(weights, mover=mover)
        launches = sc_ops.LAUNCHES.count - n0
        delta = int((it.page_device.cpu().numpy() != before).sum())
        descs = mover.descriptors_submitted
        moved = mover.bytes_submitted
    assert moved == delta * page_bytes, (moved, delta * page_bytes)
    assert 0 < descs < delta, (descs, delta)  # coalesced, not per page
    # one gather launch per route-pure batch of 16 and one landing launch
    # (``launch_bound``), and on this non-donated, shape-stable path one
    # copy-on-write copy of each receiving shard
    routes = [(dst, r.descriptors) for (_, dst), r in tel.routes.items()
              if r.descriptors]
    bound = (launch_bound(n for _, n in routes)
             + len({dst for dst, _ in routes}))
    assert launches <= bound, (launches, bound)
    if device.type == "cuda":
        assert launches > 0, "the reshape did not launch stream_copy"
    assert np.array_equal(it.to_array().cpu().numpy(), ref)
    if payload is not None:
        payload["actuation"] = {"delta_pages": delta, "descriptors": descs,
                                "bytes": moved, "stream_copy_launches":
                                launches, "launch_bound": bound}
    return [f"fig10/expansion/actuation,0,delta_pages={delta}"
            f";descriptors={descs};bytes_exact=1"]


def run(device: DeviceLike = None, payload: Optional[dict] = None
        ) -> list[str]:
    device = resolve_device(device)
    rows = []
    topo = paper_topology()
    gaps = {}
    for name, wl in WORKLOADS.items():
        dram = request_ms(topo, wl, topo.fast)
        cxl = request_ms(topo, wl, topo.slow)
        gaps[name] = cxl / dram
        rows.append(f"fig10/sim/{name}/dram,{dram*1e3:.1f},ms={dram:.3f}")
        rows.append(f"fig10/sim/{name}/cxl,{cxl*1e3:.1f},ms={cxl:.3f}"
                    f";gap=x{gaps[name]:.3f}")
    # F8: db-heavy shows a gap; front-end-heavy is amortized to ~nothing
    assert gaps["compose_post"] > 1.25, gaps
    assert gaps["read_user_timeline"] < 1.10, gaps
    mixed_dram = sum(w * request_ms(topo, WORKLOADS[n], topo.fast)
                     for n, w in MIX)
    mixed_cxl = sum(w * request_ms(topo, WORKLOADS[n], topo.slow)
                    for n, w in MIX)
    mixed_gap = mixed_cxl / mixed_dram
    assert mixed_gap < 1.25
    rows.append(f"fig10/claim/compose_gap,0,x{gaps['compose_post']:.2f}")
    rows.append(f"fig10/claim/timeline_amortized,0,"
                f"x{gaps['read_user_timeline']:.3f}")
    rows.append(f"fig10/claim/mixed_saturation_similar,0,x{mixed_gap:.3f}")
    rows.extend(run_expansion(device, payload))
    if payload is not None:
        payload["rows"] = list(rows)
    return rows


if __name__ == "__main__":
    print("\n".join(run()))
