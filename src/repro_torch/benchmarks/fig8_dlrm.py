"""Figs. 8-9 — DLRM embedding reduction (MERCI analogue) on tiered memory.

Fig. 8: inference throughput vs thread count per placement — linear in
threads, slope set by the tier's random-access bandwidth; even 3.23% on
CXL cannot match pure DRAM when DRAM is NOT bandwidth-bound.
Fig. 9: the SNC mode (fast tier cut to 2 channels) makes inference
bandwidth-bound past ~24 threads; putting ~20% of pages on CXL then
RAISES throughput ~11% — the paper's key positive interleaving result,
which the placement planner must reproduce from first principles.

The modeled rows come from the paper presets and the perfmodel, as in the
reference.  The measured row reduces 64 bags of 80 lookups over a
(4, 1)-weighted ``InterleavedTensor``: on the card an HBM shard and a
pinned host shard, one routed ``embedding_reduce`` launch per
``bag_reduce``, held to the dense sum.  The reference's Zipf-skewed
semantic section waits for the port's hotness layer.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.benchmarks.common import stopwatch, synchronize
from repro_torch.core import perfmodel
from repro_torch.core.classifier import AccessProfile
from repro_torch.core.interleave import InterleavedTensor
from repro_torch.core.planner import BufferReq, plan
from repro_torch.core.policy import BufferClass, MemPolicy
from repro_torch.core.tiers import DDR5_L8, OpClass, TierTopology, paper_topology
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.embedding_reduce import ops as er_ops

ROW_B = 256  # 64-dim fp32 embedding rows
BYTES_PER_INFER = 80 * ROW_B  # 80 lookups per sample (bags)
GATHER_B = ROW_B * 8  # per-lookup granule for the latency (R) term
BURST_B = 16384  # coalesced burst granule for the channel caps (Fig. 5)
COMPUTE_NS = 400.0  # per-inference reduction compute (MERCI)
#: the measured row against the dense sum: fp32 sums of 80 N(0, 1)
#: rows, summed in another order
MEASURED_ATOL = 1e-4


def throughput(fast, slow, f_slow: float, threads: int) -> float:
    """samples/s: closed-loop (threads / per-inference latency) bounded by
    each tier's random-access channel.  Captures both paper regimes:
    interleaving HURTS while the fast tier has headroom (latency adds),
    and HELPS once the fast tier saturates (extra parallel channel)."""
    return throughput_nd(fast, (slow,), (f_slow,), threads)


def throughput_nd(fast, devs, weights, threads: int) -> float:
    """N-device form: the table interleaved across ``fast`` + ``devs``
    with per-device page shares ``weights`` (the Fig. 10 device-mix
    model).  Each device is an independent parallel channel: per-
    inference latency sums the per-device shares, and every device caps
    throughput at its own random-access bandwidth over its share."""
    f_slow = sum(weights)
    sbw_f = perfmodel.random_block_bandwidth(fast, OpClass.LOAD, GATHER_B, 1)
    r = (1 - f_slow) * BYTES_PER_INFER / sbw_f + COMPUTE_NS * 1e-9
    for dev, w in zip(devs, weights):
        if w <= 0:
            continue
        sbw = perfmodel.random_block_bandwidth(dev, OpClass.LOAD, GATHER_B, 1)
        r += w * BYTES_PER_INFER / sbw
    x = threads / r
    cap_f = perfmodel.random_block_bandwidth(fast, OpClass.LOAD, BURST_B, threads) \
        / max((1 - f_slow) * BYTES_PER_INFER, 1e-9)
    x = min(x, cap_f)
    for dev, w in zip(devs, weights):
        if w <= 0:
            continue
        cap = perfmodel.random_block_bandwidth(dev, OpClass.LOAD, BURST_B, threads) \
            / (w * BYTES_PER_INFER)
        x = min(x, cap)
    return x


def _measured_row(device: torch.device, payload: dict) -> str:
    """One routed ``bag_reduce`` over a (4, 1)-weighted table, timed."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(4096, 64)).astype(np.float32)
    idx = torch.as_tensor(rng.integers(0, 4096, size=(64, 80)), device=device)
    w = torch.ones((64, 80), dtype=torch.float32, device=device)
    it = InterleavedTensor.from_array(
        table, MemPolicy.weighted(("fast", "slow"), (4, 1)), page_rows=64,
        device=device)
    if device.type == "cuda":
        assert it.parts[0].is_cuda and it.parts[1].is_pinned(), it.backend
    it.bag_reduce(idx, w)  # warm: the kernel's library loads here
    synchronize(device)
    n0 = er_ops.LAUNCHES.count
    stop = stopwatch(device)
    out = it.bag_reduce(idx, w)
    dt = stop()
    launches = er_ops.LAUNCHES.count - n0
    if device.type == "cuda":
        assert launches == 1, launches  # one routed launch, both shards
    dense = (torch.as_tensor(table, device=device)[idx]
             * w[..., None]).sum(dim=1)
    err = float((out - dense).abs().max())
    assert err <= MEASURED_ATOL, (err, MEASURED_ATOL)
    payload["measured"] = {"seconds": dt, "launches": launches,
                           "max_abs_err": err, "atol": MEASURED_ATOL,
                           "backend": it.backend}
    return (f"fig8/measured/kernel_bag64x80,{dt*1e6:.1f},"
            f"rows_per_s={64*80/dt:.0f};launches={launches}")


def run(smoke: bool = False, payload: Optional[dict] = None,
        device: DeviceLike = None) -> list[str]:
    device = resolve_device(device)
    payload = payload if payload is not None else {}
    rows = []
    topo = paper_topology()
    l8, cxl = topo.fast, topo.slow
    # Fig. 8: full 8-channel DRAM is never the bottleneck <=32 threads
    for f, tag in ((0.0, "dram"), (0.0323, "cxl3.23"), (0.5, "cxl50"),
                   (1.0, "cxl100")):
        for th in (8, 16, 32):
            rows.append(f"fig8/sim/{tag}/threads{th},0,"
                        f"inf_s={throughput(l8, cxl, f, th):.0f}")
    t_dram = throughput(l8, cxl, 0.0, 32)
    t_323 = throughput(l8, cxl, 0.0323, 32)
    assert t_323 < t_dram  # even 3.23% can't match pure DRAM (F7 first half)
    rows.append(f"fig8/claim/interleave_below_dram,0,"
                f"{t_323:.0f}<{t_dram:.0f}")

    # Fig. 9: SNC = fast tier clipped to 2 channels
    snc = dataclasses.replace(DDR5_L8, name="snc-2ch", load_bw=55e9,
                              load_peak_streams=12)
    base = throughput(snc, cxl, 0.0, 32)
    best_f, best_t = 0.0, base
    for f in np.linspace(0, 0.4, 41):
        t = throughput(snc, cxl, float(f), 32)
        if t > best_t:
            best_f, best_t = float(f), t
    gain = best_t / base - 1
    rows.append(f"fig9/sim/snc_gain,0,f*={best_f:.2f};gain={gain*100:.1f}%"
                f";paper=+11%@20%")
    assert 0.05 < gain < 0.35 and 0.08 < best_f < 0.35, (gain, best_f)
    # and in the UNbound regime (8-channel DRAM) interleaving never helps
    assert all(throughput(l8, cxl, f, 32) <= throughput(l8, cxl, 0.0, 32)
               for f in (0.0323, 0.1, 0.2))

    # the planner discovers the same regime from the access profile
    table_bytes = 8 << 30
    reads = 55e9 * 1.3  # demand exceeds the SNC node's bandwidth
    topo_snc = TierTopology(fast=dataclasses.replace(snc, capacity_bytes=96 << 30),
                            slow=cxl)
    p = plan([BufferReq("emb", BufferClass.EMBEDDING, table_bytes,
                        AccessProfile(reads, 0, 1, 1024, ROW_B, 1.0))],
             topo_snc, compute_seconds=1.0)
    f_planner = p.slow_fraction("emb")
    rows.append(f"fig9/planner/fraction,0,f={f_planner:.3f}")
    assert 0.05 < f_planner < 0.45  # planner lands in the beneficial band

    rows.append(_measured_row(device, payload))
    payload["rows"] = list(rows)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true", help="CI-sized lane")
    ap.add_argument("--out", default="BENCH_dlrm_torch.json")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    payload: dict = {"smoke": args.smoke}
    rows = run(smoke=args.smoke, payload=payload, device=args.device)
    payload["timestamp"] = time.time()
    print("\n".join(rows))
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"fig8/json,0,wrote={args.out}")


if __name__ == "__main__":
    main()
