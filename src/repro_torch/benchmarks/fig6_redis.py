"""Figs. 6-7 — µs-latency KV store (Redis-YCSB analogue) on tiered memory.

Model (calibrated to the paper's narrative): a GET is ~30 dependent
pointer hops + a 1 KiB value read + ~8 µs of software time; pages land on
the slow tier with probability = interleave fraction.  p99 under load is
M/M/1-inflated.  Validates F6:
  * pure-CXL p99 gap ~2x at low QPS (amortized by software time),
  * saturation QPS ordering DRAM > 50% > 100% CXL,
  * interleaving reduces but never erases the penalty (latency-bound).
Also drives the REAL ServingEngine (tiny LM, tiered KV cache; on the card
an HBM pool and a pinned pool, decoded through ``decode_attention``) as
the end-to-end artifact of the same placement decision.
"""
from __future__ import annotations

import argparse

from repro_torch.core import perfmodel
from repro_torch.core.policy import MemPolicy
from repro_torch.core.tiers import OpClass, paper_topology
from repro_torch.device import DeviceLike, resolve_device

SW_NS = 8_000.0  # per-query software path (parse, hash, syscall)
HOPS = 30  # dependent-chain depth per GET
VALUE_B = 1024
ARCH = "internvl2-2b"


def query_ns(topo, slow_fraction: float) -> float:
    fast, slow = topo.fast, topo.slow
    chase = (HOPS * (1 - slow_fraction) * fast.chase_latency_ns
             + HOPS * slow_fraction * slow.chase_latency_ns)
    read = VALUE_B / ((1 - slow_fraction) * perfmodel.stream_bandwidth(fast, OpClass.LOAD, 1)
                      + slow_fraction * perfmodel.stream_bandwidth(slow, OpClass.LOAD, 1)) * 1e9
    return SW_NS + chase + read


def p99_ms(service_ns: float, qps: float, servers: int = 4) -> float:
    lam = qps / servers
    mu = 1e9 / service_ns
    rho = min(lam / mu, 0.999)
    # M/M/1: p99 sojourn = -ln(0.01)/(mu - lam)
    return 4.6 / (mu * (1 - rho)) * 1e3


def run(device: DeviceLike = None, params=None) -> list[str]:
    """The modeled rows, then the engine rows on internvl2-2b ``.tiny()``;
    ``params`` defaults to ``module.init(cfg, 0)`` on ``device``."""
    device = resolve_device(device)
    rows = []
    topo = paper_topology()
    fracs = {"dram": 0.0, "cxl50": 0.5, "cxl100": 1.0}
    service = {k: query_ns(topo, f) for k, f in fracs.items()}
    sat = {k: 4 * 1e9 / s for k, s in service.items()}  # max sustainable QPS
    for k in fracs:
        rows.append(f"fig6/sim/{k}/service,{service[k]/1e3:.2f},"
                    f"satQPS={sat[k]:.0f}")
        for qps in (20_000, 55_000, 80_000):
            if qps < sat[k] * 0.98:
                rows.append(f"fig6/sim/{k}/p99@{qps//1000}k,"
                            f"{p99_ms(service[k], qps)*1e3:.1f},ms="
                            f"{p99_ms(service[k], qps):.3f}")
    gap = service["cxl100"] / service["dram"]
    assert 1.5 < gap < 4.0, gap  # paper: ~2x tail gap before saturation
    assert sat["dram"] > sat["cxl50"] > sat["cxl100"]  # Fig. 7 ordering
    mid = (service["dram"] < service["cxl50"] < service["cxl100"])
    assert mid  # interleaving reduces but never erases the penalty
    rows.append(f"fig6/claim/tail_gap,0,x{gap:.2f};paper=~2x")
    rows.append(f"fig6/claim/qps_order,0,"
                f"{sat['dram']:.0f}>{sat['cxl50']:.0f}>{sat['cxl100']:.0f}")

    # end-to-end: the real engine with the same placement knobs
    from repro_torch.models import registry
    from repro_torch.serving.engine import ServingEngine
    arch = registry.get(ARCH).tiny()
    if params is None:
        params = arch.module.init(arch.cfg, 0, device=device)
    for k, f in fracs.items():
        eng = ServingEngine(arch.cfg, params, max_batch=2, max_len=32,
                            policy=MemPolicy.from_slow_fraction("fast", "slow", f),
                            topology=topo, page_t=8, device=device)
        for _ in range(4):
            eng.submit([1, 2, 3], max_new_tokens=4)
        done = eng.run_until_drained()
        modeled = sorted(r.modeled_seconds for r in done)[-1]
        rows.append(f"fig6/engine/{k},{modeled*1e6:.2f},"
                    f"slow_frac={eng.cache.slow_fraction():.2f}")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    print("\n".join(run(ap.parse_args(argv).device)))


if __name__ == "__main__":
    main()
