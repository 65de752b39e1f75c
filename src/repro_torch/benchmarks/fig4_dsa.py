"""Fig. 4 — bulk data-movement efficiency (movdir64B / DSA analogue).

(a) route comparison D2D/D2C/C2D/C2C and (b) engine-offloaded movement:
sync vs async x batch {1,16,128} at page granularity, via the BulkMover
cost model; validates F4 orderings.  Also times the real ``stream_copy``
kernel on a 16 MiB HBM tensor (its plain version on the CPU).
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.benchmarks.common import stopwatch, synchronize
from repro_torch.core import memo
from repro_torch.core.tiers import paper_topology
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.stream_copy import ops as sc_ops


def run(device: DeviceLike = None) -> list[str]:
    device = resolve_device(device)
    rows = []
    topo = paper_topology()
    sim = memo.simulate_movement(topo, nbytes=1 << 28, page_bytes=4 << 10)
    for r in sim:
        rows.append(f"fig4/sim/{r['route']}/{r['mode']}/batch{r['batch']},"
                    f"0,GBps={r['GBps']:.2f}")
    def g(route, mode, batch):
        return next(r["GBps"] for r in sim
                    if (r["route"], r["mode"], r["batch"]) == (route, mode, batch))
    # F4: async >= sync; batching amortizes; mixed routes beat C2C
    assert g("C2D", "async", 128) >= g("C2D", "sync", 1)
    assert g("C2D", "sync", 128) >= g("C2D", "sync", 1)
    assert g("C2D", "sync", 1) > g("C2C", "sync", 1)
    assert g("D2C", "sync", 1) > g("C2C", "sync", 1)
    rows.append(f"fig4/claim/async_beats_sync,0,"
                f"{g('C2D','async',128):.2f}>={g('C2D','sync',1):.2f}")
    rows.append(f"fig4/claim/c2c_slowest,0,"
                f"C2C={g('C2C','sync',1):.2f};C2D={g('C2D','sync',1):.2f}")
    # the real copy kernel
    x = torch.ones((4096, 1024), dtype=torch.float32, device=device)
    out = sc_ops.stream_copy(x)
    synchronize(device)
    stop = stopwatch(device)
    for _ in range(3):
        out = sc_ops.stream_copy(x)
    dt = stop() / 3
    assert torch.equal(out, x)
    nbytes = x.numel() * x.element_size()
    rows.append(f"fig4/measured/stream_copy_16MiB,{dt*1e6:.1f},"
                f"GBps={2*nbytes/dt/1e9:.2f}")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    print("\n".join(run(ap.parse_args(argv).device)))


if __name__ == "__main__":
    main()
