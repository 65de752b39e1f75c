"""Fig. 3 — sequential bandwidth vs stream count per tier/op.

Validates F2: DDR5-L8 load peaks ~221 GB/s (~26 streams); CXL load peaks
near 8 streams then collapses past 12; CXL nt-store hits ~22 GB/s at just
2 streams (DDR4-2666 theoretical max) then degrades.  Also reports real
measured bandwidth (MEMO measure mode: the card's HBM through the
``memo_probe`` kernels and ``stream_copy``, or this host's memory).
"""
from __future__ import annotations

import argparse

from repro_torch.core import memo, perfmodel
from repro_torch.core.tiers import OpClass, paper_topology
from repro_torch.device import DeviceLike, resolve_device


def run(device: DeviceLike = None) -> list[str]:
    device = resolve_device(device)
    rows = []
    topo = paper_topology()
    for r in memo.simulate_seq_bw(topo, lanes=(1, 2, 4, 8, 12, 16, 26, 32)):
        rows.append(f"fig3/sim/{r['tier']}/{r['op']}/lanes{r['lanes']},"
                    f"0,GBps={r['GBps']:.2f}")
    l8, cxl = topo.fast, topo.slow
    peak_l8 = perfmodel.stream_bandwidth(l8, OpClass.LOAD, 26) / 1e9
    assert abs(peak_l8 - 221) < 5, peak_l8
    cxl8 = perfmodel.stream_bandwidth(cxl, OpClass.LOAD, 8) / 1e9
    cxl16 = perfmodel.stream_bandwidth(cxl, OpClass.LOAD, 16) / 1e9
    assert cxl16 < cxl8 and abs(cxl16 - 16.8) < 3.0
    nt2 = perfmodel.stream_bandwidth(cxl, OpClass.NT_STORE, 2) / 1e9
    nt16 = perfmodel.stream_bandwidth(cxl, OpClass.NT_STORE, 16) / 1e9
    assert abs(nt2 - 22) < 2 and nt16 < nt2
    rows.append(f"fig3/claim/ddr5l8_load_peak,0,GBps={peak_l8:.1f};paper=221")
    rows.append(f"fig3/claim/cxl_load_collapse,0,{cxl8:.1f}->{cxl16:.1f};paper=~20->16.8")
    rows.append(f"fig3/claim/cxl_ntstore_2streams,0,GBps={nt2:.1f};paper=22")
    for rec in memo.measure_sequential(nbytes=1 << 25, lanes_list=(1, 2, 4),
                                       device=device):
        rows.append(f"fig3/measured/{rec.op}/lanes{rec.lanes},"
                    f"{rec.seconds*1e6:.1f},GBps={rec.gbps:.2f}")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    print("\n".join(run(ap.parse_args(argv).device)))


if __name__ == "__main__":
    main()
