"""Fig. 5 — random block access bandwidth (block size x streams x tier).

Validates F5: all tiers suffer equally at 1 KiB blocks; as blocks grow,
DDR5-L8 scales with streams while CXL/DDR5-R1 saturate early (one
channel); random converges to sequential with block size.  Also reports
real random-block loads (MEMO measure mode: the card's HBM through the
``memo_probe`` kernel, or this host's memory).
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
    for r in memo.simulate_random_bw(topo, blocks=(1024, 16384, 262144),
                                     lanes=(1, 4, 16)):
        rows.append(
            f"fig5/sim/{r['tier']}/{r['op']}/b{r['block']}/l{r['lanes']},"
            f"0,GBps={r['GBps']:.2f}")
    l8, cxl = topo.fast, topo.slow
    # 16 KiB blocks: DDR5-L8 gains much more from 4->16 streams than CXL
    l8_gain = (perfmodel.random_block_bandwidth(l8, OpClass.LOAD, 16384, 16)
               / perfmodel.random_block_bandwidth(l8, OpClass.LOAD, 16384, 4))
    cxl_gain = (perfmodel.random_block_bandwidth(cxl, OpClass.LOAD, 16384, 16)
                / perfmodel.random_block_bandwidth(cxl, OpClass.LOAD, 16384, 4))
    assert l8_gain > cxl_gain, (l8_gain, cxl_gain)
    rows.append(f"fig5/claim/thread_scaling,0,"
                f"l8_gain={l8_gain:.2f};cxl_gain={cxl_gain:.2f}")
    conv = (perfmodel.random_block_bandwidth(cxl, OpClass.LOAD, 262144, 4)
            / perfmodel.stream_bandwidth(cxl, OpClass.LOAD, 4))
    assert conv > 0.9
    rows.append(f"fig5/claim/converges_to_seq,0,ratio_at_256KiB={conv:.3f}")
    for rec in memo.measure_random_block(table_bytes=1 << 24,
                                         block_bytes_list=(1024, 16384),
                                         n_blocks=256, device=device):
        rows.append(f"fig5/measured/load/b{rec.block_bytes},"
                    f"{rec.seconds*1e6:.1f},GBps={rec.gbps:.2f}")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    print("\n".join(run(ap.parse_args(argv).device)))


if __name__ == "__main__":
    main()
