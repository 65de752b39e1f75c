"""Fig. 2 — access latency per tier/instruction class.

Reports (a) a real measured pointer chase (MEMO measure mode: on the card
the ``memo_probe`` chase over HBM, on the CPU its plain version over host
memory) and (b) the calibrated tier model's Fig. 2 table, validating the
paper's headline ratios: CXL flushed-load = 2.2x DDR5-L8, ptr-chase = 3.7x.

On the card the chase table is 256 MiB of HBM and one cycle, so that the
hops miss the 50 MB L2 and never revisit a line; the CPU keeps the
reference's 4 MiB table.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import memo
from repro_torch.core.tiers import paper_topology, tpu_v5e_topology
from repro_torch.device import DeviceLike, resolve_device

CHASE_STEPS = 1 << 14
#: the measured chase's table: the reference's on the CPU; on the card a
#: single cycle through 256 MiB of HBM
HOST_CHASE_ELEMS = 1 << 20
CARD_CHASE_ELEMS = 1 << 26


def chase_args(device: torch.device) -> dict:
    """``memo.measure_pointer_chase``'s arguments for the measured row."""
    if device.type == "cuda":
        return dict(n_elems=CARD_CHASE_ELEMS, steps=CHASE_STEPS, cycle=True,
                    device=device)
    return dict(n_elems=HOST_CHASE_ELEMS, steps=CHASE_STEPS, device=device)


def run(device: DeviceLike = None) -> list[str]:
    device = resolve_device(device)
    rows = []
    topo = paper_topology()
    sim = memo.simulate_latency(topo)
    by = {r["tier"]: r for r in sim}
    for r in sim:
        rows.append(f"fig2/sim/{r['tier']}/ld,{r['ld_ns']/1e3:.4f},ns={r['ld_ns']}")
        rows.append(f"fig2/sim/{r['tier']}/ptr_chase,"
                    f"{r['ptr_chase_ns']/1e3:.4f},ns={r['ptr_chase_ns']}")
    ld_ratio = by["cxl-agilex"]["ld_ns"] / by["ddr5-l8"]["ld_ns"]
    chase_ratio = by["cxl-agilex"]["ptr_chase_ns"] / by["ddr5-l8"]["ptr_chase_ns"]
    assert abs(ld_ratio - 2.2) < 0.1, "F1 load ratio drifted"
    assert abs(chase_ratio - 3.7) < 0.1, "F1 chase ratio drifted"
    rows.append(f"fig2/claim/ld_ratio,{ld_ratio:.3f},paper=2.2")
    rows.append(f"fig2/claim/chase_ratio,{chase_ratio:.3f},paper=3.7")
    # measured pointer chase (the card's HBM, or this host)
    rec = memo.measure_pointer_chase(**chase_args(device))
    ns_hop = rec.seconds / CHASE_STEPS * 1e9
    rows.append(f"fig2/measured/local_chase,{rec.seconds*1e6:.1f},ns_per_hop={ns_hop:.1f}")
    # target-hardware prediction (TPU HBM vs host tier)
    for r in memo.simulate_latency(tpu_v5e_topology()):
        rows.append(f"fig2/tpu/{r['tier']}/ptr_chase,"
                    f"{r['ptr_chase_ns']/1e3:.4f},ns={r['ptr_chase_ns']}")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    print("\n".join(run(ap.parse_args(argv).device)))


if __name__ == "__main__":
    main()
