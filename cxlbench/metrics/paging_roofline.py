"""Share of its roofline that the optimizer's paging reaches: the slow
share of the state read and written once over PCIe, over the time in
which anything the traced optimizer steps launched ran on the device,
whatever its name (merged intervals, so a load beside a writeback counts
once), a step at a time."""
from cxlbench.common import load_piece
from cxlbench.devtrace import union


def read(run):
    tr, f = run.devtrace, float(run.traffic.get("slow_fraction", 0.0))
    if tr is None or f <= 0:
        return None
    ops = tr.in_spans("opt_step")
    steps = sum(1 for step in tr.by_span("opt_step") if step)
    if not ops:
        return None
    busy_s = sum(b - a for a, b in union((a, b) for _, a, b, _ in ops)) * 1e-6
    mfu = load_piece("metrics", "train_mfu")
    return 100.0 * mfu.paging_seconds(run.config, f) * steps / busy_s
