"""The whole lookup step's share of the chip's peak: the least time of the
untraced stretch's batches, with the configuration's HBM share holding the
pool's most looked-up pages (the best placement for this traffic), over
the stretch's wall time."""
from cxlbench.common import load_piece


def read(run):
    if "best_hbm_rows" not in run.facts or not run.timed.get("ops"):
        return None
    roof = load_piece("metrics", "lookup_kernel_roofline")
    shape = roof.batch_shape(run)
    least = sum(float(n) * roof.least_seconds(h, p, **shape)
                for n, h, p in zip(run.timed["issued"],
                                   run.facts["best_hbm_rows"],
                                   run.facts["best_pinned_rows"]) if n)
    return 100.0 * least / run.timed["seconds"]
