"""Share of its roofline that the device's work of a lookup reaches: the
least time of the traced batches over the device time of every operation
that their lookup spans launched, whatever its name.

A batch's least time is the larger of its HBM bytes at the HBM peak and
its pinned bytes at PCIe's peak one way: each distinct row read once
from the tier the window's placement put it on, the indices read and the
sums written once in HBM."""
from cxlbench import peaks

INDEX_BYTES = 4


def least_seconds(hbm_rows, pinned_rows, *, bags, lookups, row_bytes,
                  out_bytes):
    """Least seconds of batches with these distinct rows per tier."""
    io = bags * lookups * INDEX_BYTES + bags * out_bytes
    hbm = (hbm_rows * row_bytes + io) / peaks.HBM_BYTES
    pcie = pinned_rows * row_bytes / peaks.PCIE_BYTES_EACH_WAY
    return max(hbm, pcie)


def batch_shape(run) -> dict:
    """The traffic's and table's sizes that the least time needs."""
    dim = int(run.config["dim"])
    item = 2 if run.config["dtype"] == "bfloat16" else 4
    return {"bags": int(run.traffic["bags"]),
            "lookups": int(run.config["lookups_per_bag"]),
            "row_bytes": dim * item, "out_bytes": dim * item}


def read(run):
    tr = run.devtrace
    if tr is None or "hbm_rows" not in run.facts:
        return None
    ops = tr.in_spans("lookup")
    if not ops:
        return None
    issued = run.traced["issued"]
    least = sum(float(n) * least_seconds(h, p, **batch_shape(run))
                for n, h, p in zip(issued, run.facts["hbm_rows"],
                                   run.facts["pinned_rows"]) if n)
    device_s = sum(b - a for _, a, b, _ in ops) * 1e-6
    return 100.0 * least / device_s
