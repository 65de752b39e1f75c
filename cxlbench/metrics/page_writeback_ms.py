"""Milliseconds a traced optimizer step's writebacks keep the device busy
(``repro.offload.writeback`` spans: HBM -> pinned, on a side stream), as
``page_load_ms``."""
from cxlbench.common import load_piece


def read(run):
    per_step = load_piece("metrics", "page_load_ms").per_step_ms
    return per_step(run.devtrace, "repro.offload.writeback")
