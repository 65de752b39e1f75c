"""Milliseconds a traced optimizer step's paged updates keep the device
busy (``repro.offload.update`` spans: the Adam update of each run in its
staging slot and the parameter's slice), as ``page_load_ms``."""
from cxlbench.common import load_piece


def read(run):
    per_step = load_piece("metrics", "page_load_ms").per_step_ms
    return per_step(run.devtrace, "repro.offload.update")
