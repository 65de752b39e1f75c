"""Share of the device's idle time in the traced window that the tiered
optimizer's steps cover on the host (the program's ``repro.offload.step``
spans)."""
from cxlbench.common import load_piece


def read(run):
    share = load_piece("metrics", "idle_in_program_share").idle_share_in
    return share(run.devtrace, lambda n: n == "repro.offload.step")
