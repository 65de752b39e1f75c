"""Share of the device's idle time in the traced window that Python's
collections cover on the host (the program's ``repro.gc.gen<N>`` spans;
the reader of ``idle_in_gc_share.<cells>``)."""
from cxlbench.common import load_piece


def read(run):
    share = load_piece("metrics", "idle_in_program_share").idle_share_in
    return share(run.devtrace, lambda n: n.startswith("repro.gc."))
