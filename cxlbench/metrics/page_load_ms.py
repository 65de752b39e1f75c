"""Milliseconds a traced optimizer step's loads keep the device busy: the
merged device time of every operation launched inside a
``repro.offload.load`` span (pinned -> HBM), over the traced steps that
launched work (``repro.offload.step`` spans).  ``per_step_ms`` reads the
update's and the writeback's spans alike."""
from cxlbench.devtrace import union

STEP = "repro.offload.step"


def per_step_ms(tr, name: str):
    """Merged device milliseconds of the operations launched inside spans
    called ``name``, a traced step; None without a trace, such spans or
    steps."""
    if tr is None:
        return None
    ops = tr.in_spans(name)
    steps = sum(1 for step in tr.by_span(STEP) if step)
    if not ops or not steps:
        return None
    busy = sum(b - a for a, b in union((a, b) for _, a, b, _ in ops))
    return busy * 1e-3 / steps


def read(run):
    return per_step_ms(run.devtrace, "repro.offload.load")
