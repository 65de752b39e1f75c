"""Milliseconds a traced training step keeps the device busy inside latent
attention: the merged device time of every operation launched inside a
``repro.mla.attention`` span, over the traced steps (the driver's
``fwd_bwd`` spans that launched work).  A span covers a layer's forward
and, under remat, its recompute in the backward pass; the backward's own
operations lie outside it.  ``per_step_ms`` reads the MoE spans alike."""
from cxlbench.devtrace import union

STEP = "fwd_bwd"
SPAN = "repro.mla.attention"


def per_step_ms(tr, names):
    """Merged device milliseconds of the operations launched inside spans
    named in ``names``, a traced step; None without a trace, such spans or
    steps."""
    if tr is None:
        return None
    ops = [op for name in names for op in tr.in_spans(name)]
    steps = sum(1 for step in tr.by_span(STEP) if step)
    if not ops or not steps:
        return None
    busy = sum(b - a for a, b in union((a, b) for _, a, b, _ in ops))
    return busy * 1e-3 / steps


def read(run):
    return per_step_ms(run.devtrace, [SPAN])
