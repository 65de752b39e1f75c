"""Milliseconds a traced training step keeps the device busy routing and
moving pairs to and from the held experts: the merged device time of the
operations launched inside the ``repro.moe.route`` (router, top-k,
sort), ``repro.moe.dispatch`` and ``repro.moe.combine`` spans, a step, as
``mla_attention_ms`` (forward and recompute; backward outside)."""
from cxlbench.common import load_piece

SPANS = ("repro.moe.route", "repro.moe.dispatch", "repro.moe.combine")


def read(run):
    per_step = load_piece("metrics", "mla_attention_ms").per_step_ms
    return per_step(run.devtrace, SPANS)
