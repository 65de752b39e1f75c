"""Milliseconds a traced training step keeps the device busy in the held
experts' products (``repro.moe.experts`` spans: the grouped SwiGLU over
the pairs routed to them), as ``mla_attention_ms`` (forward and
recompute; backward outside)."""
from cxlbench.common import load_piece


def read(run):
    per_step = load_piece("metrics", "mla_attention_ms").per_step_ms
    return per_step(run.devtrace, ["repro.moe.experts"])
