"""Share of its roofline that latent attention reaches: the least time of
what a traced step's ``repro.mla.attention`` spans compute, over their
merged device time a step (``mla_attention_ms``).

The work comes from the configuration, not from the code: a forward's
latent attention (its four projections at two FLOPs a parameter a token,
and its score and value products over the causal pairs), once more under
remat for the recompute.  The least time is the larger of those FLOPs at
the bf16 peak and the bytes they need at HBM's peak: each layer's
projections and its input and output activations read or written once in
bf16.  The masked half of the score blocks, which the code computes, is
not counted."""
from cxlbench import peaks
from cxlbench.common import load_piece

#: bytes an element of the bf16 weights and activations
ITEM = 2


def least_seconds(c: dict, tr: dict) -> float:
    """A traced step's least time of the spans' work."""
    mfu = load_piece("metrics", "train_mfu.dsv2")
    L, tokens = c["num_hidden_layers"], tr["batch"] * tr["seq"]
    passes = 2 if tr["remat"] else 1
    flops = 2.0 * L * mfu.mla_params(c) * tokens \
        + mfu.attention_flops(c, tr["batch"], tr["seq"])
    moved = L * ITEM * (mfu.mla_params(c) + 2 * tokens * c["hidden_size"])
    return passes * max(flops / peaks.BF16_FLOPS, moved / peaks.HBM_BYTES)


def read(run):
    per_step = load_piece("metrics", "mla_attention_ms").per_step_ms
    ms = per_step(run.devtrace, ["repro.mla.attention"])
    if not ms:
        return None
    return 100.0 * least_seconds(run.config, run.traffic) / (ms * 1e-3)
