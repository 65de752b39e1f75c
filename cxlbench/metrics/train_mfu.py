"""The whole training step's share of the chip's peak: the step's least
time over its wall time on the untraced stretch.

The least time is the larger of the model's FLOPs at the bf16 peak and
the optimizer state that the traffic's slow fraction keeps in pinned
memory (12 bytes a parameter: the fp32 master and two moments), read and
written once, at PCIe's peak each way."""
from cxlbench import peaks

#: optimizer state bytes a parameter (fp32 master, mu, nu)
STATE_BYTES = 12


def matmul_params(c: dict) -> int:
    """Parameters that take part in a matrix product for each token: the
    projections, the MLP and the head (the embedding when tied)."""
    L, D, F = c["num_hidden_layers"], c["hidden_size"], c["intermediate_size"]
    q = c["num_attention_heads"] * c["head_dim"]
    kv = c["num_key_value_heads"] * c["head_dim"]
    return L * (2 * D * q + 2 * D * kv + 2 * D * F) + D * c["vocab_size"]


def all_params(c: dict) -> int:
    L, D = c["num_hidden_layers"], c["hidden_size"]
    q = c["num_attention_heads"] * c["head_dim"]
    kv = c["num_key_value_heads"] * c["head_dim"]
    n = matmul_params(c) + L * 4 * D + 2 * D
    if c["use_bias"] in ("qkv", True):
        n += L * (q + 2 * kv)
    if not c["tie_word_embeddings"]:
        n += c["vocab_size"] * D
    return n


def step_flops(c: dict, batch: int, seq: int) -> float:
    """A training step's model FLOPs: three times the forward's (the
    backward twice it; recomputation not counted), the forward being two
    a matrix parameter a token and the causal attention's two products."""
    window = c.get("sliding_window") or seq
    seen = sum(min(t + 1, window) for t in range(seq))
    attn = c["num_hidden_layers"] * 4 * c["num_attention_heads"] \
        * c["head_dim"] * seen
    return 3.0 * batch * (2.0 * matmul_params(c) * seq + attn)


def paging_seconds(c: dict, slow_fraction: float) -> float:
    """The slow share of the optimizer state read and written once, both
    ways at once, over PCIe."""
    return slow_fraction * STATE_BYTES * all_params(c) \
        / peaks.PCIE_BYTES_EACH_WAY


def least_seconds(run) -> float:
    tr = run.traffic
    return max(step_flops(run.config, tr["batch"], tr["seq"])
               / peaks.BF16_FLOPS,
               paging_seconds(run.config, float(tr["slow_fraction"])))


def read(run):
    w = run.timed
    if not w.get("ops"):
        return None
    return 100.0 * least_seconds(run) / (w["seconds"] / w["ops"])
