"""The whole training step's share of the chip's peak for a DeepSeek-V2
cell (``deepseek-v2-lite-ep8``): the step's FLOPs at the bf16 peak over
its wall time on the untraced stretch, all optimizer state in HBM.

A step's FLOPs are three times the forward's (the backward twice it;
recomputation not counted).  The forward takes two FLOPs a matrix
parameter a token, the routed experts counted at the share of a token's
choices the held experts take at an even load (``top_k * held /
published experts``), and latent attention's two products over the
causal pairs: the scores over the unrotated and rotary dimensions, the
values over ``v_head_dim``."""
from cxlbench import peaks


def mla_params(c: dict) -> int:
    """One layer's latent attention projections."""
    D, H, r = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"]
    nope, rd, vd = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                    c["v_head_dim"])
    return (D * H * (nope + rd) + D * (r + rd) + r * H * (nope + vd)
            + H * vd * D)


def swiglu_params(c: dict, width: int) -> int:
    return 3 * c["hidden_size"] * width


def matmul_params(c: dict) -> float:
    """Matrix parameters a token passes through: every layer's attention,
    the dense layers' MLP, the MoE layers' router, shared experts and its
    share of a routed expert, and the head."""
    L, Ld = c["num_hidden_layers"], c["first_k_dense_replace"]
    E = c["published"]["n_routed_experts"]
    routed = c["num_experts_per_tok"] * c["n_routed_experts"] / E
    f = c["moe_intermediate_size"]
    moe = (c["hidden_size"] * E + c["n_shared_experts"] * swiglu_params(c, f)
           + routed * swiglu_params(c, f))
    return (L * mla_params(c) + Ld * swiglu_params(c, c["intermediate_size"])
            + (L - Ld) * moe + c["hidden_size"] * c["vocab_size"])


def attention_flops(c: dict, batch: int, seq: int) -> float:
    """A forward's score and value products over the causal pairs."""
    pairs = batch * seq * (seq + 1) / 2
    width = c["qk_nope_head_dim"] + c["qk_rope_head_dim"] + c["v_head_dim"]
    return c["num_hidden_layers"] * 2.0 * c["num_attention_heads"] * width \
        * pairs


def step_flops(c: dict, batch: int, seq: int) -> float:
    return 3.0 * (2.0 * matmul_params(c) * batch * seq
                  + attention_flops(c, batch, seq))


def read(run):
    w, tr = run.timed, run.traffic
    if not w.get("ops"):
        return None
    least = step_flops(run.config, tr["batch"], tr["seq"]) / peaks.BF16_FLOPS
    return 100.0 * least / (w["seconds"] / w["ops"])
