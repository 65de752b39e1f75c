"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, MoE every other
layer, 1 shared expert. [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
Assignment gives expert d_ff=8192; the alternating dense layers use the
hf intermediate_size_mlp=16384 so total/active params land at ~400B/17B."""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=16384, vocab=202048, head_dim=128,
    qkv_bias=False, rope=True, rope_theta=500_000.0,
    norm="rmsnorm", act="swiglu",
    moe=MoESpec(
        n_experts=128, top_k=1, expert_d_ff=8192,
        n_shared=1, shared_d_ff=8192, every=2,
    ),
)
