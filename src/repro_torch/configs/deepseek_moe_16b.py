"""deepseek-moe-16b [moe] — fine-grained: 2 shared + 64 routed top-6,
first layer dense (d_ff=10944 per arXiv:2401.06066). [arXiv:2401.06066; hf]"""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab=102400, head_dim=128,
    qkv_bias=False, rope=True, rope_theta=10_000.0,
    norm="rmsnorm", act="swiglu",
    moe=MoESpec(
        n_experts=64, top_k=6, expert_d_ff=1408,
        n_shared=2, shared_d_ff=1408, every=1, first_dense=1,
    ),
)
