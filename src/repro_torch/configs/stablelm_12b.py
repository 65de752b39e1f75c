"""stablelm-12b [dense] — partial rotary (25%), LayerNorm.
[hf:stabilityai/stablelm-2-1_6b; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab=100352, head_dim=160,
    qkv_bias=False, rope=True, rope_theta=10_000.0, rope_pct=0.25,
    norm="layernorm", act="swiglu",
)
