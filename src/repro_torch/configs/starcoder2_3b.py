"""starcoder2-3b [dense] — GQA, RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab=49152, head_dim=128,
    qkv_bias=True, rope=True, rope_theta=100_000.0,
    norm="layernorm", act="gelu",
)
