"""recurrentgemma-9b [hybrid] — RG-LRU + local attn, 1:2 pattern.
[arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000, head_dim=256,
    qkv_bias=False, rope=True, rope_theta=10_000.0,
    norm="rmsnorm", act="geglu",
    block_pattern=("rglru", "rglru", "local_attn"),
    local_window=2048,
)
