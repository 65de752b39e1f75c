"""internvl2-2b [vlm] — InternLM2 backbone + InternViT stub frontend.
[arXiv:2404.16821; hf]  The ViT supplies precomputed patch embeddings
(256 prefix tokens) via input_specs; the LM backbone is exact."""
from repro_torch.configs.base import ArchConfig, VisionSpec

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553, head_dim=128,
    qkv_bias=False, rope=True, rope_theta=1_000_000.0,
    norm="rmsnorm", act="swiglu",
    vision=VisionSpec(n_prefix_tokens=256),
)
