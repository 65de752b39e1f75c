"""whisper-large-v3 [audio] — enc-dec; conv mel frontend is a STUB
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig, EncoderSpec

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, head_dim=64,
    qkv_bias=True, rope=False,
    norm="layernorm", act="gelu", tie_embeddings=True,
    encoder=EncoderSpec(n_layers=32, n_ctx=1500),
    max_seq=32_768,  # whisper spec is 448; extended so the assigned 32k shapes lower
)
