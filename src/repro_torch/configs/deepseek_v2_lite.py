"""deepseek-v2-lite [moe] — latent attention (no query LoRA, a 512-wide
latent, a 64-wide rotary key shared by the 16 heads) with YaRN scaling
(factor 40 over 4,096 positions); first layer dense (SwiGLU 10,944); then
64 routed experts, greedy top-6 over a softmax, gates not renormalised,
2 shared experts of 1,408, a sequence-wise balance loss.
[arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2-Lite config.json]

Not one of the reference's ten: the registry finds it by id, but it is
not in ``ARCH_IDS``.  ``CONFIG`` holds all 64 routed experts;
:func:`held_share` gives the share one card of an expert-parallel
deployment holds."""
import dataclasses

from repro_torch.configs.base import (HeldMoESpec, LatentArchConfig,
                                      MLASpec, YarnSpec)

#: DeepSeek-V2's expert-level balance factor; the published config gives
#: no value (the paper's is 0.003 for V2; 0.001 is assumed here)
SEQ_AUX_ALPHA = 1e-3

CONFIG = LatentArchConfig(
    name="deepseek-v2-lite", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab=102400, head_dim=128,
    qkv_bias=False, rope=True, rope_theta=10_000.0,
    norm="rmsnorm", act="swiglu", max_seq=163_840,
    moe=HeldMoESpec(
        n_experts=64, top_k=6, expert_d_ff=1408,
        n_shared=2, shared_d_ff=1408, every=1, first_dense=1,
        router_zloss=0.0, norm_topk=False, seq_aux_alpha=SEQ_AUX_ALPHA,
    ),
    mla=MLASpec(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
                v_head_dim=128),
    yarn=YarnSpec(factor=40.0, original_max_position=4096, beta_fast=32.0,
                  beta_slow=1.0, mscale=0.707, mscale_all_dim=0.707),
)


def held_share(cfg: LatentArchConfig, n_held: int,
               first_held: int = 0) -> LatentArchConfig:
    """``cfg`` holding routed experts ``[first_held, first_held +
    n_held)`` of its MoE layers, as one card of an expert-parallel
    deployment over ``n_experts / n_held`` cards does."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_held=n_held, first_held=first_held))
