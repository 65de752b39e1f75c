"""Architecture config schema for the 10 assigned architectures.

Every config is constructed from the exact figures in the assignment
block; ``tiny()`` derives the reduced same-family config used by smoke
tests (small layers/width/experts, tiny vocab).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    expert_d_ff: int
    n_shared: int = 0
    shared_d_ff: int = 0
    #: a MoE layer every `every` layers (1 = all layers; 2 = alternate)
    every: int = 1
    #: index of leading dense layers (deepseek: first layer dense)
    first_dense: int = 0
    capacity_factor: float = 1.25
    router_zloss: float = 1e-3


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    n_layers: int
    n_ctx: int  # encoder positions (whisper: 1500 mel frames)
    frontend: str = "stub"  # precomputed embeddings provided as input


@dataclasses.dataclass(frozen=True)
class VisionSpec:
    n_prefix_tokens: int  # patch embeddings prepended to the text sequence
    frontend: str = "stub"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0  # partial rotary (stablelm: 0.25)
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu | geglu | relu_sq
    tie_embeddings: bool = False
    #: block pattern repeat unit, e.g. ("rglru","rglru","local_attn");
    #: empty = uniform full-attention decoder
    block_pattern: tuple[str, ...] = ()
    local_window: int = 0
    moe: Optional[MoESpec] = None
    encoder: Optional[EncoderSpec] = None
    vision: Optional[VisionSpec] = None
    #: rwkv-specific
    rwkv_head_dim: int = 64
    max_seq: int = 131_072
    param_dtype: str = "bfloat16"
    #: sub-quadratic in sequence length (long_500k eligibility)
    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to a multiple of 128 (MXU lane alignment + TP
        divisibility); the true ``vocab`` stays in metadata/param counts."""
        return -(-self.vocab // 128) * 128

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder is not None

    def tiny(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw: dict = dict(
            name=self.name + "-tiny",
            n_layers=max(2, len(self.block_pattern) or 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 1,
            d_ff=128,
            vocab=256,
            head_dim=16,
            max_seq=128,
            param_dtype="float32",
            local_window=min(self.local_window, 16) if self.local_window else 0,
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                n_experts=4,
                top_k=min(self.moe.top_k, 2),
                expert_d_ff=32,
                shared_d_ff=32 if self.moe.n_shared else 0,
                # dropless at smoke-test scale so decode == forward exactly
                capacity_factor=4.0,
            )
            # keep the dense/moe alternation shape
            kw["n_layers"] = max(2, self.moe.every * 2 + self.moe.first_dense)
        if self.encoder is not None:
            kw["encoder"] = dataclasses.replace(self.encoder, n_layers=2, n_ctx=16)
        if self.vision is not None:
            kw["vision"] = dataclasses.replace(self.vision, n_prefix_tokens=4)
        if self.block_pattern:
            kw["n_layers"] = len(self.block_pattern) * 2  # two pattern units
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytical parameter count (used for 6·N·D roofline terms)."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        q = self.n_heads * hd
        kv = self.n_kv_heads * hd
        emb = V * D * (1 if self.tie_embeddings else 2)

        def attn_p():
            p = D * q + 2 * D * kv + q * D
            if self.qkv_bias:
                p += q + 2 * kv
            return p

        def mlp_p(ff):
            return (3 if self.act in ("swiglu", "geglu") else 2) * D * ff

        total = emb
        for i in range(self.n_layers):
            kind = self.block_kind(i)
            if kind in ("attn", "local_attn"):
                total += attn_p() + mlp_p(F)
            elif kind == "rglru":
                # conv4 + in/out proj + gates + MLP
                total += 2 * D * D + 4 * D + 2 * D + mlp_p(F)
            elif kind == "rwkv":
                total += 4 * D * D + D * D + 2 * D * F  # time-mix + channel-mix
            elif kind == "moe":
                m = self.moe
                total += attn_p()
                total += m.n_experts * mlp_p(m.expert_d_ff)
                total += m.n_shared * mlp_p(m.shared_d_ff or m.expert_d_ff)
                total += D * m.n_experts  # router
            elif kind == "dense_moe_alt":
                total += attn_p() + mlp_p(F)
        if self.encoder is not None:
            for _ in range(self.encoder.n_layers):
                total += attn_p() + mlp_p(F)
            # decoder cross-attention
            total += self.n_layers * attn_p()
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        m = self.moe
        hd = self.resolved_head_dim
        q, kv = self.n_heads * hd, self.n_kv_heads * hd
        attn_p = D * q + 2 * D * kv + q * D
        mlp = lambda ff: (3 if self.act in ("swiglu", "geglu") else 2) * D * ff
        total = self.vocab * D * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            kind = self.block_kind(i)
            if kind == "moe":
                total += attn_p + m.top_k * mlp(m.expert_d_ff)
                total += m.n_shared * mlp(m.shared_d_ff or m.expert_d_ff)
            else:
                total += attn_p + mlp(F)
        return total

    def block_kind(self, layer_idx: int) -> str:
        """Block type of decoder layer ``layer_idx``."""
        if self.family == "ssm":
            return "rwkv"
        if self.block_pattern:
            return self.block_pattern[layer_idx % len(self.block_pattern)]
        if self.moe is not None:
            if layer_idx < self.moe.first_dense:
                return "dense_moe_alt"
            # hf llama4 convention: MoE on every `every`-th layer
            return "moe" if (layer_idx + 1) % self.moe.every == 0 else "dense_moe_alt"
        return "attn"

    def layer_kinds(self) -> tuple[str, ...]:
        return tuple(self.block_kind(i) for i in range(self.n_layers))
