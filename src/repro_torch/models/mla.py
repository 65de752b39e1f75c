"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434 §2.1), full
sequence: exact, its query axis cut into chunks as
:func:`repro_torch.models.attention.attention`'s is.

Without a query LoRA: ``q = x Wq`` splits per head into an unrotated part
(``qk_nope_head_dim``) and a rotary part (``qk_rope_head_dim``);
``[c, k_pe] = x Wkv_a`` gives the latent ``c`` (``kv_lora_rank``), which is
RMS-normed, and one rotary key ``k_pe`` that every head shares;
``[k_nope, v] = c Wkv_b`` per head.  The rotary parts turn by YaRN's
frequencies (``cfg.yarn``; plain RoPE without one), over interleaved pairs
as the port's rotary does everywhere, which is how the published model
reads its rotary dimensions too.  Scores run over the nope and rotary
dimensions together at YaRN's softmax scale, in the activation dtype,
under a causal mask; the softmax is fp32; the heads' values go through
``Wo``.  The call is the span ``repro.mla.attention`` (its forward, and its
recompute under remat; the backward's operations are outside it).  There
is no decode path: decode and serving refuse a latent configuration."""
from __future__ import annotations

import torch

from repro_torch.core.telemetry import span
from repro_torch.kernels.decode_attention.ref import NEG_INF
from repro_torch.models.attention import _mask
from repro_torch.models.common import (current_policy, he, rms_norm,
                                       rope_tables, rotate, yarn_softmax_scale,
                                       yarn_tables)


def mla_params(gen: torch.Generator, cfg, dtype, device=None) -> dict:
    """One layer's latent attention: ``wq`` (D, H (nope + rope)),
    ``wkv_a`` (D, latent + rope), ``kv_norm`` (latent,) fp32 at 1,
    ``wkv_b`` (latent, H (nope + v)) and ``wo`` (H v, D)."""
    m, D, H = cfg.mla, cfg.d_model, cfg.n_heads
    return {
        "wq": he(gen, (D, H * m.qk_head_dim), dtype, device=device),
        "wkv_a": he(gen, (D, m.kv_lora_rank + m.qk_rope_head_dim), dtype,
                    device=device),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=torch.float32,
                              device=device),
        "wkv_b": he(gen, (m.kv_lora_rank,
                          H * (m.qk_nope_head_dim + m.v_head_dim)), dtype,
                    device=device),
        "wo": he(gen, (H * m.v_head_dim, D), dtype, device=device),
    }


def refuse_decode(cfg) -> None:
    """Raise for a latent configuration: no cache or decode step holds
    its compressed KV yet, and a GQA step would run the wrong model."""
    if cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: latent attention (MLA) has no decode or serving "
            "path; it trains and runs forward only")


def mla_attention(x: torch.Tensor, p: dict, cfg, positions: torch.Tensor,
                  q_chunk: int = 1024) -> torch.Tensor:
    """x (B,S,D), positions (B,S) -> (B,S,D), causal.  An installed
    policy's ``_q_chunk`` sets the query chunk, as for
    :func:`~repro_torch.models.attention.attention`."""
    pol = current_policy()
    if pol and "_q_chunk" in pol:
        q_chunk = pol["_q_chunk"]
    m, H = cfg.mla, cfg.n_heads
    nope, rd, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    B, S, _ = x.shape
    with span("repro.mla.attention"):
        q = (x @ p["wq"]).view(B, S, H, nope + rd)
        c, k_pe = (x @ p["wkv_a"]).split([m.kv_lora_rank, rd], dim=-1)
        kv = (rms_norm(c, p["kv_norm"]) @ p["wkv_b"]).view(B, S, H, nope + vd)
        k_nope, v = kv.split([nope, vd], dim=-1)
        if cfg.yarn is not None:
            cos, sin = yarn_tables(positions, rd, cfg.rope_theta, cfg.yarn)
        else:
            cos, sin = rope_tables(positions, rd, cfg.rope_theta)
        q = torch.cat([q[..., :nope], rotate(q[..., nope:], cos, sin)], -1)
        k_pe = rotate(k_pe[:, :, None], cos, sin).expand(B, S, H, rd)
        q = q.transpose(1, 2)  # (B,H,S,nope+rope)
        kt = torch.cat([k_nope, k_pe], -1).permute(0, 2, 3, 1)  # (B,H,d,S)
        v = v.transpose(1, 2)  # (B,H,S,v)
        scale = yarn_softmax_scale(m.qk_head_dim, cfg.yarn)

        def block(lo: int, hi: int) -> torch.Tensor:
            scores = (q[:, :, lo:hi] @ kt) * scale  # (B,H,C,S)
            seen = _mask(positions[:, lo:hi], positions, True, 0)
            scores = torch.where(seen[:, None], scores, NEG_INF)
            probs = torch.softmax(scores.to(torch.float32), dim=-1)
            return probs.to(x.dtype) @ v  # (B,H,C,v)

        if S % q_chunk:
            # largest divisor of S that is <= q_chunk, as attention's
            q_chunk = max(d for d in range(1, q_chunk + 1) if S % d == 0)
        out = torch.cat([block(lo, lo + q_chunk)
                         for lo in range(0, S, q_chunk)], dim=2)
        return out.transpose(1, 2).reshape(B, S, H * vd) @ p["wo"]
