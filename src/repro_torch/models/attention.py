"""GQA attention: full sequence (exact, q-chunked), decode over a KV
cache, and the tiered merge.

``attend_partial`` computes one KV partition's unnormalised attention
through the ``decode_attention`` kernel (its plain version on the CPU),
and ``merge_partials`` combines the partials of every device pool — and
of the shared-prefix pool — exactly, by the log-sum-exp algebra.

``attention`` is the reference's exact full-sequence attention (causal,
with an optional sliding ``window``), its query axis cut into chunks so
the score block is (chunk, S).  ``decode_attention`` is the model-level
decode step over one layer's cache, full or ring-buffer (``window``);
where the reference's per-partition attention is jnp, the port's goes
through ``attend_partial`` and so runs the kernel on the card.  It
writes the new K/V row into the cache in place and returns the same
tensors.  The cross-attention variant (``kv_override``) comes with the
audio family."""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import NEG_INF
from repro_torch.models.common import apply_rope, he

__all__ = ["NEG_INF", "attn_params", "attend_partial", "merge_partials",
           "attention", "decode_attention"]


def attn_params(gen: torch.Generator, d_model: int, n_heads: int,
                n_kv_heads: int, head_dim: int, dtype, qkv_bias: bool = False,
                device=None) -> dict:
    p = {
        "wq": he(gen, (d_model, n_heads * head_dim), dtype, device=device),
        "wk": he(gen, (d_model, n_kv_heads * head_dim), dtype, device=device),
        "wv": he(gen, (d_model, n_kv_heads * head_dim), dtype, device=device),
        "wo": he(gen, (n_heads * head_dim, d_model), dtype, device=device),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv_heads),
                            ("bv", n_kv_heads)):
            p[name] = torch.zeros((width * head_dim,), dtype=dtype,
                                  device=device)
    return p


def attend_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid: torch.Tensor):
    """Unnormalised attention over one KV partition.

    q: (B,H,hd); k,v: (B,T,K,hd); valid: (B,T) bool.
    Returns (acc (B,H,hd), lse-pieces (m, l): (B,H)), fp32."""
    return da_ops.attend_partial(q, k, v, valid)


def merge_partials(parts) -> torch.Tensor:
    """Exactly merge [(acc, m, l), ...] partial attentions (flash combine)."""
    ms = [m for _, m, _ in parts]
    m_all = torch.stack(ms).amax(dim=0)
    acc_t, l_t = 0.0, 0.0
    for acc, m, l in parts:
        w = torch.exp(m - m_all)
        acc_t = acc_t + acc * w[..., None]
        l_t = l_t + l * w
    return acc_t / torch.clamp_min(l_t, 1e-30)[..., None]


# ---------------------------------------------------------------------------
# Full-sequence attention (prefill)
# ---------------------------------------------------------------------------
def _project_qkv(x: torch.Tensor, p: dict, n_heads: int, n_kv_heads: int,
                 head_dim: int):
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, n_heads, head_dim),
            k.reshape(B, S, n_kv_heads, head_dim),
            v.reshape(B, S, n_kv_heads, head_dim))


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,H,hd), k: (B,Sk,K,hd) -> scores (B,K,H/K,Sq,Sk)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd)
    return torch.einsum("bqkgh,bskh->bkgqs", qg, k) / math.sqrt(hd)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B,K,G,Sq,Sk), v: (B,Sk,K,hd) -> (B,Sq,H,hd)."""
    B, K, G, Sq, _ = probs.shape
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, K * G, v.shape[-1])


def attention(x: torch.Tensor, p: dict, *, n_heads: int, n_kv_heads: int,
              head_dim: int, positions: torch.Tensor, causal: bool = True,
              window: int = 0, rope_theta: float = 10_000.0,
              rope_pct: float = 1.0, use_rope: bool = True,
              q_chunk: int = 1024) -> torch.Tensor:
    """Full-sequence attention; exact, q-chunked.  x: (B,S,D), positions:
    (B,S).  Returns (B,S,D).  Scores in the activation dtype, softmax in
    fp32 over the finite ``NEG_INF`` mask, as the reference."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(x, p, n_heads, n_kv_heads, head_dim)
    if use_rope:
        k = apply_rope(k, positions, rope_theta, rope_pct)
        q = apply_rope(q, positions, rope_theta, rope_pct)
    neg = torch.tensor(NEG_INF, dtype=x.dtype, device=x.device)

    def block(q_blk: torch.Tensor, pos_blk: torch.Tensor) -> torch.Tensor:
        scores = _gqa_scores(q_blk, k)  # (B,K,G,C,S)
        mask = torch.ones((B, pos_blk.shape[1], S), dtype=torch.bool,
                          device=x.device)
        if causal:
            mask &= pos_blk[:, :, None] >= positions[:, None, :]
        if window:
            mask &= pos_blk[:, :, None] - positions[:, None, :] < window
        scores = torch.where(mask[:, None, None], scores, neg)
        probs = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
        return _gqa_out(probs, v)

    if S % q_chunk:
        # largest divisor of S that is <= q_chunk; 1 leaves it unchunked
        q_chunk = max(d for d in range(1, q_chunk + 1) if S % d == 0)
    if S <= q_chunk or q_chunk == 1:
        out = block(q, positions)
    else:
        out = torch.cat([block(q[:, i:i + q_chunk],
                               positions[:, i:i + q_chunk])
                         for i in range(0, S, q_chunk)], dim=1)
    return out.reshape(B, S, n_heads * head_dim) @ p["wo"]


# ---------------------------------------------------------------------------
# Decode: one new token against one layer's KV cache
# ---------------------------------------------------------------------------
def decode_attention(x_tok: torch.Tensor, p: dict, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     n_heads: int, n_kv_heads: int, head_dim: int,
                     positions: torch.Tensor, rope_theta: float = 10_000.0,
                     rope_pct: float = 1.0, use_rope: bool = True,
                     window: int = 0, extra_partitions: tuple = (),
                     attend: Optional[Callable] = None):
    """One decode step over ``k_cache``/``v_cache`` (B,T,K,hd), whose first
    ``cache_len[b]`` rows are valid (ring-buffer rows when ``window``).
    The new K/V row is written in place.  Returns (out (B,D), k_cache,
    v_cache).  ``attend`` replaces the per-partition attention (default:
    :func:`attend_partial`, the kernel on the card)."""
    attend = attend or attend_partial
    B = x_tok.shape[0]
    q = x_tok @ p["wq"]
    k = x_tok @ p["wk"]
    v = x_tok @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, n_heads, head_dim)
    k = k.reshape(B, n_kv_heads, head_dim)
    v = v.reshape(B, n_kv_heads, head_dim)
    if use_rope:
        q = apply_rope(q[:, None], positions[:, None], rope_theta,
                       rope_pct)[:, 0]
        k = apply_rope(k[:, None], positions[:, None], rope_theta,
                       rope_pct)[:, 0]
    T = k_cache.shape[1]
    cache_len = cache_len.to(k_cache.device).long()
    slot = cache_len % T if window else torch.clamp_max(cache_len, T - 1)
    bidx = torch.arange(B, device=k_cache.device)
    k_cache[bidx, slot] = k.to(k_cache.dtype)
    v_cache[bidx, slot] = v.to(v_cache.dtype)
    t_idx = torch.arange(T, device=k_cache.device)[None, :]
    if window:
        valid = t_idx < torch.clamp_max(cache_len + 1, T)[:, None]
    else:
        valid = t_idx <= cache_len[:, None]
    parts = [attend(q, k_cache, v_cache, valid)]
    parts += [attend(q, ke, ve, vald) for ke, ve, vald in extra_partitions]
    out = merge_partials(parts).to(x_tok.dtype)
    return out.reshape(B, n_heads * head_dim) @ p["wo"], k_cache, v_cache
