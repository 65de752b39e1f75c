"""GQA attention: full sequence (exact, q-chunked), decode over a KV
cache, and the tiered merge.

``attend_partial`` computes one KV partition's unnormalised attention
through the ``decode_attention`` kernel (its plain version on the CPU),
and ``merge_partials`` combines the partials of every device pool — and
of the shared-prefix pool — exactly, by the log-sum-exp algebra.

``attention`` is the reference's exact full-sequence attention (causal,
with an optional sliding ``window``), its query axis cut into chunks so
the score block is (chunk, S); under a policy with ``_flash`` each
query chunk runs :func:`block_flash`, an online softmax over KV chunks
(plain torch, as the reference's is jnp).  ``decode_attention`` is the model-level
decode step over one layer's cache, full or ring-buffer (``window``);
where the reference's per-partition attention is jnp, the port's goes
through ``attend_partial`` and so runs the kernel on the card.  It
writes the new K/V row into the cache in place and returns the same
tensors.  ``attention(..., kv_override=(k, v, kv_positions))`` is the
cross-attention of the audio family's decoder."""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import NEG_INF
from repro_torch.models.common import apply_rope, current_policy, he, \
    maybe_shard

__all__ = ["NEG_INF", "attn_params", "attend_partial", "merge_partials",
           "attention", "block_flash", "decode_attention"]


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
              q_chunk: int = 1024,
              kv_override: Optional[tuple] = None) -> torch.Tensor:
    """Full-sequence attention; exact, q-chunked.  x: (B,S,D), positions:
    (B,S).  Returns (B,S,D).  Scores in the activation dtype, softmax in
    fp32 over the finite ``NEG_INF`` mask, as the reference.
    ``kv_override=(k, v, kv_positions)`` attends over given K/V (B,Sk,K,hd)
    instead of x's (cross-attention: not causal, K not rotated).

    An installed policy (:func:`repro_torch.models.common.activation_sharding`)
    sets the query chunk (``_q_chunk``) and, with ``_flash``, takes
    :func:`block_flash` over KV chunks of ``_kv_chunk`` (default 1024)
    when the KV length is a multiple of it and longer, as the reference
    does."""
    pol = current_policy()
    if pol and "_q_chunk" in pol:
        q_chunk = pol["_q_chunk"]
    B, S, _ = x.shape
    if kv_override is None:
        q, k, v = _project_qkv(x, p, n_heads, n_kv_heads, head_dim)
        kv_pos = positions
        if use_rope:
            k = apply_rope(k, kv_pos, rope_theta, rope_pct)
    else:
        q = x @ p["wq"]
        if "bq" in p:
            q = q + p["bq"]
        q = q.reshape(B, S, n_heads, head_dim)
        k, v, kv_pos = kv_override
        causal = False
    if use_rope:
        q = apply_rope(q, positions, rope_theta, rope_pct)
    q = maybe_shard(q, "act_bshd")
    k = maybe_shard(k, "act_bskd")
    v = maybe_shard(v, "act_bskd")
    Sk = k.shape[1]

    def block_exact(q_blk: torch.Tensor, pos_blk: torch.Tensor
                    ) -> torch.Tensor:
        scores = _gqa_scores(q_blk, k)  # (B,K,G,C,S)
        mask = _mask(pos_blk, kv_pos, causal, window)
        # a Python scalar, cast to the scores' dtype like the reference's
        # constant (a device tensor made here would copy from the host
        # and wait for the card every call)
        scores = torch.where(mask[:, None, None], scores, NEG_INF)
        probs = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
        return _gqa_out(probs, v)

    kv_chunk = int(pol.get("_kv_chunk", 1024)) if pol else 1024
    use_flash = bool(pol and pol.get("_flash")) \
        and Sk % kv_chunk == 0 and Sk > kv_chunk
    if use_flash:
        def block(q_blk, pos_blk):
            return block_flash(q_blk, pos_blk, k, v, kv_pos, causal=causal,
                               window=window, kv_chunk=kv_chunk
                               ).to(x.dtype)
    else:
        block = block_exact

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


def _mask(pos_q: torch.Tensor, pos_k: torch.Tensor, causal: bool,
          window: int) -> torch.Tensor:
    """(B, Sq, Sk) bool: which keys each query may see."""
    mask = torch.ones((pos_q.shape[0], pos_q.shape[1], pos_k.shape[1]),
                      dtype=torch.bool, device=pos_q.device)
    if causal:
        mask &= pos_q[:, :, None] >= pos_k[:, None, :]
    if window:
        mask &= pos_q[:, :, None] - pos_k[:, None, :] < window
    return mask


def block_flash(q_blk: torch.Tensor, pos_blk: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
                window: int, kv_chunk: int) -> torch.Tensor:
    """Online-softmax attention of a query block over KV chunks: the
    (C, S_kv) score tensor never exists, only (C, kv_chunk) blocks, the
    running max, sum and output kept in fp32 (the reference's
    ``block_flash``).  q_blk: (B,C,H,hd); k, v: (B,Sk,K,hd) with Sk a
    multiple of ``kv_chunk``.  Returns (B,C,H,hd) fp32."""
    B, C, H, hd = q_blk.shape
    K = k.shape[2]
    G = H // K
    f32 = torch.float32
    acc = torch.zeros((B, K, G, C, hd), dtype=f32, device=q_blk.device)
    m = torch.full((B, K, G, C), NEG_INF, dtype=f32, device=q_blk.device)
    l = torch.zeros((B, K, G, C), dtype=f32, device=q_blk.device)
    for j in range(0, k.shape[1], kv_chunk):
        kj, vj = k[:, j:j + kv_chunk], v[:, j:j + kv_chunk]
        s = _gqa_scores(q_blk, kj).to(f32)  # (B,K,G,C,ck)
        mask = _mask(pos_blk, kv_pos[:, j:j + kv_chunk], causal, window)
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p_ = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p_.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskh->bkgqh", p_.to(vj.dtype), vj)
        acc = acc * alpha[..., None] + pv.to(f32)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]  # (B,K,G,C,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, H, hd)


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
