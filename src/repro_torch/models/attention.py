"""GQA attention for decode over a tiered KV cache.

``attend_partial`` computes one KV partition's unnormalised attention
through the ``decode_attention`` kernel (its plain version on the CPU),
and ``merge_partials`` combines the partials of every device pool — and
of the shared-prefix pool — exactly, by the log-sum-exp algebra.  The
full-sequence ``attention()`` and the model-level ``decode_attention()``
of the reference belong to training and the untiered decode step, which
are not ported yet."""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import NEG_INF
from repro_torch.models.common import he

__all__ = ["NEG_INF", "attn_params", "attend_partial", "merge_partials"]


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
