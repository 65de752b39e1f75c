"""Plain PyTorch versions of flash-decode GQA attention, in both forms.

``attend_partial`` is the semantics of the reference's
``repro.models.attention.attend_partial``: fp32 scores taken as the dot
product divided by sqrt(hd), the finite ``NEG_INF = -1e30`` where a
position is not valid, then a two-pass softmax (max, then exp and sum).
A row with no valid position gives ``m = -1e30``, ``l = T`` and the sum
of V, which the merge weights by zero.

``decode_attention`` follows the reference's oracle
(``repro/kernels/decode_attention/ref.py``) for ``lengths >= 1``.  At
``lengths == 0`` it returns 0, as the Pallas kernel and the CUDA kernel do
(the oracle's softmax over nothing gives NaN)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attend_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   valid: torch.Tensor):
    """q: (B,H,hd); k,v: (B,T,K,hd); valid: (B,T) bool.
    Returns (acc (B,H,hd), m (B,H), l (B,H)), all fp32."""
    B, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd).to(torch.float32)
    scores = torch.einsum("bkgh,btkh->bkgt", qg,
                          k.to(torch.float32)) / math.sqrt(hd)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG_INF, dtype=torch.float32,
                                      device=scores.device))
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgt,btkh->bkgh", p, v.to(torch.float32))
    return acc.reshape(B, H, hd), m.reshape(B, H), l.reshape(B, H)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q: (B,H,hd); k,v: (B,T,K,hd); lengths: (B,) valid prefix.
    Returns (B,H,hd) in fp32."""
    B, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd).to(torch.float32)
    scores = torch.einsum("bkgh,btkh->bkgt", qg,
                          k.to(torch.float32)) / math.sqrt(hd)
    lengths = lengths.to(scores.device)
    valid = torch.arange(T, device=scores.device)[None, :] < lengths[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)  # lengths == 0: 0, not NaN
    out = torch.einsum("bkgt,btkh->bkgh", probs, v.to(torch.float32))
    return out.reshape(B, H, hd)


def kv_append(k_pool: torch.Tensor, v_pool: torch.Tensor, rows: torch.Tensor,
              k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """In place: row ``rows[b]`` of sequence b of ``k_pool``/``v_pool``
    (B,T,K,hd) gets ``k_new[b]``/``v_new[b]`` cast to the pool dtype;
    rows outside [0, T) are dropped (the reference's ``mode="drop"``)."""
    T = k_pool.shape[1]
    b = torch.nonzero((rows >= 0) & (rows < T)).reshape(-1)
    r = rows[b].to(torch.int64)
    k_pool[b, r] = k_new[b].to(k_pool.dtype)
    v_pool[b, r] = v_new[b].to(v_pool.dtype)
