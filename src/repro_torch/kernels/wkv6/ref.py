"""Plain PyTorch version of the RWKV6 WKV recurrence: the exact loop over
time of the reference's ``repro/kernels/wkv6/ref.py`` and
``repro.models.rwkv.wkv_scan``.  Inputs may be any float dtype; every
product is taken in fp32."""
from __future__ import annotations

from typing import Optional

import torch


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor, *,
         state_out: Optional[torch.Tensor] = None):
    """r, k, v, w: (B,T,H,hd); u: (H,hd); state: (B,H,hd,hd), indexed
    (k-dim, v-dim).  Per step ``y_t = r_tᵀ(S + u ⊙ k_t v_tᵀ)``, then
    ``S ← diag(w_t) S + k_t v_tᵀ``.

    Returns (y (B,T,H,hd) fp32, final state fp32).  With ``state_out``
    the final state is written there (it may be ``state`` itself) and
    that tensor is returned."""
    f32 = torch.float32
    rs, ks, vs, ws = (a.to(f32) for a in (r, k, v, w))
    uf = u.to(f32)[None, :, :, None]
    s = state.to(f32)
    ys = []
    for t in range(r.shape[1]):
        kv = ks[:, t, :, :, None] * vs[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", rs[:, t], s + uf * kv))
        s = ws[:, t, :, :, None] * s + kv
    y = torch.stack(ys, dim=1)
    if state_out is None:
        return y, s
    state_out.copy_(s)
    return y, state_out
