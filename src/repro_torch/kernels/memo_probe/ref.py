"""Plain PyTorch versions of MEMO's probes (``repro.core.memo``'s jitted
programs ``_seq_load``, ``_seq_store``, ``_random_block_load`` and
``_pointer_chase``), on fp32 tables and int32 indices."""
from __future__ import annotations

import torch


def seq_load(x: torch.Tensor, lanes: int) -> torch.Tensor:
    """(lanes,) fp32: each lane's sum of its contiguous slice of ``x``."""
    return x.reshape(lanes, -1).sum(dim=1)


def seq_store(x: torch.Tensor, lanes: int, v: torch.Tensor) -> torch.Tensor:
    """``x`` with each lane's slice set to ``v[lane]``, in place (the
    reference returns ``xs * 0 + v``: the same for finite ``x``)."""
    x.view(lanes, -1).copy_(v.to(x.dtype)[:, None].expand(lanes, -1))
    return x


def clamp_starts(starts: torch.Tensor, n: int,
                 block_elems: int) -> torch.Tensor:
    """Starts placed as ``lax.dynamic_slice`` places them: a negative one
    counts from the end, then each is clamped so its block lies in the
    table."""
    s = starts.to(torch.int64)
    return torch.where(s < 0, s + n, s).clamp(0, n - block_elems)


def random_block_load(x: torch.Tensor, starts: torch.Tensor,
                      block_elems: int) -> torch.Tensor:
    """The sum of the ``block_elems``-long blocks of flat ``x`` that begin at
    ``starts``: a scalar for (n,) starts (the reference's call), one sum a
    lane for (lanes, n)."""
    flat = x.reshape(-1)
    s = clamp_starts(starts, flat.numel(), block_elems)
    idx = s[..., None] + torch.arange(block_elems, device=s.device)
    rows = flat.index_select(0, idx.reshape(-1).to(flat.device))
    return rows.view(idx.shape).sum(dim=(-2, -1))


def pointer_chase(perm: torch.Tensor, steps: int,
                  start: int = 0) -> torch.Tensor:
    """``p = perm[p]`` ``steps`` times from ``p = start`` (the reference
    starts at 0); the last ``p`` as a 0-dim int32 tensor."""
    table = perm.detach().cpu().numpy()
    p = int(start)
    for _ in range(int(steps)):
        p = int(table[p])
    return torch.tensor(p, dtype=torch.int32)
