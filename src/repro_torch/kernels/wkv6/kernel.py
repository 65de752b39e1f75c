"""Launch of the hand-written CUDA WKV6 recurrence (csrc/wkv6.cu)."""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import common

#: head dims the kernel is built for
HEAD_DIMS = (16, 32, 64)

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGS = [_P, _P, _P, _I, _I64, _I64, _I64, _P, _I, _I64, _I64, _I64, _P, _P,
         _P, _P, _I, _I, _I, _I, _P]


def _fn():
    fn = common.load("wkv6").repro_wkv6
    fn.argtypes = _ARGS
    fn.restype = ctypes.c_int
    return fn


def blocks_per_sm(rkv_dtype: torch.dtype, w_dtype: torch.dtype,
                  hd: int) -> int:
    """Blocks of the kernel (one per (batch, head)) that one SM holds at
    once, as the CUDA occupancy calculator gives it (needs the card)."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported (want one of {HEAD_DIMS})")
    fn = common.load("wkv6").repro_wkv6_blocks_per_sm
    fn.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
    fn.restype = ctypes.c_int
    out = _I(0)
    common.check(fn(common.dtype_code(rkv_dtype), common.dtype_code(w_dtype),
                    hd, ctypes.byref(out)), "wkv6 occupancy")
    return out.value


def check(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
          u: torch.Tensor, state: torch.Tensor,
          state_out: Optional[torch.Tensor]) -> None:
    """Refuse, before any build or launch, what the kernel does not take."""
    if r.ndim != 4 or k.shape != r.shape or v.shape != r.shape \
            or w.shape != r.shape:
        raise ValueError(f"want r, k, v, w (B,T,H,hd) of one shape; got "
                         f"{[tuple(a.shape) for a in (r, k, v, w)]}")
    B, T, H, hd = r.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported (want one of {HEAD_DIMS})")
    if B < 1 or T < 1 or H < 1:
        raise ValueError(f"empty input {tuple(r.shape)}")
    if u.shape != (H, hd):
        raise ValueError(f"u {tuple(u.shape)} != {(H, hd)}")
    for name, s in (("state", state), ("state_out", state_out)):
        if s is None:
            continue
        if s.shape != (B, H, hd, hd) or s.dtype != torch.float32 \
                or not s.is_contiguous():
            raise ValueError(f"{name} must be contiguous fp32 {(B, H, hd, hd)};"
                             f" got {tuple(s.shape)} {s.dtype}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError("r, k and v must share a dtype")
    if k.stride() != r.stride() or v.stride() != r.stride():
        raise ValueError("r, k and v must share strides")
    if r.stride(3) != 1 or w.stride(3) != 1:
        raise ValueError("r, k, v and w need a contiguous last dim")
    common.dtype_code(r.dtype)
    common.dtype_code(w.dtype)


def wkv6(r, k, v, w, u, state, state_out, device: torch.device):
    """The recurrence on ``device``'s current stream.  Returns (y fp32
    (B,T,H,hd), the final state), the latter in ``state_out`` (which may
    be ``state``) or in a new tensor."""
    check(r, k, v, w, u, state, state_out)
    B, T, H, hd = r.shape
    u = u.to(device=device, dtype=torch.float32).contiguous()
    if state_out is None:
        state_out = torch.empty_like(state)
    y = torch.empty((B, T, H, hd), dtype=torch.float32, device=device)
    err = _fn()(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), common.dtype_code(r.dtype),
        r.stride(0), r.stride(1), r.stride(2), w.data_ptr(),
        common.dtype_code(w.dtype), w.stride(0), w.stride(1), w.stride(2),
        u.data_ptr(), state.data_ptr(), state_out.data_ptr(), y.data_ptr(),
        B, T, H, hd, common.stream_handle(device))
    common.check(err, "wkv6 launch")
    return y, state_out
