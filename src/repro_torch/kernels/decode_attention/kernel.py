"""Launch of the hand-written CUDA flash decode (csrc/decode_attention.cu)."""
from __future__ import annotations

import ctypes
import math
import torch

from repro_torch.kernels import common

#: head dims the kernel is built for
HEAD_DIMS = (16, 32, 64, 128)
#: query heads per KV head the kernel is built for
MAX_GROUP = 16
#: SMs of an H100, for the split of T across blocks
_SMS = 132

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGS = {
    "repro_decode_attention_partial": [_P, _P, _P, _I, _I64, _I64, _I64, _P,
                                       _I64, _I, _I, _I, _I, _I, _I, _P, _P,
                                       _P, _P, _P, _P, _P],
    "repro_decode_attention": [_P, _P, _P, _I, _I64, _I64, _I64, _P, _I, _I,
                               _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "repro_kv_append": [_P, _P, _I, _P, _P, _I, _P, _I, _I, _I64, _I64, _I64,
                        _P],
}


def _fn(name: str):
    fn = getattr(common.load("decode_attention"), name)
    fn.argtypes = _ARGS[name]
    fn.restype = ctypes.c_int
    return fn


def splits_for(batch: int, kv_heads: int, positions: int) -> int:
    """Pieces of T per (sequence, KV head): about four blocks per SM, and
    no piece shorter than 128 positions (four tiles)."""
    want = math.ceil(4 * _SMS / max(batch * kv_heads, 1))
    return max(1, min(want, math.ceil(positions / 128)))


def _check_kv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B,H,hd) and k, v (B,T,K,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported (want one of {HEAD_DIMS})")
    if H // k.shape[2] > MAX_GROUP:
        raise ValueError(f"{H // k.shape[2]} query heads per KV head; the "
                         f"kernel takes at most {MAX_GROUP}")
    if k.stride() != v.stride() or k.dtype != v.dtype:
        raise ValueError("k and v must share dtype and strides")
    if k.stride(3) != 1:
        raise ValueError("k and v need a contiguous last dim")
    item = k.element_size()
    if any((s * item) % 16 for s in k.stride()[:3]) or (
            k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError("k and v rows must be 16-byte aligned")
    common.dtype_code(k.dtype)


def _scratch(B: int, K: int, splits: int, G: int, hd: int,
             device: torch.device):
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((B, K, splits, G, hd), **f32),
            torch.empty((B, K, splits, G), **f32),
            torch.empty((B, K, splits, G), **f32))


def attend_partial(q, k, v, valid, device: torch.device):
    """Partial form on ``device``'s current stream: ``q`` (B,H,hd) and
    ``valid`` (B,T) on the card, ``k``/``v`` (B,T,K,hd) in HBM or pinned
    host memory.  Returns fp32 (acc (B,H,hd), m (B,H), l (B,H))."""
    _check_kv(q, k, v)
    B, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if valid.shape != (B, T):
        raise ValueError(f"valid {tuple(valid.shape)} != {(B, T)}")
    q = q.to(device=device, dtype=torch.float32).contiguous()
    valid = valid.to(device=device, dtype=torch.bool)
    if valid.stride(1) != 1:
        valid = valid.contiguous()
    splits = splits_for(B, K, T)
    acc, m, l = _scratch(B, K, splits, G, hd, device)
    if splits == 1:
        out = (acc.view(B, H, hd), m.view(B, H), l.view(B, H))
    else:
        out = (torch.empty((B, H, hd), dtype=torch.float32, device=device),
               torch.empty((B, H), dtype=torch.float32, device=device),
               torch.empty((B, H), dtype=torch.float32, device=device))
    err = _fn("repro_decode_attention_partial")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), common.dtype_code(k.dtype),
        k.stride(0), k.stride(1), k.stride(2), valid.data_ptr(),
        valid.stride(0), B, T, K, G, hd, splits, acc.data_ptr(),
        m.data_ptr(), l.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), common.stream_handle(device))
    common.check(err, "decode_attention (partial) launch")
    return out


def decode_attention(q, k, v, lengths, device: torch.device) -> torch.Tensor:
    """Normalised form on ``device``'s current stream; (B,H,hd) fp32."""
    _check_kv(q, k, v)
    B, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if lengths.shape != (B,):
        raise ValueError(f"lengths {tuple(lengths.shape)} != {(B,)}")
    q = q.to(device=device, dtype=torch.float32).contiguous()
    lengths = lengths.to(device=device, dtype=torch.int32).contiguous()
    splits = splits_for(B, K, T)
    acc, m, l = _scratch(B, K, splits, G, hd, device)
    out = torch.empty((B, H, hd), dtype=torch.float32, device=device)
    err = _fn("repro_decode_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), common.dtype_code(k.dtype),
        k.stride(0), k.stride(1), k.stride(2), lengths.data_ptr(), B, T, K, G,
        hd, splits, acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        out.data_ptr(), common.stream_handle(device))
    common.check(err, "decode_attention launch")
    return out


def kv_append(k_pool: torch.Tensor, v_pool: torch.Tensor, rows: torch.Tensor,
              k_new: torch.Tensor, v_new: torch.Tensor,
              device: torch.device) -> None:
    """Write ``k_new``/``v_new`` (B,K,hd) at row ``rows[b]`` of sequence b
    of one pool layer ``k_pool``/``v_pool`` (B,T,K,hd), HBM or pinned;
    rows outside [0, T) are dropped."""
    B, T = k_pool.shape[:2]
    row_elems = k_pool.shape[2] * k_pool.shape[3]
    if k_pool.stride() != v_pool.stride() or k_pool.dtype != v_pool.dtype:
        raise ValueError("k and v pools must share dtype and strides")
    if k_pool.stride(3) != 1 or k_pool.stride(2) != k_pool.shape[3]:
        raise ValueError("pool rows must be contiguous")
    if k_new.shape != (B,) + tuple(k_pool.shape[2:]) or v_new.shape != k_new.shape:
        raise ValueError(f"new rows {tuple(k_new.shape)} do not fit "
                         f"{tuple(k_pool.shape)}")
    k_new = k_new.to(device).contiguous()
    v_new = v_new.to(device=device, dtype=k_new.dtype).contiguous()
    rows = rows.to(device=device, dtype=torch.int64).contiguous()
    err = _fn("repro_kv_append")(
        k_new.data_ptr(), v_new.data_ptr(), common.dtype_code(k_new.dtype),
        k_pool.data_ptr(), v_pool.data_ptr(), common.dtype_code(k_pool.dtype),
        rows.data_ptr(), B, T, row_elems, k_pool.stride(0), k_pool.stride(1),
        common.stream_handle(device))
    common.check(err, "kv_append launch")
