"""Launch of the hand-written CUDA MEMO probes (csrc/memo_probe.cu)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGS = {
    "repro_memo_seq_load": [_P, _I64, _I, _I, _P, _P],
    "repro_memo_seq_store": [_P, _I64, _I, _P, _P],
    "repro_memo_random_block_load": [_P, _I64, _P, _I64, _I, _I64, _I, _P,
                                     _P],
    "repro_memo_pointer_chase": [_P, _I, _I64, _P, _P],
}
#: lanes a launch may have (one block each)
MAX_LANES = (1 << 31) - 1

_fns: dict = {}


def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(common.load("memo_probe"), name)
        fn.argtypes = _ARGS[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _table(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32 or not x.is_contiguous() or x.numel() < 1:
        raise ValueError(f"want a non-empty contiguous float32 table; got "
                         f"{x.dtype} {tuple(x.shape)}")
    return x


def _lanes(x: torch.Tensor, lanes: int) -> int:
    if not 1 <= lanes <= MAX_LANES or x.numel() % lanes:
        raise ValueError(f"{x.numel()} elements do not split into {lanes} "
                         "lanes")
    return x.numel() // lanes


def seq_load(x: torch.Tensor, lanes: int, device: torch.device
             ) -> torch.Tensor:
    """(lanes,) fp32 sums of ``x``'s slices (HBM or pinned host memory)."""
    per_lane = _lanes(_table(x), lanes)
    out = torch.empty(lanes, dtype=torch.float32, device=device)
    err = _fn("repro_memo_seq_load")(
        x.data_ptr(), per_lane, lanes, int(not x.is_cuda), out.data_ptr(),
        common.stream_handle(device))
    common.check(err, "memo seq_load launch")
    return out


def seq_store(x: torch.Tensor, lanes: int, v: torch.Tensor,
              device: torch.device) -> torch.Tensor:
    """``x``'s slices set to ``v`` (a (lanes,) fp32 CUDA tensor), in place."""
    per_lane = _lanes(_table(x), lanes)
    if v.shape != (lanes,) or v.dtype != torch.float32 or not v.is_cuda:
        raise ValueError(f"want v a ({lanes},) float32 CUDA tensor; got "
                         f"{v.dtype} {tuple(v.shape)} on {v.device}")
    err = _fn("repro_memo_seq_store")(
        x.data_ptr(), per_lane, lanes, v.contiguous().data_ptr(),
        common.stream_handle(device))
    common.check(err, "memo seq_store launch")
    return x


def random_block_load(x: torch.Tensor, starts: torch.Tensor,
                      block_elems: int, device: torch.device) -> torch.Tensor:
    """Block sums over ``x`` from int32 ``starts`` (n,) or (lanes, n), in
    HBM or pinned host memory: a 0-dim or a (lanes,) fp32 tensor."""
    _table(x)
    if starts.dtype != torch.int32 or starts.ndim not in (1, 2) \
            or starts.numel() < 1 or not starts.is_contiguous():
        raise ValueError(f"want contiguous int32 starts (n,) or (lanes, n); "
                         f"got {starts.dtype} {tuple(starts.shape)}")
    if not 1 <= block_elems <= x.numel():
        raise ValueError(f"block of {block_elems} elements in a table of "
                         f"{x.numel()}")
    lanes = 1 if starts.ndim == 1 else starts.shape[0]
    out = torch.empty(lanes, dtype=torch.float32, device=device)
    err = _fn("repro_memo_random_block_load")(
        x.data_ptr(), x.numel(), starts.data_ptr(), starts.shape[-1], lanes,
        block_elems, int(not x.is_cuda), out.data_ptr(),
        common.stream_handle(device))
    common.check(err, "memo random_block_load launch")
    return out[0] if starts.ndim == 1 else out


def pointer_chase(perm: torch.Tensor, steps: int, start: int,
                  device: torch.device) -> torch.Tensor:
    """The last index of ``steps`` dependent hops from ``start`` through
    the int32 permutation ``perm`` (HBM or pinned host memory): a 0-dim
    int32 CUDA tensor."""
    if perm.dtype != torch.int32 or perm.ndim != 1 or perm.numel() < 1 \
            or not perm.is_contiguous():
        raise ValueError(f"want a contiguous (n,) int32 permutation; got "
                         f"{perm.dtype} {tuple(perm.shape)}")
    if steps < 0 or not 0 <= start < perm.numel():
        raise ValueError(f"want steps >= 0 and a start in the table; got "
                         f"{steps}, {start}")
    out = torch.empty((), dtype=torch.int32, device=device)
    err = _fn("repro_memo_pointer_chase")(
        perm.data_ptr(), int(start), int(steps), out.data_ptr(),
        common.stream_handle(device))
    common.check(err, "memo pointer_chase launch")
    return out
