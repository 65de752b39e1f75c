"""Launch of the hand-written CUDA embedding-bag kernel (csrc/embedding_reduce.cu):
the table form and the routed form over an ``InterleavedTensor``'s shards."""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.kernels import common

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_TABLE_ARGS = [_P, _I64, _INT, _P, _INT, _P, _INT, _P, _I64, _I64, _I64, _INT,
               _INT, _P]
_ROUTED_ARGS = [ctypes.POINTER(_P), ctypes.POINTER(_I64), ctypes.POINTER(_INT),
                _INT, _P, _P, _I64, _I64, _P, _INT, _P, _INT, _P, _I64, _I64,
                _I64, _INT, _INT, _P]

#: rows a shard may have: the kernel stages local rows as int32
MAX_ROWS = 1 << 31
#: shards one routed launch reduces (the fast tier and three CXL devices)
MAX_SHARDS = 4


_fns: dict = {}


def _fn(name: str, argtypes):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(common.load("embedding_reduce"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _indices(indices: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(B, K) indices as the kernel reads them: int32 or int64 as given."""
    if indices.dtype not in (torch.int32, torch.int64):
        indices = indices.to(torch.int64)
    return indices.contiguous(), int(indices.dtype == torch.int64)


def _weights(weights: Optional[torch.Tensor],
             dtype: torch.dtype) -> tuple[Optional[torch.Tensor], int]:
    """Weights as the kernel reads them: fp32 (0), bf16 (1) or none (-1,
    all ones); the kernel rounds each to the table dtype."""
    if weights is None:
        return None, -1
    if weights.dtype not in common.DTYPE_CODES:
        weights = weights.to(dtype)
    return weights.contiguous(), common.dtype_code(weights.dtype)


def _vec(out: torch.Tensor, tensors) -> int:
    """Elements per 16-byte load, or 1 (scalar path) when D or a pointer
    is not 16-byte aligned."""
    per_vec = 16 // out.element_size()
    ok = (out.shape[1] % per_vec == 0
          and all(t.data_ptr() % 16 == 0 for t in (out, *tensors)))
    return per_vec if ok else 1


def _check_table(t: torch.Tensor, what: str) -> None:
    if t.ndim != 2 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous (rows, D) tensor; got "
                         f"{tuple(t.shape)}")
    if t.shape[0] > MAX_ROWS:
        raise ValueError(f"{what} has {t.shape[0]} rows; the kernel stages "
                         f"{MAX_ROWS} at most")


def _check_bags(indices: torch.Tensor, weights: Optional[torch.Tensor]) -> None:
    if indices.ndim != 2 or (weights is not None
                             and weights.shape != indices.shape):
        raise ValueError(f"want indices/weights (B, K); got "
                         f"{tuple(indices.shape)}, "
                         f"{None if weights is None else tuple(weights.shape)}")
    if not indices.is_cuda or (weights is not None and not weights.is_cuda):
        raise ValueError("indices and weights must be CUDA tensors")


def embedding_reduce(table: torch.Tensor, indices: torch.Tensor,
                     weights: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The table form, on ``device``'s current stream.  ``table`` lies in
    HBM or in pinned host memory; ``indices`` (int32 or int64, read as
    given) and ``weights`` are CUDA tensors of shape (B, K)."""
    _check_table(table, "table")
    _check_bags(indices, weights)
    code = common.dtype_code(table.dtype)
    indices, idx64 = _indices(indices)
    weights, wcode = _weights(weights, table.dtype)
    V, D = table.shape
    B, K = indices.shape
    out = torch.empty((B, D), dtype=table.dtype, device=device)
    err = _fn("repro_embedding_reduce", _TABLE_ARGS)(
        table.data_ptr(), V, int(not table.is_cuda), indices.data_ptr(), idx64,
        weights.data_ptr(), wcode, out.data_ptr(), D, B, K, code,
        _vec(out, (table,)), common.stream_handle(device))
    common.check(err, "embedding_reduce launch")
    return out


def bag_reduce_routed(parts: Sequence[torch.Tensor], page_device: torch.Tensor,
                      page_local: torch.Tensor, page_rows: int,
                      indices: torch.Tensor, weights: Optional[torch.Tensor],
                      device: torch.device) -> torch.Tensor:
    """The routed form, one launch on ``device``'s current stream.
    ``parts``: 1 to 4 shards (rows, D) of one dtype, each in HBM or pinned
    host memory; ``page_device`` (int8) and ``page_local`` (int64): the
    page maps on the card; ``indices``: (B, K) global rows, int32 or
    int64; ``weights``: (B, K) or None (all ones)."""
    n = len(parts)
    dtype, D = parts[0].dtype, parts[0].shape[-1]
    for i, p in enumerate(parts):
        _check_table(p, f"shard {i}")
        if p.dtype != dtype or p.shape[1] != D:
            raise ValueError(f"shard {i} is {p.dtype} {tuple(p.shape)}; "
                             f"shard 0 is {dtype} (rows, {D})")
    if (page_device.dtype != torch.int8 or page_local.dtype != torch.int64
            or page_device.shape != page_local.shape or page_device.ndim != 1
            or page_device.numel() < 1 or page_rows < 1
            or not (page_device.is_cuda and page_local.is_cuda)):
        raise ValueError("want CUDA page maps (n_pages,) int8 and int64, "
                         "n_pages >= 1, page_rows >= 1")
    _check_bags(indices, weights)
    code = common.dtype_code(dtype)
    indices, idx64 = _indices(indices)
    weights, wcode = _weights(weights, dtype)
    page_device, page_local = page_device.contiguous(), page_local.contiguous()
    B, K = indices.shape
    out = torch.empty((B, D), dtype=dtype, device=device)
    filled = [p for p in parts if p.shape[0] > 0]
    err = _fn("repro_bag_reduce_routed", _ROUTED_ARGS)(
        (_P * n)(*[p.data_ptr() for p in parts]),
        (_I64 * n)(*[p.shape[0] for p in parts]),
        (_INT * n)(*[int(not p.is_cuda) for p in parts]), n,
        page_device.data_ptr(), page_local.data_ptr(), int(page_rows),
        page_device.numel(), indices.data_ptr(), idx64,
        0 if weights is None else weights.data_ptr(), wcode, out.data_ptr(),
        D, B, K, code, _vec(out, filled),
        common.stream_handle(device))
    common.check(err, "bag_reduce_routed launch")
    return out
