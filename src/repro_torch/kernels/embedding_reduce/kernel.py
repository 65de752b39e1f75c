"""Launch of the hand-written CUDA embedding-bag kernel (csrc/embedding_reduce.cu)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

_argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

#: rows an int32 index addresses
MAX_ROWS = 1 << 31


def _lib():
    lib = common.load("embedding_reduce")
    fn = lib.repro_embedding_reduce
    fn.argtypes = _argtypes
    fn.restype = ctypes.c_int
    return fn


def embedding_reduce(table: torch.Tensor, indices: torch.Tensor,
                     weights: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Launch on ``device``'s current stream.  ``table`` lies in HBM or in
    pinned host memory and has at most 2^31 rows; ``indices`` (read as
    int32, as the TPU kernel reads them) and ``weights`` (table dtype) are
    CUDA tensors of shape (B, K)."""
    if table.ndim != 2 or indices.ndim != 2 or weights.shape != indices.shape:
        raise ValueError(f"want table (V, D) and indices/weights (B, K); got "
                         f"{tuple(table.shape)}, {tuple(indices.shape)}, "
                         f"{tuple(weights.shape)}")
    if not (indices.is_cuda and weights.is_cuda):
        raise ValueError("indices and weights must be CUDA tensors")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    if table.shape[0] > MAX_ROWS:
        raise ValueError(f"table has {table.shape[0]} rows; int32 indices "
                         f"address {MAX_ROWS}")
    code = common.dtype_code(table.dtype)
    indices = indices.to(torch.int32).contiguous()
    weights = weights.to(table.dtype).contiguous()
    V, D = table.shape
    B, K = indices.shape
    out = torch.empty((B, D), dtype=table.dtype, device=device)
    per_vec = 16 // table.element_size()
    vec = int(D % per_vec == 0 and table.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    err = _lib()(table.data_ptr(), indices.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), V, D, B, K, code, per_vec if vec else 1,
                 common.stream_handle(device))
    common.check(err, "embedding_reduce launch")
    return out
