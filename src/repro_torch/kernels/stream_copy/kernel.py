"""Launch of the hand-written CUDA streaming copy (csrc/stream_copy.cu)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

_argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = common.load("stream_copy")
    fn = lib.repro_stream_copy
    fn.argtypes = _argtypes
    fn.restype = ctypes.c_int
    return fn


def row_strided(t: torch.Tensor) -> bool:
    """A 2-D tensor whose rows are contiguous (any row stride)."""
    return t.ndim == 2 and (t.stride(1) == 1 or t.shape[1] <= 1)


def stream_copy(src: torch.Tensor, out: torch.Tensor,
                device: torch.device) -> torch.Tensor:
    """Copy ``src`` into ``out`` (same shape, any of HBM or pinned host
    memory on either side) with the cast to ``out.dtype`` fused in,
    launched on ``device``'s current stream.  Both contiguous (one row of
    ``numel`` elements), or both 2-D with contiguous rows (each with its
    own row stride)."""
    if src.shape != out.shape:
        raise ValueError(f"shape mismatch {tuple(src.shape)} -> {tuple(out.shape)}")
    if src.is_contiguous() and out.is_contiguous():
        rows, cols = 1, src.numel()
        ss = ds = cols
    elif row_strided(src) and row_strided(out):
        (rows, cols), ss, ds = src.shape, src.stride(0), out.stride(0)
    else:
        raise ValueError("stream_copy needs contiguous tensors or 2-D "
                         "tensors with contiguous rows")
    if src.dtype == out.dtype:
        s_code = d_code = 0
    else:
        s_code, d_code = common.dtype_code(src.dtype), common.dtype_code(out.dtype)
    item = src.element_size()
    # every row starts on a 16-byte boundary on both sides
    vec = int(all(x % 16 == 0 for x in (src.data_ptr(), out.data_ptr(),
                                         ss * item, ds * out.element_size())))
    err = _lib()(src.data_ptr(), out.data_ptr(), rows, cols, ss, ds, s_code,
                 d_code, item, vec, common.stream_handle(device))
    common.check(err, "stream_copy launch")
    return out


def pointer_info(t: torch.Tensor) -> tuple[int, int]:
    """(cudaMemoryType, device pointer) of ``t``'s storage, as the CUDA
    runtime reports them: a pinned host tensor that the kernels can read
    in place has type 1 (host) and a device pointer equal to its own."""
    lib = common.load("stream_copy")
    fn = lib.repro_pointer_info
    fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_void_p)]
    fn.restype = ctypes.c_int
    kind = ctypes.c_int(0)
    dev_ptr = ctypes.c_void_p(0)
    common.check(fn(t.data_ptr(), ctypes.byref(kind), ctypes.byref(dev_ptr)),
                 "cudaPointerGetAttributes")
    return kind.value, dev_ptr.value or 0
