"""Launch of the hand-written CUDA streaming copy (csrc/stream_copy.cu)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common

_argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = common.load("stream_copy")
    fn = lib.repro_stream_copy
    fn.argtypes = _argtypes
    fn.restype = ctypes.c_int
    return fn


def stream_copy(src: torch.Tensor, out: torch.Tensor,
                device: torch.device) -> torch.Tensor:
    """Copy ``src`` into ``out`` (same shape, any of HBM or pinned host
    memory on either side) with the cast to ``out.dtype`` fused in,
    launched on ``device``'s current stream."""
    if src.shape != out.shape:
        raise ValueError(f"shape mismatch {tuple(src.shape)} -> {tuple(out.shape)}")
    if not (src.is_contiguous() and out.is_contiguous()):
        raise ValueError("stream_copy needs contiguous tensors")
    if src.dtype == out.dtype:
        s_code = d_code = 0
    else:
        s_code, d_code = common.dtype_code(src.dtype), common.dtype_code(out.dtype)
    vec = int(src.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    err = _lib()(src.data_ptr(), out.data_ptr(), src.numel(), s_code, d_code,
                 src.element_size(), vec, common.stream_handle(device))
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
