"""Launch of the hand-written CUDA streaming copy (csrc/stream_copy.cu)."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.device import host_to_device
from repro_torch.kernels import common

_argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_seg_argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                 ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]

#: columns of a segment list (``ops.stream_copy_segments``): source base,
#: element offset into it, source row stride, destination base, offset,
#: destination row stride, rows, cols (offsets and strides in elements of
#: each side's dtype)
SRC, SRC_OFF, SRC_STRIDE, DST, DST_OFF, DST_STRIDE, ROWS, COLS = range(8)
#: flags of a launch-table row: rows 16-byte aligned on both sides, source
#: in host memory, destination in host memory
VEC, SRC_HOST, DST_HOST = 1, 2, 4


def _lib():
    lib = common.load("stream_copy")
    fn = lib.repro_stream_copy
    fn.argtypes = _argtypes
    fn.restype = ctypes.c_int
    return fn


def _seg_lib():
    lib = common.load("stream_copy")
    fn = lib.repro_stream_copy_segments
    fn.argtypes = _seg_argtypes
    fn.restype = ctypes.c_int
    return fn


def row_strided(t: torch.Tensor) -> bool:
    """A 2-D tensor whose rows are contiguous (any row stride)."""
    return t.ndim == 2 and (t.stride(1) == 1 or t.shape[1] <= 1)


def slab_args(src: torch.Tensor, out: torch.Tensor) -> tuple:
    """``repro_stream_copy``'s arguments between the two pointers and the
    stream: rows, cols, row strides, dtype codes, itemsize, vec."""
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
    return rows, cols, ss, ds, s_code, d_code, item, vec


def stream_copy(src: torch.Tensor, out: torch.Tensor,
                device: torch.device) -> torch.Tensor:
    """Copy ``src`` into ``out`` (same shape, any of HBM or pinned host
    memory on either side) with the cast to ``out.dtype`` fused in,
    launched on ``device``'s current stream: one segment of the
    segment-list kernel.  Both contiguous (one row of ``numel``
    elements), or both 2-D with contiguous rows (each with its own row
    stride)."""
    args = slab_args(src, out)
    err = _lib()(src.data_ptr(), out.data_ptr(), *args,
                 common.stream_handle(device))
    common.check(err, "stream_copy launch")
    return out


def _bases(tensors, what: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(addresses, element counts, host flags) of a side's base tensors,
    which must be contiguous and of one dtype."""
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"stream_copy_segments: {what} bases must be "
                         "contiguous")
    if len({t.dtype for t in tensors}) > 1:
        raise ValueError(f"stream_copy_segments: one {what} dtype a launch")
    return (np.fromiter((t.data_ptr() for t in tensors), np.int64,
                        len(tensors)),
            np.fromiter((t.numel() for t in tensors), np.int64, len(tensors)),
            np.fromiter((not t.is_cuda for t in tensors), bool, len(tensors)))


#: lists of at most this many segments take the per-row table path: a
#: mover batch (16 runs) or a small move's landing, where a loop over
#: Python integers costs less than the vectorised path's fixed numpy
#: calls (about even at 50 segments)
SMALL_TABLE = 48


def launch_table(srcs, dsts, segs: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray, int, int]:
    """The kernel's view of a segment list: its table (one row of 8 int64
    per segment: source and destination addresses, rows, cols, row
    strides, flags; for equal dtypes in bytes), the prefix sum of its
    16-byte source units, and the launch's dtype codes.  Raises on a
    segment that reaches outside its bases."""
    segs = np.asarray(segs, np.int64).reshape(-1, 8)
    if len(segs) <= SMALL_TABLE:
        return _small_table(srcs, dsts, segs)
    s_item, d_item = srcs[0].element_size(), dsts[0].element_size()
    s_ptr, s_numel, s_host = _bases(srcs, "source")
    d_ptr, d_numel, d_host = _bases(dsts, "destination")
    si, di = segs[:, SRC], segs[:, DST]
    rows, cols = segs[:, ROWS], segs[:, COLS]
    live = (rows > 0) & (cols > 0)
    last_s = segs[:, SRC_OFF] + (rows - 1) * segs[:, SRC_STRIDE] + cols
    last_d = segs[:, DST_OFF] + (rows - 1) * segs[:, DST_STRIDE] + cols
    bad = live & ((si < 0) | (si >= len(srcs)) | (di < 0) | (di >= len(dsts)))
    if bad.any():
        raise ValueError("stream_copy_segments: base index out of range")
    si, di = np.where(live, si, 0), np.where(live, di, 0)
    if (live & ((segs[:, SRC_OFF] < 0) | (segs[:, DST_OFF] < 0)
                | (segs[:, SRC_STRIDE] < 0)
                | ((rows > 1) & (segs[:, DST_STRIDE] < cols))
                | (last_s > s_numel[si]) | (last_d > d_numel[di]))).any():
        raise ValueError("stream_copy_segments: a segment reaches outside "
                         "its bases")
    if srcs[0].dtype == dsts[0].dtype:
        s_code = d_code = 0
        scale, vec_elems = s_item, 16  # bytes
    else:
        s_code = common.dtype_code(srcs[0].dtype)
        d_code = common.dtype_code(dsts[0].dtype)
        scale, vec_elems = 1, 16 // s_item
    table = np.zeros((len(segs), 8), np.int64)
    table[:, 0] = s_ptr[si] + segs[:, SRC_OFF] * s_item
    table[:, 1] = d_ptr[di] + segs[:, DST_OFF] * d_item
    table[:, 2] = np.where(live, rows, 0)
    table[:, 3] = np.where(live, cols * scale, 0)
    table[:, 4] = segs[:, SRC_STRIDE] * scale
    table[:, 5] = segs[:, DST_STRIDE] * scale
    # every row starts on a 16-byte boundary on both sides (the strides
    # of a one-row segment do not matter)
    many = rows > 1
    aligned = ((table[:, 0] | table[:, 1]
                | np.where(many, segs[:, SRC_STRIDE] * s_item, 0)
                | np.where(many, segs[:, DST_STRIDE] * d_item, 0)) % 16) == 0
    table[:, 6] = (aligned * VEC + s_host[si] * SRC_HOST
                   + d_host[di] * DST_HOST)
    units = table[:, 2] * ((table[:, 3] + vec_elems - 1) // vec_elems)
    prefix = np.zeros(len(segs) + 1, np.int64)
    np.cumsum(units, out=prefix[1:])
    return table, prefix, s_code, d_code


def _dtype_codes(srcs, dsts) -> tuple[int, int, int, int]:
    """(source code, destination code, table scale, units' elements): for
    equal dtypes the table counts bytes."""
    s_item = srcs[0].element_size()
    if srcs[0].dtype == dsts[0].dtype:
        return 0, 0, s_item, 16
    return (common.dtype_code(srcs[0].dtype),
            common.dtype_code(dsts[0].dtype), 1, 16 // s_item)


def _small_table(srcs, dsts, segs: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray, int, int]:
    """:func:`launch_table` row by row, on Python integers (the same table
    and the same refusals: a base out of range before a segment past its
    bases)."""
    s_item, d_item = srcs[0].element_size(), dsts[0].element_size()
    s_ptr, s_numel, s_host = (x.tolist() for x in _bases(srcs, "source"))
    d_ptr, d_numel, d_host = (x.tolist() for x in _bases(dsts, "destination"))
    n_src, n_dst = len(srcs), len(dsts)
    s_code, d_code, scale, vec_elems = _dtype_codes(srcs, dsts)
    table, prefix = [], [0]
    bad_base = outside = False
    units = 0
    for si, so, ss, di, do, ds, rows, cols in segs.tolist():
        if rows > 0 and cols > 0:
            if not (0 <= si < n_src and 0 <= di < n_dst):
                bad_base = True
                continue
            if (so < 0 or do < 0 or ss < 0 or (rows > 1 and ds < cols)
                    or so + (rows - 1) * ss + cols > s_numel[si]
                    or do + (rows - 1) * ds + cols > d_numel[di]):
                outside = True
            n_rows, n_cols = rows, cols * scale
            units += n_rows * (-(-n_cols // vec_elems))
        else:
            si = di = n_rows = n_cols = 0
        a_src, a_dst = s_ptr[si] + so * s_item, d_ptr[di] + do * d_item
        # every row starts on a 16-byte boundary on both sides
        tail = (ss * s_item | ds * d_item) if rows > 1 else 0
        table += (a_src, a_dst, n_rows, n_cols, ss * scale, ds * scale,
                  ((a_src | a_dst | tail) % 16 == 0) * VEC
                  + s_host[si] * SRC_HOST + d_host[di] * DST_HOST, 0)
        prefix.append(units)
    if bad_base:
        raise ValueError("stream_copy_segments: base index out of range")
    if outside:
        raise ValueError("stream_copy_segments: a segment reaches outside "
                         "its bases")
    return (np.array(table, np.int64).reshape(-1, 8),
            np.array(prefix, np.int64), s_code, d_code)


def stream_copy_segments(srcs, dsts, segs: np.ndarray,
                         device: torch.device) -> int:
    """One launch that moves every segment of ``segs`` (see
    :func:`launch_table`) on ``device``'s current stream.  Returns the
    units moved (0: nothing was launched)."""
    table, prefix, s_code, d_code = launch_table(srcs, dsts, segs)
    total = int(prefix[-1])
    if total == 0:
        return 0
    # the table reaches the card in one copy, without a host wait
    buf = host_to_device(np.concatenate([table.reshape(-1), prefix]),
                         torch.int64, device)
    ptr = buf.data_ptr()
    err = _seg_lib()(ptr, ptr + table.size * 8, len(table), total, s_code,
                     d_code, common.stream_handle(device))
    common.check(err, "stream_copy_segments launch")
    return total


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
