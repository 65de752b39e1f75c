"""Launch of the hand-written CUDA embedding-bag kernel (csrc/embedding_reduce.cu):
the table form and the routed form over an ``InterleavedTensor``'s shards,
with the routed form's staged path for calls with a pinned shard and at
least ``STAGE_MIN_LOOKUPS`` lookups."""
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
_STAGED_ARGS = _ROUTED_ARGS[:-2] + [_P, _I64, _INT, _P]

#: rows a shard may have: the kernel stages local rows as int32
MAX_ROWS = 1 << 31
#: shards one routed launch reduces (the fast tier and three CXL devices)
MAX_SHARDS = 4
#: lookups (B x K) from which a routed call with a pinned shard takes the
#: staged path.  On an H100 it took 0.51x (28.8 GiB pinned shard) and 0.46x
#: (8 GiB) the one-launch kernel's device time on uniform batches of
#: 655,360 lookups, 90% of them pinned (tools/embedding_reduce_probe.py
#: --pinned-order); at 163,840, the DLRM walk's batch, the walk's calls
#: leave the card mostly idle and 5 more launches a call cost it 15-44% of
#: its bags/s at slow fractions 0-0.10 (chip_smoke.py phase 4).
STAGE_MIN_LOOKUPS = 1 << 18
#: the staged path reads pinned rows in order of regions of this many
#: bytes (log2)
REGION_LOG2 = 21
#: kernels a staged call launches: clear, plan, scan, scatter, gather, reduce
STAGED_KERNELS = 6


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


def stages(host: Sequence[bool], lookups: int, vec: int) -> bool:
    """Whether a routed call takes the staged path: a pinned shard with
    rows (``host``: one flag a shard with rows), at least
    ``STAGE_MIN_LOOKUPS`` lookups, and 16-byte rows and pointers (``vec`` >
    1).  Every other call launches the one routed kernel."""
    return (any(host) and STAGE_MIN_LOOKUPS <= lookups < MAX_ROWS
            and vec > 1)


def staged_bytes(parts: Sequence[torch.Tensor], lookups: int,
                 row_bytes: int) -> int:
    """The staged path's workspace (csrc ``staged_bytes``): a counter a
    region of the pinned shards, then a key, a source address and a slot
    a lookup, then a row of staging a lookup."""
    regions = sum(-(-p.shape[0] * row_bytes >> REGION_LOG2) for p in parts
                  if not p.is_cuda and p.shape[0] > 0)
    return (_align16(4 * (regions + 1)) + 16 * lookups
            + _align16(4 * lookups) + lookups * row_bytes)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def bag_reduce_routed(parts: Sequence[torch.Tensor], page_device: torch.Tensor,
                      page_local: torch.Tensor, page_rows: int,
                      indices: torch.Tensor, weights: Optional[torch.Tensor],
                      device: torch.device) -> tuple[torch.Tensor, int]:
    """The routed form on ``device``'s current stream: (sums, kernels
    launched).  ``parts``: 1 to 4 shards (rows, D) of one dtype, each in
    HBM or pinned host memory; ``page_device`` (int8) and ``page_local``
    (int64): the page maps on the card; ``indices``: (B, K) global rows,
    int32 or int64; ``weights``: (B, K) or None (all ones).  One launch,
    or ``STAGED_KERNELS`` where :func:`stages`."""
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
    vec = _vec(out, filled)
    args = ((_P * n)(*[p.data_ptr() for p in parts]),
            (_I64 * n)(*[p.shape[0] for p in parts]),
            (_INT * n)(*[int(not p.is_cuda) for p in parts]), n,
            page_device.data_ptr(), page_local.data_ptr(), int(page_rows),
            page_device.numel(), indices.data_ptr(), idx64,
            0 if weights is None else weights.data_ptr(), wcode,
            out.data_ptr(), D, B, K, code)
    if stages([not p.is_cuda for p in filled], B * K, vec):
        work = torch.empty(staged_bytes(parts, B * K, D * out.element_size()),
                           dtype=torch.uint8, device=device)
        err = _fn("repro_bag_reduce_staged", _STAGED_ARGS)(
            *args, work.data_ptr(), work.numel(), REGION_LOG2,
            common.stream_handle(device))
        common.check(err, "bag_reduce_routed staged launch")
        return out, STAGED_KERNELS
    err = _fn("repro_bag_reduce_routed", _ROUTED_ARGS)(
        *args, vec, common.stream_handle(device))
    common.check(err, "bag_reduce_routed launch")
    return out, 1
