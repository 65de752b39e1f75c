"""Plain PyTorch versions of the streaming copy (optionally casting): one
slab, and a list of segments."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch


def stream_copy(src: torch.Tensor, out_dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
    """A fresh copy of ``src`` in ``out_dtype`` (default: its own)."""
    return src.to(dtype=out_dtype or src.dtype, copy=True)


def segment_view(base: torch.Tensor, off: int, stride: int, rows: int,
                 cols: int) -> torch.Tensor:
    """The ``rows x cols`` window of a contiguous ``base`` that starts
    ``off`` elements in, rows ``stride`` elements apart."""
    flat = base.view(-1)
    return flat.as_strided((rows, cols), (stride, 1),
                           flat.storage_offset() + off)


def stream_copy_segments(srcs: Sequence[torch.Tensor],
                         dsts: Sequence[torch.Tensor],
                         segs: np.ndarray) -> None:
    """``dst_i[r, c] = src_i[r, c]`` cast to the destination dtype, for
    every row of ``segs`` (columns as
    :data:`~repro_torch.kernels.stream_copy.kernel.SRC` ... ``COLS``:
    source base, offset, row stride, destination base, offset, row
    stride, rows, cols), one segment after another."""
    for si, so, ss, di, do, ds, rows, cols in np.asarray(
            segs, np.int64).reshape(-1, 8).tolist():
        if rows <= 0 or cols <= 0:
            continue
        src = segment_view(srcs[si], so, ss, rows, cols)
        segment_view(dsts[di], do, ds, rows, cols).copy_(
            stream_copy(src, dsts[di].dtype))
