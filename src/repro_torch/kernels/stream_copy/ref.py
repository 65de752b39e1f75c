"""Plain PyTorch version of the streaming copy (optionally casting)."""
from __future__ import annotations

from typing import Optional

import torch


def stream_copy(src: torch.Tensor, out_dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
    """A fresh copy of ``src`` in ``out_dtype`` (default: its own)."""
    return src.to(dtype=out_dtype or src.dtype, copy=True)
