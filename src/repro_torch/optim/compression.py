"""Gradient compression with error feedback for a slow cross-group hop.

int8 per-tensor-scaled quantization with an error-feedback residual keeps
an all-reduce over a slow link 4x smaller without biasing convergence.
The reference reduces over a ``shard_map`` mesh axis (``psum``); here the
group is a ``torch.distributed`` process group, and the reduction is
``all_reduce`` over it.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import named_leaves


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8. Returns (q, scale); rounds half to even."""
    xf = x.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(g: torch.Tensor, residual: torch.Tensor):
    """Error-feedback compression of one gradient tensor.

    Returns (q, scale, new_residual): ``dequant(q)*scale + new_residual ==
    g + residual`` (up to rounding of the carried term).
    """
    corrected = g.to(torch.float32) + residual
    q, scale = quantize_int8(corrected)
    new_residual = corrected - dequantize_int8(q, scale)
    return q, scale, new_residual


def init_residuals(grads) -> dict:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in named_leaves(grads)}


def cross_group_mean_compressed(grads, residuals, group=None):
    """Mean-reduce grads over ``group`` with int8 + error feedback.

    Every rank of ``group`` must call it.  The int8 payloads are summed as
    int32 (no overflow), the scales beside them; each rank used its own
    scale, so the mean scale dequantizes.  Returns ({name: mean},
    {name: new residual})."""
    n = torch.tensor(float(dist.get_world_size(group)))
    means, new_res = {}, {}
    for key, g in named_leaves(grads):
        q, scale, r = compress_with_feedback(g, residuals[key])
        summed = q.to(torch.int32)
        dist.all_reduce(summed, group=group)
        scale_sum = scale.clone()
        dist.all_reduce(scale_sum, group=group)
        n_dev = n.to(g.device)
        mean = summed.to(torch.float32) * (scale_sum / n_dev) / n_dev
        means[key], new_res[key] = mean.to(g.dtype), r
    return means, new_res
