"""AdamW with fp32 moments, global-norm clipping, decoupled weight decay.

The reference's dtypes: clipping multiplies in the gradient's dtype, the
moments and the new parameter are computed in fp32 and the parameter is
cast back.  Unlike the reference, :func:`apply` updates the parameters
and the moments in place (``copy_`` under ``torch.no_grad()``), so their
storage and ``data_ptr()`` are kept, and it walks a large leaf in chunks
of :data:`CHUNK` elements (element-wise math, so the values are the
same) to bound the fp32 temporaries.

Parameters are an ``nn.Module`` or a (nested or dotted) dict of tensors;
gradients and moments are dicts keyed by the leaves' dotted names
(:mod:`repro_torch.tree`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.tree import named_leaves

#: elements of a leaf an update touches at once
CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        base = torch.as_tensor(self.lr, dtype=torch.float32,
                               device=torch.as_tensor(step).device)
        return base * self.schedule(step) if self.schedule else base


def by_name(tree) -> dict:
    """``{dotted name: leaf}`` of a tree (or of a dict keyed by names)."""
    return dict(named_leaves(tree))


def init_state(params) -> dict:
    leaves = named_leaves(params)
    device = leaves[0][1].device
    return {
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "mu": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in leaves},
        "nu": {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in leaves},
    }


def chunks(*tensors: torch.Tensor, size: int = CHUNK):
    """Aligned flat chunks of same-sized contiguous tensors."""
    flat = [t.view(-1) for t in tensors]
    n = flat[0].numel()
    for i in range(0, n, size):
        yield tuple(f[i:i + size] for f in flat)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares."""
    total = 0
    for _, g in named_leaves(grads):
        leaf = 0
        for (c,) in chunks(g.contiguous()):
            leaf = leaf + torch.sum(torch.square(c.to(torch.float32)))
        total = total + leaf
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / max(norm, 1e-9)), in fp32 (a true division)."""
    one = torch.ones((), dtype=torch.float32, device=norm.device)
    limit = torch.full((), max_norm, dtype=torch.float32, device=norm.device)
    return torch.minimum(one, limit / torch.clamp(norm, min=1e-9))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return {k: g * scale.to(g.dtype) for k, g in named_leaves(grads)}, norm


def coefficients(cfg: AdamWConfig, step: torch.Tensor):
    """(lr, c1, c2) at ``step`` (an int32 tensor), in fp32."""
    sf = step.to(torch.float32)
    b1 = torch.full((), cfg.b1, dtype=torch.float32, device=step.device)
    b2 = torch.full((), cfg.b2, dtype=torch.float32, device=step.device)
    return cfg.lr_at(step), 1.0 - b1 ** sf, 1.0 - b2 ** sf


def adam_math(cfg: AdamWConfig, p32: torch.Tensor, g32: torch.Tensor,
              mu: torch.Tensor, nu: torch.Tensor, lr, c1, c2):
    """(new fp32 parameter, mu, nu): the reference's expressions, one op
    at a time in its order (the fused and the tiered step share them)."""
    mu = cfg.b1 * mu + (1 - cfg.b1) * g32
    nu = cfg.b2 * nu + (1 - cfg.b2) * g32 * g32
    upd = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps) \
        + cfg.weight_decay * p32
    return p32 - lr * upd, mu, nu


@torch.no_grad()
def apply(cfg: AdamWConfig, params, grads, state) -> tuple:
    """One AdamW step, in place. Returns (params, new_state, metrics)."""
    grads = by_name(grads)
    leaves = named_leaves(params)
    gnorm = global_norm(grads)
    scale = clip_scale(gnorm, cfg.grad_clip)
    step = state["step"] + 1
    lr, c1, c2 = coefficients(cfg, step)
    for key, p in leaves:
        g = grads[key]
        mu, nu = state["mu"][key], state["nu"][key]
        for pc, gc, mc, nc in chunks(p, g.contiguous(), mu, nu):
            g32 = (gc * scale.to(gc.dtype)).to(torch.float32)
            new_p, new_mu, new_nu = adam_math(
                cfg, pc.to(torch.float32), g32, mc, nc, lr, c1, c2)
            mc.copy_(new_mu)
            nc.copy_(new_nu)
            pc.copy_(new_p.to(pc.dtype))
    new_state = {"step": step, "mu": state["mu"], "nu": state["nu"]}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
