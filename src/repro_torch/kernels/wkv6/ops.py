"""Public wrapper for the RWKV6 WKV recurrence.

On the card (any CUDA or pinned host tensor among the arguments) it
launches the CUDA kernel or raises; the plain version runs only when
every tensor lies in pageable host memory.  ``LAUNCHES`` counts kernel
launches and nothing else.

While autograd records through any input, the call goes through
:class:`Wkv6Fn`: its forward is the same launch (or plain version), its
backward recomputes the plain recurrence from the saved inputs and
differentiates that, as the reference differentiates its jnp scan (it
has no backward kernel either).  The kernel's outputs alone carry no
``grad_fn``, so without it a loss on the card would skip the
recurrence's gradients."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import common
from repro_torch.kernels.wkv6 import kernel, ref

#: kernel launches (never bumped by the plain version).
LAUNCHES = common.LaunchCounter()


def _run(r, k, v, w, u, state, state_out):
    extra = () if state_out is None else (state_out,)
    device = common.card_device(r, k, v, w, u, state, *extra)
    if device is None:
        return ref.wkv6(r, k, v, w, u, state, state_out=state_out)
    out = kernel.wkv6(r, k, v, w, u, state, state_out, device)
    LAUNCHES.bump()
    return out


class Wkv6Fn(torch.autograd.Function):
    """The recurrence with a recomputing backward (see the module)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        ctx.save_for_backward(r, k, v, w, u, state)
        return _run(r, k, v, w, u, state, None)

    @staticmethod
    def backward(ctx, gy, gs):
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y, s = ref.wkv6(*inputs)
            outs = [(o, g) for o, g in ((y, gy), (s, gs)) if g is not None]
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(
                [o for o, _ in outs], wanted, [g for _, g in outs],
                allow_unused=True))
        return tuple(next(grads) if t.requires_grad else None
                     for t in inputs)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state: torch.Tensor, *,
         state_out: Optional[torch.Tensor] = None):
    """(B,T,H,hd) r, k, v, w; (H,hd) u; (B,H,hd,hd) state -> (y fp32,
    final state fp32).  Any T >= 1; ``state_out`` may alias ``state``
    (not while autograd records: the differentiable call allocates)."""
    inputs = (r, k, v, w, u, state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        if state_out is not None:
            raise ValueError("state_out is written in place: not "
                             "differentiable")
        return Wkv6Fn.apply(*inputs)
    return _run(r, k, v, w, u, state, state_out)
