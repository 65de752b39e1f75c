"""Shared model primitives: norms, RoPE, MLPs, initialisers, dtypes, and
the activation-policy hooks.

The reference's launch code installs a policy (logical activation name ->
sharding spec, plus a few ``_``-prefixed switches the models read: query
and KV chunk sizes, flash attention, chunked WKV, the expert-parallel
context) around model calls.  The port keeps the same thread-local
policy: the models read its switches, and :func:`maybe_shard` is the
identity, since one card has no mesh to constrain an activation to.
Initialisers draw from an explicit ``torch.Generator``; its numbers
differ from ``jax.random``'s, so tests that compare the two packages
carry the reference's parameters across
(:func:`repro_torch.convert.params_from_jax`)."""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.tree import named_leaves


# ---------------------------------------------------------------------------
# Activation-policy hooks.  launch/shardings.py builds a policy dict
# {logical_name: spec, "_switch": value}; models call maybe_shard(x, name)
# at the reference's names.  Without a policy this is all the identity.
# ---------------------------------------------------------------------------
_SHARDING_POLICY = threading.local()


def current_policy() -> Optional[dict]:
    return getattr(_SHARDING_POLICY, "policy", None)


@contextlib.contextmanager
def activation_sharding(policy: dict):
    prev = current_policy()
    _SHARDING_POLICY.policy = policy
    try:
        yield
    finally:
        _SHARDING_POLICY.policy = prev


def maybe_shard(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` itself.  The reference constrains ``x`` to the policy's spec
    for ``name``; one card has nothing to constrain it to."""
    return x


# ---------------------------------------------------------------------------
# Norms (computed in fp32, cast back)
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def apply_norm(x, p, kind: str):
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def norm_params(d: int, kind: str, dtype, device=None) -> dict:
    out = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind != "rmsnorm":
        out["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return out


# ---------------------------------------------------------------------------
# RoPE (supports partial rotary).  Pairs are interleaved: (x[0::2], x[1::2])
# rotate together, as in the reference — not the half-split layout.
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, rope_pct: float = 1.0,
               device=None) -> torch.Tensor:
    rot = int(head_dim * rope_pct) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                rope_pct: float = 1.0):
    """(cos, sin) of shape (..., seq, 1, rot/2) for ``positions`` (..., seq):
    computed once per decode step and shared by every layer."""
    freqs = rope_freqs(head_dim, theta, rope_pct, device=positions.device)
    angles = positions[..., :, None].to(torch.float32) * freqs
    return torch.cos(angles)[..., :, None, :], torch.sin(angles)[..., :, None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """Apply precomputed rope tables to x (..., seq, heads, head_dim)."""
    rot = 2 * cos.shape[-1]
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    if rot < x.shape[-1]:
        out = torch.cat([out.to(x.dtype), xp], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rope_pct: float = 1.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    cos, sin = rope_tables(positions, x.shape[-1], theta, rope_pct)
    return rotate(x, cos, sin)


# ---------------------------------------------------------------------------
# YaRN (arXiv:2309.00071) as DeepSeek-V2 applies it: each pair's frequency
# blends the interpolated (theta-frequency / factor) and the extrapolated one
# over a linear ramp between the dimensions that turn ``beta_fast`` and
# ``beta_slow`` times over the original context; cos/sin carry
# mscale(mscale) / mscale(mscale_all_dim), the softmax scale mscale(
# mscale_all_dim) squared.
# ---------------------------------------------------------------------------
def yarn_mscale(factor: float, mscale: float) -> float:
    """``0.1 mscale ln(factor) + 1`` (1 when ``factor <= 1``)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def _yarn_correction_dim(rotations: float, dim: int, theta: float,
                         length: int) -> float:
    """The dimension whose frequency turns ``rotations`` times over
    ``length`` positions."""
    return dim * math.log(length / (rotations * 2 * math.pi)) \
        / (2 * math.log(theta))


def yarn_freqs(dim: int, theta: float, yarn, device=None) -> torch.Tensor:
    """(dim/2,) inverse frequencies of a ``dim``-wide rotary part."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (theta ** exps)
    inter = 1.0 / (yarn.factor * theta ** exps)
    low = max(math.floor(_yarn_correction_dim(
        yarn.beta_fast, dim, theta, yarn.original_max_position)), 0)
    high = min(math.ceil(_yarn_correction_dim(
        yarn.beta_slow, dim, theta, yarn.original_max_position)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    keep = 1.0 - ramp  # 1: extrapolated (fast dims), 0: interpolated
    return inter * (1 - keep) + extra * keep


def yarn_tables(positions: torch.Tensor, dim: int, theta: float, yarn):
    """(cos, sin) as :func:`rope_tables` gives them, of YaRN's frequencies,
    each times ``mscale(mscale) / mscale(mscale_all_dim)``."""
    freqs = yarn_freqs(dim, theta, yarn, device=positions.device)
    angles = positions[..., :, None].to(torch.float32) * freqs
    m = yarn_mscale(yarn.factor, yarn.mscale) \
        / yarn_mscale(yarn.factor, yarn.mscale_all_dim)
    return ((torch.cos(angles) * m)[..., :, None, :],
            (torch.sin(angles) * m)[..., :, None, :])


def yarn_softmax_scale(qk_head_dim: int, yarn) -> float:
    """``qk_head_dim ** -0.5``, times ``mscale(mscale_all_dim)`` squared
    under YaRN (``yarn`` None: plain)."""
    scale = qk_head_dim ** -0.5
    if yarn is not None and yarn.mscale_all_dim:
        scale *= yarn_mscale(yarn.factor, yarn.mscale_all_dim) ** 2
    return scale


# ---------------------------------------------------------------------------
# MLPs.  GELU is the tanh approximation, jax.nn.gelu's default.
# ---------------------------------------------------------------------------
def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def mlp_apply(x, p, act: str):
    if act in ("swiglu", "geglu"):
        gate = x @ p["w_gate"]
        up = x @ p["w_up"]
        inner = (F.silu(gate) if act == "swiglu" else _gelu(gate)) * up
        return inner @ p["w_down"]
    if act == "relu_sq":
        h = torch.square(F.relu(x @ p["w_up"]))
        return h @ p["w_down"]
    return _gelu(x @ p["w_up"]) @ p["w_down"]


def mlp_params(gen: torch.Generator, d: int, f: int, act: str, dtype,
               device=None) -> dict:
    if act in ("swiglu", "geglu"):
        return {"w_gate": he(gen, (d, f), dtype, device=device),
                "w_up": he(gen, (d, f), dtype, device=device),
                "w_down": he(gen, (f, d), dtype, device=device)}
    return {"w_up": he(gen, (d, f), dtype, device=device),
            "w_down": he(gen, (f, d), dtype, device=device)}


# ---------------------------------------------------------------------------
# Initialisers (explicit generator) and dtypes
# ---------------------------------------------------------------------------
def he(gen: torch.Generator, shape, dtype=torch.float32, scale: float = 1.0,
       device=None) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale / math.sqrt(fan_in)
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (x * std).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device=None) -> torch.Tensor:
    x = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (x * 0.02).to(dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL, fp32 accumulation; with ``mask``, the masked mean."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Parameter trees and their gradients
# ---------------------------------------------------------------------------
def records_grad(module: nn.Module) -> bool:
    """Whether autograd records through ``module``'s parameters now."""
    return torch.is_grad_enabled() and any(
        p.requires_grad for p in module.parameters())


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: each dict a submodule, each
    tensor a frozen parameter of the same name, so ``state_dict`` keys are
    the reference tree's paths (``units.moe.experts.w_up``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def tree(self) -> dict:
        return {**{k: p for k, p in self._parameters.items()},
                **{k: m.tree() for k, m in self._modules.items()}}

    def views(self, i: int) -> dict:
        """Entry ``i`` of every stacked tensor, as a dict tree."""
        return {**{k: p[i] for k, p in self._parameters.items()},
                **{k: m.views(i) for k, m in self._modules.items()}}

    def entries(self) -> list[dict]:
        """Every entry of the stacked tensors as a dict tree: views made
        once and cached (a decode step reads every layer every step), or,
        while autograd records through the parameters, fresh ``unbind``
        views (one backward node a leaf, its gradient one stacked
        tensor)."""
        if records_grad(self):
            def split(node: "ParamTree") -> dict:
                return {**{k: torch.unbind(p)
                           for k, p in node._parameters.items()},
                        **{k: split(m) for k, m in node._modules.items()}}

            def pick(node: dict, i: int) -> dict:
                return {k: pick(v, i) if isinstance(v, dict) else v[i]
                        for k, v in node.items()}
            parts = split(self)
            return [pick(parts, i) for i in range(self.n_entries)]
        cached = self.__dict__.get("_entries")
        if cached is None:
            with torch.no_grad():
                cached = [self.views(i) for i in range(self.n_entries)]
            self.__dict__["_entries"] = cached
        return cached

    @property
    def n_entries(self) -> int:
        """The leading (stacked) axis's length."""
        return next(self.parameters()).shape[0]


def loss_and_grad_of(loss: Callable) -> Callable:
    """``loss_and_grad(cfg, params, batch, *, remat=False, **kw)`` for a
    family's ``loss``: (loss, {leaf name: gradient}), as
    ``jax.value_and_grad`` gives them; each parameter's ``requires_grad``
    is restored after.  ``kw`` goes to ``loss``."""
    def loss_and_grad(cfg, params: nn.Module, batch: dict, *,
                      remat: bool = False, **kw):
        names, leaves = zip(*named_leaves(params))
        flags = [p.requires_grad for p in leaves]
        try:
            for p in leaves:
                p.requires_grad_(True)
            with torch.enable_grad():
                value = loss(cfg, params, batch, remat=remat, **kw)
                grads = torch.autograd.grad(value, leaves)
        finally:
            for p, flag in zip(leaves, flags):
                p.requires_grad_(flag)
        return value.detach(), dict(zip(names, grads))
    loss_and_grad.__doc__ = (
        f"(loss, {{leaf name: gradient}}) of :func:`{loss.__module__}."
        f"loss`, as ``jax.value_and_grad`` gives them.")
    return loss_and_grad
