"""Shared model primitives: norms, RoPE, MLPs, initialisers, dtypes.

The reference's activation-sharding hooks have no counterpart: one card
has no mesh.  Initialisers draw from an explicit ``torch.Generator``; its
numbers differ from ``jax.random``'s, so tests that compare the two
packages carry the reference's parameters across
(:func:`repro_torch.convert.params_from_jax`)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]
