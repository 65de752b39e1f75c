"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks and local MQA
in the pattern (recurrent, recurrent, local attention).

The port of ``repro.models.rglru``.  A recurrent block is a gated branch
(GeLU) times (width-4 causal conv -> RG-LRU), then an output projection;
the RG-LRU is ``a = exp(-c softplus(lam) sigmoid(x W_a + b_a))``,
``h = a h + sqrt(1 - a^2) (i * x)``.  Every temporal block is followed
by a GeGLU MLP.  The parameters keep the reference's tree: ``units.
{rec_a,rec_b,attn}`` stacked over the units, ``tail_rec`` (the layers
past the last whole unit) stacked over its layers.

The reference's ``rg_lru_scan`` is ``jax.lax.associative_scan``; the
port runs the same combine, ``(a1 a2, b1 a2 + b2)``, as a log-depth
Hillis–Steele scan: ceil(log2 T) elementwise passes over the whole
sequence, with no division by a cumulative product.  There is no TPU
kernel for it, so none is ported.

Decode carries each recurrent layer's conv inputs and state and each
attention unit's ring-buffer K/V (``min(local_window, max_len)`` rows);
the local attention goes through the model-level
``attention.decode_attention``, so on the card it launches the
``decode_attention`` kernel, once an attention unit.  ``decode_step``
writes the cache's tensors in place (the reference returns new ones).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as dense
from repro_torch.models.common import (ParamTree, apply_norm, cross_entropy,
                                       dtype_of, embed_init, he,
                                       loss_and_grad_of, maybe_shard,
                                       mlp_apply, mlp_params, norm_params)

RG_C = 8.0
CONV_W = 4


class RglruParams(ParamTree):
    """The parameter tree of one hybrid model: ``embed``, ``units.rec_a``,
    ``units.rec_b``, ``units.attn`` (stacked over the units),
    ``tail_rec`` (optional, stacked), ``final_norm``, ``lm_head``
    (stored ``(D, V)``)."""

    @property
    def n_units(self) -> int:
        return self.units.n_entries

    @property
    def n_tail(self) -> int:
        return self.tail_rec.n_entries if "tail_rec" in self else 0

    def unit_trees(self) -> list[dict]:
        return self.units.entries()

    def tail_trees(self) -> list[dict]:
        return self.tail_rec.entries() if "tail_rec" in self else []


def _unit(cfg: ArchConfig) -> tuple[int, int]:
    unit = len(cfg.block_pattern)
    return cfg.n_layers // unit, cfg.n_layers % unit


def init_rec_layer(cfg: ArchConfig, gen: torch.Generator, device) -> dict:
    dt = dtype_of(cfg.param_dtype)
    D = cfg.d_model
    f32 = torch.float32

    def w(shape, scale=1.0):
        return he(gen, shape, dt, scale, device=device)
    return {
        "ln1": norm_params(D, cfg.norm, f32, device=device),
        "rec": {
            "W_gate": w((D, D)), "W_in": w((D, D)),
            "conv": w((CONV_W, D), 0.5), "W_a": w((D, D), 0.5),
            "b_a": torch.zeros((D,), dtype=f32, device=device),
            "W_i": w((D, D), 0.5),
            "b_i": torch.zeros((D,), dtype=f32, device=device),
            "lam": torch.full((D,), 0.655, dtype=f32, device=device),
            "W_out": w((D, D)),
        },
        "ln2": norm_params(D, cfg.norm, f32, device=device),
        "mlp": mlp_params(gen, D, cfg.d_ff, cfg.act, dt, device=device),
    }


def init(cfg: ArchConfig, seed: Union[int, torch.Generator] = 0, *,
         device: DeviceLike = None) -> RglruParams:
    """Random parameters from a seeded generator, made on ``device``
    (``cuda`` unless told ``"cpu"``), one layer at a time into the
    stacked tensors."""
    device = resolve_device(device)
    gen = dense.generator(seed, device)
    dt = dtype_of(cfg.param_dtype)
    n_units, n_tail = _unit(cfg)
    D = cfg.d_model
    tree = {"embed": embed_init(gen, cfg.vocab_padded, D, dt, device=device)}
    tree["units"] = dense.stack_layers(lambda: {
        "rec_a": init_rec_layer(cfg, gen, device),
        "rec_b": init_rec_layer(cfg, gen, device),
        "attn": dense.init_layer(cfg, gen, device)}, n_units, device)
    tree["final_norm"] = norm_params(D, cfg.norm, torch.float32,
                                     device=device)
    tree["lm_head"] = embed_init(gen, cfg.vocab_padded, D, dt,
                                 device=device).T.contiguous()
    if n_tail:
        tree["tail_rec"] = dense.stack_layers(
            lambda: init_rec_layer(cfg, gen, device), n_tail, device)
    return RglruParams(tree)


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------
def rg_lru_scan(a: torch.Tensor, gated: torch.Tensor, h0: torch.Tensor):
    """``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) gated_t`` over axis 1.

    a, gated: (B,T,D) fp32; h0: (B,D).  Returns (h (B,T,D), h[:, -1]).
    A Hillis–Steele scan: pass ``d`` combines each step with the one
    ``d`` before it, ``(a1 a2, b1 a2 + b2)``, for d = 1, 2, 4, ..."""
    beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * gated
    T = a.shape[1]
    d = 1
    while d < T:
        a, beta = (torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1),
                   torch.cat([beta[:, :d], beta[:, :-d] * a[:, d:]
                              + beta[:, d:]], dim=1))
        d *= 2
    h = a * h0[:, None, :] + beta
    return h, h[:, -1]


def _gates(x: torch.Tensor, rp: dict, u: torch.Tensor, conv_hist):
    """The conv over ``conv_hist`` (B, T+3, D) and the RG-LRU's decay and
    input: (uf, a, i), fp32."""
    T = u.shape[1]
    conv = 0
    for i in range(CONV_W):
        j = CONV_W - 1 - i
        conv = conv + conv_hist[:, j:j + T] * rp["conv"][j]
    uf = conv.to(torch.float32)
    r = torch.sigmoid((x @ rp["W_a"]).to(torch.float32) + rp["b_a"])
    i = torch.sigmoid((x @ rp["W_i"]).to(torch.float32) + rp["b_i"])
    a = torch.exp(-RG_C * F.softplus(rp["lam"]) * r)
    return uf, a, i


def rec_block(cfg: ArchConfig, x: torch.Tensor, rp: dict,
              conv_state: torch.Tensor, h_state: torch.Tensor):
    """x: (B,T,D).  Returns (out, (new conv state, new h))."""
    gate = F.gelu(x @ rp["W_gate"], approximate="tanh")
    u = x @ rp["W_in"]
    hist = torch.cat([conv_state.to(u.dtype), u], dim=1)  # (B,T+3,D)
    uf, a, i = _gates(x, rp, u, hist)
    h, h_last = rg_lru_scan(a, i * uf, h_state)
    out = (h.to(x.dtype) * gate) @ rp["W_out"]
    return out, (hist[:, -(CONV_W - 1):].to(torch.float32), h_last)


def _rec_layer_fwd(cfg: ArchConfig, x, lp: dict, conv_s, h_s):
    h = apply_norm(x, lp["ln1"], cfg.norm)
    out, _ = rec_block(cfg, h, lp["rec"], conv_s, h_s)
    x = x + out
    h = apply_norm(x, lp["ln2"], cfg.norm)
    return x + maybe_shard(mlp_apply(h, lp["mlp"], cfg.act), "act_btd")


def forward(cfg: ArchConfig, params: RglruParams, tokens: torch.Tensor, *,
            remat: bool = False, last_only: bool = False) -> torch.Tensor:
    """Logits (B,T,V) of ``tokens`` (B,T), from zero recurrent states;
    (B,1,V) with ``last_only``.  ``remat`` recomputes each layer in the
    backward pass."""
    x, positions = dense.embed_tokens(params, tokens)
    B, D = x.shape[0], cfg.d_model
    conv0 = torch.zeros((B, CONV_W - 1, D), dtype=torch.float32,
                        device=x.device)
    h0 = torch.zeros((B, D), dtype=torch.float32, device=x.device)
    rec = partial(_rec_layer_fwd, cfg)
    att = partial(dense._layer_fwd, cfg)
    if remat and torch.is_grad_enabled():
        rec = partial(checkpoint, rec, use_reentrant=False)
        att = partial(checkpoint, att, use_reentrant=False)
    for up in params.unit_trees():
        x = rec(x, up["rec_a"], conv0, h0)
        x = rec(x, up["rec_b"], conv0, h0)
        x = att(x, up["attn"], positions)
    for lp in params.tail_trees():
        x = rec(x, lp, conv0, h0)
    if last_only:
        x = x[:, -1:]
    return dense.head_logits(cfg, params, x)


def loss(cfg: ArchConfig, params: RglruParams, batch: dict, *,
         remat: bool = False) -> torch.Tensor:
    logits = forward(cfg, params, batch["tokens"], remat=remat)
    return cross_entropy(logits, batch["labels"].to(logits.device),
                         batch.get("mask"))


loss_and_grad = loss_and_grad_of(loss)


# ---------------------------------------------------------------------------
# Decode: recurrent states + ring-buffer KV for the local attention layers
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, *,
               device: DeviceLike = None) -> dict:
    """Zero states: ``rec_a``/``rec_b``/``tail`` ``{"conv" (n,B,3,D),
    "h" (n,B,D)}`` fp32 (``tail`` None without tail layers), ring-buffer
    ``k``/``v`` (units, B, min(window, max_len), K, hd), ``len`` (B,)."""
    device = resolve_device(device)
    dt = dtype or dtype_of(cfg.param_dtype)
    n_units, n_tail = _unit(cfg)
    D, K, hd = cfg.d_model, cfg.n_kv_heads, cfg.resolved_head_dim
    W = min(cfg.local_window or max_len, max_len)
    f32 = dict(dtype=torch.float32, device=device)

    def rec(n: int) -> dict:
        return {"conv": torch.zeros((n, batch, CONV_W - 1, D), **f32),
                "h": torch.zeros((n, batch, D), **f32)}
    return {"rec_a": rec(n_units), "rec_b": rec(n_units),
            "tail": rec(n_tail) if n_tail else None,
            "k": torch.zeros((n_units, batch, W, K, hd), dtype=dt,
                             device=device),
            "v": torch.zeros((n_units, batch, W, K, hd), dtype=dt,
                             device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def _rec_decode(cfg: ArchConfig, x: torch.Tensor, lp: dict,
                conv_s: torch.Tensor, h_s: torch.Tensor) -> torch.Tensor:
    """One token through a recurrent layer, x (B,D); ``conv_s`` (B,3,D)
    and ``h_s`` (B,D) take the new states in place."""
    h = apply_norm(x, lp["ln1"], cfg.norm)
    rp = lp["rec"]
    gate = F.gelu(h @ rp["W_gate"], approximate="tanh")
    u = h @ rp["W_in"]
    hist = torch.cat([conv_s.to(u.dtype), u[:, None]], dim=1)  # (B,4,D)
    uf, a, i = _gates(h, rp, u[:, None], hist)
    uf = uf[:, 0]
    h_new = a * h_s + torch.sqrt(torch.clamp_min(1 - a * a, 1e-12)) * (i * uf)
    x = x + (h_new.to(x.dtype) * gate) @ rp["W_out"]
    h2 = apply_norm(x, lp["ln2"], cfg.norm)
    x = x + mlp_apply(h2, lp["mlp"], cfg.act)
    conv_s.copy_(hist[:, 1:])
    h_s.copy_(h_new)
    return x


def decode_step(cfg: ArchConfig, params: RglruParams, cache: dict,
                tokens: torch.Tensor, *, attend: Optional[Callable] = None
                ) -> tuple[torch.Tensor, dict]:
    """One token for every sequence: (logits (B,V), cache with ``len +
    1``); the cache's tensors are updated in place.  ``attend`` replaces
    the per-partition attention (default: the kernel on the card)."""
    x = params.embed[tokens.to(params.embed.device).long()]
    pos = cache["len"]
    ra, rb, kc, vc = cache["rec_a"], cache["rec_b"], cache["k"], cache["v"]
    for u, up in enumerate(params.unit_trees()):
        x = _rec_decode(cfg, x, up["rec_a"], ra["conv"][u], ra["h"][u])
        x = _rec_decode(cfg, x, up["rec_b"], rb["conv"][u], rb["h"][u])
        x = dense.dense_step(cfg, x, up["attn"], kc[u], vc[u], pos,
                             attend=attend)
    tail = cache["tail"]
    for i, lp in enumerate(params.tail_trees()):
        x = _rec_decode(cfg, x, lp, tail["conv"][i], tail["h"][i])
    return (dense.head_logits(cfg, params, x),
            {**cache, "len": cache["len"] + 1})
