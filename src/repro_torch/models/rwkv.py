"""RWKV6 "Finch" — attention-free RNN LM with data-dependent decay.

The port of ``repro.models.rwkv``: token-shift lerps, the LoRA-modulated
per-channel decay ``w = exp(-exp(w0 + tanh(x @ A) @ B))``, the per-head
WKV state ``S <- diag(w) S + k^T v`` with bonus ``u``, grouped head norm
and silu output gate, squared-ReLU channel mixing.  Dtypes follow the
reference: r, k, v, g and the mixes in the parameter dtype, w and the
WKV state in fp32, y out of the group norm in fp32 and cast back before
the gate.

Where the reference's ``time_mix`` runs the jnp ``wkv_scan``, the port
runs the hand-written ``wkv6`` kernel through its wrapper
(:mod:`repro_torch.kernels.wkv6.ops`); its plain version is the same
exact recurrence.  Under a policy with ``_wkv_chunked`` and a length that
is a multiple of 16, ``time_mix`` takes :func:`wkv_chunked`, the
reference's intra-chunk matrix form in plain torch, where the reference
takes its jnp one.  ``forward`` and ``decode_step`` take ``wkv=`` to swap
in another function of the same signature (a check holds a step against
the plain version that way); ``None`` means the choice above.

Serving: ``forward(..., return_states=True, last_only=True)`` is the
prefill; ``decode_step`` then advances the recurrent state one token at a
time.  The state is O(1) in the sequence length.  ``decode_step`` updates
the cache's tensors in place (the reference returns new ones); the
returned cache shares them.

Training: ``loss`` differentiates through the kernel's autograd wrapper,
whose backward recomputes the plain recurrence; the forward then writes
no state in place.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.wkv6 import ops as wkv_ops
from repro_torch.models.common import (cross_entropy, current_policy,
                                       dtype_of, embed_init, he, layer_norm,
                                       loss_and_grad_of, maybe_shard,
                                       records_grad)
from repro_torch.models.transformer import DenseParams

LORA_RANK = 64

Wkv = Callable[..., tuple]


class RwkvParams(DenseParams):
    """The parameter tree of one rwkv6 model, laid out as the reference's
    (``embed``, ``layers.{ln1,ln2,tm,cm}.*`` stacked over a leading L
    axis, ``final_norm``, ``lm_head`` stored ``(D, V)``)."""


def _heads(cfg: ArchConfig) -> tuple[int, int]:
    hd = cfg.rwkv_head_dim
    assert cfg.d_model % hd == 0
    return cfg.d_model // hd, hd


def _layer_init(cfg: ArchConfig, gen: torch.Generator, device) -> dict:
    dt = dtype_of(cfg.param_dtype)
    D, F_ = cfg.d_model, cfg.d_ff
    H, hd = _heads(cfg)

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=device)

    def w(shape, scale=1.0):
        return he(gen, shape, dt, scale, device=device)

    f32 = torch.float32
    return {
        "ln1": {"scale": full((D,), 1.0, f32), "bias": full((D,), 0.0, f32)},
        "ln2": {"scale": full((D,), 1.0, f32), "bias": full((D,), 0.0, f32)},
        "tm": {
            "mu_r": full((D,), 0.5), "mu_k": full((D,), 0.5),
            "mu_v": full((D,), 0.5), "mu_w": full((D,), 0.5),
            "mu_g": full((D,), 0.5),
            "w0": full((D,), -6.0, f32),
            "w_A": w((D, LORA_RANK), 0.1), "w_B": w((LORA_RANK, D), 0.1),
            "u": full((H, hd), 0.0, f32),
            "Wr": w((D, D)), "Wk": w((D, D)), "Wv": w((D, D)),
            "Wg": w((D, D)), "Wo": w((D, D)),
            "gn_scale": full((H, hd), 1.0, f32),
            "gn_bias": full((H, hd), 0.0, f32),
        },
        "cm": {
            "mu_k": full((D,), 0.5), "mu_r": full((D,), 0.5),
            "Wk": w((D, F_)), "Wv": w((F_, D)), "Wr": w((D, D)),
        },
    }


def init(cfg: ArchConfig, seed: Union[int, torch.Generator] = 0, *,
         device: DeviceLike = None) -> RwkvParams:
    """Random parameters from a seeded generator, made on ``device``
    (``cuda`` unless told ``"cpu"``), one layer at a time into the
    stacked tensors."""
    device = resolve_device(device)
    gen = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=device).manual_seed(int(seed))
    dt = dtype_of(cfg.param_dtype)
    L = cfg.n_layers
    embed = embed_init(gen, cfg.vocab_padded, cfg.d_model, dt, device=device)
    layers: dict = {}
    for i in range(L):
        for group, leaves in _layer_init(cfg, gen, device).items():
            out = layers.setdefault(group, {})
            for name, value in leaves.items():
                if i == 0:
                    out[name] = torch.empty((L,) + tuple(value.shape),
                                            dtype=value.dtype, device=device)
                out[name][i] = value
    final_norm = {"scale": torch.ones((cfg.d_model,), device=device),
                  "bias": torch.zeros((cfg.d_model,), device=device)}
    lm_head = embed_init(gen, cfg.vocab_padded, cfg.d_model, dt,
                         device=device).T.contiguous()
    return RwkvParams(embed, layers, final_norm, lm_head)


def _group_norm(y: torch.Tensor, scale, bias, eps: float = 64e-5
                ) -> torch.Tensor:
    """Per-head layer norm in fp32; y: (..., H, hd)."""
    yf = y.to(torch.float32)
    mu = yf.mean(-1, keepdim=True)
    var = torch.square(yf - mu).mean(-1, keepdim=True)
    return (yf - mu) * torch.rsqrt(var + eps) * scale + bias


def _decay(tm: dict, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel decay w in (0, 1), fp32; xw: (..., D)."""
    f32 = torch.float32
    lora = torch.tanh(xw.to(f32) @ tm["w_A"].to(f32))
    lora = lora @ tm["w_B"].to(f32)
    return torch.exp(-torch.exp(tm["w0"] + lora))


def _shifted(x: torch.Tensor, shift_in: torch.Tensor) -> torch.Tensor:
    """x_{t-1} along time, with ``shift_in`` before the first step."""
    return torch.cat([shift_in[:, None].to(x.dtype), x[:, :-1]], dim=1)


def wkv_chunked(r, k, v, w, u, state, *, chunk: int = 16,
                state_out: Optional[torch.Tensor] = None):
    """Chunked WKV6: the intra-chunk matrix form and an inter-chunk state
    carry (the reference's ``wkv_chunked``).  Within a chunk the decay
    ratios exp(L_{t-1} - L_s), s < t, are all <= 1, so nothing is
    rescaled by 1/P; the state is read and written once a chunk.

    r, k, v, w: (B,T,H,hd), T a multiple of min(chunk, T); u: (H,hd);
    state: (B,H,hd,hd).  Returns (y (B,T,H,hd) fp32, final state fp32),
    the state written into ``state_out`` when one is given."""
    B, T, H, hd = r.shape
    C = min(chunk, T)
    if T % C:
        raise ValueError(f"T={T} is not a multiple of the chunk {C}")
    n = T // C
    f32 = torch.float32
    rs, ks, vs = (a.to(f32).reshape(B, n, C, H, hd) for a in (r, k, v))
    logw = torch.log(torch.clamp_min(w.to(f32), 1e-38)).reshape(
        B, n, C, H, hd)
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     diagonal=-1)  # s < t
    uf = u.to(f32)
    S = state.to(f32)
    ys = []
    for c in range(n):
        rc, kc, vc, lw = rs[:, c], ks[:, c], vs[:, c], logw[:, c]
        lam = torch.cumsum(lw, dim=1)  # L_t (inclusive)
        lam_prev = lam - lw  # L_{t-1}
        y = torch.einsum("bthi,bhij->bthj", rc * torch.exp(lam_prev), S)
        diff = lam_prev[:, :, None] - lam[:, None, :]  # (B,t,s,H,hd), <= 0
        dmat = torch.where(tri[None, :, :, None, None], torch.exp(diff),
                           0.0)
        coeff = torch.einsum("bthi,btshi,bshi->btsh", rc, dmat, kc)
        y = y + torch.einsum("btsh,bshj->bthj", coeff, vc)
        diag = torch.einsum("bthi,hi,bthi->bth", rc, uf, kc)
        ys.append(y + diag[..., None] * vc)
        lam_c = lam[:, -1:]
        S = torch.exp(lam_c[:, 0])[..., None] * S + torch.einsum(
            "bshi,bshj->bhij", kc * torch.exp(lam_c - lam), vc)
    y = torch.stack(ys, dim=1).reshape(B, T, H, hd)
    if state_out is not None:
        return y, state_out.copy_(S)
    return y, S


def _use_chunked() -> bool:
    pol = current_policy()
    return bool(pol and pol.get("_wkv_chunked"))


def time_mix(cfg: ArchConfig, x: torch.Tensor, tm: dict, state: torch.Tensor,
             shift_in: torch.Tensor, *, wkv: Optional[Wkv] = None,
             state_out: Optional[torch.Tensor] = None):
    """x: (B,T,D).  Returns (out, (new_shift, new_state)); the new WKV
    state lands in ``state_out`` when one is given."""
    B, T, D = x.shape
    H, hd = _heads(cfg)
    dx = _shifted(x, shift_in) - x

    def mix(mu):
        return x + dx * mu

    r = (mix(tm["mu_r"]) @ tm["Wr"]).reshape(B, T, H, hd)
    k = (mix(tm["mu_k"]) @ tm["Wk"]).reshape(B, T, H, hd)
    v = (mix(tm["mu_v"]) @ tm["Wv"]).reshape(B, T, H, hd)
    g = F.silu(mix(tm["mu_g"]) @ tm["Wg"])
    w = _decay(tm, mix(tm["mu_w"])).reshape(B, T, H, hd)
    if wkv is None:
        wkv = wkv_chunked if (_use_chunked() and T % 16 == 0) \
            else wkv_ops.wkv6
    y, new_state = wkv(r, k, v, w, tm["u"], state, state_out=state_out)
    y = _group_norm(y, tm["gn_scale"], tm["gn_bias"]).reshape(B, T, D)
    out = (y.to(x.dtype) * g) @ tm["Wo"]
    return out, (x[:, -1], new_state)


def channel_mix(x: torch.Tensor, cm: dict, shift_in: torch.Tensor):
    dx = _shifted(x, shift_in) - x
    xk = x + dx * cm["mu_k"]
    xr = x + dx * cm["mu_r"]
    k = torch.square(F.relu(xk @ cm["Wk"]))
    return torch.sigmoid(xr @ cm["Wr"]) * (k @ cm["Wv"]), x[:, -1]


def _layer_fwd(cfg: ArchConfig, x, lp: dict, states, *,
               wkv: Optional[Wkv] = None,
               state_out: Optional[torch.Tensor] = None):
    tm_shift, cm_shift, wkv_state = states
    h = layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"])
    out, (tm_shift, wkv_state) = time_mix(cfg, h, lp["tm"], wkv_state,
                                          tm_shift, wkv=wkv,
                                          state_out=state_out)
    x = x + out
    h = layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"])
    out, cm_shift = channel_mix(h, lp["cm"], cm_shift)
    return x + maybe_shard(out, "act_btd"), (tm_shift, cm_shift, wkv_state)


def init_states(cfg: ArchConfig, batch: int, *, device: DeviceLike = None):
    """Zero (token-shift of time mix, of channel mix, WKV) states, fp32,
    stacked over layers: (L,B,D), (L,B,D), (L,B,H,hd,hd)."""
    device = resolve_device(device)
    H, hd = _heads(cfg)
    L, D = cfg.n_layers, cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((L, batch, D), **f32),
            torch.zeros((L, batch, D), **f32),
            torch.zeros((L, batch, H, hd, hd), **f32))


def _embed(params: RwkvParams, tokens: torch.Tensor) -> torch.Tensor:
    return params.embed[tokens.to(params.embed.device).long()]


def forward(cfg: ArchConfig, params: RwkvParams, tokens: torch.Tensor, *,
            states=None, return_states: bool = False,
            last_only: bool = False, remat: bool = False,
            wkv: Optional[Wkv] = None):
    """Logits (B,T,V) — (B,1,V) with ``last_only`` — over ``tokens``
    (B,T), from ``states`` (zero when None, left unchanged).  With
    ``return_states`` also the new (tm, cm, wkv) states: the token shifts
    in the activation dtype, the WKV state in fp32.  ``remat`` recomputes
    each layer in the backward pass.  While autograd records, no state is
    written in place: the new states are stacked from each layer's."""
    B, T = tokens.shape
    x = maybe_shard(_embed(params, tokens), "act_btd")
    if states is None:
        states = init_states(cfg, B, device=x.device)
    H, hd = _heads(cfg)
    L, D = params.n_layers, cfg.d_model
    grad = records_grad(params)
    body = partial(_layer_fwd, cfg, wkv=wkv)
    if remat and grad:
        body = partial(checkpoint, body, use_reentrant=False)
    wkv_out = None
    if return_states and not grad:
        wkv_out = torch.empty((L, B, H, hd, hd), dtype=torch.float32,
                              device=x.device)
    new_states = []
    for i, lp in enumerate(params.layer_trees()):
        x, s = body(x, lp, (states[0][i], states[1][i], states[2][i]),
                    state_out=None if wkv_out is None else wkv_out[i])
        new_states.append(s)
    if last_only:
        x = x[:, -1:]
    x = layer_norm(x, params.final_norm["scale"], params.final_norm["bias"])
    logits = maybe_shard(x @ params.lm_head, "act_btv")
    if return_states:
        tm_s, cm_s, wkv_s = zip(*new_states)
        return logits, (torch.stack(tm_s), torch.stack(cm_s),
                        torch.stack(wkv_s) if wkv_out is None else wkv_out)
    return logits


def loss(cfg: ArchConfig, params: RwkvParams, batch: dict, *,
         remat: bool = False, wkv: Optional[Wkv] = None) -> torch.Tensor:
    """Mean token NLL of ``batch`` (``tokens``, ``labels``, optional
    ``mask``).  On the card the forward launches the ``wkv6`` kernel and
    its backward recomputes the plain recurrence
    (:class:`repro_torch.kernels.wkv6.ops.Wkv6Fn`)."""
    logits = forward(cfg, params, batch["tokens"], remat=remat, wkv=wkv)
    return cross_entropy(logits, batch["labels"].to(logits.device),
                         batch.get("mask"))


loss_and_grad = loss_and_grad_of(loss)


# ---------------------------------------------------------------------------
# Decode: one token per call; cache = recurrent states (O(1) in seq len).
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int = 0, dtype=None, *,
               device: DeviceLike = None) -> dict:
    tm, cm, wkv = init_states(cfg, batch, device=device)
    return {"tm": tm, "cm": cm, "wkv": wkv,
            "len": torch.zeros((batch,), dtype=torch.int32, device=wkv.device)}


def decode_step(cfg: ArchConfig, params: RwkvParams, cache: dict,
                tokens: torch.Tensor, *, wkv: Optional[Wkv] = None):
    """Logits (B,V) for one token per sequence.  The cache's ``tm``,
    ``cm`` and ``wkv`` tensors are updated in place (the WKV state by the
    kernel, which reads and writes the same buffer); the returned cache
    holds those tensors and ``len + 1``."""
    x = _embed(params, tokens)[:, None]  # (B,1,D)
    tm, cm, state = cache["tm"], cache["cm"], cache["wkv"]
    for i in range(params.n_layers):
        x, (tm_s, cm_s, _) = _layer_fwd(
            cfg, x, params.layer(i), (tm[i], cm[i], state[i]), wkv=wkv,
            state_out=state[i])
        tm[i] = tm_s
        cm[i] = cm_s
    x = layer_norm(x, params.final_norm["scale"], params.final_norm["bias"])
    logits = (x @ params.lm_head)[:, 0]
    return logits, {"tm": tm, "cm": cm, "wkv": state, "len": cache["len"] + 1}
