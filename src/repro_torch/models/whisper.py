"""Whisper-large-v3 backbone: an encoder-decoder transformer.

The port of ``repro.models.whisper``.  The conv mel frontend is a stub,
as in the reference: ``frames`` (B, n_ctx, D) are precomputed frame
embeddings fed to the encoder.  Learned positional embeddings, pre-LN,
GELU, full attention (K/V heads = heads), a head tied to the embedding.

Cross-attention K/V are computed once a request (``prepare_cross``).  In
``decode_step`` the self-attention goes through the model-level
``attention.decode_attention`` and the cross-attention through
``attend_partial`` + ``merge_partials`` over the encoder's rows, so on
the card a decoder layer launches the ``decode_attention`` kernel twice.
``decode_step`` writes the self-attention cache in place (the reference
returns new arrays).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import transformer as dense
from repro_torch.models.common import (ParamTree, apply_norm, cross_entropy,
                                       dtype_of, embed_init, he,
                                       loss_and_grad_of, maybe_shard,
                                       mlp_apply, mlp_params, norm_params)


class WhisperParams(ParamTree):
    """The parameter tree of one audio model: ``embed`` (the tied head),
    ``enc_pos``, ``dec_pos``, ``enc_layers`` and ``dec_layers`` (stacked
    over their layers), ``enc_norm``, ``final_norm``."""

    @property
    def n_layers(self) -> int:
        return self.dec_layers.n_entries


def _attn_p(cfg: ArchConfig, gen, dt, device) -> dict:
    return attn.attn_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.resolved_head_dim, dt, qkv_bias=True,
                            device=device)


def init_enc_layer(cfg: ArchConfig, gen, device) -> dict:
    dt = dtype_of(cfg.param_dtype)
    D = cfg.d_model
    return {"ln1": norm_params(D, cfg.norm, torch.float32, device=device),
            "attn": _attn_p(cfg, gen, dt, device),
            "ln2": norm_params(D, cfg.norm, torch.float32, device=device),
            "mlp": mlp_params(gen, D, cfg.d_ff, cfg.act, dt, device=device)}


def init_dec_layer(cfg: ArchConfig, gen, device) -> dict:
    dt = dtype_of(cfg.param_dtype)
    D = cfg.d_model
    return {"ln1": norm_params(D, cfg.norm, torch.float32, device=device),
            "attn": _attn_p(cfg, gen, dt, device),
            "ln_x": norm_params(D, cfg.norm, torch.float32, device=device),
            "xattn": _attn_p(cfg, gen, dt, device),
            "ln2": norm_params(D, cfg.norm, torch.float32, device=device),
            "mlp": mlp_params(gen, D, cfg.d_ff, cfg.act, dt, device=device)}


def init(cfg: ArchConfig, seed: Union[int, torch.Generator] = 0, *,
         device: DeviceLike = None) -> WhisperParams:
    """Random parameters from a seeded generator, made on ``device``
    (``cuda`` unless told ``"cpu"``)."""
    device = resolve_device(device)
    gen = dense.generator(seed, device)
    dt = dtype_of(cfg.param_dtype)
    D = cfg.d_model
    return WhisperParams({
        "embed": embed_init(gen, cfg.vocab_padded, D, dt, device=device),
        "enc_pos": he(gen, (cfg.encoder.n_ctx, D), dt, 0.02, device=device),
        "dec_pos": he(gen, (cfg.max_seq, D), dt, 0.02, device=device),
        "enc_layers": dense.stack_layers(
            lambda: init_enc_layer(cfg, gen, device), cfg.encoder.n_layers,
            device),
        "enc_norm": norm_params(D, cfg.norm, torch.float32, device=device),
        "dec_layers": dense.stack_layers(
            lambda: init_dec_layer(cfg, gen, device), cfg.n_layers, device),
        "final_norm": norm_params(D, cfg.norm, torch.float32, device=device),
    })


def _positions(B: int, T: int, device) -> torch.Tensor:
    return torch.arange(T, device=device)[None, :].expand(B, T)


def _enc_layer_fwd(cfg: ArchConfig, x, lp: dict, positions):
    h = apply_norm(x, lp["ln1"], cfg.norm)
    x = x + attn.attention(
        h, lp["attn"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, positions=positions, causal=False,
        use_rope=False)
    h = apply_norm(x, lp["ln2"], cfg.norm)
    return x + mlp_apply(h, lp["mlp"], cfg.act)


def encode(cfg: ArchConfig, params: WhisperParams, frames: torch.Tensor, *,
           remat: bool = False) -> torch.Tensor:
    """frames: (B, n_ctx, D) precomputed mel-frame embeddings (stub).
    Returns the encoder's output (B, n_ctx, D)."""
    B, T, _ = frames.shape
    frames = frames.to(params.enc_pos.device)
    x = maybe_shard(frames + params.enc_pos[None, :T], "act_btd")
    positions = _positions(B, T, x.device)
    body = partial(_enc_layer_fwd, cfg)
    if remat and torch.is_grad_enabled():
        body = partial(checkpoint, body, use_reentrant=False)
    for lp in params.enc_layers.entries():
        x = body(x, lp, positions)
    return apply_norm(x, params.enc_norm, cfg.norm)


def cross_kv(cfg: ArchConfig, xp: dict, enc_out: torch.Tensor):
    """One layer's cross-attention K/V of ``enc_out``: (B, Tc, K, hd) x2."""
    B, Tc, _ = enc_out.shape
    shape = (B, Tc, cfg.n_kv_heads, cfg.resolved_head_dim)
    return ((enc_out @ xp["wk"] + xp["bk"]).reshape(shape),
            (enc_out @ xp["wv"] + xp["bv"]).reshape(shape))


def _dec_layer_fwd(cfg: ArchConfig, x, lp: dict, positions, enc_out,
                   enc_pos):
    h = apply_norm(x, lp["ln1"], cfg.norm)
    x = x + attn.attention(
        h, lp["attn"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, positions=positions, causal=True,
        use_rope=False)
    h = apply_norm(x, lp["ln_x"], cfg.norm)
    k, v = cross_kv(cfg, lp["xattn"], enc_out)
    x = x + attn.attention(
        h, lp["xattn"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, positions=positions, use_rope=False,
        kv_override=(k, v, enc_pos))
    h = apply_norm(x, lp["ln2"], cfg.norm)
    return x + maybe_shard(mlp_apply(h, lp["mlp"], cfg.act), "act_btd")


def head_logits(cfg: ArchConfig, params: WhisperParams, x: torch.Tensor
                ) -> torch.Tensor:
    """Final norm, then the head tied to the embedding."""
    return maybe_shard(apply_norm(x, params.final_norm, cfg.norm)
                       @ params.embed.T, "act_btv")


def forward(cfg: ArchConfig, params: WhisperParams, tokens: torch.Tensor, *,
            frames: torch.Tensor, remat: bool = False,
            last_only: bool = False) -> torch.Tensor:
    """Logits (B,S,V) of decoder ``tokens`` (B,S) over the encoding of
    ``frames``; (B,1,V) with ``last_only``."""
    enc_out = encode(cfg, params, frames, remat=remat)
    B, S = tokens.shape
    x = params.embed[tokens.to(params.embed.device).long()] \
        + params.dec_pos[None, :S]
    x = maybe_shard(x, "act_btd")
    positions = _positions(B, S, x.device)
    enc_pos = _positions(B, enc_out.shape[1], x.device)
    body = partial(_dec_layer_fwd, cfg)
    if remat and torch.is_grad_enabled():
        body = partial(checkpoint, body, use_reentrant=False)
    for lp in params.dec_layers.entries():
        x = body(x, lp, positions, enc_out, enc_pos)
    if last_only:
        x = x[:, -1:]
    return head_logits(cfg, params, x)


def loss(cfg: ArchConfig, params: WhisperParams, batch: dict, *,
         remat: bool = False) -> torch.Tensor:
    """Mean token NLL of ``batch`` (``tokens``, ``labels``, ``frames``,
    optional ``mask``)."""
    logits = forward(cfg, params, batch["tokens"], frames=batch["frames"],
                     remat=remat)
    return cross_entropy(logits, batch["labels"].to(logits.device),
                         batch.get("mask"))


loss_and_grad = loss_and_grad_of(loss)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def prepare_cross(cfg: ArchConfig, params: WhisperParams,
                  enc_out: torch.Tensor):
    """Every decoder layer's cross K/V, computed once a request:
    (L, B, Tc, K, hd) x2."""
    ks, vs = zip(*(cross_kv(cfg, lp["xattn"], enc_out)
                   for lp in params.dec_layers.entries()))
    return torch.stack(ks), torch.stack(vs)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, *,
               device: DeviceLike = None) -> dict:
    """Zero ``k``/``v`` (L, B, max_len, K, hd) self-attention rows,
    ``xk``/``xv`` (L, B, n_ctx, K, hd) cross rows, ``len`` (B,)."""
    device = resolve_device(device)
    dt = dtype or dtype_of(cfg.param_dtype)
    K, hd, L = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    Tc = cfg.encoder.n_ctx

    def z(T: int) -> torch.Tensor:
        return torch.zeros((L, batch, T, K, hd), dtype=dt, device=device)
    return {"k": z(max_len), "v": z(max_len), "xk": z(Tc), "xv": z(Tc),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def decode_step(cfg: ArchConfig, params: WhisperParams, cache: dict,
                tokens: torch.Tensor, *, attend: Optional[Callable] = None
                ) -> tuple[torch.Tensor, dict]:
    """One token for every sequence: (logits (B,V), cache with ``len +
    1``).  ``attend`` replaces the per-partition attention of both the
    self- and the cross-attention (default: the kernel on the card)."""
    attend = attend or attn.attend_partial
    B = tokens.shape[0]
    pos = cache["len"]
    x = params.embed[tokens.to(params.embed.device).long()]
    x = x + params.dec_pos[torch.clamp_max(pos.long(), cfg.max_seq - 1)]
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    xvalid = torch.ones(cache["xk"].shape[1:3], dtype=torch.bool,
                        device=x.device)
    for i, lp in enumerate(params.dec_layers.entries()):
        x = dense.attn_step(cfg, x, lp, cache["k"][i], cache["v"][i], pos,
                            attend=attend)
        h = apply_norm(x, lp["ln_x"], cfg.norm)
        xp = lp["xattn"]
        q = (h @ xp["wq"] + xp["bq"]).reshape(B, H, hd)
        o = attn.merge_partials(
            [attend(q, cache["xk"][i], cache["xv"][i], xvalid)])
        x = x + o.to(x.dtype).reshape(B, H * hd) @ xp["wo"]
        h = apply_norm(x, lp["ln2"], cfg.norm)
        x = x + mlp_apply(h, lp["mlp"], cfg.act)
    return head_logits(cfg, params, x), {**cache, "len": cache["len"] + 1}
