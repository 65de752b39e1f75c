"""Dense decoder-only transformer parameters (qwen2.5/qwen1.5, starcoder2,
stablelm, the InternLM2 backbone of internvl2).

``init`` builds the parameters as an ``nn.Module`` whose names follow the
reference's tree — ``embed``, ``layers.ln1.scale``, ``layers.attn.wq``,
…, ``final_norm.scale``, ``lm_head`` (stored transposed, ``(D, V)``) —
with every layer parameter stacked over a leading ``L`` axis, as the
reference's ``vmap``-ed init stacks them.

``forward`` (full sequence, ``last_only`` for a prefill) and the untiered
``decode_step`` over ``init_cache`` are the reference's; the MoE family's
dense layers run through ``_layer_fwd`` and the same decode layers.
``decode_step`` writes each layer's new K/V row into the cache in place
(the reference returns new arrays); the returned cache shares the
tensors.  ``loss`` comes with the training slice; the tiered serving path
decodes through :func:`repro_torch.serving.kv_cache.tiered_decode_step`."""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import (apply_norm, dtype_of, embed_init,
                                       mlp_apply, mlp_params, norm_params)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _group(tree: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _frozen(v) for k, v in tree.items()})


class DenseParams(nn.Module):
    """The parameter tree of one dense model (inference only: no grads)."""

    def __init__(self, embed: torch.Tensor, layers: dict, final_norm: dict,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = _frozen(embed)
        self.layers = nn.ModuleDict({k: _group(v) for k, v in layers.items()})
        self.final_norm = _group(final_norm)
        self.lm_head = None if lm_head is None else _frozen(lm_head)

    @property
    def n_layers(self) -> int:
        return self.layers["ln1"]["scale"].shape[0]

    def layer(self, i: int) -> dict:
        """Layer ``i``'s parameters as a dict tree of views (cached: the
        decode step reads every layer every step)."""
        views = self.__dict__.get("_layer_views")
        if views is None:
            views = [{g: {k: p[j] for k, p in grp.items()}
                      for g, grp in self.layers.items()}
                     for j in range(self.n_layers)]
            self.__dict__["_layer_views"] = views
        return views[i]


def generator(seed: Union[int, torch.Generator], device: torch.device
              ) -> torch.Generator:
    """``seed`` itself when it is a generator, else a new one on
    ``device`` seeded with it."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


def init_layer(cfg: ArchConfig, gen: torch.Generator, device) -> dict:
    """One dense layer's parameters (the reference's ``init_layer``)."""
    dt = dtype_of(cfg.param_dtype)
    D = cfg.d_model
    return {
        "ln1": norm_params(D, cfg.norm, torch.float32, device=device),
        "attn": attn.attn_params(gen, D, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.resolved_head_dim, dt, cfg.qkv_bias,
                                 device=device),
        "ln2": norm_params(D, cfg.norm, torch.float32, device=device),
        "mlp": mlp_params(gen, D, cfg.d_ff, cfg.act, dt, device=device),
    }


def stack_layers(make: Callable[[], dict], n: int, device) -> dict:
    """``n`` draws of ``make()`` (a tree of tensors) stacked over a leading
    axis, drawn one at a time into the stacked tensors."""
    def alloc(v):
        if isinstance(v, dict):
            return {k: alloc(x) for k, x in v.items()}
        return torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                           device=device)

    def put(out, v, i):
        if isinstance(v, dict):
            for k, x in v.items():
                put(out[k], x, i)
        else:
            out[i] = v
    first = make()
    out = alloc(first)
    put(out, first, 0)
    for i in range(1, n):
        put(out, make(), i)
    return out


def init(cfg: ArchConfig, seed: Union[int, torch.Generator] = 0, *,
         device: DeviceLike = None) -> DenseParams:
    """Random parameters from a seeded generator, made on ``device``
    (``cuda`` unless told ``"cpu"``)."""
    device = resolve_device(device)
    gen = generator(seed, device)
    dt = dtype_of(cfg.param_dtype)
    D, L, hd = cfg.d_model, cfg.n_layers, cfg.resolved_head_dim
    embed = embed_init(gen, cfg.vocab_padded, D, dt, device=device)

    def stacked(make) -> dict:
        first = make()
        out = {k: torch.empty((L,) + tuple(v.shape), dtype=v.dtype,
                              device=device) for k, v in first.items()}
        for k, v in first.items():
            out[k][0] = v
        for i in range(1, L):
            for k, v in make().items():
                out[k][i] = v
        return out

    layers = {
        "ln1": stacked(lambda: norm_params(D, cfg.norm, torch.float32,
                                           device=device)),
        "attn": stacked(lambda: attn.attn_params(
            gen, D, cfg.n_heads, cfg.n_kv_heads, hd, dt, cfg.qkv_bias,
            device=device)),
        "ln2": stacked(lambda: norm_params(D, cfg.norm, torch.float32,
                                           device=device)),
        "mlp": stacked(lambda: mlp_params(gen, D, cfg.d_ff, cfg.act, dt,
                                          device=device)),
    }
    final_norm = norm_params(D, cfg.norm, torch.float32, device=device)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = embed_init(gen, cfg.vocab_padded, D, dt,
                             device=device).T.contiguous()
    return DenseParams(embed, layers, final_norm, lm_head)


# ---------------------------------------------------------------------------
# Full sequence
# ---------------------------------------------------------------------------
def _layer_fwd(cfg: ArchConfig, x: torch.Tensor, lp: dict,
               positions: torch.Tensor) -> torch.Tensor:
    h = apply_norm(x, lp["ln1"], cfg.norm)
    h = attn.attention(
        h, lp["attn"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, positions=positions, causal=True,
        window=cfg.local_window, rope_theta=cfg.rope_theta,
        rope_pct=cfg.rope_pct, use_rope=cfg.rope)
    x = x + h
    h = apply_norm(x, lp["ln2"], cfg.norm)
    return x + mlp_apply(h, lp["mlp"], cfg.act)


def embed_tokens(params, tokens: torch.Tensor,
                 prefix_embeds: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(x (B,S,D), positions (B,S)): the embedding rows of ``tokens``,
    the first ``P`` replaced by ``prefix_embeds`` (B,P,D) when given."""
    B, S = tokens.shape
    x = params.embed[tokens.to(params.embed.device).long()]
    if prefix_embeds is not None:
        P = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(x.dtype), x[:, P:]], dim=1)
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    return x, positions


def head_logits(cfg: ArchConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm, then the (tied or separate) output head."""
    x = apply_norm(x, params.final_norm, cfg.norm)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    return x @ head


def forward(cfg: ArchConfig, params: DenseParams, tokens: torch.Tensor, *,
            prefix_embeds: Optional[torch.Tensor] = None,
            last_only: bool = False) -> torch.Tensor:
    """Logits (B,S,V) of ``tokens`` (B,S); (B,1,V) with ``last_only``."""
    x, positions = embed_tokens(params, tokens, prefix_embeds)
    for i in range(params.n_layers):
        x = _layer_fwd(cfg, x, params.layer(i), positions)
    if last_only:
        x = x[:, -1:]
    return head_logits(cfg, params, x)


# ---------------------------------------------------------------------------
# Decode over an untiered KV cache
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, *,
               device: DeviceLike = None) -> dict:
    """``{"k", "v": (L, B, T, K, hd), "len": (B,) int32}``, zeros; T is
    ``max_len``, or the local window when the model has one."""
    device = resolve_device(device)
    dt = dtype or dtype_of(cfg.param_dtype)
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    T = min(max_len, cfg.local_window) if cfg.local_window else max_len
    shape = (cfg.n_layers, batch, T, K, hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def attn_step(cfg: ArchConfig, x: torch.Tensor, lp: dict,
              kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor, *,
              attend: Optional[Callable] = None) -> torch.Tensor:
    """A decode layer's attention half: x (B,D) plus its attention over
    the layer's cache ``kc``/``vc``, which takes the new row in place."""
    h = apply_norm(x, lp["ln1"], cfg.norm)
    h, _, _ = attn.decode_attention(
        h, lp["attn"], kc, vc, pos, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
        positions=pos, rope_theta=cfg.rope_theta, rope_pct=cfg.rope_pct,
        use_rope=cfg.rope, window=cfg.local_window, attend=attend)
    return x + h


def dense_step(cfg: ArchConfig, x: torch.Tensor, lp: dict, kc, vc, pos, *,
               attend: Optional[Callable] = None) -> torch.Tensor:
    x = attn_step(cfg, x, lp, kc, vc, pos, attend=attend)
    h = apply_norm(x, lp["ln2"], cfg.norm)
    return x + mlp_apply(h, lp["mlp"], cfg.act)


def decode_step(cfg: ArchConfig, params: DenseParams, cache: dict,
                tokens: torch.Tensor, *, attend: Optional[Callable] = None
                ) -> tuple[torch.Tensor, dict]:
    """One token for every sequence: (logits (B,V), cache with ``len +
    1``).  ``attend`` replaces the per-partition attention."""
    x = params.embed[tokens.to(params.embed.device).long()]
    pos = cache["len"]
    for i in range(params.n_layers):
        x = dense_step(cfg, x, params.layer(i), cache["k"][i],
                       cache["v"][i], pos, attend=attend)
    return head_logits(cfg, params, x), {**cache, "len": cache["len"] + 1}
