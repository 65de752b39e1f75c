"""Mixture-of-Experts decoder (deepseek-moe-16b, llama4-maverick).

The port of ``repro.models.moe``.  Sort-based token dispatch (no
(T, E, C) one-hot tensor): the (token, choice) pairs are sorted by expert
id (stable), each expert keeps its first ``C`` in capacity slots
(``mode="drop"`` overflow goes to a spare row past the ``E * C`` slots,
which is sliced off), the experts run as batched matmuls, and every
token sums its ``top_k`` weighted outputs.

The combine keeps the reference's order: its ``.at[src_tok].add``
walks the sorted pairs in order, so each token adds its choices in
ascending expert id, one rounding in the activation dtype each.  The
port adds them in that order as ``top_k`` elementwise adds, which needs
no atomics and gives the same bits on every run, where ``index_add_``
on the card would add in whatever order its atomics land.

Shared experts are one dense MLP.  The leading ``first_dense`` dense
layers and the repeating unit (an optional dense layer and a MoE layer,
``every`` in {1, 2}) keep the reference's tree: ``head_dense`` and
``units.{dense,moe}`` stacked over a leading axis.  ``routed_mlp``
takes the single-device path; the reference's expert-parallel
``moe_mlp_ep`` (a mesh's all-to-all) comes with the pod tooling.
``decode_step`` writes the cache in place, as the dense decode does;
``loss`` comes with training.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig, MoESpec
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import transformer as dense
from repro_torch.models.common import (apply_norm, dtype_of, embed_init, he,
                                       mlp_apply, mlp_params, norm_params)


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

    def tree(self) -> dict:
        return {**{k: p for k, p in self._parameters.items()},
                **{k: m.tree() for k, m in self._modules.items()}}

    def views(self, i: int) -> dict:
        """Entry ``i`` of every stacked tensor, as a dict tree."""
        return {**{k: p[i] for k, p in self._parameters.items()},
                **{k: m.views(i) for k, m in self._modules.items()}}


class MoEParams(nn.Module):
    """The parameter tree of one MoE model (inference only: no grads):
    ``embed``, ``head_dense`` (``first_dense`` dense layers, stacked),
    ``units.moe`` and, when ``every == 2``, ``units.dense`` (stacked over
    the units), ``final_norm`` and ``lm_head`` (stored ``(D, V)``)."""

    def __init__(self, embed: torch.Tensor, head_dense: Optional[dict],
                 units: dict, final_norm: dict,
                 lm_head: Optional[torch.Tensor] = None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.head_dense = None if head_dense is None else ParamTree(head_dense)
        self.units = ParamTree(units)
        self.final_norm = ParamTree(final_norm)
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))

    @property
    def n_head(self) -> int:
        if self.head_dense is None:
            return 0
        return self.head_dense["ln1"]["scale"].shape[0]

    @property
    def n_units(self) -> int:
        return self.units["moe"]["ln1"]["scale"].shape[0]

    def _views(self) -> tuple[list, list]:
        cached = self.__dict__.get("_layer_views")
        if cached is None:
            head = [self.head_dense.views(i) for i in range(self.n_head)]
            units = [self.units.views(u) for u in range(self.n_units)]
            cached = self.__dict__["_layer_views"] = (head, units)
        return cached

    def head_layer(self, i: int) -> dict:
        """Leading dense layer ``i``'s parameters (cached views)."""
        return self._views()[0][i]

    def unit(self, u: int) -> dict:
        """Unit ``u``'s ``{"moe": ..., "dense": ...}`` (cached views)."""
        return self._views()[1][u]


# ---------------------------------------------------------------------------
# Expert MLP (stacked over E) + sort-based dispatch
# ---------------------------------------------------------------------------
def expert_params(gen: torch.Generator, E: int, d: int, f: int, act: str,
                  dtype, device=None) -> dict:
    """E experts' MLPs stacked over a leading axis, each drawn with the
    fan-in of its own (d, f) or (f, d) matrix, as the reference's
    ``vmap``-ed ``mlp_params``."""
    if act in ("swiglu", "geglu"):
        return {"w_gate": he(gen, (E, d, f), dtype, device=device),
                "w_up": he(gen, (E, d, f), dtype, device=device),
                "w_down": he(gen, (E, f, d), dtype, device=device)}
    return {"w_up": he(gen, (E, d, f), dtype, device=device),
            "w_down": he(gen, (E, f, d), dtype, device=device)}


def expert_apply(xs: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """xs: (E, C, D) -> (E, C, D) through each expert's MLP."""
    if "w_gate" in p:
        inner = F.silu(torch.bmm(xs, p["w_gate"])) * torch.bmm(xs, p["w_up"])
        return torch.bmm(inner, p["w_down"])
    h = F.gelu(torch.bmm(xs, p["w_up"]), approximate="tanh")
    return torch.bmm(h, p["w_down"])


def capacity(tokens: int, spec: MoESpec) -> int:
    """Slots per expert: ``tokens * top_k / E * capacity_factor``, rounded
    up to a multiple of 8, at least 8."""
    C = int(math.ceil(tokens * spec.top_k / spec.n_experts
                      * spec.capacity_factor))
    return max(8, -(-C // 8) * 8)


def moe_mlp(x2d: torch.Tensor, p: dict, spec: MoESpec, act: str):
    """Routed expert MLP over flat tokens.  Returns (y (T,D), aux)."""
    T, D = x2d.shape
    E, K = spec.n_experts, spec.top_k
    dev = x2d.device
    logits = x2d.to(torch.float32) @ p["router"].to(torch.float32)  # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_ids = torch.topk(probs, K, dim=-1)
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    C = capacity(T, spec)

    flat_ids = gate_ids.reshape(-1)
    flat_w = gate_w.reshape(-1)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    seg_start = torch.searchsorted(sorted_ids,
                                   torch.arange(E, device=dev), right=False)
    pos = torch.arange(T * K, device=dev) - seg_start[sorted_ids]
    keep = pos < C
    dest = torch.where(keep, sorted_ids * C + pos,
                       torch.full_like(pos, E * C))  # overflow -> spare row
    src_tok = order // K

    buf = torch.zeros((E * C + 1, D), dtype=x2d.dtype, device=dev)
    buf[dest] = x2d[src_tok]
    expert_out = expert_apply(buf[:E * C].reshape(E, C, D), p["experts"], act)
    out_buf = expert_out.reshape(E * C, D)
    contrib = out_buf[torch.where(keep, dest, torch.zeros_like(dest))]
    w = (flat_w[order] * keep).to(x2d.dtype)
    contrib = contrib * w[:, None]  # (T*K, D) in sorted order
    # combine in the reference's scatter order: each token's choices by
    # ascending expert id (their order in the stable sort)
    slot_of = torch.empty_like(order)
    slot_of[order] = torch.arange(T * K, device=dev)
    by_id = torch.argsort(gate_ids, dim=-1)  # a token's experts are distinct
    rows = slot_of.reshape(T, K).gather(1, by_id)  # (T, K) sorted positions
    y = contrib[rows[:, 0]]
    for j in range(1, K):
        y = y + contrib[rows[:, j]]

    if spec.n_shared:
        y = y + mlp_apply(x2d, p["shared"], act)

    # Switch-style load-balance + router z-loss.  The histograms add ones
    # (exact in any order) and read nothing back to the host.
    zeros = torch.zeros(E, dtype=torch.float32, device=dev)
    f_e = zeros.index_add(0, gate_ids[:, 0],
                          torch.ones(T, dtype=torch.float32, device=dev)) / T
    p_e = probs.mean(dim=0)
    kept = keep.to(torch.float32)
    aux = {
        "lb_loss": E * torch.sum(f_e * p_e),
        "z_loss": torch.mean(torch.square(torch.logsumexp(logits, dim=-1))),
        "dropped": torch.mean(1.0 - kept),
        # per-expert dispatch histogram of the kept slots: the access
        # signal the hotness ledger places expert weights by
        "expert_counts": zeros.index_add(0, sorted_ids, kept),
    }
    return y, aux


def routed_mlp(x2d: torch.Tensor, p: dict, spec: MoESpec, act: str):
    """The single-device dispatch (one card has no expert-parallel mesh)."""
    return moe_mlp(x2d, p, spec, act)


def moe_layer_params(cfg: ArchConfig, gen: torch.Generator, device) -> dict:
    dt = dtype_of(cfg.param_dtype)
    spec = cfg.moe
    D = cfg.d_model
    p = {
        "ln1": norm_params(D, cfg.norm, torch.float32, device=device),
        "attn": attn.attn_params(gen, D, cfg.n_heads, cfg.n_kv_heads,
                                 cfg.resolved_head_dim, dt, cfg.qkv_bias,
                                 device=device),
        "ln2": norm_params(D, cfg.norm, torch.float32, device=device),
        "router": he(gen, (D, spec.n_experts), torch.float32, device=device),
        "experts": expert_params(gen, spec.n_experts, D, spec.expert_d_ff,
                                 cfg.act, dt, device=device),
    }
    if spec.n_shared:
        # n parallel shared experts == one MLP with n*f hidden units
        p["shared"] = mlp_params(
            gen, D, spec.n_shared * (spec.shared_d_ff or spec.expert_d_ff),
            cfg.act, dt, device=device)
    return p


def _moe_layer_fwd(cfg: ArchConfig, x: torch.Tensor, lp: dict,
                   positions: torch.Tensor):
    h = apply_norm(x, lp["ln1"], cfg.norm)
    h = attn.attention(
        h, lp["attn"], n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, positions=positions, causal=True,
        window=cfg.local_window, rope_theta=cfg.rope_theta,
        rope_pct=cfg.rope_pct, use_rope=cfg.rope)
    x = x + h
    h = apply_norm(x, lp["ln2"], cfg.norm)
    B, S, D = h.shape
    y, aux = routed_mlp(h.reshape(B * S, D), lp, cfg.moe, cfg.act)
    return x + y.reshape(B, S, D), aux


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------
def _unit_structure(cfg: ArchConfig) -> tuple[int, int, bool]:
    """(n_head_dense, n_units, unit_has_dense)."""
    spec = cfg.moe
    rest = cfg.n_layers - spec.first_dense
    assert rest % spec.every == 0, "layer count must fit the MoE pattern"
    return spec.first_dense, rest // spec.every, spec.every == 2


def init(cfg: ArchConfig, seed: Union[int, torch.Generator] = 0, *,
         device: DeviceLike = None) -> MoEParams:
    """Random parameters from a seeded generator, made on ``device``
    (``cuda`` unless told ``"cpu"``), one layer at a time into the stacked
    tensors (the full deepseek-moe-16b is 16.4 B parameters: a unit's
    experts in fp32 are drawn one matrix at a time)."""
    device = resolve_device(device)
    gen = dense.generator(seed, device)
    dt = dtype_of(cfg.param_dtype)
    n_head, n_units, has_dense = _unit_structure(cfg)
    embed = embed_init(gen, cfg.vocab_padded, cfg.d_model, dt, device=device)
    head = None
    if n_head:
        head = dense.stack_layers(lambda: dense.init_layer(cfg, gen, device),
                                  n_head, device)

    def unit() -> dict:
        out = {}
        if has_dense:
            out["dense"] = dense.init_layer(cfg, gen, device)
        out["moe"] = moe_layer_params(cfg, gen, device)
        return out
    units = dense.stack_layers(unit, n_units, device)
    final_norm = norm_params(cfg.d_model, cfg.norm, torch.float32,
                             device=device)
    lm_head = None
    if not cfg.tie_embeddings:
        lm_head = embed_init(gen, cfg.vocab_padded, cfg.d_model, dt,
                             device=device).T.contiguous()
    return MoEParams(embed, head, units, final_norm, lm_head)


def forward(cfg: ArchConfig, params: MoEParams, tokens: torch.Tensor, *,
            prefix_embeds: Optional[torch.Tensor] = None,
            last_only: bool = False) -> torch.Tensor:
    logits, _ = forward_with_aux(cfg, params, tokens,
                                 prefix_embeds=prefix_embeds,
                                 last_only=last_only)
    return logits


def forward_with_aux(cfg: ArchConfig, params: MoEParams,
                     tokens: torch.Tensor, *,
                     prefix_embeds: Optional[torch.Tensor] = None,
                     last_only: bool = False):
    """(logits, aux): aux holds the mean ``lb_loss``/``z_loss`` over the
    units, the mean ``dropped`` share and ``expert_counts`` (E,) summed
    over the units — the histogram a :class:`HotnessLedger` records."""
    x, positions = dense.embed_tokens(params, tokens, prefix_embeds)
    for i in range(params.n_head):
        x = dense._layer_fwd(cfg, x, params.head_layer(i), positions)
    lb = zl = 0.0
    dropped, counts = [], []
    for u in range(params.n_units):
        up = params.unit(u)
        if "dense" in up:
            x = dense._layer_fwd(cfg, x, up["dense"], positions)
        x, aux = _moe_layer_fwd(cfg, x, up["moe"], positions)
        lb, zl = lb + aux["lb_loss"], zl + aux["z_loss"]
        dropped.append(aux["dropped"])
        counts.append(aux["expert_counts"])
    if last_only:
        x = x[:, -1:]
    logits = dense.head_logits(cfg, params, x)
    n = params.n_units
    return logits, {"lb_loss": lb / n, "z_loss": zl / n,
                    "dropped": torch.stack(dropped).mean(),
                    "expert_counts": torch.stack(counts).sum(dim=0)}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
init_cache = dense.init_cache  # same KV layout (uniform attention stack)


def decode_step(cfg: ArchConfig, params: MoEParams, cache: dict,
                tokens: torch.Tensor, *, attend: Optional[Callable] = None
                ) -> tuple[torch.Tensor, dict]:
    """One token for every sequence: (logits (B,V), cache with ``len +
    1``), layer ``li`` attending over ``cache["k"][li]`` (written in
    place).  ``attend`` replaces the per-partition attention."""
    x = params.embed[tokens.to(params.embed.device).long()]
    pos = cache["len"]
    kc, vc = cache["k"], cache["v"]
    li = 0
    for i in range(params.n_head):
        x = dense.dense_step(cfg, x, params.head_layer(i), kc[li], vc[li],
                             pos, attend=attend)
        li += 1
    for u in range(params.n_units):
        up = params.unit(u)
        if "dense" in up:
            x = dense.dense_step(cfg, x, up["dense"], kc[li], vc[li], pos,
                                 attend=attend)
            li += 1
        x = dense.attn_step(cfg, x, up["moe"], kc[li], vc[li], pos,
                            attend=attend)
        h = apply_norm(x, up["moe"]["ln2"], cfg.norm)
        y, _ = routed_mlp(h, up["moe"], cfg.moe, cfg.act)
        x = x + y
        li += 1
    return (dense.head_logits(cfg, params, x),
            {**cache, "len": cache["len"] + 1})
