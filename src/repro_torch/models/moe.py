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
takes the single-device path, or :func:`moe_mlp_ep` when the installed
policy's ``_ep`` holds a ``torch.distributed`` process group whose size
divides the experts and the tokens: the reference's expert-parallel
dispatch (per-rank routing, one all-to-all each way), where the
reference's runs over a mesh axis in ``shard_map``.
``decode_step`` writes the cache in place, as the dense decode does.
``loss`` adds the routers' load-balance and z losses to the token NLL.

DeepSeek-V2 (``configs/deepseek_v2_lite.py``), which the reference does
not have: its layers' attention is latent (:mod:`repro_torch.models.mla`),
its gates may stay unnormalised (``MoESpec.norm_topk``), and a
:class:`HeldMoESpec` layer computes only the experts this card holds of
an expert-parallel deployment, dropless (:func:`held_moe_mlp`), with the
sequence-wise balance loss.  Such a configuration trains; its decode is
refused.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, NamedTuple, Optional, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, HeldMoESpec, MoESpec
from repro_torch.core.telemetry import span
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mla
from repro_torch.models import transformer as dense
from repro_torch.models.common import (ParamTree, apply_norm, cross_entropy,
                                       current_policy, dtype_of, embed_init,
                                       he, loss_and_grad_of, maybe_shard,
                                       mlp_apply, mlp_params, norm_params)


class MoEParams(nn.Module):
    """The parameter tree of one MoE model, frozen outside
    :func:`loss_and_grad` (which trains it): ``embed``, ``head_dense``
    (``first_dense`` dense layers, stacked), ``units.moe`` and, when
    ``every == 2``, ``units.dense`` (stacked over the units),
    ``final_norm`` and ``lm_head`` (stored ``(D, V)``)."""

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

    def trees(self) -> tuple[list, list]:
        """(the leading dense layers' trees, the units' ``{"moe": ...,
        "dense": ...}`` trees): cached views, or fresh ones while autograd
        records (:meth:`ParamTree.entries`)."""
        head = [] if self.head_dense is None else self.head_dense.entries()
        return head, self.units.entries()

    def head_layer(self, i: int) -> dict:
        """Leading dense layer ``i``'s parameters (cached views)."""
        return self.head_dense.entries()[i]

    def unit(self, u: int) -> dict:
        """Unit ``u``'s ``{"moe": ..., "dense": ...}`` (cached views)."""
        return self.units.entries()[u]


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


class Route(NamedTuple):
    """A batch's routing over its T * top_k (token, choice) pairs, sorted
    stably by expert id: ``order`` the pairs' sort, ``keep`` whether a
    pair got one of its expert's ``C`` slots, ``dest`` its slot (an
    overflow pair's is the spare row ``E * C``), ``weights`` its gate
    weight (0 when dropped)."""
    logits: torch.Tensor  # (T, E) fp32
    probs: torch.Tensor
    gate_ids: torch.Tensor  # (T, top_k)
    order: torch.Tensor
    sorted_ids: torch.Tensor
    keep: torch.Tensor
    dest: torch.Tensor
    weights: torch.Tensor


def _route(x2d: torch.Tensor, router: torch.Tensor, spec: MoESpec,
           C: int) -> Route:
    """Top-k routing with ``C`` slots an expert."""
    T = x2d.shape[0]
    E, K = spec.n_experts, spec.top_k
    dev = x2d.device
    logits = x2d.to(torch.float32) @ router.to(torch.float32)  # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_ids = torch.topk(probs, K, dim=-1)
    if spec.norm_topk:
        gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)
    flat_ids = gate_ids.reshape(-1)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    seg_start = torch.searchsorted(sorted_ids,
                                   torch.arange(E, device=dev), right=False)
    pos = torch.arange(T * K, device=dev) - seg_start[sorted_ids]
    keep = pos < C
    dest = torch.where(keep, sorted_ids * C + pos,
                       torch.full_like(pos, E * C))  # overflow -> spare row
    w = (gate_w.reshape(-1)[order] * keep).to(x2d.dtype)
    return Route(logits, probs, gate_ids, order, sorted_ids, keep, dest, w)


def _combine(out_buf: torch.Tensor, route: Route, T: int, K: int,
             row: Optional[torch.Tensor] = None,
             mine: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Each token's sum of its pairs' outputs, weighted, in the
    reference's scatter order: a token's choices by ascending expert id
    (their order in the stable sort).  ``row`` (T*K,) gives each sorted
    pair's row of ``out_buf`` (by default its kept slot of the (E*C, D)
    buffer); with ``mine`` (T*K,) a pair it leaves out adds nothing."""
    order, gate_ids, dest = route.order, route.gate_ids, route.dest
    if row is None:
        row = torch.where(route.keep, dest, torch.zeros_like(dest))
    slot_of = torch.empty_like(order)
    slot_of[order] = torch.arange(T * K, device=order.device)
    by_id = torch.argsort(gate_ids, dim=-1)  # a token's experts are distinct
    rows = slot_of.reshape(T, K).gather(1, by_id)  # (T, K) sorted positions
    y = None
    for j in range(K):
        pos = rows[:, j]
        part = out_buf[row[pos]]
        if mine is not None:  # before the weight: a left-out row is garbage
            part = torch.where(mine[pos, None], part, 0)
        part = part * route.weights[pos, None]
        y = part if y is None else y + part
    return y


def _dispatch(x2d: torch.Tensor, route: Route, E: int, C: int
              ) -> torch.Tensor:
    """The (E*C, D) expert-major slot buffer of the kept pairs' tokens."""
    buf = torch.zeros((E * C + 1, x2d.shape[1]), dtype=x2d.dtype,
                      device=x2d.device)
    # (T*K, D) token-major: pair i is token order[i] // top_k's
    top_k = route.gate_ids.shape[1]
    buf[route.dest] = maybe_shard(x2d[route.order // top_k], "act_td")
    return buf[:E * C]


def _aux(route: Route, E: int) -> tuple:
    """This batch's load-balance terms: (top-1 share f_e, mean router
    probability p_e, z-loss, dropped share, kept-slot histogram).  The
    histograms add ones (exact in any order) and read nothing back to
    the host."""
    logits, probs, gate_ids = route.logits, route.probs, route.gate_ids
    sorted_ids, keep = route.sorted_ids, route.keep
    T = logits.shape[0]
    zeros = torch.zeros(E, dtype=torch.float32, device=logits.device)
    f_e = zeros.index_add(0, gate_ids[:, 0], torch.ones(
        T, dtype=torch.float32, device=logits.device)) / T
    kept = keep.to(torch.float32)
    return (f_e, probs.mean(dim=0),
            torch.mean(torch.square(torch.logsumexp(logits, dim=-1))),
            torch.mean(1.0 - kept),
            # per-expert dispatch histogram of the kept slots: the access
            # signal the hotness ledger places expert weights by
            zeros.index_add(0, sorted_ids, kept))


def moe_mlp(x2d: torch.Tensor, p: dict, spec: MoESpec, act: str):
    """Routed expert MLP over flat tokens.  Returns (y (T,D), aux)."""
    T, D = x2d.shape
    E, K = spec.n_experts, spec.top_k
    C = capacity(T, spec)
    x2d = maybe_shard(x2d, "act_td")
    route = _route(x2d, p["router"], spec, C)
    buf = maybe_shard(_dispatch(x2d, route, E, C), "act_ecd_flat")
    expert_in = maybe_shard(buf.reshape(E, C, D), "act_ecd")
    expert_out = maybe_shard(expert_apply(expert_in, p["experts"], act),
                             "act_ecd")
    out_buf = maybe_shard(expert_out.reshape(E * C, D), "act_ecd_flat")
    y = maybe_shard(_combine(out_buf, route, T, K), "act_td")
    if spec.n_shared:
        y = y + mlp_apply(x2d, p["shared"], act)
    f_e, p_e, z, dropped, counts = _aux(route, E)
    return y, {"lb_loss": E * torch.sum(f_e * p_e), "z_loss": z,
               "dropped": dropped, "expert_counts": counts}


def moe_mlp_ep(x2d: torch.Tensor, p: dict, spec: MoESpec, act: str, group):
    """Expert-parallel dispatch over the ``torch.distributed`` process
    group ``group`` (``None``: the default group): the reference's
    ``moe_mlp_ep``, whose mesh axis becomes the group's ranks.

    Every rank calls it with the same ``x2d`` (T, D) and the whole tree,
    as the reference's global view.  Rank ``r`` routes tokens
    [r T/n, (r+1) T/n) with the reference's per-shard capacity ``C``,
    sends each expert's slots to the rank that owns it (one
    ``all_to_all``), runs its experts [r E/n, (r+1) E/n) and sends the
    outputs back (one ``all_to_all``); ``pmean``/``psum`` of the aux terms
    are ``all_reduce``s.  The ranks' outputs are then all-gathered, so
    each returns the whole (T, D), where the reference's stays sharded.
    Not differentiable (the collectives are torch.distributed's own)."""
    T, D = x2d.shape
    E, K = spec.n_experts, spec.top_k
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    E_loc, T_loc = E // n, T // n
    C = int(math.ceil(T_loc * K / E * spec.capacity_factor))
    C = max(4, -(-C // 4) * 4)

    x_loc = x2d[rank * T_loc:(rank + 1) * T_loc]
    route = _route(x_loc, p["router"], spec, C)
    # -> expert ranks: (n, E_loc*C, D), dim 0 the destination rank
    send = _dispatch(x_loc, route, E, C).reshape(n, E_loc * C, D)
    recv = torch.empty_like(send)  # dim 0 the source rank
    dist.all_to_all_single(recv, send.contiguous(), group=group)
    ein = recv.reshape(n, E_loc, C, D).transpose(0, 1).reshape(
        E_loc, n * C, D)
    mine = {k: w[rank * E_loc:(rank + 1) * E_loc]
            for k, w in p["experts"].items()}
    eout = expert_apply(ein, mine, act)
    back = eout.reshape(E_loc, n, C, D).transpose(0, 1).reshape(
        n, E_loc * C, D).contiguous()
    got = torch.empty_like(back)
    dist.all_to_all_single(got, back, group=group)
    y_loc = _combine(got.reshape(E * C, D), route, T_loc, K)
    parts = [torch.empty_like(y_loc) for _ in range(n)]
    dist.all_gather(parts, y_loc.contiguous(), group=group)
    y = torch.cat(parts)

    f_e, p_e, z, dropped, counts = _aux(route, E)
    means = torch.cat([f_e, p_e, z[None], dropped[None]])
    dist.all_reduce(means, group=group)
    dist.all_reduce(counts, group=group)
    means = means / n
    f_e, p_e, z, dropped = means[:E], means[E:2 * E], means[2 * E], \
        means[2 * E + 1]
    if spec.n_shared:
        y = y + mlp_apply(x2d, p["shared"], act)
    return y, {"lb_loss": E * torch.sum(f_e * p_e), "z_loss": z,
               "dropped": dropped, "expert_counts": counts}


def _ep_group():
    """The process group of the installed policy's ``_ep``, if it holds
    one (a launch policy's mesh record does not: one card runs every
    expert)."""
    pol = current_policy()
    ep = pol.get("_ep") if pol else None
    if dist.is_available() and isinstance(ep, dist.ProcessGroup):
        return ep
    return None


def routed_mlp(x2d: torch.Tensor, p: dict, spec: MoESpec, act: str):
    """Expert-parallel dispatch when the policy provides a group whose
    size divides the experts and the tokens; else the single-device
    dispatch."""
    group = _ep_group()
    if group is not None:
        n = dist.get_world_size(group)
        if spec.n_experts % n == 0 and x2d.shape[0] % n == 0:
            return moe_mlp_ep(x2d, p, spec, act, group)
    return moe_mlp(x2d, p, spec, act)


# ---------------------------------------------------------------------------
# Held experts (DeepSeek-V2 on one card of an expert-parallel deployment)
# ---------------------------------------------------------------------------
def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor
               ) -> torch.Tensor:
    """Rows ``[ends[g-1], ends[g])`` of ``x`` (M, a) times ``w[g]`` (a, b),
    ``ends`` (G,) int32 cumulative on the device: (M, b), its rows from
    ``ends[-1]`` on undefined (the caller masks them).  On the card,
    ``torch._grouped_mm`` (bf16; it takes the ends on the device, so
    nothing is read back); on the CPU :func:`grouped_mm_by_group`."""
    if x.is_cuda:
        return torch._grouped_mm(x, w, offs=ends)
    return grouped_mm_by_group(x, w, ends)


def grouped_mm_by_group(x: torch.Tensor, w: torch.Tensor,
                        ends: torch.Tensor) -> torch.Tensor:
    """:func:`grouped_mm` as one product a group, the rows from
    ``ends[-1]`` on zeros: the CPU's path, and the card's fp32 reference
    in its test (it reads ``ends`` to the host)."""
    parts, lo = [], 0
    for g, hi in enumerate(ends.tolist()):
        parts.append(x[lo:hi] @ w[g])
        lo = hi
    parts.append(x.new_zeros((x.shape[0] - lo, w.shape[-1])))
    return torch.cat(parts)


def grouped_expert_apply(xs: torch.Tensor, p: dict, ends: torch.Tensor,
                         act: str) -> torch.Tensor:
    """xs (M, D) grouped by expert (``ends``) -> (M, D) through each
    group's expert MLP (:func:`expert_apply` over segments)."""
    if "w_gate" in p:
        inner = F.silu(grouped_mm(xs, p["w_gate"], ends)) \
            * grouped_mm(xs, p["w_up"], ends)
    else:
        inner = F.gelu(grouped_mm(xs, p["w_up"], ends), approximate="tanh")
    return grouped_mm(inner, p["w_down"], ends)


def seq_balance(route: Route, n_seqs: int, E: int) -> torch.Tensor:
    """DeepSeek-V2's sequence-wise balance term (arXiv:2405.04434
    §2.2.3), the mean over sequences of ``sum_i f_i P_i``: ``f_i`` expert
    ``i``'s share of the sequence's (token, choice) pairs times ``E``,
    ``P_i`` its mean router probability over the sequence's tokens.  The
    counts add ones (exact in any order)."""
    T, K = route.gate_ids.shape
    S = T // n_seqs
    ids = route.gate_ids.reshape(n_seqs, S * K)
    counts = torch.zeros((n_seqs, E), dtype=torch.float32,
                         device=ids.device).scatter_add_(
        1, ids, torch.ones(ids.shape, dtype=torch.float32,
                           device=ids.device))
    f = counts * (E / (S * K))
    P = route.probs.reshape(n_seqs, S, E).mean(dim=1)
    return (f * P).sum(dim=1).mean()


def held_moe_mlp(x2d: torch.Tensor, p: dict, spec: HeldMoESpec, act: str,
                 n_seqs: int = 1):
    """This card's share of a MoE layer: route each token over all
    ``n_experts`` (softmax, greedy top-k, gates as ``spec.norm_topk``
    says), compute every (token, choice) pair routed to a held expert
    (``spec.held``; ``p["experts"]`` stacked over them), none dropped, and
    give each token the weighted sum of its held choices, in ascending
    expert id; pairs routed elsewhere add nothing here (another card
    computes them).  The shared experts are computed whole.

    No count is read back to the host: the held pairs, a contiguous run
    of the expert-sorted pairs, fill the first rows of a buffer of
    ``T min(top_k, n_held)`` rows (as many as there can be), and the
    grouped products take the experts' ends on the device.  The buffer's
    other rows are masked out both ways.  Spans: ``repro.moe.route``
    (router, top-k, sort), ``repro.moe.dispatch``, ``repro.moe.experts``
    (the held experts' products), ``repro.moe.combine``.  Returns (y
    (T, D), aux: ``seq_lb`` over ``n_seqs`` sequences, ``lb_loss``,
    ``z_loss``, ``dropped`` 0 and ``expert_counts`` (n_held,), the held
    experts' pairs)."""
    T, D = x2d.shape
    E, K, held = spec.n_experts, spec.top_k, spec.held
    M = T * min(K, len(held))
    dev = x2d.device
    with span("repro.moe.route"):
        # T slots an expert: a token's choices are distinct, so none drop
        route = _route(x2d, p["router"], spec, T)
        bounds = torch.searchsorted(route.sorted_ids, torch.arange(
            held.start, held.stop + 1, device=dev))
        lo = bounds[0]
        ends = (bounds[1:] - lo).to(torch.int32)
    with span("repro.moe.dispatch"):
        src = lo + torch.arange(M, device=dev)
        valid = src < bounds[-1]
        pair = route.order[torch.clamp_max(src, T * K - 1)]
        xs = torch.where(valid[:, None], x2d[pair // K], 0)
    with span("repro.moe.experts"):
        ys = grouped_expert_apply(xs, p["experts"], ends, act)
    with span("repro.moe.combine"):
        at = torch.arange(T * K, device=dev)
        y = _combine(ys, route, T, K, row=torch.clamp(at - lo, 0, M - 1),
                     mine=(at >= lo) & (at < bounds[-1]))
    if spec.n_shared:
        y = y + mlp_apply(x2d, p["shared"], act)
    f_e, p_e, z, _, counts = _aux(route, E)
    return y, {"seq_lb": seq_balance(route, n_seqs, E),
               "lb_loss": E * torch.sum(f_e * p_e), "z_loss": z,
               "dropped": torch.zeros((), device=dev),
               "expert_counts": counts[held.start:held.stop]}


def moe_layer_params(cfg: ArchConfig, gen: torch.Generator, device) -> dict:
    dt = dtype_of(cfg.param_dtype)
    spec = cfg.moe
    D = cfg.d_model
    n_local = len(spec.held) if isinstance(spec, HeldMoESpec) \
        else spec.n_experts
    p = {
        "ln1": norm_params(D, cfg.norm, torch.float32, device=device),
        "attn": _attn_params(cfg, gen, dt, device),
        "ln2": norm_params(D, cfg.norm, torch.float32, device=device),
        "router": he(gen, (D, spec.n_experts), torch.float32, device=device),
        "experts": expert_params(gen, n_local, D, spec.expert_d_ff,
                                 cfg.act, dt, device=device),
    }
    if spec.n_shared:
        # n parallel shared experts == one MLP with n*f hidden units
        p["shared"] = mlp_params(
            gen, D, spec.n_shared * (spec.shared_d_ff or spec.expert_d_ff),
            cfg.act, dt, device=device)
    return p


def _attn_params(cfg: ArchConfig, gen: torch.Generator, dt, device
                 ) -> dict:
    """A layer's attention: latent (``cfg.mla``) or GQA."""
    if cfg.mla is not None:
        return mla.mla_params(gen, cfg, dt, device=device)
    return attn.attn_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.resolved_head_dim, dt, cfg.qkv_bias,
                            device=device)


def _attend(cfg: ArchConfig, h: torch.Tensor, p: dict,
            positions: torch.Tensor) -> torch.Tensor:
    if cfg.mla is not None:
        return mla.mla_attention(h, p, cfg, positions)
    return attn.attention(
        h, p, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, positions=positions, causal=True,
        window=cfg.local_window, rope_theta=cfg.rope_theta,
        rope_pct=cfg.rope_pct, use_rope=cfg.rope)


def _dense_layer_params(cfg: ArchConfig, gen: torch.Generator, device
                        ) -> dict:
    """A dense layer: the transformer's, its attention latent when
    ``cfg.mla`` says so."""
    if cfg.mla is None:
        return dense.init_layer(cfg, gen, device)
    dt = dtype_of(cfg.param_dtype)
    D = cfg.d_model
    return {"ln1": norm_params(D, cfg.norm, torch.float32, device=device),
            "attn": mla.mla_params(gen, cfg, dt, device=device),
            "ln2": norm_params(D, cfg.norm, torch.float32, device=device),
            "mlp": mlp_params(gen, D, cfg.d_ff, cfg.act, dt, device=device)}


def _dense_layer_fwd(cfg: ArchConfig, x: torch.Tensor, lp: dict,
                     positions: torch.Tensor) -> torch.Tensor:
    if cfg.mla is None:
        return dense._layer_fwd(cfg, x, lp, positions)
    x = x + _attend(cfg, apply_norm(x, lp["ln1"], cfg.norm), lp["attn"],
                    positions)
    h = apply_norm(x, lp["ln2"], cfg.norm)
    return x + mlp_apply(h, lp["mlp"], cfg.act)


def _moe_layer_fwd(cfg: ArchConfig, x: torch.Tensor, lp: dict,
                   positions: torch.Tensor):
    h = apply_norm(x, lp["ln1"], cfg.norm)
    x = x + _attend(cfg, h, lp["attn"], positions)
    h = apply_norm(x, lp["ln2"], cfg.norm)
    B, S, D = h.shape
    if isinstance(cfg.moe, HeldMoESpec):
        y, aux = held_moe_mlp(h.reshape(B * S, D), lp, cfg.moe, cfg.act,
                              n_seqs=B)
    else:
        y, aux = routed_mlp(h.reshape(B * S, D), lp, cfg.moe, cfg.act)
    return x + maybe_shard(y.reshape(B, S, D), "act_btd"), aux


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
        head = dense.stack_layers(lambda: _dense_layer_params(cfg, gen, device),
                                  n_head, device)

    def unit() -> dict:
        out = {}
        if has_dense:
            out["dense"] = _dense_layer_params(cfg, gen, device)
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
            remat: bool = False, last_only: bool = False) -> torch.Tensor:
    logits, _ = forward_with_aux(cfg, params, tokens,
                                 prefix_embeds=prefix_embeds, remat=remat,
                                 last_only=last_only)
    return logits


def forward_with_aux(cfg: ArchConfig, params: MoEParams,
                     tokens: torch.Tensor, *,
                     prefix_embeds: Optional[torch.Tensor] = None,
                     remat: bool = False, last_only: bool = False):
    """(logits, aux): aux holds the mean ``lb_loss``/``z_loss`` over the
    units, the mean ``dropped`` share and ``expert_counts`` (E,) summed
    over the units — the histogram a :class:`HotnessLedger` records (a
    held share's: its held experts' pairs) — and, for a held share,
    ``seq_lb`` summed over the units.  ``remat`` recomputes each layer in
    the backward pass."""
    x, positions = dense.embed_tokens(params, tokens, prefix_embeds)
    dense_fwd = partial(_dense_layer_fwd, cfg)
    moe_fwd = partial(_moe_layer_fwd, cfg)
    if remat and torch.is_grad_enabled():
        dense_fwd = partial(checkpoint, dense_fwd, use_reentrant=False)
        moe_fwd = partial(checkpoint, moe_fwd, use_reentrant=False)
    heads, units = params.trees()
    for lp in heads:
        x = dense_fwd(x, lp, positions)
    lb = zl = seq = 0.0
    dropped, counts = [], []
    for up in units:
        if "dense" in up:
            x = dense_fwd(x, up["dense"], positions)
        x, aux = moe_fwd(x, up["moe"], positions)
        lb, zl = lb + aux["lb_loss"], zl + aux["z_loss"]
        seq = seq + aux.get("seq_lb", 0.0)
        dropped.append(aux["dropped"])
        counts.append(aux["expert_counts"])
    if last_only:
        x = x[:, -1:]
    logits = dense.head_logits(cfg, params, x)
    n = params.n_units
    out = {"lb_loss": lb / n, "z_loss": zl / n,
           "dropped": torch.stack(dropped).mean(),
           "expert_counts": torch.stack(counts).sum(dim=0)}
    if isinstance(cfg.moe, HeldMoESpec):
        out["seq_lb"] = seq
    return logits, out


def loss(cfg: ArchConfig, params: MoEParams, batch: dict, *,
         remat: bool = False,
         expert_counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token NLL plus the routers' auxiliary losses: ``nll + 0.01 lb +
    router_zloss z``, as the reference; with ``seq_aux_alpha`` (DeepSeek-
    V2) ``nll + seq_aux_alpha * seq_lb`` instead, the sequence-wise term
    summed over the MoE layers.  ``expert_counts``, a float32 tensor of
    ``forward_with_aux``'s ``expert_counts`` shape on the device, gets the
    batch's histogram added in place (nothing is read to the host)."""
    logits, aux = forward_with_aux(
        cfg, params, batch["tokens"],
        prefix_embeds=batch.get("prefix_embeds"), remat=remat)
    if expert_counts is not None:
        expert_counts.add_(aux["expert_counts"].detach())
    nll = cross_entropy(logits, batch["labels"].to(logits.device),
                        batch.get("mask"))
    if cfg.moe.seq_aux_alpha:
        return nll + cfg.moe.seq_aux_alpha * aux["seq_lb"]
    return nll + 0.01 * aux["lb_loss"] + cfg.moe.router_zloss * aux["z_loss"]


loss_and_grad = loss_and_grad_of(loss)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=None, *,
               device: DeviceLike = None) -> dict:
    """The dense transformer's cache (the same KV layout: a uniform
    attention stack); a latent configuration is refused."""
    mla.refuse_decode(cfg)
    return dense.init_cache(cfg, batch, max_len, dtype, device=device)


def decode_step(cfg: ArchConfig, params: MoEParams, cache: dict,
                tokens: torch.Tensor, *, attend: Optional[Callable] = None
                ) -> tuple[torch.Tensor, dict]:
    """One token for every sequence: (logits (B,V), cache with ``len +
    1``), layer ``li`` attending over ``cache["k"][li]`` (written in
    place).  ``attend`` replaces the per-partition attention.  A latent
    configuration is refused."""
    mla.refuse_decode(cfg)
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
