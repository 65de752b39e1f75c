"""Step functions and abstract inputs for every (arch x shape) cell.

``make_train_step`` builds the training step: micro-batched gradient
accumulation with per-layer remat, fp32 gradient accumulators, the fused
AdamW update (or the gradients returned, for a tiered optimizer).
``make_serve_step`` / ``make_prefill_step`` build the decode and prefill
steps.  ``input_specs`` gives the abstract inputs of a cell: the family's
``init`` and ``init_cache`` run on ``device="cpu"`` under one
``FakeTensorMode``, so nothing of model scale is allocated, with the
sharding specs the reference would place them by.  The same step
functions run on real tensors on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.launch import shardings as shmod
from repro_torch.launch.mesh import Mesh, chips, dp_axes, dp_size
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models.common import activation_sharding, dtype_of
from repro_torch.models.registry import Arch
from repro_torch.optim import adamw
from repro_torch.tree import named_leaves


# ---------------------------------------------------------------------------
# Abstract params / batch / cache (fake tensors on "cpu": a fake tensor on
# the card would reach a kernel's launch, which reads its address)
# ---------------------------------------------------------------------------
def abstract_params(arch: Arch, mode: FakeTensorMode):
    with mode:
        return arch.module.init(arch.cfg, 0, device="cpu")


def abstract_batch(arch: Arch, shape: ShapeSpec, mode: FakeTensorMode
                   ) -> dict:
    cfg = arch.cfg
    B, S = shape.batch, shape.seq
    dt = dtype_of(cfg.param_dtype)
    with mode:
        batch = {"tokens": torch.empty((B, S), dtype=torch.int32),
                 "labels": torch.empty((B, S), dtype=torch.int32)}
        if cfg.family == "vlm":
            batch["prefix_embeds"] = torch.empty(
                (B, cfg.vision.n_prefix_tokens, cfg.d_model), dtype=dt)
        if cfg.family == "audio":
            batch["frames"] = torch.empty((B, cfg.encoder.n_ctx,
                                           cfg.d_model), dtype=dt)
    return batch


def abstract_cache(arch: Arch, shape: ShapeSpec, mode: FakeTensorMode,
                   dtype=None) -> dict:
    with mode:
        return arch.module.init_cache(arch.cfg, shape.batch, shape.seq,
                                      dtype=dtype, device="cpu")


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------
def _train_policy(act_policy: Optional[dict]) -> dict:
    # flash stays off in training, as in the reference: its measured
    # memory-term win was for prefill and serving
    policy = dict(act_policy or {})
    policy.pop("_flash", None)
    return policy


def make_micro_grad_step(arch: Arch, *, act_policy: Optional[dict] = None
                         ) -> Callable:
    """ONE micro-batch forward + backward, bf16 gradients out: the device
    program of a tiered optimizer, which accumulates in fp32 and pages
    the optimizer state itself."""
    cfg, mod = arch.cfg, arch.module
    train_policy = _train_policy(act_policy)

    def micro_step(params, micro_batch):
        with activation_sharding(train_policy):
            loss, grads = mod.loss_and_grad(cfg, params, micro_batch,
                                            remat=True)
        grads = {k: g.to(torch.bfloat16) for k, g in grads.items()}
        return grads, {"loss": loss}

    return micro_step


def micro_batches(batch: dict, n_micro: int) -> list[dict]:
    """``batch`` cut along its leading axis into ``n_micro`` equal parts."""
    size = next(iter(batch.values())).shape[0]
    if size % n_micro:
        raise ValueError(f"batch {size} does not split into {n_micro}")
    step = size // n_micro
    return [{k: v[i * step:(i + 1) * step] for k, v in batch.items()}
            for i in range(n_micro)]


def zero_accumulators(params) -> dict:
    """fp32 gradient accumulators, one a leaf."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in named_leaves(params)}


def accumulate(arch: Arch, params, acc: dict, micro_batch: dict, *,
               act_policy: Optional[dict] = None):
    """One micro-batch's loss, its gradients added into ``acc`` in fp32
    (in place)."""
    with activation_sharding(_train_policy(act_policy)):
        loss, grads = arch.module.loss_and_grad(arch.cfg, params,
                                                micro_batch, remat=True)
    for k, g in grads.items():
        acc[k].add_(g.to(torch.float32))
    return loss


def make_train_step(arch: Arch, opt_cfg: adamw.AdamWConfig, *,
                    n_micro: int = 1, act_policy: Optional[dict] = None,
                    return_grads: bool = False) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, the update fused in and applied in place; with
    ``return_grads``, ``train_step(params, batch) -> (grads, metrics)``.
    ``n_micro > 1`` accumulates the micro-batches' gradients in fp32 and
    averages them and the losses, as the reference's scan does."""
    cfg, mod = arch.cfg, arch.module
    train_policy = _train_policy(act_policy)

    def grads_of(params, batch):
        if n_micro == 1:
            with activation_sharding(train_policy):
                return mod.loss_and_grad(cfg, params, batch, remat=True)
        acc = zero_accumulators(params)
        loss = torch.zeros((), dtype=torch.float32,
                           device=next(iter(acc.values())).device)
        for mb in micro_batches(batch, n_micro):
            loss = loss + accumulate(arch, params, acc, mb,
                                     act_policy=train_policy)
        inv = 1.0 / n_micro
        return loss * inv, {k: g.mul_(inv) for k, g in acc.items()}

    if return_grads:
        def train_step(params, batch):
            loss, grads = grads_of(params, batch)
            return grads, {"loss": loss}
        return train_step

    def train_step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        params, opt_state, metrics = adamw.apply(opt_cfg, params, grads,
                                                 opt_state)
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


# ---------------------------------------------------------------------------
# Prefill / serve steps
# ---------------------------------------------------------------------------
def make_prefill_step(arch: Arch, *, act_policy: Optional[dict] = None
                      ) -> Callable:
    cfg, mod = arch.cfg, arch.module

    def prefill_step(params, batch):
        with activation_sharding(act_policy or {}):
            kwargs = {}
            if cfg.family == "audio":
                kwargs["frames"] = batch["frames"]
            if cfg.family == "vlm":
                kwargs["prefix_embeds"] = batch["prefix_embeds"]
            logits = mod.forward(cfg, params, batch["tokens"],
                                 last_only=True, **kwargs)
            return logits[:, -1, :]  # next-token logits only

    return prefill_step


def make_serve_step(arch: Arch, *, act_policy: Optional[dict] = None
                    ) -> Callable:
    """``serve_step(params, cache, tokens) -> (logits, cache)``: one
    ``decode_step``, which writes the cache in place."""
    cfg, mod = arch.cfg, arch.module

    def serve_step(params, cache, tokens):
        with activation_sharding(act_policy or {}):
            return mod.decode_step(cfg, params, cache, tokens)

    return serve_step


# ---------------------------------------------------------------------------
# Abstract inputs and their specs for the dry run
# ---------------------------------------------------------------------------
def batch_shardings(batch_abstract: dict, mesh: Mesh) -> dict:
    dp, n_dp = dp_axes(mesh), dp_size(mesh)
    return {k: shmod.P(dp if v.shape[0] % n_dp == 0 else None,
                       *([None] * (v.dim() - 1)))
            for k, v in batch_abstract.items()}


@dataclasses.dataclass
class CellSpecs:
    """Everything the dry run needs for one (arch x shape x mesh) cell:
    fake tensors of ``mode`` and the specs the reference places them by."""
    mode: FakeTensorMode
    params: object
    param_sh: dict
    batch: Optional[dict] = None
    batch_sh: Optional[dict] = None
    opt_state: Optional[dict] = None
    opt_sh: Optional[dict] = None
    cache: Optional[dict] = None
    cache_sh: Optional[dict] = None
    tokens: Optional[torch.Tensor] = None
    tokens_sh: Optional[tuple] = None
    cache_dtype: Optional[torch.dtype] = None  # the fp8 rule's choice


def self_cache_bytes(cfg, shape) -> int:
    """Self-attention KV bytes for one decode cell (0 for ssm)."""
    if cfg.family == "ssm":
        return 0
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    T = min(cfg.local_window, shape.seq) if cfg.local_window else shape.seq
    return 2 * cfg.n_layers * shape.batch * T * K * hd * 2


def input_specs(arch: Arch, shape: ShapeSpec, mesh: Mesh,
                scfg: Optional[shmod.ShardingConfig] = None,
                cache_dtype=None, *, hbm_bytes: Optional[int] = None
                ) -> CellSpecs:
    """The cell's abstract inputs.  A decode cell's cache is fp8
    (``float8_e4m3fn``) when the bf16 cache would take more than 15% of a
    device's ``hbm_bytes`` (default: the card's memory), as the
    reference's rule at its 16 GiB."""
    cfg = arch.cfg
    hbm = shmod.default_hbm_bytes() if hbm_bytes is None else hbm_bytes
    scfg = scfg or shmod.ShardingConfig.for_arch(cfg, hbm)
    mode = FakeTensorMode()
    pa = abstract_params(arch, mode)
    out = CellSpecs(mode=mode, params=pa,
                    param_sh=shmod.param_shardings(pa, cfg, mesh, scfg))
    if shape.kind in ("train", "prefill"):
        out.batch = abstract_batch(arch, shape, mode)
        out.batch_sh = batch_shardings(out.batch, mesh)
    if shape.kind == "train":
        with mode:
            out.opt_state = adamw.init_state(pa)
        out.opt_sh = shmod.opt_state_shardings(out.param_sh, pa,
                                               zero1=scfg.zero1, mesh=mesh)
    if shape.kind == "decode":
        if cache_dtype is None:
            # fp8 KV once the bf16 cache would eat >15% of a device's
            # memory (headroom for the decode working set)
            per_chip = self_cache_bytes(cfg, shape) / chips(mesh)
            if per_chip > 0.15 * hbm and cfg.family != "ssm":
                cache_dtype = torch.float8_e4m3fn
        out.cache_dtype = cache_dtype
        out.cache = abstract_cache(arch, shape, mode, dtype=cache_dtype)
        out.cache_sh = shmod.cache_shardings(out.cache, mesh)
        out.tokens_sh = shmod.P(
            dp_axes(mesh) if shape.batch % dp_size(mesh) == 0 else None)
        with mode:
            out.tokens = torch.empty((shape.batch,), dtype=torch.int32)
    return out
