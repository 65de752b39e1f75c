"""Sharding rules, computed and recorded: the reference's logical-axis
mapping from parameter paths to mesh axes, as tuples.

TP shards the flattened head (H*hd), FFN (F), vocab (V) and expert (E)
dims; FSDP additionally shards one large dim of each weight over the
data(+pod) axes for models past ``fsdp_threshold`` params.  On one card
no spec is applied: each function gives the reference's
``PartitionSpec`` as a tuple of entries (``None``, an axis name, or a
tuple of axis names), over a :class:`repro_torch.launch.mesh.Mesh`
record, so the dry run can record a cell's layout and the tests can hold
it to the reference's.  Trees of specs are keyed by
:func:`repro_torch.tree.ref_key`, the reference's leaf paths.

Where the reference sizes against a TPU chip's 16 GiB, the port takes
``hbm_bytes``, by default the card's memory (:func:`default_hbm_bytes`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tiers import H100_HBM
from repro_torch.launch.mesh import Mesh, dp_axes, dp_size
from repro_torch.tree import flatten, ref_key

#: ``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA H100
#: 80GB HBM3 (the fitted tier's capacity, ``core/tiers.py``): the default
#: memory where no card is present
H100_80GB_HBM3_BYTES = H100_HBM.capacity_bytes

Spec = tuple


def P(*entries) -> Spec:
    """A spec: one entry a dim, ``None``, an axis name or a tuple of
    names; a one-name tuple is written as the name, as
    ``PartitionSpec`` normalises it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def default_hbm_bytes() -> int:
    """The card's memory, or an H100 80GB HBM3's where no card is present."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return H100_80GB_HBM3_BYTES


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    fsdp: bool = False  # shard params over data axes too (ZeRO-3-ish)
    zero1: bool = False  # params replicated over dp; ONLY moments dp-sharded
    fsdp_threshold: float = 10e9  # auto-enable above this many params
    seq_shard_prefill: bool = True  # shard long-seq activations over data axes

    @staticmethod
    def for_arch(cfg: ArchConfig, hbm_bytes: Optional[int] = None
                 ) -> "ShardingConfig":
        # params bf16 + grads fp32 + moments fp32x2 = 14 B/param; enable
        # FSDP once a pure-TP layout would eat >25% of a device's memory.
        hbm = default_hbm_bytes() if hbm_bytes is None else hbm_bytes
        per_chip = cfg.param_count() * 14 / 16
        return ShardingConfig(fsdp=per_chip > 0.25 * hbm)


# param-name classification --------------------------------------------------
_COL_KEYS = {"wq", "wk", "wv", "w_gate", "w_up", "Wk", "Wr", "Wv", "Wg",
             "W_gate", "W_in", "W_a", "W_i"}
_ROW_KEYS = {"wo", "w_down", "Wo", "W_out"}
_REPLICATE_KEYS = {"scale", "bias", "w0", "u", "gn_scale", "gn_bias",
                   "lam", "conv", "b_a", "b_i", "w_A", "w_B",
                   "mu_r", "mu_k", "mu_v", "mu_w", "mu_g"}


def param_spec(path, leaf, cfg: ArchConfig, mesh: Mesh,
               scfg: ShardingConfig) -> Spec:
    """The spec of one parameter leaf (stacked layer dims included);
    ``path`` is the leaf's path of keys (``("layers", "mlp", "w_up")``)."""
    key = str(path[-1])
    keys = [str(p) for p in path]
    ndim = len(leaf.shape)
    dp = dp_axes(mesh)
    fs = dp if scfg.fsdp else None

    def spec(*tail: object) -> Spec:
        """Right-align ``tail`` onto the leaf's dims (leading dims unsharded)."""
        return P(*([None] * (ndim - len(tail)) + list(tail)))

    if key in {"embed"}:
        return P("model", None)  # vocab-sharded table
    if key in {"lm_head"}:
        return P(None, "model")
    if key in {"router"}:
        return P(None, None) if ndim == 2 else spec(None, None)
    if key in {"enc_pos", "dec_pos"}:
        return P(None, None)
    if "experts" in keys:
        # (units, E, D, F) / (units, E, F, D): EP on data axes, TP on model
        if key in {"w_gate", "w_up"}:
            return spec(fs, None, "model") if ndim >= 3 else spec(None, "model")
        if key == "w_down":
            return spec(fs, "model", None) if ndim >= 3 else spec("model", None)
    if key in _REPLICATE_KEYS:
        return P(*([None] * ndim))
    if key.startswith("b") and ndim <= 2:  # qkv biases (stacked (L, Hhd))
        return spec("model")
    if key in _COL_KEYS and ndim >= 2:
        return spec(fs, "model")
    if key in _ROW_KEYS and ndim >= 2:
        return spec("model", fs)
    return P(*([None] * ndim))


def param_shardings(params_abstract, cfg: ArchConfig, mesh: Mesh,
                    scfg: Optional[ShardingConfig] = None) -> dict:
    """``{ref_key(path): spec}`` over every parameter leaf."""
    scfg = scfg or ShardingConfig.for_arch(cfg)
    return {ref_key(path): param_spec(path, leaf, cfg, mesh, scfg)
            for path, leaf in flatten(params_abstract)}


def opt_state_shardings(params_shardings: dict, params_abstract=None,
                        zero1: bool = False, *, mesh: Mesh) -> dict:
    """Moments follow their parameter's spec; under ZeRO-1 they are
    additionally sharded over the dp axes (first evenly-divisible dim),
    so replicated params don't imply replicated optimizer state."""
    moments = params_shardings
    if zero1 and params_abstract is not None:
        dp = dp_axes(mesh)
        n_dp = dp_size(mesh)

        def shard_more(sh: Spec, shape) -> Spec:
            spec = list(sh) + [None] * (len(shape) - len(sh))
            for i, (ax, dim) in enumerate(zip(spec, shape)):
                if ax is None and dim % n_dp == 0 and dim >= n_dp:
                    spec[i] = dp
                    return P(*spec)
            return sh

        shapes = {ref_key(p): tuple(leaf.shape)
                  for p, leaf in flatten(params_abstract)}
        moments = {k: shard_more(sh, shapes[k])
                   for k, sh in params_shardings.items()}
    return {"step": P(), "mu": moments, "nu": moments}


def batch_sharding(mesh: Mesh, batch: int, extra_dims: int = 1,
                   feature_dims: int = 0) -> Spec:
    """(B, ...) batch-sharded over the dp axes when divisible."""
    lead = dp_axes(mesh) if batch % dp_size(mesh) == 0 else None
    return P(lead, *([None] * (extra_dims - 1 + feature_dims)))


def activation_policy(mesh: Mesh, *, seq_sharded: bool = False) -> dict:
    """Logical-name -> spec entries installed around model calls
    (:func:`repro_torch.models.common.activation_sharding`), and the
    switches the models read.  ``_ep`` records the mesh and its dp axes,
    as the reference's; the port's MoE runs expert-parallel only when
    ``_ep`` holds a process group (:func:`repro_torch.models.moe.routed_mlp`)."""
    dp = dp_axes(mesh)
    seq = dp if seq_sharded else None
    lead = dp if not seq_sharded else None
    return {
        "act_btd": P(lead, seq, None),
        "act_btf": P(lead, seq, "model"),
        "act_btv": P(lead, seq, "model"),
        "act_ecd": P(dp, None, None),  # experts over dp (EP)
        "act_ecd_flat": P(dp, None),  # (E*C, D) expert-major
        "act_td": P(dp, None),  # flat tokens, batch-major
        "_ep": (mesh, dp),  # the expert-parallel dispatch context
        "_q_chunk": 256,  # score-block rows per flight
        "_flash": True,  # online-softmax KV chunking (no (C,S) score spill)
        "_kv_chunk": 1024,
    }


def cache_shardings(cache_abstract, mesh: Mesh) -> dict:
    """``{ref_key(path): spec}`` of a KV cache / recurrent state: the
    batch dim sharded over the dp axes."""
    dp = dp_axes(mesh)
    n_dp = dp_size(mesh)
    n_model = mesh.shape["model"]

    def one(path, leaf) -> Spec:
        key = str(path[-1])
        if key == "len":
            return P(None)
        shape = tuple(leaf.shape)
        nd = len(shape)
        batch_ok = nd >= 2 and shape[1] % n_dp == 0
        # self-attention KV caches (L, B, T, K, hd): shard the time axis
        # over the model axis too (flash-decode style partial softmaxes)
        if key in ("k", "v") and nd == 5 and shape[2] % n_model == 0:
            return P(None, dp if batch_ok else None, "model", None, None)
        if key in ("xk", "xv") and nd == 5:
            return P(None, dp if batch_ok else None, None, None, None)
        if batch_ok:
            return P(None, dp, *([None] * (nd - 2)))
        if nd >= 1 and shape[0] % n_dp == 0:
            return P(dp, *([None] * (nd - 1)))
        return P(*([None] * nd))

    return {ref_key(path): one(path, leaf)
            for path, leaf in flatten(cache_abstract)}
