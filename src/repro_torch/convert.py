"""Carry the reference package's state across into the port.

The reference hands its state over as numpy arrays (``np.asarray`` of
its shards and maps), a policy's fields and a warm-start memo's JSON;
these functions rebuild the port's objects from them, so both packages
can compute on the same data.  Nothing here imports the reference.

bfloat16 arrays (``ml_dtypes.bfloat16``, which ``torch.from_numpy``
rejects) cross as a ``uint16`` view of the same bits.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.interleave import InterleavedTensor
from repro_torch.core.policy import MemPolicy, PolicyKind
from repro_torch.core.warmstart import WarmStartMemo
from repro_torch.device import (DeviceLike, resolve_backend, resolve_device,
                                shard_storage)
from repro_torch.models.moe import MoEParams
from repro_torch.models.rwkv import RwkvParams
from repro_torch.models.transformer import DenseParams
from repro_torch.serving.kv_cache import TieredKVCache
from repro_torch.serving.prefix_cache import PrefixBlock


def tensor_from_numpy(array) -> torch.Tensor:
    """A host tensor with ``array``'s values (bfloat16 bit-exact)."""
    array = np.ascontiguousarray(array)
    if array.dtype.name == "bfloat16":
        return torch.from_numpy(array.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(array.copy())


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host numpy copy of ``t``; bfloat16 comes back as float32 (exact)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def policy_from_reference(policy) -> MemPolicy:
    """The port's :class:`MemPolicy` equal to a reference ``MemPolicy``
    (read through its ``kind``, ``tiers`` and ``weights`` fields)."""
    kind = getattr(policy.kind, "value", policy.kind)
    return MemPolicy(PolicyKind(kind), tuple(policy.tiers),
                     tuple(int(w) for w in policy.weights))


def interleaved_from_state(
    parts: Sequence, page_device, page_local, page_rows: int, rows: int,
    device_names: Sequence[str], headroom: int = 0, *,
    device: DeviceLike = None, backend: Optional[str] = None,
) -> InterleavedTensor:
    """An :class:`InterleavedTensor` holding exactly the reference
    tensor's shards (capacity padding included) and page maps."""
    device = resolve_device(device)
    backend = resolve_backend(backend, device)
    shards = []
    for i, part in enumerate(parts):
        host = tensor_from_numpy(part)
        shard = torch.empty(tuple(host.shape), dtype=host.dtype,
                            **shard_storage(i, backend, device))
        shards.append(shard.copy_(host))
    dev = np.array(page_device, np.int8)
    local = np.array(page_local, np.int32)
    out = InterleavedTensor(
        parts=tuple(shards),
        page_device=torch.as_tensor(dev, dtype=torch.int8, device=device),
        page_local=torch.as_tensor(local, dtype=torch.int64, device=device),
        page_rows=int(page_rows),
        rows=int(rows),
        device_names=tuple(device_names),
        headroom=int(headroom),
        backend=backend,
        device=device,
    )
    out._with_map(dev, local)
    return out


def interleaved_from_reference(it, *, device: DeviceLike = None
                               ) -> InterleavedTensor:
    """Carry a reference ``InterleavedTensor`` across (its arrays are read
    through ``np.asarray``; its backend is not, the port's follows from
    ``device``)."""
    return interleaved_from_state(
        [np.asarray(p) for p in it.parts], np.asarray(it.page_device),
        np.asarray(it.page_local), it.page_rows, it.rows, it.device_names,
        it.headroom, device=device)


def table_from_numpy(table, policy: MemPolicy, page_rows: int, *,
                     headroom: int = 0, device: DeviceLike = None
                     ) -> InterleavedTensor:
    """Page a numpy table under ``policy``, as the reference's
    ``InterleavedTensor.from_array`` does with the same arguments."""
    return InterleavedTensor.from_array(
        tensor_from_numpy(table), policy, page_rows, headroom=headroom,
        device=device)


def memo_from_json(text: str) -> WarmStartMemo:
    """A warm-start memo written by either package."""
    return WarmStartMemo.from_json(text)


def params_from_jax(cfg: ArchConfig, tree: dict, *,
                    device: DeviceLike = None):
    """The port's parameter module holding exactly the reference's
    parameter tree (its leaves read through ``np.asarray``): ``embed``,
    ``layers`` (stacked over a leading L axis), ``final_norm`` and, unless
    the embeddings are tied, ``lm_head`` (stored transposed).  An ``ssm``
    config's tree becomes :class:`RwkvParams`, a ``moe`` config's a
    :class:`MoEParams` (``head_dense`` and ``units.{dense,moe}`` stacked,
    the fp32 ``router`` among a unit's leaves), any other a
    :class:`DenseParams`."""
    device = resolve_device(device)

    def t(a) -> torch.Tensor:
        return tensor_from_numpy(np.asarray(a)).to(device)

    def tree_of(node):
        if isinstance(node, dict):
            return {k: tree_of(v) for k, v in node.items()}
        return t(node)

    if cfg.tie_embeddings == ("lm_head" in tree):
        raise ValueError(f"{cfg.name}: tie_embeddings={cfg.tie_embeddings} "
                         f"but the tree {'has' if 'lm_head' in tree else 'lacks'}"
                         f" lm_head")
    lm_head = t(tree["lm_head"]) if "lm_head" in tree else None
    final_norm = tree_of(tree["final_norm"])
    if cfg.family == "moe":
        units = tree_of(tree["units"])
        head = tree_of(tree["head_dense"]) if "head_dense" in tree else None
        n_head = 0 if head is None else head["ln1"]["scale"].shape[0]
        n_units = units["moe"]["ln1"]["scale"].shape[0]
        if n_head + n_units * cfg.moe.every != cfg.n_layers:
            raise ValueError("layer stacks do not match cfg.n_layers")
        return MoEParams(t(tree["embed"]), head, units, final_norm, lm_head)
    cls = RwkvParams if cfg.family == "ssm" else DenseParams
    layers = {group: {k: t(v) for k, v in leaves.items()}
              for group, leaves in tree["layers"].items()}
    if layers["ln1"]["scale"].shape[0] != cfg.n_layers:
        raise ValueError("layer stack does not match cfg.n_layers")
    return cls(t(tree["embed"]), layers, final_norm, lm_head)


def kv_cache_from_jax(cache, *, device: DeviceLike = None) -> TieredKVCache:
    """A :class:`TieredKVCache` holding exactly a reference cache's state
    (read through ``np.asarray``): the per-device pools (capacity padding
    included), ``page_local``, ``pos_parts``, ``page_device``, ``lengths``
    and the shared-prefix block.  Its memory follows from ``device``."""
    device = resolve_device(device)
    backend = resolve_backend(None, device)

    def pool(i: int, a) -> torch.Tensor:
        host = tensor_from_numpy(np.asarray(a))
        out = torch.empty(tuple(host.shape), dtype=host.dtype,
                          **shard_storage(i, backend, device))
        return out.copy_(host)

    def dev(a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    prefix = None
    if cache.prefix is not None:
        p = cache.prefix
        prefix = PrefixBlock(
            k=tensor_from_numpy(np.asarray(p.k)).to(device),
            v=tensor_from_numpy(np.asarray(p.v)).to(device),
            slot_pages=dev(p.slot_pages, torch.int32),
            slot_shared=dev(p.slot_shared, torch.int32),
            page_device=dev(p.page_device, torch.int32),
            page_t=int(p.page_t))
    page_dev = np.array(cache.page_device, np.int8)
    page_local = np.array(cache.page_local, np.int32)
    out = TieredKVCache(
        k_parts=tuple(pool(i, a) for i, a in enumerate(cache.k_parts)),
        v_parts=tuple(pool(i, a) for i, a in enumerate(cache.v_parts)),
        lengths=dev(cache.lengths, torch.int32),
        page_local=dev(page_local, torch.int32),
        pos_parts=tuple(dev(p, torch.int32) for p in cache.pos_parts),
        page_device=dev(page_dev, torch.int8),
        page_t=int(cache.page_t),
        device_names=tuple(cache.device_names),
        slow_headroom=int(cache.slow_headroom),
        prefix=prefix,
        backend=backend,
        device=device)
    return out._with_host(page_dev, page_local)


def rwkv_cache_from_jax(cache: dict, *, device: DeviceLike = None) -> dict:
    """An rwkv decode cache (``{"tm", "cm", "wkv", "len"}``) holding
    exactly a reference cache's arrays, dtypes included."""
    device = resolve_device(device)
    return {k: tensor_from_numpy(np.asarray(cache[k])).to(device)
            for k in ("tm", "cm", "wkv", "len")}
