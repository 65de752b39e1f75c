"""Page-granular N:M tier interleaving of one logical array.

``InterleavedTensor`` is the framework object behind the paper's
weighted-interleave experiments: a logical ``(rows, *feature)`` array
whose pages are distributed across a fast tier and N slow devices
according to a :class:`~repro_torch.core.policy.MemPolicy` (the paper's
testbed exposes three CXL devices from different manufacturers at
once, §4/Table 1).  The tensor holds one page shard per device plus a
page->device map; reads and writes are routed to the owning device,
and embedding-bag reduction (the paper's DLRM §5.2 workload) runs the
``embedding_reduce`` kernel per shard and sums — numerically identical
to the un-tiered reduce.

Hot paths (the Caption loop's actuation and access costs):

* **Shape-stable shards** — with ``headroom > 0`` each device shard is
  capacity-padded by that many page chunks, and a repartition whose new
  per-device page counts fit the existing capacities rewrites only the
  index maps and the moved pages: every shard keeps its storage (its
  ``data_ptr()``).  Only when headroom is exhausted does a shard grow.
* **O(Δ) vectorized repartition** — the planner is numpy index
  arithmetic, and moved pages are coalesced into contiguous
  source-local *runs*, one batched mover :class:`Descriptor` per run
  (route-pure, billed bytes identical to per-page movement).
* **Single-pass routed access** — ``gather_rows``/``update_rows`` bucket
  rows by owning device, do one compact take/scatter per shard over only
  the rows it owns, and inverse-permute; the masked N-pass formulation
  stays beside it and gives the same values.

Memory backends (``backend=`` on :meth:`from_array`, which follows from
``device=``; see :mod:`repro_torch.device`):

* ``modeled`` (CPU) — every shard is a host tensor; the tier split is
  accounting (ledger + telemetry + perfmodel).
* ``pinned`` (CUDA) — shard 0 lives in HBM, every slow shard in
  page-locked host memory.  The ``embedding_reduce`` kernel reads a
  slow shard in place through unified virtual addressing, and page
  moves run through the mover's executor from shard memory to shard
  memory: with :func:`~repro_torch.core.mover.stream_executor` the
  ``stream_copy`` kernel stages each run in the destination's memory and
  ``index_copy_`` lands it in its free slots.  No host mirror of a card
  shard exists.

Donation (``donate=`` on the writers/repartitioners): when the caller
provably drops the parent tensor, the stable-path update writes the
receiving shard in place — no full-shard copy-on-write in the
probe-epoch loop (see :mod:`repro_torch.core.donation` for the contract).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.donation import FULL_SHARD_COPIES, donated_update
from repro_torch.core.ledger import TierLedger
from repro_torch.core.mover import LANE_BULK, PINNED, Descriptor
from repro_torch.core.policy import MemPolicy, largest_remainder_split
from repro_torch.core.telemetry import GLOBAL_TELEMETRY, Telemetry
from repro_torch.device import (DeviceLike, resolve_backend, resolve_device,
                                shard_storage)

#: default movement-run length (pages) the minimal-move planner clusters
#: its picks into: one mover Descriptor ships one run, so a Δ-page shift
#: drains ~Δ/RUN descriptors instead of Δ (§6 descriptor batching).  Run
#: STARTS stay evenly spread across the address range, so the interleave
#: discipline holds at run granularity; raise for cheaper actuation,
#: lower toward 1 for finer spreading (1 = legacy page-at-a-time).
DEFAULT_RUN_PAGES = 16

#: gather-crossover cost model of the ``modeled`` backend, the reference's
#: CPU calibration kept so both packages take the same path for the same
#: call:
#: the masked gather pays one pass per non-empty shard (fixed dispatch +
#: per-byte work over the WHOLE batch each pass); the bucketed gather pays
#: one host base (route + hand-back) plus per-row indexing overhead.
_GATHER_DISPATCH_S = 45e-6  #: per eager-op dispatch, per shard pass
_GATHER_XLA_PER_BYTE = 0.0002e-6  #: masked per-byte cost, per shard pass
_GATHER_HOST_BASE_S = 100e-6  #: bucketed fixed cost (route + hand-back)
_GATHER_HOST_PER_ROW = 0.05e-6  #: per-row indexing overhead
_GATHER_HOST_PER_BYTE = 0.0003e-6  #: bucketed per-byte copy cost

#: rows an int32 index addresses (the kernel's index width)
_INT32_ROWS = 1 << 31


def _as_numpy(x) -> np.ndarray:
    """Host int64 copy of an index array (tensor on any device, or array)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.int64).numpy()
    return np.asarray(x, np.int64)


def _empty(shape, dtype: torch.dtype, ordinal: int, backend: str,
           device: torch.device) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype,
                       **shard_storage(ordinal, backend, device))


def device_page_map(assign: np.ndarray, n_devices: int
                    ) -> tuple[np.ndarray, np.ndarray, list[int]]:
    """(device ordinals, local index within owning device, per-device counts).

    The one place the page->device bookkeeping lives: each page's local
    index is its arrival order within its device.  Vectorized (cumsum
    per device) — it runs on every construction and repartition.  Shared
    by construction and repartition here and by the tiered KV cache."""
    dev = np.asarray(assign, np.int8)
    if dev.size and int(dev.max()) >= n_devices:
        raise ValueError(
            f"page assigned to device {int(dev.max())} >= {n_devices}")
    local = np.zeros(len(dev), np.int32)
    counts: list[int] = []
    for d in range(n_devices):
        mask = dev == d
        counts.append(int(mask.sum()))
        if counts[-1]:
            local[mask] = np.cumsum(mask)[mask] - 1
    return dev, local, counts


def tier_page_map(assign: np.ndarray) -> tuple[np.ndarray, np.ndarray, list[int]]:
    """Two-part storage view: devices beyond the second collapse onto the
    slow part, and each page's local index is its arrival order within its
    storage tier (the KV cache's shape-stable fast/slow pools)."""
    assign01 = np.minimum(np.asarray(assign), 1).astype(np.int8)
    return device_page_map(assign01, 2)


def contiguous_runs(values: np.ndarray) -> list[tuple[int, int]]:
    """(start, length) spans where ``values`` increments by exactly 1.

    The run-coalescing primitive: positions whose source locals are
    consecutive form one contiguous slab in the owning shard and ship as
    a single batched mover descriptor."""
    v = np.asarray(values)
    if v.size == 0:
        return []
    breaks = np.nonzero(np.diff(v) != 1)[0] + 1
    starts = np.concatenate(([0], breaks))
    ends = np.concatenate((breaks, [v.size]))
    return [(int(s), int(e - s)) for s, e in zip(starts, ends)]


def route_pure_runs(src: np.ndarray, dst: np.ndarray, loc: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sort moved items by (src, dst, source local) and split them into
    route-pure runs of consecutive locals.

    Returns ``(order, starts, ends)``: ``order`` permutes the inputs into
    run order, and ``[starts[i], ends[i])`` spans run ``i`` within it.
    The ONE place the coalescing rule lives — a run never mixes (src,
    dst) routes and its source locals are adjacent, so it is a single
    contiguous slab of the source pool and ships as one batched
    descriptor.  Shared by ``InterleavedTensor`` and ``TieredKVCache``
    so the two actuation paths can never bill runs differently."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    loc = np.asarray(loc, np.int64)
    if src.size == 0:
        empty = np.zeros(0, np.int64)
        return empty, empty, empty
    order = np.lexsort((loc, dst, src))
    s, d, lo = src[order], dst[order], loc[order]
    key = s * (int(max(s.max(), d.max())) + 2) + d
    brk = np.nonzero((np.diff(key) != 0) | (np.diff(lo) != 1))[0] + 1
    starts = np.concatenate(([0], brk))
    ends = np.concatenate((brk, [order.size]))
    return order, starts, ends


def _policy_device_map(policy, n_pages: int
                       ) -> tuple[np.ndarray, tuple[str, ...]]:
    """Resolve a policy to (page->device ordinals, canonical device names).

    Canonical order is fast first, then the policy's slow tiers in
    declaration order — so ``membind("slow")`` lands every page on device
    1 and a three-device weighted policy yields ordinals 0..3.  The fast
    tier is the first well-known fast name, else — for multi-tier
    policies — the FIRST tier (``from_tier_fractions`` always puts the
    fast home first, and registry fast tiers like ``ddr5-r1`` are not on
    the whitelist)."""
    assign = np.asarray(policy.assign_pages(n_pages))
    tiers = tuple(policy.tiers)
    fast_names = MemPolicy._FAST_NAMES
    fast_tier = next((t for t in tiers if t.lower() in fast_names), None)
    if fast_tier is None and len(tiers) > 1:
        fast_tier = tiers[0]
    if fast_tier is None and len(tiers) == 1:
        # membind on a registry device: infer fast-vs-slow from its KIND
        # (local DRAM/HBM is a fast home; CXL/host/remote are far tiers),
        # so membind('ddr5-r1') is not silently treated as 100% slow when
        # the operator made it the fast tier... and membind('cxl-a') still
        # correctly lands every page on the slow side.
        from repro_torch.core.tiers import DEVICE_REGISTRY
        spec = DEVICE_REGISTRY.get(tiers[0].lower())
        if spec is not None and spec.kind in ("hbm", "ddr_local"):
            fast_tier = tiers[0]

    def is_fast(t: str) -> bool:
        return t == fast_tier or t.lower() in fast_names

    slow_tiers: list[str] = []
    for t in tiers:
        if not is_fast(t) and t not in slow_tiers:
            slow_tiers.append(t)
    names = (fast_tier or "fast",) + (tuple(slow_tiers) or ("slow",))
    dev_of = np.asarray(
        [0 if is_fast(t) else 1 + slow_tiers.index(t) for t in tiers],
        np.int8)
    dev = dev_of[np.minimum(assign, len(tiers) - 1)]
    return dev, names


def resolve_device_names(existing: Sequence[str], n_devices: int,
                         policy_names: Optional[Sequence[str]] = None,
                         fast_tier: Optional[str] = None,
                         slow_tier: Optional[str] = None) -> tuple[str, ...]:
    """Resolve device-ordinal route labels: a policy's names, widened
    with the EXISTING names for higher ordinals (a narrower policy must
    not rename a pinned page's real device), padded with placeholders,
    with the legacy fast/slow overrides on the first two (the two-device
    compatibility path).  Shared by InterleavedTensor and TieredKVCache
    so the two actuation paths can never resolve names differently."""
    names = list(policy_names or existing)
    for n in tuple(existing)[len(names):]:
        names.append(n)
    while len(names) < n_devices:
        names.append(f"slow{len(names)}")
    if fast_tier is not None:
        names[0] = fast_tier
    if slow_tier is not None and len(names) > 1:
        names[1] = slow_tier
    return tuple(names)


@dataclasses.dataclass
class InterleavedTensor:
    """A logical array paged across (fast, slow devices...) along axis 0."""

    #: per-device page shards; ``parts[0]`` is the fast tier's.  With
    #: ``headroom > 0`` each shard is capacity-padded: only the slots the
    #: page->local map points at are valid, the rest is reserve.
    parts: tuple[torch.Tensor, ...]
    page_device: torch.Tensor  # (n_pages,) int8: 0 = fast, i >= 1 = slow dev i-1
    page_local: torch.Tensor  # (n_pages,) int64: page index within its device
    page_rows: int
    rows: int  # logical row count (may be < n_pages * page_rows)
    #: route labels per device ordinal (telemetry/mover tier names).
    device_names: tuple[str, ...] = ("fast", "slow")
    #: capacity padding, in page chunks per device shard.  0 = exact-size
    #: shards (every repartition resizes them — the legacy layout);
    #: > 0 = shape-stable shards (repartitions that fit keep every shard's
    #: storage).
    headroom: int = 0
    #: shard memory backend: ``modeled`` (host tensors, accounted tiers)
    #: or ``pinned`` (HBM fast shard, pinned-host slow shards).
    backend: str = "modeled"
    #: the device maps, routing and outputs live on (HBM on ``pinned``).
    device: torch.device = torch.device("cpu")

    # -- host-side map cache --------------------------------------------------
    def _host_map(self) -> tuple[np.ndarray, np.ndarray]:
        """Cached numpy (page_device, page_local) — controller reads
        (slow_fraction / device_fractions / weights) happen every epoch
        and must not copy the device maps back each time."""
        cached = self.__dict__.get("_host_cache")
        if cached is None:
            cached = (self.page_device.cpu().numpy().astype(np.int8),
                      self.page_local.cpu().numpy().astype(np.int32))
            self.__dict__["_host_cache"] = cached
        return cached

    def _with_map(self, dev: np.ndarray, local: np.ndarray) -> None:
        """Seed the host cache when the maps were just built host-side."""
        self.__dict__["_host_cache"] = (dev, local)

    def _maps(self, dev: np.ndarray, local: np.ndarray) -> dict:
        """Device copies of host-built maps (``dataclasses.replace`` kwargs)."""
        return {"page_device": torch.as_tensor(dev, dtype=torch.int8,
                                               device=self.device),
                "page_local": torch.as_tensor(local, dtype=torch.int64,
                                              device=self.device)}

    # -- two-device compatibility views --------------------------------------
    @property
    def fast(self) -> torch.Tensor:
        return self.parts[0]

    @property
    def slow(self) -> torch.Tensor:
        """The single slow shard (two-device path); ambiguous beyond that."""
        if len(self.parts) > 2:
            raise AttributeError(
                "tensor has multiple slow devices; index .parts directly")
        return self.parts[1]

    @property
    def page_tier(self) -> torch.Tensor:
        """(n_pages,) int8 0/1 fast-vs-slow view of the device map."""
        return self.page_device.clamp(max=1).to(torch.int8)

    # -- construction --------------------------------------------------------
    @classmethod
    def from_array(
        cls,
        array,
        policy: MemPolicy,
        page_rows: int = 256,
        *,
        device: DeviceLike = None,
        headroom: int = 0,
        backend: Optional[str] = None,
        ledger: Optional[TierLedger] = None,
        name: str = "interleaved",
    ) -> "InterleavedTensor":
        """Page ``array`` (a tensor on any device, or a numpy array) onto
        the devices ``policy`` names.  ``device`` defaults to ``cuda``
        (which raises without CUDA); the backend follows from it."""
        device = resolve_device(device)
        backend = resolve_backend(backend, device)
        if not isinstance(array, torch.Tensor):
            array = torch.from_numpy(np.ascontiguousarray(array))
        rows = array.shape[0]
        n_pages = max(1, math.ceil(rows / page_rows))
        assign, names = _policy_device_map(policy, n_pages)
        dev, page_local, counts = device_page_map(assign, len(names))
        pad_rows = n_pages * page_rows - rows
        feature = tuple(array.shape[1:])
        if pad_rows:
            array = torch.cat([array, torch.zeros((pad_rows,) + feature,
                                                  dtype=array.dtype,
                                                  device=array.device)])
        paged = array.reshape((n_pages, page_rows) + feature)
        headroom = max(int(headroom), 0)
        parts = []
        for i in range(len(names)):
            ids = np.nonzero(dev == i)[0]
            cap = counts[i] + headroom
            part = _empty((cap * page_rows,) + feature, array.dtype, i,
                          backend, device)
            view = part.view((cap, page_rows) + feature)
            if len(ids):
                idx = torch.as_tensor(ids, device=array.device)
                if part.device == array.device:
                    torch.index_select(paged, 0, idx, out=view[: len(ids)])
                else:
                    view[: len(ids)].copy_(paged.index_select(0, idx))
            view[len(ids):].zero_()
            parts.append(part)
        out = cls(
            parts=tuple(parts),
            page_device=torch.as_tensor(dev, dtype=torch.int8, device=device),
            page_local=torch.as_tensor(page_local, dtype=torch.int64,
                                       device=device),
            page_rows=page_rows,
            rows=rows,
            device_names=names,
            headroom=headroom,
            backend=backend,
            device=device,
        )
        out._with_map(dev, page_local)
        if ledger is not None:
            for i, part in enumerate(parts):
                if part.numel():
                    ledger.register(name, names[i],
                                    part.numel() * part.element_size())
        return out

    # -- derived -------------------------------------------------------------
    @property
    def n_pages(self) -> int:
        return self.page_device.shape[0]

    @property
    def n_devices(self) -> int:
        return len(self.parts)

    @property
    def row_bytes(self) -> int:
        f = self.parts[0]
        feat = int(np.prod(f.shape[1:])) if f.ndim > 1 else 1
        return feat * f.element_size()

    @property
    def capacity_pages(self) -> tuple[int, ...]:
        """Per-device shard capacity in pages (valid + headroom)."""
        return tuple(p.shape[0] // self.page_rows for p in self.parts)

    def valid_page_counts(self) -> tuple[int, ...]:
        """Per-device VALID page counts (what the map actually uses)."""
        dev, _ = self._host_map()
        return tuple(np.bincount(dev, minlength=len(self.parts)).tolist())

    def slow_fraction(self) -> float:
        dev, _ = self._host_map()
        return float((dev >= 1).mean())

    def device_fractions(self) -> dict[str, float]:
        """Per-device page share, keyed by device name."""
        dev, _ = self._host_map()
        return {n: float((dev == i).mean())
                for i, n in enumerate(self.device_names)}

    def weights(self) -> tuple[float, ...]:
        """Per-slow-device page shares (the Caption weight vector)."""
        dev, _ = self._host_map()
        return tuple(float((dev == i).mean())
                     for i in range(1, len(self.parts)))

    # -- addressing ----------------------------------------------------------
    def _route(self, idx: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """row idx -> (owning device ordinal, local flat row index), on
        ``self.device``; out-of-range pages clip to the first/last page."""
        idx = idx.to(device=self.device, dtype=torch.int64)
        page = torch.div(idx, self.page_rows, rounding_mode="floor")
        offset = idx - page * self.page_rows
        page = page.clamp(0, self.n_pages - 1)
        dev = self.page_device[page]
        local = self.page_local[page] * self.page_rows + offset
        return dev, local

    def _route_host(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Host-side :meth:`_route` over the cached maps (no device sync)."""
        dev_map, local_map = self._host_map()
        # clip (not wrap) out-of-range pages, like the device route
        page = np.clip(idx // self.page_rows, 0, self.n_pages - 1)
        offset = idx % self.page_rows
        dev = dev_map[page]
        local = local_map[page].astype(np.int64) * self.page_rows + offset
        return dev, local

    # -- access --------------------------------------------------------------
    def choose_gather_path(self, n_rows: int) -> str:
        """Size-based crossover: ``"masked"`` or ``"bucketed"`` for a
        gather of ``n_rows`` rows.

        The masked path pays one full pass PER NON-EMPTY SHARD, so its
        cost scales with shard count and bytes; the bucketed path pays a
        fixed host base plus per-row indexing overhead, independent of
        shard count.  Both give the same values.  The crossover applies on
        the ``modeled`` backend only, with the reference package's CPU
        constants, so both packages pick the same path there.  On
        ``pinned`` the bucketed gather is the one path: it reads a slow
        shard over PCIe only for the rows that shard owns (no card
        measurement yet places a crossover)."""
        if self.backend == "pinned":
            return "bucketed"
        shards = sum(1 for p in self.parts if p.shape[0] > 0) or 1
        row_bytes = (int(np.prod(self.parts[0].shape[1:]))
                     * self.parts[0].element_size())
        masked_est = shards * (_GATHER_DISPATCH_S
                               + n_rows * row_bytes * _GATHER_XLA_PER_BYTE)
        bucketed_est = (_GATHER_HOST_BASE_S
                        + n_rows * (_GATHER_HOST_PER_ROW
                                    + row_bytes * _GATHER_HOST_PER_BYTE))
        return "bucketed" if bucketed_est < masked_est else "masked"

    def gather_rows(self, idx) -> torch.Tensor:
        """rows[idx] — routed gather across the device shards, returned on
        ``self.device``.  Picks the bucketed single-pass gather or the
        masked N-pass formulation per call (:meth:`choose_gather_path`);
        the two are value-identical."""
        n = idx.numel() if isinstance(idx, torch.Tensor) else np.size(idx)
        if self.choose_gather_path(int(n)) == "bucketed":
            return self._gather_rows_bucketed(idx)
        return self._gather_rows_masked(idx)

    def _gather_rows_masked(self, idx) -> torch.Tensor:
        idx = torch.as_tensor(_as_numpy(idx) if not isinstance(idx, torch.Tensor)
                              else idx)
        dev, local = self._route(idx)
        feat = tuple(self.parts[0].shape[1:])
        out = None
        for i, part in enumerate(self.parts):
            if part.shape[0] == 0:
                continue
            li = local.clamp(0, part.shape[0] - 1).reshape(-1)
            got = part.index_select(0, li.to(part.device)).to(self.device)
            got = got.reshape(tuple(idx.shape) + feat)
            if out is None:
                out = got
            else:
                mask = (dev == i).reshape(tuple(idx.shape) + (1,) * len(feat))
                out = torch.where(mask, got, out)
        if out is None:  # zero-page tensor
            out = torch.zeros(tuple(idx.shape) + feat,
                              dtype=self.parts[0].dtype, device=self.device)
        return out

    def _gather_rows_bucketed(self, idx) -> torch.Tensor:
        idx = _as_numpy(idx)
        feat = tuple(self.parts[0].shape[1:])
        dtype = self.parts[0].dtype
        flat = idx.ravel()
        if flat.size == 0 or all(p.shape[0] == 0 for p in self.parts):
            return torch.zeros(idx.shape + feat, dtype=dtype,
                               device=self.device)
        dev, local = self._route_host(flat)
        out = torch.empty((flat.size,) + feat, dtype=dtype, device=self.device)
        for i, part in enumerate(self.parts):
            mask = dev == i
            if not mask.any():
                continue  # shard untouched: no gather pass at all
            rows = np.minimum(local[mask], max(part.shape[0] - 1, 0))
            got = part.index_select(0, torch.as_tensor(rows,
                                                       device=part.device))
            pos = torch.as_tensor(np.nonzero(mask)[0], device=self.device)
            out[pos] = got.to(self.device)
        return out.reshape(idx.shape + feat)

    def _copy_shard(self, i: int) -> torch.Tensor:
        """A full copy of shard ``i`` in the same memory (copy-on-write)."""
        part = self.parts[i]
        return _empty(part.shape, part.dtype, i, self.backend,
                      self.device).copy_(part)

    def _scatter_masked(self, idx, values, op: str) -> "InterleavedTensor":
        """The N-pass formulation: every shard scatters the whole batch,
        with rows another shard owns pushed out of bounds and dropped."""
        idx = idx if isinstance(idx, torch.Tensor) else torch.as_tensor(
            _as_numpy(idx))
        dev, local = self._route(idx)
        feat = tuple(self.parts[0].shape[1:])
        vals = torch.as_tensor(values).reshape((-1,) + feat)
        parts = []
        for i, part in enumerate(self.parts):
            if part.shape[0] == 0:
                parts.append(part)
                continue
            p_idx = torch.where(dev == i, local, part.shape[0]).reshape(-1)
            keep = p_idx < part.shape[0]
            new = self._copy_shard(i)
            donated_update(new, p_idx[keep].to(part.device),
                           vals[keep.to(vals.device)].to(part.device), op)
            parts.append(new)
        return dataclasses.replace(self, parts=tuple(parts))

    def _scatter_bucketed(self, idx, values, op: str,
                          donate: bool = False) -> "InterleavedTensor":
        # Rows bucketed by owning shard: one compact scatter per touched
        # shard.  With ``donate`` the receiving shard is written in place
        # (caller drops the parent; see repro_torch.core.donation), else
        # into one full copy of it.
        feat = tuple(self.parts[0].shape[1:])
        flat = _as_numpy(idx).ravel()
        vals = torch.as_tensor(values).reshape((flat.size,) + feat)
        dev, local = self._route_host(flat)
        parts = list(self.parts)
        for i, part in enumerate(self.parts):
            if part.shape[0] == 0:
                continue
            mask = dev == i
            if not mask.any():
                continue  # shard untouched: no scatter pass at all
            rows = local[mask]
            keep = rows < part.shape[0]
            sel = torch.as_tensor(np.nonzero(mask)[0][keep],
                                  device=vals.device)
            v = vals.index_select(0, sel).to(device=part.device,
                                              dtype=part.dtype)
            r = torch.as_tensor(rows[keep], device=part.device)
            if donate:
                parts[i] = donated_update(part, r, v, op)
                continue
            FULL_SHARD_COPIES.bump()
            parts[i] = donated_update(self._copy_shard(i), r, v, op)
        return dataclasses.replace(self, parts=tuple(parts))

    def update_rows(self, idx, values, *,
                    donate: bool = False) -> "InterleavedTensor":
        """Scatter-set of ``values`` at row ``idx`` into a new tensor.

        ``donate=True`` writes the receiving shards in place — only valid
        when the caller drops ``self`` (and every ancestor sharing its
        shards) after the call."""
        return self._scatter_bucketed(idx, values, "set", donate)

    def add_rows(self, idx, values, *,
                 donate: bool = False) -> "InterleavedTensor":
        return self._scatter_bucketed(idx, values, "add", donate)

    def bag_reduce(
        self,
        indices,  # (batch, bag)
        weights: Optional[torch.Tensor] = None,  # (batch, bag)
        reduce_fn: Optional[Callable] = None,
    ) -> torch.Tensor:
        """Embedding-bag sum across all device shards (DLRM §5.2 reduction).

        ``reduce_fn(table, indices, weights) -> (batch, feature)`` defaults
        to the ``embedding_reduce`` kernel (its plain version for shards on
        the CPU).  Rows owned by another device contribute weight 0 to
        each shard, which the kernel skips without a row load, so the
        per-shard partials sum to the un-tiered reduction exactly and the
        slow shard is only read for the rows it owns."""
        if reduce_fn is None:
            from repro_torch.kernels.embedding_reduce import ops
            reduce_fn = ops.embedding_reduce
        indices = torch.as_tensor(indices).to(self.device)
        if weights is None:
            weights = torch.ones(indices.shape, dtype=self.parts[0].dtype,
                                 device=self.device)
        weights = torch.as_tensor(weights).to(self.device)
        dev, local = self._route(indices)
        if max(p.shape[0] for p in self.parts) <= _INT32_ROWS:
            local = local.to(torch.int32)  # the kernel reads 4-byte indices
        out = None
        for i, part in enumerate(self.parts):
            if part.shape[0] == 0:
                continue
            w_i = torch.where(dev == i, weights, 0).to(part.dtype)
            local_i = local.clamp(max=part.shape[0] - 1)
            partial = reduce_fn(part, local_i, w_i)
            out = partial if out is None else out + partial
        if out is None:  # zero-row tensor
            feat = tuple(self.parts[0].shape[1:])
            out = torch.zeros((indices.shape[0],) + feat,
                              dtype=self.parts[0].dtype, device=self.device)
        return out

    # -- migration (TPP-style page moves; used by elastic re-planning) -------
    def migrate_pages(self, page_ids: np.ndarray, to_slow: bool) -> "InterleavedTensor":
        """Move whole pages between tiers (rebuilds the tensor)."""
        dense = self.to_array()
        dev = self._host_map()[0].copy()
        dev[np.asarray(page_ids)] = 1 if to_slow else 0
        policy_like = _ExplicitAssignment(dev, self.device_names)
        return InterleavedTensor.from_array(
            dense, policy_like, self.page_rows, device=self.device,
            headroom=self.headroom, backend=self.backend,
        )

    def repartition(
        self,
        policy: MemPolicy,
        *,
        mover=None,  # Optional[BulkMover]
        fast_tier: Optional[str] = None,
        slow_tier: Optional[str] = None,
        telemetry: Telemetry = GLOBAL_TELEMETRY,
        source: Optional[str] = None,
        lane: Optional[int] = None,
        donate: bool = False,
    ) -> "InterleavedTensor":
        """Re-tier under ``policy``, migrating ONLY the delta pages.

        The Caption controller's actuation path: diff the current
        page->device map against the policy's and ship just the changed
        pages between devices — through the
        :class:`~repro_torch.core.mover.BulkMover` when one is given
        (batched descriptors, writer-limited; the landed data is the
        mover's copy), else copied directly and accounted to telemetry.
        Unchanged pages never cross the interconnect, so inter-device
        traffic equals ``delta_pages * page_bytes`` exactly.  Every move
        is billed to its real ``(src_device, dst_device)`` route.

        ``fast_tier``/``slow_tier`` override the first two route labels
        (the two-device compatibility path).

        ``donate=True`` lets the stable path write receiving shards in
        place (zero full-shard copies, every ``data_ptr()`` kept) — only
        valid when the caller drops ``self`` after the call (the Caption
        actuation pattern ``it = it.repartition(...)``).

        Numerically a no-op: ``to_array()`` before == after.
        """
        n = self.n_pages
        new_dev, names = _policy_device_map(policy, n)
        # Widen with the tensor's EXISTING names: a narrower policy on a
        # wider tensor must keep billing the higher ordinals' real
        # devices, not rename them to placeholders.
        names = resolve_device_names(
            self.device_names, max(len(names), len(self.parts)), names,
            fast_tier, slow_tier)
        return self._reassign(new_dev, names, mover=mover,
                              telemetry=telemetry, source=source, lane=lane,
                              donate=donate)

    def reassign_pages(self, new_dev: np.ndarray, *,
                       device_names: Optional[Sequence[str]] = None,
                       mover=None, telemetry: Telemetry = GLOBAL_TELEMETRY,
                       source: Optional[str] = None,
                       lane: Optional[int] = None,
                       donate: bool = False) -> "InterleavedTensor":
        """Re-tier to an EXPLICIT page -> device-ordinal map.

        The semantic-placement entry point: a caller that knows *what*
        each page holds hands the exact map instead of a share vector,
        and the move still rides the normal O(Δ) path — run-coalesced
        route-pure descriptors, shape-stable shards under ``headroom``,
        optional donation.  A map equal to the current assignment returns
        ``self`` unchanged."""
        new_dev = np.asarray(new_dev, np.int8)
        if new_dev.shape != (self.n_pages,):
            raise ValueError(
                f"assignment has {new_dev.shape} pages, tensor has "
                f"{self.n_pages}")
        if new_dev.size and int(new_dev.min()) < 0:
            raise ValueError("negative device ordinal")
        n_devices = max(len(self.parts), int(new_dev.max(initial=0)) + 1)
        names = resolve_device_names(self.device_names, n_devices,
                                     device_names)
        return self._reassign(new_dev, names, mover=mover,
                              telemetry=telemetry, source=source, lane=lane,
                              donate=donate)

    # -- the vectorized O(Δ) actuation core ----------------------------------
    def _move_runs(self, delta: np.ndarray, old_dev: np.ndarray,
                   old_local: np.ndarray, new_dev: np.ndarray
                   ) -> list[tuple[int, int, np.ndarray, int]]:
        """Coalesce the delta pages into route-pure movement runs.

        Returns ``(src_dev, dst_dev, page_ids, src_local_start)`` tuples
        where the pages' source locals are consecutive — each run is one
        contiguous slab of its source shard and ships as ONE batched
        descriptor.  Sorting is (src, dst, src_local), so coalescing
        never mixes routes and billed bytes are exactly
        ``delta_pages * page_bytes``."""
        if delta.size == 0:
            return []
        order, starts, ends = route_pure_runs(
            old_dev[delta], new_dev[delta], old_local[delta])
        pages = delta[order]
        src = old_dev[delta][order]
        dst = new_dev[delta][order]
        loc = old_local[delta][order]
        return [(int(src[s]), int(dst[s]), pages[s:e], int(loc[s]))
                for s, e in zip(starts, ends)]

    def _memory(self, ordinal: int):
        """Mover ``dst`` for shard ``ordinal``: HBM or pinned host on the
        ``pinned`` backend; beside the payload (the host) on ``modeled``."""
        if self.backend != "pinned":
            return None
        return self.device if ordinal == 0 else PINNED

    def _slab(self, s: int, l0: int, n_pages: int) -> torch.Tensor:
        pr = self.page_rows
        return self.parts[s][l0 * pr: (l0 + n_pages) * pr]

    def _ship_runs(self, runs, names, *, mover, telemetry, source, lane
                   ) -> list[torch.Tensor]:
        """Move the runs' data into their destinations' memory and return
        one staged copy per run (gather-first: nothing is written yet).

        With a mover: one batched descriptor per run, and the staged data
        is the executor's output (on the card, after this stream waits on
        each copy's ``done`` event).  Without one: one ``stream_copy`` per
        run on the current stream (the kernel on the card, its plain
        version on the CPU) and one telemetry record per run."""
        if not runs:
            return []
        if mover is None:
            from repro_torch.kernels.stream_copy.ops import stream_copy
            page_bytes = self.page_rows * self.row_bytes
            staged = []
            for s, d, pages, l0 in runs:
                telemetry.record_move(_route_name(names, s),
                                      _route_name(names, d),
                                      page_bytes * len(pages), 0.0,
                                      source=source)
                slab = self._slab(s, l0, len(pages))
                staged.append(stream_copy(
                    slab, out=_empty(slab.shape, slab.dtype, d, self.backend,
                                     self.device), device=self.device))
        else:
            staged = self._issue_runs(runs, names, mover=mover,
                                      source=source, lane=lane)
        if self.device.type == "cuda" and any(not t.is_cuda for t in staged):
            # host-side landings below run on the CPU: the copies into
            # pinned staging, and every kernel still reading the pinned
            # shards, must have finished first
            torch.cuda.current_stream(self.device).synchronize()
        return staged

    def _issue_runs(self, runs, names, *, mover, source, lane
                    ) -> list[torch.Tensor]:
        """One descriptor per run through ``mover``; returns the executor's
        outputs once this stream has waited on each copy's ``done``."""
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        descs = [
            Descriptor(
                src_tier=_route_name(names, s),
                dst_tier=_route_name(names, d),
                payload=self._slab(s, l0, len(pages)),
                lane=LANE_BULK if lane is None else lane,
                source=source,
                dst=self._memory(d),
                ready=ready,
            )
            for s, d, pages, l0 in runs
        ]
        futures = mover.issue(descs)
        if mover.asynchronous:
            mover.wait_all()
        staged = [f.result().result for f in futures]
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            for desc in descs:
                if desc.done is not None:
                    stream.wait_event(desc.done)
        return staged

    def _land(self, targets: dict, runs, staged, new_local: np.ndarray
              ) -> None:
        """Write each run's staged pages into its destination slots."""
        pr = self.page_rows
        feat = tuple(self.parts[0].shape[1:])
        by_dst: dict[int, list] = {}
        for (s, d, pages, l0), data in zip(runs, staged):
            by_dst.setdefault(d, []).append((pages, data))
        for d, items in by_dst.items():
            target = targets[d]
            rows = np.concatenate([
                (new_local[pages].astype(np.int64)[:, None] * pr
                 + np.arange(pr)).reshape(-1) for pages, _ in items])
            rows_t = torch.as_tensor(rows, device=target.device)
            off = 0
            for pages, data in items:
                n = len(pages) * pr
                if data.is_cuda:
                    data.record_stream(torch.cuda.current_stream(data.device))
                donated_update(target, rows_t[off: off + n],
                               data.reshape((n,) + feat), "set")
                off += n

    def _reassign(self, new_dev: np.ndarray, names: tuple[str, ...], *,
                  mover=None, telemetry: Telemetry = GLOBAL_TELEMETRY,
                  source: Optional[str] = None,
                  lane: Optional[int] = None,
                  donate: bool = False) -> "InterleavedTensor":
        new_dev = np.asarray(new_dev, np.int8)
        old_dev, old_local = self._host_map()
        n_devices = max(len(names), len(self.parts),
                        int(new_dev.max(initial=0)) + 1)
        delta = np.nonzero(new_dev != old_dev)[0]
        if delta.size == 0 and n_devices == len(self.parts):
            return self

        new_counts = np.bincount(new_dev, minlength=n_devices)
        caps = self.capacity_pages

        # Ship the movement first (payloads slice the CURRENT shards): one
        # route-pure batched descriptor per contiguous run.  Every moved
        # page is staged before any shard is written (ORDERING HAZARD: a
        # leaving page's old slot counts as free and may be refilled).
        runs = self._move_runs(delta, old_dev, old_local, new_dev)
        staged = self._ship_runs(runs, names, mover=mover,
                                 telemetry=telemetry, source=source,
                                 lane=lane)

        stable = (self.headroom > 0 and n_devices == len(self.parts)
                  and all(int(new_counts[d]) <= caps[d]
                          for d in range(n_devices)))
        if stable:
            out = self._reassign_stable(delta, old_dev, old_local, new_dev,
                                        runs, staged, donate=donate)
        else:
            out = self._reassign_rebuild(old_dev, old_local, new_dev,
                                         n_devices, runs, staged)
        final = dataclasses.replace(
            out, device_names=tuple(_route_name(names, d)
                                    for d in range(n_devices)))
        final._with_map(*out._host_map())
        return final

    def _reassign_stable(self, delta: np.ndarray, old_dev: np.ndarray,
                         old_local: np.ndarray, new_dev: np.ndarray,
                         runs, staged, donate: bool = False
                         ) -> "InterleavedTensor":
        """Shape-stable fast path: every moved page lands in a free slot
        of its destination shard — shard shapes and every unmoved page's
        slot are untouched.  Planning, index updates, and metered movement
        are all O(Δ).  The landing write goes either into one copy of each
        RECEIVING shard (non-receiving shards are reused as-is), or — with
        ``donate`` — into the receiving shard itself: zero full copies,
        O(Δ) rows written, every ``data_ptr()`` kept (the caller must drop
        the parent)."""
        new_local = old_local.copy()
        caps = self.capacity_pages
        recv = new_dev[delta]
        parts = list(self.parts)
        targets = {}
        for d in np.unique(recv):
            d = int(d)
            incoming = delta[recv == d]
            # free slots = capacity minus the slots kept by staying pages
            staying = (old_dev == d) & (new_dev == d)
            used = np.zeros(caps[d], bool)
            used[old_local[staying]] = True
            free = np.nonzero(~used)[0]
            new_local[incoming] = free[: incoming.size].astype(np.int32)
            if donate:
                targets[d] = parts[d]
            else:
                FULL_SHARD_COPIES.bump()
                targets[d] = self._copy_shard(d)
        self._land(targets, runs, staged, new_local)
        for d, target in targets.items():
            parts[d] = target
        out = dataclasses.replace(self, parts=tuple(parts),
                                  **self._maps(new_dev, new_local))
        out._with_map(new_dev, new_local)
        return out

    def _reassign_rebuild(self, old_dev: np.ndarray, old_local: np.ndarray,
                          new_dev: np.ndarray, n_devices: int, runs, staged
                          ) -> "InterleavedTensor":
        """Exact-size (or grow) path: rebuild each shard at its new count
        plus headroom.  Staying pages are copied over from their old
        shard, moved pages land from their staged copies.  This is the
        path that changes shapes and storage, by design (headroom
        exhausted or the device set widened)."""
        pr = self.page_rows
        feature = tuple(self.parts[0].shape[1:])
        dtype = self.parts[0].dtype
        dev2, local2, counts = device_page_map(new_dev, n_devices)
        parts = []
        for d in range(n_devices):
            cap = counts[d] + self.headroom
            part = _empty((cap * pr,) + feature, dtype, d, self.backend,
                          self.device)
            if cap == 0:
                parts.append(part)
                continue
            FULL_SHARD_COPIES.bump()
            part.view((cap, pr) + feature)[counts[d]:].zero_()
            stay = np.nonzero((old_dev == d) & (dev2 == d))[0]
            if stay.size:
                src = (old_local[stay].astype(np.int64)[:, None] * pr
                       + np.arange(pr)).reshape(-1)
                dst = (local2[stay].astype(np.int64)[:, None] * pr
                       + np.arange(pr)).reshape(-1)
                old = self.parts[d]
                donated_update(part, torch.as_tensor(dst, device=part.device),
                               old.index_select(0, torch.as_tensor(
                                   src, device=old.device)), "set")
            parts.append(part)
        self._land(dict(enumerate(parts)), runs, staged, local2)
        out = dataclasses.replace(self, parts=tuple(parts),
                                  **self._maps(dev2, local2))
        out._with_map(dev2, local2)
        return out

    def repartition_fraction(self, fraction: float, **kwargs
                             ) -> "InterleavedTensor":
        """Re-tier to ``fraction`` slow with the minimal page delta
        (two-device path: the single slow device absorbs the fraction)."""
        return self.repartition_weights((float(fraction),), **kwargs)

    def repartition_weights(self, weights: Sequence[float], *,
                            mover=None, fast_tier: Optional[str] = None,
                            slow_tier: Optional[str] = None,
                            device_names: Optional[Sequence[str]] = None,
                            telemetry: Telemetry = GLOBAL_TELEMETRY,
                            source: Optional[str] = None,
                            lane: Optional[int] = None,
                            run_pages: int = DEFAULT_RUN_PAGES,
                            donate: bool = False
                            ) -> "InterleavedTensor":
        """Re-tier to a per-slow-device weight vector with minimal moves.

        ``weights[i]`` is the target page share of slow device ``i``; the
        fast tier keeps the remainder.  Unlike building an N:M policy —
        whose round-robin pattern can disagree with the current map on far
        more pages than the share delta — this flips exactly the surplus/
        deficit page counts, clustered into evenly spread runs of up to
        ``run_pages`` consecutive pages so the mover drains O(runs)
        batched descriptors instead of O(pages).  A weight vector that
        rounds to the current per-device page counts is a true no-op: the
        same object is returned and no mover work is enqueued."""
        n_devices = max(len(self.parts), len(weights) + 1)
        dev, _ = self._host_map()
        new_dev = minimal_delta_weights(dev, tuple(weights), n_devices,
                                        run_pages=run_pages)
        if new_dev is None:  # rounds to the current assignment: no-op
            return self
        names = resolve_device_names(self.device_names, n_devices,
                                     device_names, fast_tier, slow_tier)
        return self._reassign(new_dev, names, mover=mover,
                              telemetry=telemetry, source=source, lane=lane,
                              donate=donate)

    def drain_device(self, device, **kwargs) -> "InterleavedTensor":
        """Move every page off one slow device (elastic hot-remove drain).

        ``device`` is a slow-device ordinal (>= 1) or its name.  The
        departing share is redistributed over the surviving slow devices
        proportionally to their current shares (the fast tier absorbs it
        when no survivor holds pages), and the move rides the normal
        minimal-delta repartition path: run-coalesced LANE_BULK
        descriptors on real (dead device -> survivor) routes.  Keyword
        arguments forward to :meth:`repartition_weights`."""
        if isinstance(device, str):
            if device not in self.device_names:
                raise KeyError(device)
            i = self.device_names.index(device)
        else:
            i = int(device)
        if not 1 <= i < self.n_devices:
            raise KeyError(device)
        cur = list(self.weights())
        departing, cur[i - 1] = cur[i - 1], 0.0
        rest = sum(cur)
        if departing > 0 and rest > 0:
            cur = [w + departing * w / rest for w in cur]
        return self.repartition_weights(tuple(cur), **kwargs)

    def to_array(self) -> torch.Tensor:
        """Materialize the logical array on ``self.device`` (tests /
        checkpointing)."""
        return self.gather_rows(torch.arange(self.rows))

    # -- accounting -----------------------------------------------------------
    def traffic_bytes(self, idx) -> dict[str, int]:
        """Bytes touched per device for an index batch (host-side)."""
        page = _as_numpy(idx).ravel() // self.page_rows
        dev_map, _ = self._host_map()
        dev = dev_map[np.minimum(page, self.n_pages - 1)]
        out = {}
        for i, name in enumerate(self.device_names):
            out[name] = int((dev == i).sum()) * self.row_bytes
        # two-device compatibility keys
        out.setdefault("fast", out.get(self.device_names[0], 0))
        out.setdefault("slow", sum(
            int((dev == i).sum()) * self.row_bytes
            for i in range(1, len(self.parts))))
        return out

    def record_gather(self, idx, seconds: float,
                      telemetry: Telemetry = GLOBAL_TELEMETRY) -> None:
        t = self.traffic_bytes(idx)
        for i, name in enumerate(self.device_names):
            telemetry.record_move(name, "engine", t.get(name, 0), seconds)


def _route_name(names: Sequence[str], d: int) -> str:
    return names[d] if d < len(names) else f"dev{d}"


class _ExplicitAssignment:
    """Adapter: a fixed page->device map with the MemPolicy interface."""

    def __init__(self, assignment: np.ndarray,
                 tiers: Sequence[str] = ("fast", "slow")):
        self._assignment = np.asarray(assignment).astype(np.int8)
        self.tiers = tuple(tiers)

    def assign_pages(self, n_pages: int) -> np.ndarray:
        if n_pages != len(self._assignment):
            raise ValueError("page count mismatch")
        return self._assignment

    def page_is_slow(self, n_pages: int) -> np.ndarray:
        return self.assign_pages(n_pages) >= 1


def _round_targets(weights: tuple[float, ...], n_pages: int) -> list[int]:
    """Per-slow-device page targets by largest-remainder rounding.

    The total slow count is ``round(sum(weights) * n)`` — identical to the
    scalar path's rounding — then split so the per-device counts sum to it
    exactly (plain per-device rounding can create or destroy pages)."""
    w = [min(max(float(x), 0.0), 1.0) for x in weights]
    total = min(sum(w), 1.0)
    want = int(round(total * n_pages))
    base, _ = largest_remainder_split([x * n_pages for x in w], want)
    return base


def _spread_run_picks(n_cands: int, k: int, run_pages: int) -> np.ndarray:
    """Indices (into a candidate list of length ``n_cands``) of ``k``
    picks grouped into evenly spaced runs of up to ``run_pages``
    consecutive candidates.

    The movement-coalescing compromise: perfectly even per-page spreading
    (stride n/k) keeps the interleave discipline but makes every moved
    page its own mover descriptor; clustering the picks into short runs
    whose *starts* stay evenly spread keeps the access interleave nearly
    uniform while letting the actuator ship each run as one contiguous
    batched descriptor."""
    if k >= n_cands:
        return np.arange(n_cands)
    n_runs = max(1, -(-k // max(run_pages, 1)))
    picked = np.zeros(n_cands, bool)
    taken = 0
    prev_end = 0
    for j in range(n_runs):
        want = (k - taken + (n_runs - j - 1)) // (n_runs - j)  # ceil spread
        start = max((j * n_cands) // n_runs, prev_end)
        end = min(start + want, n_cands)
        picked[start:end] = True
        taken += end - start
        prev_end = end
    if taken < k:  # dense move: fill from the unpicked complement
        rest = np.nonzero(~picked)[0][: k - taken]
        picked[rest] = True
    return np.nonzero(picked)[0]


def minimal_delta_weights(current: np.ndarray, weights: tuple[float, ...],
                          n_devices: int, *,
                          run_pages: int = DEFAULT_RUN_PAGES
                          ) -> Optional[np.ndarray]:
    """New page->device map hitting ``weights`` with the FEWEST moves.

    Returns ``None`` when the targets round to the current per-device
    counts (the no-op guarantee: callers must not churn page ids or
    enqueue empty-delta mover work).  Surplus pages are released in
    evenly spread *runs* of up to ``run_pages`` consecutive pages — each
    run is a contiguous slab of its device and ships as one batched
    mover descriptor — and the runs are dealt to deficit devices
    round-robin, so each deficit device's new pages stay spread across
    the address range (clustered pages would serialize one device on
    strided access).  ``run_pages=1`` recovers the legacy page-at-a-time
    even spreading exactly."""
    cur = np.asarray(current, np.int8)
    n = len(cur)
    targets = _round_targets(tuple(weights), n)
    targets += [0] * (n_devices - 1 - len(targets))
    counts = np.bincount(cur, minlength=n_devices)
    target_all = [n - sum(targets)] + list(targets)
    if all(int(counts[d]) == target_all[d] for d in range(n_devices)):
        return None
    out = cur.copy()
    # Release surplus pages as evenly spread runs within each device.  A
    # run is contiguous in the device's CANDIDATE order — i.e. in its
    # source locals when those are rank-ordered — which is exactly what
    # the actuator can ship as one contiguous-slab descriptor.
    runs_list: list[np.ndarray] = []
    for d in range(n_devices):
        surplus = int(counts[d]) - target_all[d]
        if surplus <= 0:
            continue
        cands = np.nonzero(cur == d)[0]
        picks = _spread_run_picks(len(cands), surplus, run_pages)
        for start, length in contiguous_runs(picks):
            runs_list.append(cands[picks[start: start + length]])
    # Deal whole runs to deficit devices, round-robin, so each deficit
    # device's new pages stay spread across the address range AND every
    # run stays route-pure (one (src, dst) per run; split only when a
    # deficit fills mid-run).
    runs_list.sort(key=lambda a: int(a[0]))
    deficits = [[d, target_all[d] - int(counts[d])]
                for d in range(n_devices) if target_all[d] > int(counts[d])]
    k = 0
    for run in runs_list:
        offset = 0
        while offset < len(run):
            entry = deficits[k % len(deficits)]
            if entry[1] <= 0:
                deficits.pop(k % len(deficits))
                continue
            take = min(entry[1], len(run) - offset)
            out[run[offset: offset + take]] = entry[0]
            entry[1] -= take
            offset += take
            k += 1
    return out


def minimal_delta_assignment(current: np.ndarray, fraction: float) -> np.ndarray:
    """Two-device view of :func:`minimal_delta_weights`.

    The Caption actuation helper: two N:M interleave patterns at nearby
    ratios can disagree on far more pages than the ratio delta, so the
    controller flips exactly ``|target - current|`` pages instead,
    spreading the flipped pages evenly.  When ``fraction`` rounds to the
    current slow-page count the current assignment is returned unchanged
    (no phantom page-id churn)."""
    cur = np.asarray(current, np.int8)
    out = minimal_delta_weights(np.minimum(cur, 1), (float(fraction),), 2)
    return cur.copy() if out is None else out
