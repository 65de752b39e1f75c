"""Tiered, page-interleaved KV cache + decode step (the Redis §5.1 analogue).

The KV time axis is split into pages placed across (fast, slow...) devices
by a MemPolicy — the paper's N:M weighted interleave applied to serving
state.  Decode attends over every device partition with the
``decode_attention`` kernel and merges exactly via log-sum-exp
(``attention.merge_partials``); per-step per-tier byte counts feed the
perfmodel.

Placement is **per slot**: each batch slot carries its own page->device
map, so a latency-SLO request can pin its pages fast while batch-class
neighbours tolerate slow pages.  Pinned slots are excluded from
``repartition_fraction``.

Physical layout: **per-device pools** — one ``(L, B, T_d, K, hd)`` K/V
pool pair per device ordinal, placed by
:func:`repro_torch.device.shard_storage`: on the card pool 0 lives in HBM
and every slow pool in page-locked host memory, which the kernels read
and write in place through unified virtual addressing; on the CPU every
pool is a host tensor and the split is accounting.  The fast pool is
sized for ALL pages; each slow pool holds its own pages plus
``slow_headroom`` pages.  A retile whose per-device counts fit the held
capacities takes the **O(Δ) stable path**: moved pages land in free slots
of their destination pool and, with ``donate=True``, the receiving pools
are written in place (every ``data_ptr()`` kept, zero full-pool copies).
Only when a pool outgrows its capacity (or the device set changes) does
the full rebuild run.

Where the port differs from the reference, by design:

* The pools are written in place — by the decode step's append (the
  ``kv_append`` kernel: no host sync inside the step), by
  ``write_token_rows`` and ``write_prefix_pages``, and by donated
  retiles.  A cache object returned by those calls shares its pools with
  its parent; page maps, positions and lengths stay functional.
* Page moves are data moves: each route-pure run of a slot group is
  staged, as one segment list, in its destination pool's staging buffer
  (kept by the cache and grown on demand) by the ``stream_copy`` kernel
  (the mover's executor, or a direct launch without a mover), then landed in
  its free slots by one ``stream_copy`` segment-list launch (a rebuild's
  staying pages ride the same launch).  The host never reads or writes a
  pool, so only a fenced move (``wait=True``) waits for the stream; an
  unfenced one returns once its launches are queued.  There is no host
  mirror of a pool; the host holds only the page maps it plans with.
* The page maps, positions and lengths live beside pool 0 (HBM on the
  card); host copies of the page maps and positions are cached for
  planning.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.donation import FULL_SHARD_COPIES
from repro_torch.core.interleave import (_policy_device_map,
                                         minimal_delta_weights,
                                         page_segments,
                                         resolve_device_names,
                                         route_pure_runs)
from repro_torch.core.mover import (LANE_BULK, LANE_LATENCY, PINNED,
                                    Descriptor, Segments)
from repro_torch.core.policy import MemPolicy
from repro_torch.core.telemetry import GLOBAL_TELEMETRY
from repro_torch.device import (DeviceLike, resolve_backend, resolve_device,
                                shard_storage)
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.stream_copy.ops import (stream_copy,
                                                 stream_copy_segments)
from repro_torch.models import attention as attn
from repro_torch.models.common import (apply_norm, dtype_of, mlp_apply,
                                       rope_tables, rotate)
from repro_torch.serving.prefix_cache import NO_PAGE, UNALLOCATED, PrefixBlock

_INT32_MAX = np.iinfo(np.int32).max


def _kv_device_layout_rows(assign: np.ndarray, page_t: int, n_devices: int):
    """Physical layout for a (B, n_pages) page->device map.

    Returns ``(local, counts, pos_list)``: ``local[b, p]`` is page p's
    rank within its owning device (page order), ``counts[d, b]`` the page
    count of device d in slot b, and ``pos_list[d]`` the
    ``(B, max_b counts[d, b] * page_t)`` global position held by each
    pool slot (INT32_MAX pads never validate in the attention masks)."""
    assign = np.asarray(assign)
    B, P = assign.shape
    local = np.zeros((B, P), np.int32)
    counts = np.zeros((n_devices, B), np.int64)
    pos_list = []
    at = np.arange(page_t)
    for d in range(n_devices):
        mask = assign == d
        counts[d] = mask.sum(axis=1)
        local = np.where(mask, np.cumsum(mask, axis=1) - 1, local).astype(
            np.int32)
        need = int(counts[d].max(initial=0))
        if need == 0:
            pos_list.append(np.zeros((B, 0), np.int32))
            continue
        order = np.argsort(~mask, axis=1, kind="stable")[:, :need]
        allpos = (order[:, :, None] * page_t + at).reshape(
            B, need * page_t).astype(np.int32)
        cols = np.arange(need * page_t)
        pos_d = np.where(cols[None, :] < counts[d][:, None] * page_t,
                         allpos, _INT32_MAX)
        pos_list.append(pos_d.astype(np.int32))
    return local, counts, pos_list


def _pad_pos(pos: np.ndarray, T: int) -> np.ndarray:
    """Pad a (B, t) position map to (B, T) with never-valid sentinels."""
    if pos.shape[1] >= T:
        return pos
    pad = np.full((pos.shape[0], T - pos.shape[1]), _INT32_MAX, np.int32)
    return np.concatenate([pos, pad], axis=1)


def _segments(dev: np.ndarray, rows: np.ndarray):
    """Maximal runs of positions on one device with consecutive pool rows:
    ``[(device, first row, first position, length)]``."""
    if dev.size == 0:
        return []
    brk = np.nonzero((np.diff(dev) != 0) | (np.diff(rows) != 1))[0] + 1
    starts = np.concatenate(([0], brk))
    ends = np.concatenate((brk, [dev.size]))
    return [(int(dev[s]), int(rows[s]), int(s), int(e - s))
            for s, e in zip(starts, ends)]


@dataclasses.dataclass
class _Run:
    """One route-pure run of one slot group: ``pages`` (in source-local
    order) of every slot in ``slots`` move from device ``src`` (locals
    ``l0 ..``) to ``dst``; ``k``/``v`` hold the staged copies, one
    ``(L, len(pages) * page_t * K * hd)`` tensor per slot, in the
    destination's memory."""

    slots: np.ndarray
    src: int
    dst: int
    pages: np.ndarray
    l0: int
    k: list
    v: list


@dataclasses.dataclass
class TieredKVCache:
    #: per-device K/V pools: ``k_parts[d]`` is ``(L, B, T_d, K, hd)``.
    k_parts: tuple
    v_parts: tuple
    lengths: torch.Tensor  # (B,) int32
    #: (B, n_pages) int32: page slot within its OWN device pool
    page_local: torch.Tensor
    #: per-device (B, T_d) int32 global position held by each pool slot.
    pos_parts: tuple
    #: (B, n_pages) int8 owning device ordinal (0 = fast).
    page_device: torch.Tensor
    page_t: int
    device_names: tuple = ("fast", "slow")
    #: slow-pool capacity padding, in pages per slot per device.
    slow_headroom: int = 0
    #: shared-prefix page pool (None disables sharing).
    prefix: Optional[PrefixBlock] = None
    #: pool memory backend: ``modeled`` (host) or ``pinned`` (HBM + pinned).
    backend: str = "modeled"
    #: where pool 0, the maps and the step's tensors live.
    device: torch.device = torch.device("cpu")

    # -- functional updates that keep the host map caches ----------------------
    def _evolve(self, **changes) -> "TieredKVCache":
        out = dataclasses.replace(self, **changes)
        if "page_device" not in changes and "_host_cache" in self.__dict__:
            out.__dict__["_host_cache"] = self.__dict__["_host_cache"]
        if "page_local" not in changes and "_local_cache" in self.__dict__:
            out.__dict__["_local_cache"] = self.__dict__["_local_cache"]
        if "pos_parts" not in changes and "_pos_cache" in self.__dict__:
            out.__dict__["_pos_cache"] = self.__dict__["_pos_cache"]
        if "_stages" in self.__dict__:
            out.__dict__["_stages"] = self.__dict__["_stages"]
        return out

    def _with_host(self, dev: np.ndarray, local: np.ndarray
                   ) -> "TieredKVCache":
        self.__dict__["_host_cache"] = np.asarray(dev)
        self.__dict__["_local_cache"] = np.asarray(local)
        return self

    # -- two-pool compatibility views ------------------------------------------
    @property
    def k_fast(self) -> torch.Tensor:
        return self.k_parts[0]

    @property
    def v_fast(self) -> torch.Tensor:
        return self.v_parts[0]

    @property
    def pos_fast(self) -> torch.Tensor:
        return self.pos_parts[0]

    @property
    def k_slow(self) -> torch.Tensor:
        return self.k_parts[1]

    @property
    def v_slow(self) -> torch.Tensor:
        return self.v_parts[1]

    @property
    def pos_slow(self) -> torch.Tensor:
        return self.pos_parts[1]

    @property
    def page_tier(self) -> torch.Tensor:
        """(B, n_pages) int8 0/1 fast-vs-slow view of the device map."""
        return torch.clamp(self.page_device, max=1).to(torch.int8)

    # -- host-side map cache ----------------------------------------------------
    def _host_dev(self) -> np.ndarray:
        """Cached numpy page->device map (the Caption loop reads it every
        epoch and must not copy the device map back each time)."""
        cached = self.__dict__.get("_host_cache")
        if cached is None:
            cached = self.page_device.cpu().numpy()
            self.__dict__["_host_cache"] = cached
        return cached

    def _host_pos(self) -> list:
        """Host copies of ``pos_parts`` (cached while the tensors are the
        same; a retile seeds the cache, so it need not read them back)."""
        key = tuple(id(p) for p in self.pos_parts)
        cached = self.__dict__.get("_pos_cache")
        if cached is None or cached[0] != key:
            cached = (key, [p.cpu().numpy() for p in self.pos_parts])
            self.__dict__["_pos_cache"] = cached
        return cached[1]

    def _with_host_pos(self, pos: list) -> "TieredKVCache":
        self.__dict__["_pos_cache"] = (tuple(id(p) for p in self.pos_parts),
                                       pos)
        return self

    def _host_local(self) -> np.ndarray:
        cached = self.__dict__.get("_local_cache")
        if cached is None:
            cached = self.page_local.cpu().numpy()
            self.__dict__["_local_cache"] = cached
        return cached

    def _pool(self, d: int, shape, dtype) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=dtype,
                           **shard_storage(d, self.backend, self.device))

    def _copy_pool(self, d: int, pool: torch.Tensor) -> torch.Tensor:
        """A copy of pool ``d`` in the same memory (pinned stays pinned):
        one ``stream_copy`` launch on the card, in stream order."""
        out = torch.empty(tuple(pool.shape), dtype=pool.dtype,
                          **shard_storage(d, self.backend, self.device))
        return stream_copy(pool, out=out, device=self.device)

    def _dev(self, array, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array), dtype=dtype,
                               device=self.device)

    # -- construction ---------------------------------------------------------
    @classmethod
    def create(cls, cfg: ArchConfig, batch: int, max_len: int,
               policy: MemPolicy, *, page_t: int = 256, dtype=None,
               slow_headroom: int = 0, device: DeviceLike = None
               ) -> "TieredKVCache":
        """Empty pools on ``device`` (``cuda`` unless told ``"cpu"``)."""
        device = resolve_device(device)
        backend = resolve_backend(None, device)
        dt = dtype or dtype_of(cfg.param_dtype)
        L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
        page_t = min(page_t, max_len)
        assert max_len % page_t == 0
        n_pages = max_len // page_t
        slow_headroom = min(max(int(slow_headroom), 0), n_pages)
        dev_row, names = _policy_device_map(policy, n_pages)
        dev = np.array(np.broadcast_to(dev_row.astype(np.int8),
                                       (batch, n_pages)))
        n_devices = len(names)
        local, counts, pos_list = _kv_device_layout_rows(dev, page_t,
                                                         n_devices)
        caps = [n_pages * page_t]  # fast pool holds every page
        for d in range(1, n_devices):
            caps.append(min(int(counts[d].max(initial=0)) + slow_headroom,
                            n_pages) * page_t)
        shell = cls((), (), None, None, (), None, page_t, names,
                    slow_headroom, None, backend, device)
        out = cls(
            k_parts=tuple(shell._pool(d, (L, batch, caps[d], K, hd), dt)
                          for d in range(n_devices)),
            v_parts=tuple(shell._pool(d, (L, batch, caps[d], K, hd), dt)
                          for d in range(n_devices)),
            lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
            page_local=shell._dev(local, torch.int32),
            pos_parts=tuple(shell._dev(_pad_pos(pos_list[d], caps[d]),
                                       torch.int32)
                            for d in range(n_devices)),
            page_device=shell._dev(dev, torch.int8),
            page_t=page_t,
            device_names=names,
            slow_headroom=slow_headroom,
            backend=backend,
            device=device,
        )
        return out._with_host(dev, local)

    # -- addressing -------------------------------------------------------------
    def _route(self, pos: torch.Tensor):
        """token position -> (owning device ordinal, flat pool row)."""
        page = torch.clamp(pos // self.page_t,
                           max=self.page_device.shape[1] - 1)[:, None].long()
        dev = torch.gather(self.page_device, 1, page)[:, 0]
        local = torch.gather(self.page_local, 1, page)[:, 0]
        return dev, local * self.page_t + pos % self.page_t

    def slow_fraction(self, pinned_slots=()) -> float:
        """Slow-page share of the *tunable* slots (all slots minus
        ``pinned_slots``)."""
        tiers = np.minimum(self._host_dev(), 1).astype(np.float32)
        pinned = set(pinned_slots)
        unpinned = [b for b in range(tiers.shape[0]) if b not in pinned]
        if not unpinned:
            return 0.0
        return float(tiers[unpinned].mean())

    def weights(self, pinned_slots=()) -> tuple[float, ...]:
        """Per-slow-device page shares of the tunable slots."""
        dev = self._host_dev()
        pinned = set(pinned_slots)
        unpinned = [b for b in range(dev.shape[0]) if b not in pinned]
        n_slow = max(len(self.device_names) - 1, 1)
        if not unpinned:
            return (0.0,) * n_slow
        sub = dev[unpinned]
        return tuple(float((sub == i + 1).mean()) for i in range(n_slow))

    def device_fractions(self, pinned_slots=()) -> dict[str, float]:
        """Per-device page share of the tunable slots, keyed by name."""
        w = self.weights(pinned_slots)
        out = {self.device_names[0]: 1.0 - sum(w)}
        for i, share in enumerate(w):
            out[self.device_names[i + 1]] = share
        return out

    # -- per-step traffic -------------------------------------------------------
    def _dims(self) -> tuple[int, int, int, int]:
        kp = self.k_parts[0]
        return kp.shape[0], kp.shape[3], kp.shape[4], kp.element_size()

    def read_bytes_per_step(self) -> dict[str, int]:
        """Bytes streamed per decode step per tier (both K and V)."""
        L, K, hd, item = self._dims()
        tiers = np.minimum(self._host_dev(), 1)
        n_pages = tiers.shape[1]
        slow_pages = tiers.sum(axis=1)
        fast_rows = int(np.maximum((n_pages - slow_pages), 1).sum()) * self.page_t
        slow_rows = int(slow_pages.sum()) * self.page_t
        out = {
            "fast": 2 * L * fast_rows * K * hd * item,
            "slow": 2 * L * slow_rows * K * hd * item,
        }
        for dev_ord, n_refs in self._prefix_ref_pages().items():
            key = "fast" if dev_ord == 0 else "slow"
            out[key] += n_refs * self._page_kv_bytes()
        return out

    def read_bytes_per_device(self) -> dict[str, int]:
        """Per-device decode-step read bytes, keyed by device name."""
        L, K, hd, item = self._dims()
        dev = self._host_dev()
        out = {}
        ref_pages = self._prefix_ref_pages()
        for i, name in enumerate(self.device_names):
            pages = (dev == i).sum(axis=1)
            if i == 0:
                pages = np.maximum(pages, 1)  # >= 1 fast page per slot
            out[name] = (2 * L * int(pages.sum()) * self.page_t * K * hd
                         * item
                         + ref_pages.get(i, 0) * self._page_kv_bytes())
        return out

    def storage_bytes_per_device(self) -> dict[str, int]:
        """Physically OCCUPIED bytes per device pool (valid page slots,
        K and V, all layers), read off the pos maps' sentinel structure."""
        L, K, hd, item = self._dims()
        out = {}
        pfx_dev = (self.prefix.page_device.cpu().numpy()
                   if self.prefix is not None else None)
        for i, name in enumerate(self.device_names):
            rows = int((self.pos_parts[i].cpu().numpy() != _INT32_MAX).sum())
            out[name] = 2 * L * rows * K * hd * item
            if pfx_dev is not None:
                out[name] += (int((pfx_dev == i).sum())
                              * self._page_kv_bytes())
        return out

    def pool_bytes_per_device(self) -> dict[str, int]:
        """ALLOCATED pool capacity per device, keyed by device name."""
        out = {}
        for i, name in enumerate(self.device_names):
            out[name] = int(
                (self.k_parts[i].numel() + self.v_parts[i].numel())
                * self.k_parts[i].element_size()
                + self.pos_parts[i].numel() * self.pos_parts[i].element_size())
        if self.prefix is not None:
            pdev = self.prefix.page_device.cpu().numpy()
            pb = self.prefix.page_bytes()
            for i, name in enumerate(self.device_names):
                out[name] += int((pdev == i).sum()) * pb
            out[self.device_names[0]] += (
                int((pdev == UNALLOCATED).sum()) * pb)
        return out

    def register_in_ledger(self, ledger, buffer: str = "kv_cache", *,
                           device_names=None, note: str = "serving KV pool",
                           strict: bool = False) -> dict[str, int]:
        """Register (or refresh) this cache's pools in a TierLedger."""
        names = tuple(device_names) if device_names else self.device_names
        if len(names) != len(self.device_names):
            raise ValueError(
                f"{len(names)} names for {len(self.device_names)} devices")
        pool = self.pool_bytes_per_device()
        ledger.release(buffer)
        billed = {}
        for cache_name, ledger_name in zip(self.device_names, names):
            nbytes = pool[cache_name]
            if not nbytes:
                continue
            try:
                ledger.register(buffer, ledger_name, nbytes, note,
                                strict=strict)
            except KeyError:
                continue
            billed[ledger_name] = nbytes
        return billed

    def _prefix_ref_pages(self) -> dict[int, int]:
        """Per-device ordinal count of prefix-page REFERENCES held by slots."""
        if self.prefix is None:
            return {}
        sp = self.prefix.slot_pages.cpu().numpy()
        pdev = self.prefix.page_device.cpu().numpy()
        refs = sp[sp >= 0]
        if refs.size == 0:
            return {}
        devs = pdev[refs]
        return {int(d): int((devs == d).sum()) for d in np.unique(devs)
                if d >= 0}

    def capacity_pages(self) -> tuple:
        """Per-device pool capacity in pages per slot."""
        return tuple(kp.shape[2] // self.page_t for kp in self.k_parts)

    # -- append + attend --------------------------------------------------------
    def append_rows(self) -> list[torch.Tensor]:
        """Per pool, the row each slot's next token lands in (the pool's
        size where another pool owns it: dropped by the scatter)."""
        dev, local = self._route(self.lengths)
        local = local.long()
        return [torch.where(dev == d, local, self.k_parts[d].shape[2])
                for d in range(len(self.k_parts))]

    def append_layer(self, layer: int, k_new: torch.Tensor,
                     v_new: torch.Tensor, rows=None) -> "TieredKVCache":
        """Scatter one token's K/V for one layer into the pools, in place.
        k_new: (B, K, hd).  ``rows`` (from :meth:`append_rows`) may be
        computed once per step."""
        if rows is None:
            rows = self.append_rows()
        for d, r in enumerate(rows):
            if self.k_parts[d].shape[2] == 0:
                continue
            da_ops.kv_append(self.k_parts[d][layer], self.v_parts[d][layer],
                             r, k_new, v_new)
        return self

    def partition_valids(self) -> list[torch.Tensor]:
        """The step's validity masks: one per pool (and one for the prefix
        pool).  They do not depend on the layer."""
        upto = self.lengths[:, None] + 1
        out = [p < upto for p in self.pos_parts]
        if self.prefix is not None and self.prefix.pool_pages:
            out.append(self.prefix.valid())
        return out

    def partitions(self, layer: int, valids=None):
        """[(k, v, valid)] per device pool for decode attention
        (post-append); zero-width pools contribute no partial.  With a
        shared-prefix pool attached, its referenced pages form one more
        partition."""
        if valids is None:
            valids = self.partition_valids()
        parts = [(self.k_parts[d][layer], self.v_parts[d][layer], valids[d])
                 for d in range(len(self.k_parts))
                 if self.k_parts[d].shape[2]]
        if self.prefix is not None and self.prefix.pool_pages:
            parts.append(self.prefix.partition(layer, valids[-1]))
        return parts

    # -- SLO pinning -------------------------------------------------------------
    def pin_slot(self, i: int, **kwargs) -> "TieredKVCache":
        """Move slot ``i``'s pages all-fast on the mover's latency lane."""
        new_dev = self._host_dev().copy()
        new_dev[i] = 0
        return self._retile(new_dev, lane=LANE_LATENCY, **kwargs)

    # -- dynamic re-tiering (Caption actuation path) ----------------------------
    def repartition(self, policy: MemPolicy, pinned_slots=(), **kwargs
                    ) -> "TieredKVCache":
        """Re-tier every unpinned slot's KV pages under ``policy``."""
        n_pages = self.page_device.shape[1]
        row, names = _policy_device_map(policy, n_pages)
        pinned = set(pinned_slots)
        new_dev = self._host_dev().copy()
        for b in range(new_dev.shape[0]):
            if b not in pinned:
                new_dev[b] = row
        return self._retile(new_dev, policy_names=names, **kwargs)

    def repartition_fraction(self, fraction: float, pinned_slots=(),
                             **kwargs) -> "TieredKVCache":
        """Re-tier unpinned slots to ``fraction`` slow flipping the fewest
        KV pages per slot (two-device path)."""
        return self.repartition_weights((float(fraction),), pinned_slots,
                                        **kwargs)

    def repartition_weights(self, weights, pinned_slots=(), **kwargs
                            ) -> "TieredKVCache":
        """Re-tier unpinned slots to a per-slow-device weight vector,
        flipping the fewest KV pages per slot; a vector that rounds to the
        current counts returns ``self``."""
        pinned = set(pinned_slots)
        n_devices = max(len(self.device_names), len(tuple(weights)) + 1)
        new_dev = self._host_dev().copy()
        changed = False
        for b in range(new_dev.shape[0]):
            if b in pinned:
                continue
            row = minimal_delta_weights(new_dev[b], tuple(weights),
                                        n_devices)
            if row is not None:
                new_dev[b] = row
                changed = True
        if not changed:
            return self
        return self._retile(new_dev, **kwargs)

    def drain_device(self, device, pinned_slots=(), *, weights=None,
                     **kwargs) -> "TieredKVCache":
        """Move every unpinned slot's pages off one slow device (elastic
        hot-remove drain)."""
        if isinstance(device, str):
            if device not in self.device_names:
                raise KeyError(device)
            i = self.device_names.index(device)
        else:
            i = int(device)
        if not 1 <= i < len(self.device_names):
            raise KeyError(device)
        if weights is None:
            cur = list(self.weights(pinned_slots))
            departing, cur[i - 1] = cur[i - 1], 0.0
            rest = sum(cur)
            if departing > 0 and rest > 0:
                cur = [w + departing * w / rest for w in cur]
            weights = tuple(cur)
        elif weights[i - 1] > 0:
            raise ValueError(
                f"drain target keeps weight on {self.device_names[i]!r}")
        return self.repartition_weights(weights, pinned_slots, **kwargs)

    def _route_names(self, n_devices: int,
                     policy_names: Optional[tuple] = None,
                     fast_tier: Optional[str] = None,
                     slow_tier: Optional[str] = None) -> tuple:
        return resolve_device_names(self.device_names, n_devices,
                                    policy_names, fast_tier, slow_tier)

    # -- retile internals -------------------------------------------------------
    def _page_kv_bytes(self) -> int:
        L, K, hd, item = self._dims()
        return 2 * L * self.page_t * K * hd * item

    def _slot_groups(self, old_dev, new_dev, old_local) -> dict:
        """Slots sharing (old row, new row, old locals) move as ONE batched
        slab per run instead of per-slot-per-page."""
        groups: dict = {}
        for b in range(old_dev.shape[0]):
            key = (old_dev[b].tobytes() + new_dev[b].tobytes()
                   + old_local[b].tobytes())
            groups.setdefault(key, []).append(b)
        return groups

    def _memory(self, ordinal: int):
        """Mover ``dst`` for pool ``ordinal`` on the card; None (beside
        the payload) on the host."""
        if self.backend != "pinned":
            return None
        return self.device if ordinal == 0 else PINNED

    def _stage(self, ordinal: int, numel: int, dtype) -> torch.Tensor:
        """A flat staging buffer of ``numel`` elements in pool
        ``ordinal``'s memory: one a (pool, dtype), kept on the cache and
        on every cache evolved from it, and grown on demand, so a retile
        allocates no page-locked memory once it is large enough.  A
        retile's landing reads it in stream order before the next
        retile's gather (which waits on an event recorded after that
        landing) writes it again."""
        stages = self.__dict__.setdefault("_stages", {})
        buf = stages.get((ordinal, dtype))
        if buf is None or buf.numel() < numel:
            buf = stages[(ordinal, dtype)] = torch.empty(
                numel, dtype=dtype,
                **shard_storage(ordinal, self.backend, self.device))
        return buf[:numel]

    def _gather_segments(self, r: "_Run", stage: torch.Tensor) -> Segments:
        """Run ``r``'s slabs, every slot's K and V, as one segment list
        into ``stage`` (a flat view of its destination's staging buffer,
        ``2 * len(r.slots)`` slabs long): one launch on the card.
        ``r.k``/``r.v`` become the staged per-slot views.  It bills the
        run's whole pages, as the reference's per-page moves do."""
        n = len(r.pages)
        L, K, hd, _ = self._dims()
        pools = (self.k_parts[r.src], self.v_parts[r.src])
        B, T = pools[0].shape[1:3]
        row = n * self.page_t * K * hd
        stage = stage.view(2, len(r.slots), L, row)
        segs = np.empty((2 * len(r.slots), 8), np.int64)
        for side in (0, 1):
            rows = segs[side * len(r.slots):(side + 1) * len(r.slots)]
            rows[:, 0], rows[:, 2], rows[:, 3] = side, B * T * K * hd, 0
            rows[:, 1] = (r.slots * T + r.l0 * self.page_t) * K * hd
            rows[:, 4] = (side * len(r.slots) + np.arange(len(r.slots))) \
                * L * row
            rows[:, 5], rows[:, 6], rows[:, 7] = row, L, row
        r.k, r.v = list(stage[0]), list(stage[1])
        return Segments(tuple(p.view(-1) for p in pools),
                        (stage.view(-1),), segs,
                        self._page_kv_bytes() * len(r.slots) * n)

    def _ship_retile(self, groups, old_dev, new_dev, old_local, route, *,
                     mover, telemetry, source, lane, wait=True) -> list:
        """Movement on real device routes, gather-first: every moved run
        is staged in its destination's memory before any pool is
        written.  Each run is one segment list (every slot's K and V
        slabs) into its destination's staging buffer
        (:meth:`_gather_segments`), billed as its whole pages.  With a
        mover: ONE descriptor per (slot group, run), and the executor
        moves a route-pure batch of them in one launch on the card.
        Without one: one launch a run on the current stream, billed to
        ``telemetry``.  Returns the staged runs."""
        runs: list[_Run] = []
        for slots in groups.values():
            b0, sl = slots[0], np.asarray(slots)
            od, nd = old_dev[b0].astype(np.int64), new_dev[b0].astype(np.int64)
            ol = old_local[b0].astype(np.int64)
            moved = np.nonzero(od != nd)[0]
            if moved.size == 0:
                continue
            order, starts, ends = route_pure_runs(
                od[moved], nd[moved], ol[moved])
            mv = moved[order]
            for s, e in zip(starts, ends):
                p0 = mv[s]
                runs.append(_Run(sl, int(od[p0]), int(nd[p0]), mv[s:e],
                                 int(ol[p0]), [], []))
        if not runs:
            return runs
        L, K, hd, _ = self._dims()
        dtype = self.k_parts[0].dtype
        sizes = [2 * len(r.slots) * L * len(r.pages) * self.page_t * K * hd
                 for r in runs]
        need: dict = {}
        for r, size in zip(runs, sizes):
            need[r.dst] = need.get(r.dst, 0) + size
        stages = {d: self._stage(d, n, dtype) for d, n in need.items()}
        at = dict.fromkeys(need, 0)
        payloads = []
        for r, size in zip(runs, sizes):
            payloads.append(self._gather_segments(
                r, stages[r.dst][at[r.dst]:at[r.dst] + size]))
            at[r.dst] += size
        if mover is None:
            for r, payload in zip(runs, payloads):
                if telemetry is not None:
                    telemetry.record_move(route[r.src], route[r.dst],
                                          payload.nbytes, 0.0, source=source)
                payload.run(self.device)
            return runs
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        descs = [Descriptor(route[r.src], route[r.dst], payload, lane=lane,
                            source=source, dst=self._memory(r.dst),
                            ready=ready)
                 for r, payload in zip(runs, payloads)]
        # One submission: descriptors batch (§6).  The landing needs the
        # copies, so the host waits until each is enqueued (the card-side
        # wait is on each copy's ``done`` event); the landing is a launch
        # on this stream, and nothing waits for it.
        for f in mover.issue(descs):
            f.result()
        if wait and mover.asynchronous:
            mover.wait_all()
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            for desc in descs:
                if desc.done is not None:
                    stream.wait_event(desc.done)
        return runs

    def _land(self, pools_k: list, pools_v: list, runs, new_local_of,
              keep=()) -> None:
        """One ``stream_copy_segments`` call writes each run's staged slabs
        into their destination slots (``new_local_of(slot)`` gives the
        slot's new page->local row; consecutive slots coalesced, every
        layer a row of the segment; rows past a pool's end dropped) and,
        for a rebuild, copies ``keep``'s staying pages — ``(d, slots,
        page segments)`` from old pools ``self.*_parts[d]`` into
        ``pools_*[d]``.  On the card that is one launch in stream order:
        the host touches no pinned pool and waits for nothing."""
        pt = self.page_t
        L, K, hd, _ = self._dims()
        pe = pt * K * hd
        dsts = list(pools_k) + list(pools_v)
        nd = len(pools_k)
        srcs, segs = [], []

        def add(src_id, src_stride, src_off, base, b, ps):
            """Segments of page segments ``ps`` (src page, dst page, n) of
            slot ``b`` into destination base ``base``, every layer a row."""
            T = dsts[base].shape[2]
            n = np.minimum(ps[:, 4], T // pt - ps[:, 3])
            ok = n > 0
            rows = np.empty((int(ok.sum()), 8), np.int64)
            rows[:, 0], rows[:, 2], rows[:, 3] = src_id, src_stride, base
            rows[:, 1] = src_off + ps[ok, 1] * pe
            rows[:, 4] = b * T * K * hd + ps[ok, 3] * pe
            rows[:, 5] = dsts[base].shape[1] * T * K * hd
            rows[:, 6], rows[:, 7] = L, n[ok] * pe
            segs.append(rows)

        for r in runs:
            n = len(r.pages)
            for j, b in enumerate(r.slots):
                b = int(b)
                ps = page_segments(np.zeros(n), np.arange(n), np.zeros(n),
                                   new_local_of(b)[r.pages])
                for data, base in ((r.k[j], r.dst), (r.v[j], nd + r.dst)):
                    if data.is_cuda:
                        data.record_stream(torch.cuda.current_stream(
                            data.device))
                    srcs.append(data.reshape(-1))
                    add(len(srcs) - 1, n * pe, 0, base, b, ps)
        old = list(self.k_parts) + list(self.v_parts)
        n_old = len(self.k_parts)
        for d, slots, ps in keep:
            for side in (0, 1):
                pool = old[side * n_old + d]
                srcs.append(pool.view(-1))
                B_, T_old = pool.shape[1], pool.shape[2]
                for b in slots:
                    add(len(srcs) - 1, B_ * T_old * K * hd,
                        int(b) * T_old * K * hd, side * nd + d, int(b), ps)
        if segs:
            stream_copy_segments(srcs, [p.view(-1) for p in dsts],
                                 np.concatenate(segs), device=self.device)

    def _retile(self, new_dev: np.ndarray, *, mover=None,
                fast_tier: Optional[str] = None,
                slow_tier: Optional[str] = None,
                policy_names: Optional[tuple] = None,
                telemetry=GLOBAL_TELEMETRY, source: Optional[str] = None,
                lane: int = LANE_BULK, donate: bool = False,
                wait: bool = True) -> "TieredKVCache":
        old_dev = self._host_dev()
        if np.array_equal(new_dev, old_dev):
            return self
        n_old = len(self.k_parts)
        n_devices = max(len(self.device_names),
                        int(new_dev.max(initial=0)) + 1,
                        len(policy_names or ()), n_old)
        route = self._route_names(n_devices, policy_names, fast_tier,
                                  slow_tier)
        old_local = self._host_local()
        groups = self._slot_groups(old_dev, new_dev, old_local)
        runs = self._ship_retile(groups, old_dev, new_dev, old_local, route,
                                 mover=mover, telemetry=telemetry,
                                 source=source, lane=lane, wait=wait)
        caps = self.capacity_pages()
        need = [int(max((new_dev == d).sum(axis=1).max(initial=0), 0))
                for d in range(n_devices)]
        stable = (self.slow_headroom > 0 and n_devices == n_old
                  and all(need[d] <= caps[d] for d in range(n_devices)))
        if stable:
            out = self._retile_stable(groups, old_dev, new_dev, old_local,
                                      runs, donate=donate)
        else:
            out = self._retile_rebuild(groups, old_dev, new_dev, old_local,
                                       n_devices, runs)
        out = out._evolve(device_names=self._route_names(
            n_devices, policy_names, None, None))
        if out.prefix is not None:
            out = out._apply_prefix_sentinels()
        if wait and self.device.type == "cuda":
            # a fenced move: the host returns once every copy has landed
            torch.cuda.current_stream(self.device).synchronize()
        return out

    def _apply_prefix_sentinels(self) -> "TieredKVCache":
        shared = self.prefix.slot_shared[:, None]
        sentinel = torch.tensor(_INT32_MAX, dtype=torch.int32,
                                device=self.device)
        pos_new = tuple(torch.where(p < shared, sentinel, p)
                        for p in self.pos_parts)
        return self._evolve(pos_parts=pos_new)

    def _retile_stable(self, groups, old_dev, new_dev, old_local, runs, *,
                       donate: bool = False) -> "TieredKVCache":
        """O(Δ) retile: every moved page lands in a free slot of its
        destination pool — pool shapes and every unmoved page's slot are
        untouched.  Non-receiving pools are reused as-is; receiving pools
        are copied once each (copy-on-write) or — with ``donate`` —
        written in place (zero full-pool copies, ``data_ptr`` kept; the
        caller must drop the parent cache).  The runs were staged before
        (gather-first), so a leaving page's freed slot can be refilled."""
        pt = self.page_t
        at = np.arange(pt)
        caps = self.capacity_pages()
        n_devices = len(self.k_parts)
        new_local = old_local.copy()
        pos_np = [p.copy() for p in self._host_pos()]
        for slots in groups.values():
            b0, sl = slots[0], np.asarray(slots)
            od, nd = old_dev[b0].astype(np.int64), new_dev[b0].astype(np.int64)
            ol = old_local[b0].astype(np.int64)
            moved = np.nonzero(od != nd)[0]
            if moved.size == 0:
                continue
            nl_row = ol.copy()
            for d in np.unique(nd[moved]):
                incoming = moved[nd[moved] == d]
                staying = (od == d) & (nd == d)
                used = np.zeros(caps[int(d)], bool)
                used[ol[staying]] = True
                free = np.nonzero(~used)[0]
                nl_row[incoming] = free[: incoming.size]
            new_local[np.ix_(sl, np.arange(nl_row.size))] = \
                nl_row[None, :].astype(np.int32)
            for d in range(n_devices):
                row = np.full(caps[d] * pt, _INT32_MAX, np.int32)
                pages_d = np.nonzero(nd == d)[0]
                if pages_d.size:
                    row[(nl_row[pages_d][:, None] * pt + at).ravel()] = (
                        pages_d[:, None] * pt + at).ravel().astype(np.int32)
                pos_np[d][sl] = row
        k_pools = list(self.k_parts)
        v_pools = list(self.v_parts)
        if not donate:
            for d in sorted({r.dst for r in runs}):
                FULL_SHARD_COPIES.bump(2)  # one full CoW per K and V pool
                k_pools[d] = self._copy_pool(d, k_pools[d])
                v_pools[d] = self._copy_pool(d, v_pools[d])
        self._land(k_pools, v_pools, runs, lambda b: new_local[b])
        out = self._evolve(
            k_parts=tuple(k_pools), v_parts=tuple(v_pools),
            page_local=self._dev(new_local, torch.int32),
            pos_parts=tuple(self._dev(p, torch.int32) for p in pos_np),
            page_device=self._dev(new_dev, torch.int8))
        return out._with_host(new_dev.copy(), new_local)._with_host_pos(pos_np)

    def _retile_rebuild(self, groups, old_dev, new_dev, old_local,
                        n_devices: int, runs) -> "TieredKVCache":
        """Full rebuild: re-rank locals, reallocate every pool at its new
        capacity (plus headroom), copy every staying page across and land
        the moved ones — the path that changes shapes, by design."""
        pt = self.page_t
        at = np.arange(pt)
        L, B = self.k_parts[0].shape[:2]
        K, hd = self.k_parts[0].shape[3:]
        dt = self.k_parts[0].dtype
        P = old_dev.shape[1]
        old_caps = self.capacity_pages()
        new_local, counts, pos_list = _kv_device_layout_rows(
            new_dev, pt, n_devices)
        caps = [P]
        for d in range(1, n_devices):
            need = int(counts[d].max(initial=0))
            if (self.slow_headroom > 0 and d < len(old_caps)
                    and old_caps[d] >= need):
                caps.append(old_caps[d])
            else:
                caps.append(min(need + self.slow_headroom, P))
        k_new = [self._pool(d, (L, B, caps[d] * pt, K, hd), dt)
                 for d in range(n_devices)]
        v_new = [self._pool(d, (L, B, caps[d] * pt, K, hd), dt)
                 for d in range(n_devices)]
        FULL_SHARD_COPIES.bump(2 * n_devices)
        n_old = len(self.k_parts)
        keep = []  # staying pages, old pool -> new pool, per slot group
        for slots in groups.values():
            b0 = slots[0]
            od, nd = old_dev[b0].astype(np.int64), new_dev[b0].astype(np.int64)
            ol = old_local[b0].astype(np.int64)
            nl = new_local[b0].astype(np.int64)
            for d in range(min(n_old, n_devices)):
                sel = np.nonzero((od == d) & (nd == d))[0]
                if sel.size:
                    sel = sel[np.argsort(ol[sel], kind="stable")]
                    keep.append((d, slots, page_segments(
                        np.zeros(sel.size), ol[sel], np.zeros(sel.size),
                        nl[sel])))
        self._land(k_new, v_new, runs, lambda b: new_local[b], keep)
        pos_np = [_pad_pos(pos_list[d], caps[d] * pt)
                  for d in range(n_devices)]
        out = self._evolve(
            k_parts=tuple(k_new), v_parts=tuple(v_new),
            page_local=self._dev(new_local, torch.int32),
            pos_parts=tuple(self._dev(p, torch.int32) for p in pos_np),
            page_device=self._dev(new_dev, torch.int8))
        return out._with_host(new_dev.copy(), new_local)._with_host_pos(pos_np)

    # -- shared-prefix pool -------------------------------------------------------
    def with_prefix(self, pool_pages: int) -> "TieredKVCache":
        """Attach an (empty) shared-prefix page pool of ``pool_pages``
        pages, in the cache's home memory (HBM on the card)."""
        L, B = self.k_parts[0].shape[:2]
        K, hd = self.k_parts[0].shape[3:]
        blk = PrefixBlock.create(
            B, pool_pages, self.page_device.shape[1], self.page_t,
            L, K, hd, self.k_parts[0].dtype, self.device)
        return self._evolve(prefix=blk)

    def attach_prefix(self, i: int, pages) -> "TieredKVCache":
        """Map shared pool pages into slot ``i`` BY REFERENCE: the slot's
        leading positions are served by the pool partition, its own pool
        rows below the boundary are sentineled out of attention, and
        ``lengths`` jumps to the shared boundary."""
        assert self.prefix is not None
        pages = [int(p) for p in pages]
        Pm = self.prefix.slot_pages.shape[1]
        assert len(pages) <= Pm
        full_rows = len(pages) * self.page_t
        row = np.full(Pm, NO_PAGE, np.int32)
        row[:len(pages)] = pages
        slot_pages = self.prefix.slot_pages.clone()
        slot_pages[i] = self._dev(row, torch.int32)
        slot_shared = self.prefix.slot_shared.clone()
        slot_shared[i] = full_rows
        lengths = self.lengths.clone()
        lengths[i] = full_rows
        pos_new = []
        for p in self.pos_parts:
            p = p.clone()
            p[i] = torch.where(p[i] < full_rows,
                               torch.full_like(p[i], _INT32_MAX), p[i])
            pos_new.append(p)
        blk = dataclasses.replace(self.prefix, slot_pages=slot_pages,
                                  slot_shared=slot_shared)
        return self._evolve(prefix=blk, lengths=lengths,
                            pos_parts=tuple(pos_new))

    def detach_prefix(self, i: int) -> "TieredKVCache":
        """Drop slot ``i``'s references and restore its own pos rows."""
        if self.prefix is None:
            return self
        slot_pages = self.prefix.slot_pages.clone()
        slot_pages[i] = NO_PAGE
        slot_shared = self.prefix.slot_shared.clone()
        slot_shared[i] = 0
        blk = dataclasses.replace(self.prefix, slot_pages=slot_pages,
                                  slot_shared=slot_shared)
        return self._evolve(prefix=blk)._restore_slot_pos(i)

    def _restore_slot_pos(self, i: int) -> "TieredKVCache":
        pt = self.page_t
        at = np.arange(pt)
        dev = self._host_dev()[i]
        loc = self._host_local()[i]
        pos_new = list(self.pos_parts)
        for d in range(len(self.k_parts)):
            T_d = self.k_parts[d].shape[2]
            row = np.full(T_d, _INT32_MAX, np.int32)
            pages_d = np.nonzero(dev == d)[0]
            if pages_d.size:
                row[(loc[pages_d][:, None] * pt + at).ravel()] = (
                    pages_d[:, None] * pt + at).ravel().astype(np.int32)
            p = pos_new[d].clone()
            p[i] = self._dev(row, torch.int32)
            pos_new[d] = p
        return self._evolve(pos_parts=tuple(pos_new))

    def _slot_row_route(self, i: int, start: int, n: int):
        """(per-position device, own-pool row) for slot ``i`` positions
        ``[start, start + n)``."""
        positions = np.arange(start, start + n)
        page = positions // self.page_t
        dev = self._host_dev()[i][page]
        rows = (self._host_local()[i][page].astype(np.int64) * self.page_t
                + positions % self.page_t)
        return dev, rows

    def gather_token_rows(self, i: int, start: int, n: int):
        """Copy slot ``i``'s own K/V rows for positions ``[start,
        start + n)`` out of the per-device pools: an ``(L, n, K, hd)``
        pair beside pool 0 (each contiguous run through ``stream_copy``)."""
        L, K, hd, _ = self._dims()
        dev, rows = self._slot_row_route(i, start, n)
        outs = []
        for pools in (self.k_parts, self.v_parts):
            out = torch.empty((L, n, K, hd), dtype=pools[0].dtype,
                              device=self.device)
            for d, r0, p0, m in _segments(dev, rows):
                stream_copy(pools[d][:, i, r0:r0 + m].flatten(1),
                            out=out[:, p0:p0 + m].flatten(1),
                            device=self.device)
            outs.append(out)
        return outs[0], outs[1]

    def write_token_rows(self, i: int, start: int, k_rows: torch.Tensor,
                         v_rows: torch.Tensor) -> "TieredKVCache":
        """Write ``(L, n, K, hd)`` rows into slot ``i``'s OWN pools at
        positions ``[start, ...)``, in place (each contiguous run through
        ``stream_copy``, cast to the pool dtype), and set its length to
        ``start + n``."""
        n = k_rows.shape[1]
        dev, rows = self._slot_row_route(i, start, n)
        for pools, src in ((self.k_parts, k_rows), (self.v_parts, v_rows)):
            for d, r0, p0, m in _segments(dev, rows):
                stream_copy(src[:, p0:p0 + m].flatten(1),
                            out=pools[d][:, i, r0:r0 + m].flatten(1),
                            device=self.device)
        lengths = self.lengths.clone()
        lengths[i] = start + n
        return self._evolve(lengths=lengths)

    def write_prefix_pages(self, pool_slots, k_pages, v_pages, *,
                           device: int = 0) -> "TieredKVCache":
        """Fill shared pool pages (promotion), in place: ``k_pages`` is
        ``(L, n, page_t, K, hd)`` for ``n`` pool slots, labelled with
        device ordinal ``device``."""
        assert self.prefix is not None
        idx = self._dev(np.asarray(pool_slots, np.int64), torch.int64)
        self.prefix.k.index_copy_(1, idx, k_pages.to(self.prefix.k.dtype))
        self.prefix.v.index_copy_(1, idx, v_pages.to(self.prefix.v.dtype))
        page_device = self.prefix.page_device.clone()
        page_device[idx] = device
        blk = dataclasses.replace(self.prefix, page_device=page_device)
        return self._evolve(prefix=blk)

    def retile_prefix(self, new_dev, *, mover=None,
                      telemetry=GLOBAL_TELEMETRY,
                      policy_names: Optional[tuple] = None,
                      source: Optional[str] = None, lane: int = LANE_BULK,
                      wait: bool = True) -> "TieredKVCache":
        """Re-label the shared pool's per-page placement.  Each moved page
        bills its bytes ONCE on its real route however many slots
        reference it; the pool stays one buffer, so the label is
        accounting and the mover's copy is not landed anywhere."""
        assert self.prefix is not None
        old = self.prefix.page_device.cpu().numpy()
        new_dev = np.asarray(new_dev, np.int32)
        moved = np.nonzero((old >= 0) & (new_dev >= 0)
                           & (old != new_dev))[0]
        if moved.size == 0:
            return self
        n_devices = max(len(self.device_names), int(new_dev.max()) + 1)
        route = self._route_names(n_devices, policy_names, None, None)
        page_b = self._page_kv_bytes()
        routes: dict[tuple, list] = {}
        for pg in moved:
            routes.setdefault((int(old[pg]), int(new_dev[pg])),
                              []).append(int(pg))
        if mover is not None:
            descs = []
            for (d0, d1), pages in routes.items():
                idx = self._dev(np.asarray(pages, np.int64), torch.int64)
                descs.append(Descriptor(
                    route[d0], route[d1],
                    (self.prefix.k.index_select(1, idx),
                     self.prefix.v.index_select(1, idx)),
                    lane=lane, source=source))
            mover.submit(descs)
            if wait and mover.asynchronous:
                mover.wait_all()
        elif telemetry is not None:
            for (d0, d1), pages in routes.items():
                telemetry.record_move(route[d0], route[d1],
                                      page_b * len(pages), 0.0,
                                      source=source)
        out = old.copy()
        out[moved] = new_dev[moved]
        blk = dataclasses.replace(self.prefix,
                                  page_device=self._dev(out, torch.int32))
        return self._evolve(prefix=blk)


def tiered_decode_step(cfg: ArchConfig, params, cache: TieredKVCache,
                       tokens: torch.Tensor, *,
                       attend: Optional[Callable] = None
                       ) -> tuple[torch.Tensor, TieredKVCache]:
    """One decode step for the dense family over a tiered KV cache.

    ``params`` is a :class:`~repro_torch.models.transformer.DenseParams`.
    The pools take the step's K/V rows in place; the returned cache has
    ``lengths + 1``.  ``attend`` replaces the per-partition attention
    (default: the ``decode_attention`` kernel through
    :func:`repro_torch.models.attention.attend_partial`) — a check of the
    kernel against its plain version on the same step."""
    attend = attend or attn.attend_partial
    B = tokens.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    x = params.embed.index_select(0, tokens.to(params.embed.device).long())
    pos = cache.lengths
    rows = cache.append_rows()
    valids = cache.partition_valids()
    if cfg.rope:
        cos, sin = rope_tables(pos[:, None], hd, cfg.rope_theta, cfg.rope_pct)
        cos, sin = cos[:, 0], sin[:, 0]
    for li in range(cfg.n_layers):
        lp = params.layer(li)
        a = lp["attn"]
        h = apply_norm(x, lp["ln1"], cfg.norm)
        q = h @ a["wq"]
        k = h @ a["wk"]
        v = h @ a["wv"]
        if "bq" in a:
            q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
        q = q.reshape(B, H, hd)
        k = k.reshape(B, K, hd)
        v = v.reshape(B, K, hd)
        if cfg.rope:
            q = rotate(q, cos, sin)
            k = rotate(k, cos, sin)
        cache.append_layer(li, k, v, rows)
        parts = [attend(q, kk, vv, valid)
                 for (kk, vv, valid) in cache.partitions(li, valids)]
        o = attn.merge_partials(parts).to(x.dtype)
        x = x + o.reshape(B, H * hd) @ a["wo"]
        h = apply_norm(x, lp["ln2"], cfg.norm)
        x = x + mlp_apply(h, lp["mlp"], cfg.act)
    x = apply_norm(x, params.final_norm, cfg.norm)
    head = params.embed.T if cfg.tie_embeddings else params.lm_head
    logits = x @ head
    return logits, cache._evolve(lengths=cache.lengths + 1)
