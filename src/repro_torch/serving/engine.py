"""Batched serving engine with continuous batching over slot-based decode.

Requests occupy batch slots; each engine step decodes one token for
every active slot (ragged lengths handled by the cache's valid masks).
Per-request latency is tracked both as measured wall time and as
*modeled* time on the target tier topology (compute + per-tier KV
streaming via the calibrated perfmodel), which is what the Redis-
analogue benchmark (Figs. 6-7) reports.

The engine runs on the card unless told ``device="cpu"``; its parameters
must lie on the same device.  The decode step is plain eager PyTorch
around the ``decode_attention`` and ``kv_append`` kernels, so there is no
trace to count: ``decode_traces`` counts the times the decode step's pool
bindings (each pool's storage, shape and dtype) changed — 1 across a
Caption walk on the stable, donated path, as the reference's jit trace
count is.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import perfmodel
from repro_torch.core.caption import CaptionController
from repro_torch.core.classifier import AccessProfile
from repro_torch.core.policy import MemPolicy
from repro_torch.core.telemetry import GLOBAL_TELEMETRY, EpochWindow
from repro_torch.core.tiers import OpClass, TierTopology
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serving.kv_cache import TieredKVCache, tiered_decode_step
from repro_torch.serving.prefix_cache import PrefixCache
from repro_torch.serving.sampler import sample_greedy


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    #: SLO class — "latency" requests pin their KV pages fast (their slots
    #: leave the Caption repartition population); "batch" tolerate slow.
    slo: str = "batch"
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    generated: list[int] = dataclasses.field(default_factory=list)
    modeled_seconds: float = 0.0

    def __post_init__(self):
        if self.slo not in ("latency", "batch"):
            raise ValueError(f"slo must be 'latency' or 'batch': {self.slo!r}")

    @property
    def latency(self) -> float:
        return (self.finished_at or time.perf_counter()) - self.submitted_at


def kv_access_profile(cfg: ArchConfig, max_batch: int, max_len: int, *,
                      page_t: int = 64, item_bytes: int = 4,
                      compute_seconds: float = 0.0,
                      deadline_seconds: Optional[float] = None
                      ) -> AccessProfile:
    """AccessProfile of the tiered KV cache under steady decode.

    One decode step streams the whole live KV window once (attention
    reads every cached token) and appends one token row per sequence —
    massively parallel page gathers, shallow dependent chains.  The
    drivers feed this to :meth:`CaptionController.from_profile` so the
    §6.1 taxonomy drives controller seeding: against a latency-class
    deadline (µs SLO) the profile classifies LATENCY_BOUND and the KV
    controller is fast-pinned; the ordinary batch-serving shape
    classifies bandwidth-bound and keeps the planner's slow prior."""
    hd = cfg.resolved_head_dim
    row = 2 * cfg.n_layers * cfg.n_kv_heads * hd * item_bytes  # K+V, 1 tok
    return AccessProfile(
        bytes_read_per_step=float(row * max_len * max_batch),
        bytes_written_per_step=float(row * max_batch),
        dependent_chain=1,  # page gathers are independent across heads
        parallelism=max(max_batch * cfg.n_kv_heads, 1),
        granularity=max(page_t * hd * item_bytes, 1),
        compute_seconds=compute_seconds,
        deadline_seconds=deadline_seconds,
    )


class ServingEngine:
    def __init__(
        self,
        cfg: ArchConfig,
        params,
        *,
        max_batch: int = 8,
        max_len: int = 512,
        policy: Optional[MemPolicy] = None,
        topology: Optional[TierTopology] = None,
        page_t: int = 64,
        caption: Optional[CaptionController] = None,
        arbiter=None,
        buffer_name: str = "kv",
        mover=None,
        telemetry=GLOBAL_TELEMETRY,
        donate_kv: bool = True,
        prefix_pages: int = 0,
        admission: str = "none",
        admission_watermark: float = 0.9,
        admission_max_defer: int = 64,
        admission_capacity_bytes: Optional[int] = None,
        overlap: bool = False,
        ledger=None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if params.embed.device != self.device:
            raise ValueError(f"parameters on {params.embed.device}, engine "
                             f"on {self.device}")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.topology = topology
        policy = policy or MemPolicy.membind("fast")
        # With a Caption loop attached, size the KV slow pool for the
        # walk's ceiling up front (capacity padding): every repartition
        # the controller can request then fits the existing shapes, so
        # the jitted decode step traces exactly once across all probe
        # epochs instead of retracing on each actuation.
        n_pages = max_len // min(page_t, max_len)
        slow_headroom = (caption.headroom_pages(n_pages)
                         if caption is not None else 0)
        self.cache = TieredKVCache.create(
            cfg, max_batch, max_len, policy, page_t=page_t,
            slow_headroom=slow_headroom, device=self.device)
        # Shared-prefix paged KV: the pool is created up front (its
        # storage is part of the decode step's bindings) and indexed by a
        # host-side refcounted radix trie.
        self.prefix_index: Optional[PrefixCache] = None
        if prefix_pages > 0:
            self.cache = self.cache.with_prefix(int(prefix_pages))
            self.prefix_index = PrefixCache(int(prefix_pages),
                                            min(page_t, max_len))
        self._slot_refs: dict[int, list] = {}
        self.prefill_tokens_total = 0
        self.prefill_tokens_avoided = 0
        # Cost-model admission: batch-class requests whose
        # predicted fast-tier footprint would pressure latency-class
        # pins are deferred (bounded by ``admission_max_defer`` steps).
        if admission not in ("none", "cost"):
            raise ValueError(f"admission must be 'none' or 'cost': "
                             f"{admission!r}")
        self.admission = admission
        self.admission_watermark = float(admission_watermark)
        self.admission_max_defer = int(admission_max_defer)
        self.admission_capacity_bytes = admission_capacity_bytes
        self.admission_deferrals = 0
        self._defer_steps = 0
        # Async migration/compute overlap: Caption actuations
        # submit mover descriptors WITHOUT fencing; decode keeps running
        # and completions drain at the next epoch boundary.  Hidden vs
        # exposed migration time is modeled via perfmodel.overlap_cost.
        self.overlap = bool(overlap)
        self.migration_stall_s = 0.0
        self.migration_hidden_s = 0.0
        self.migration_exposed_s = 0.0
        self._inflight_move_bytes = 0
        self._inflight_compute_s = 0.0
        # Engine-owned actuations (Caption repartitions, SLO pins, elastic
        # drains) always replace ``self.cache`` with the retiled cache, so
        # the parent provably dies — exactly the donation contract.  With
        # ``donate_kv`` those retiles patch the receiving pools in place
        # (zero full-pool copies on the stable path) instead of paying one
        # copy-on-write per receiving pool.  Direct ``cache.*`` calls made
        # by outside code keep the safe donate=False default.
        self.donate_kv = bool(donate_kv)
        # Binding accounting: the counter increments when the decode
        # step's pool bindings change (a rebuild or a copy-on-write), so
        # benchmarks and tests can assert the walk stayed in place.
        self.decode_traces = 0
        self._bound: Optional[tuple] = None
        self.slots: list[Optional[Request]] = [None] * max_batch
        # Latency-SLO slots (request policy lives here, not in the cache):
        # excluded from Caption repartitions while their request is active.
        self.pinned_slots: set[int] = set()
        self.queue: list[Request] = []
        self._next_rid = 0
        self.done: list[Request] = []
        # modeled per-step seconds: per-tier KV streaming on the target HW
        self._step_model_cache: Optional[dict] = None
        # Caption control loop: between decode steps the controller reads
        # the epoch's modeled token throughput and re-tiers the KV pages.
        # When an arbiter spans several buffers, epochs route through it:
        # this engine's slow-tier traffic is billed to ``buffer_name`` and
        # growth is granted/clipped against the fleet budget.
        self.caption = caption
        self.arbiter = arbiter
        self.buffer_name = buffer_name
        if arbiter is not None and caption is not None:
            arbiter.register(buffer_name, caption)
        self.mover = mover
        self.telemetry = telemetry
        self._steps = 0
        self._epoch_tokens = 0
        self._epoch_modeled_s = 0.0
        self.caption_trace: list[tuple[int, float]] = []
        # One tier namespace for traffic accounting and migration: the
        # mover's topology names when a mover meters the moves, else the
        # generic fast/slow labels the modeled path uses.
        # Device-ordinal route labels (fast + every slow device): the
        # mover's real names when it meters the moves, else the names the
        # placement policy stamped onto the cache — repartitions reuse the
        # same labels, so device keys never churn mid-run.
        name_src = mover.topology if mover is not None else topology
        multi = (name_src is not None and name_src.n_slow > 1
                 and len(self.cache.device_names) > 2)
        if mover is not None:
            self._fast_name = mover.topology.fast.name
            self._slow_name = (mover.topology.slow or mover.topology.fast).name
        elif multi:
            self._fast_name = self.cache.device_names[0]
            self._slow_name = self.cache.device_names[1]
        else:
            self._fast_name, self._slow_name = "fast", "slow"
        if multi:
            self._device_names = ((self._fast_name,)
                                  + tuple(name_src.slow_names))
        else:
            self._device_names = (self._fast_name, self._slow_name)
        self._epoch_window = (EpochWindow(telemetry)
                              if caption is not None else None)
        # Capacity accounting: the serving plane's
        # framework-managed pools show up in the TierLedger report next
        # to the planner's buffers.  Registration refreshes whenever an
        # actuation can change pool shapes (Caption epochs, drains).
        self.ledger = ledger
        self.register_pools()

    def register_pools(self) -> dict[str, int]:
        """(Re-)register the KV + prefix pools in ``self.ledger``.

        No-op without a ledger.  Uses the engine's device-ordinal route
        labels, so generic ``fast/slow`` caches bill against the real
        topology tier names.  Safe to call after every re-tile: the
        previous registration is released first."""
        if self.ledger is None:
            return {}
        names = self._device_names[: len(self.cache.device_names)]
        if len(names) < len(self.cache.device_names):
            names = self.cache.device_names
        return self.cache.register_in_ledger(
            self.ledger, self.buffer_name, device_names=names,
            strict=False)

    # -- elastic topology (hot-remove / hot-add) -------------------------------
    def _active_slow_names(self) -> tuple[str, ...]:
        """Slow devices that are CURRENT placement targets.  The engine's
        ``_device_names`` is the union of every device ever seen (route
        labels never churn mid-run); the controller's weight vector spans
        only the live topology, so the two map by name."""
        if self.caption is not None and self.caption.topology.slows:
            return self.caption.topology.slow_names
        if self.topology is not None and self.topology.slows:
            return self.topology.slow_names
        return tuple(self._device_names[1:])

    def _expand_weights(self, weights) -> tuple[float, ...]:
        """Controller weight vector (live slow devices) -> cache device
        ordinals, zeros for devices that are no longer placement targets."""
        by_name = dict(zip(self._active_slow_names(), weights))
        n = len(self._device_names) - 1
        if not any(name in by_name for name in self._device_names[1:]):
            # Disjoint namespaces (a controller built on generic labels):
            # fall back to the positional alignment of the pre-elastic era.
            w = tuple(float(x) for x in weights)[:n]
            return w + (0.0,) * (n - len(w))
        return tuple(by_name.get(name, 0.0)
                     for name in self._device_names[1:])

    def _project_weights(self, kv_w) -> tuple[float, ...]:
        """Cache per-ordinal weights -> the controller's live-device order."""
        active = self._active_slow_names()
        by_name = dict(zip(self._device_names[1:], kv_w))
        if not any(name in by_name for name in active):
            w = tuple(float(x) for x in kv_w)[:len(active)]
            return w + (0.0,) * (len(active) - len(w))
        return tuple(by_name.get(name, 0.0) for name in active)

    def remove_device(self, name: str, *, monitor=None) -> None:
        """Elastic hot-remove of slow device ``name``.

        Drains the departing device's KV pages through the mover's bulk
        lane (run-coalesced descriptors billed on real dead->survivor
        routes) without touching in-flight requests, then rebuilds the
        control plane: topology and mover drop the device (it stays
        ledger-visible for queued descriptors), the arbiter forgets its
        budget and billed demand, and the Caption walk re-seeds on the
        survivors' bandwidth weights.  ``monitor`` (a HeartbeatMonitor)
        is deregistered so one dead device cannot poison every later
        health check."""
        if self.topology is None or name not in self.topology.slow_names:
            raise KeyError(name)
        new_topo = self.topology.remove_device(name)
        # Drain target: survivors keep the departing population's total
        # slow share, split bandwidth-proportionally — the same re-seed
        # the controller applies, so drain and walk agree on the new
        # operating point.
        if name in self.cache.device_names:
            total = sum(self.cache.weights(self.pinned_slots))
            by_name = dict(zip(new_topo.slow_names,
                               (total * b
                                for b in new_topo.bandwidth_weights())))
            target = tuple(by_name.get(n, 0.0)
                           for n in self._device_names[1:])
            self.cache = self.cache.drain_device(
                name, self.pinned_slots, weights=target, mover=self.mover,
                telemetry=self.telemetry, policy_names=self._device_names,
                source=self.buffer_name, donate=self.donate_kv)
            if self.cache.prefix is not None:
                # shared pool pages evacuate the dead device too — each
                # page ships once (refcount-deduplicated), to fast
                ord_ = self.cache.device_names.index(name)
                pdev = self.cache.prefix.page_device.cpu().numpy()
                if (pdev == ord_).any():
                    new = pdev.copy()
                    new[pdev == ord_] = 0
                    self.cache = self.cache.retile_prefix(
                        new, mover=self.mover, telemetry=self.telemetry,
                        policy_names=self._device_names,
                        source=self.buffer_name)
        self.topology = new_topo
        if self.mover is not None and name in self.mover.topology.slow_names:
            self.mover.update_topology(
                self.mover.topology.remove_device(name))
        if (self.arbiter is not None
                and name in self.arbiter.topology.slow_names):
            self.arbiter.remove_device(name)
        if (self.caption is not None
                and name in self.caption.topology.slow_names):
            self.caption.remove_device(name)
            self.caption.actuated_weights(self._project_weights(
                self.cache.weights(self.pinned_slots)))
        if monitor is not None:
            monitor.remove(name)
        self.register_pools()

    def add_device(self, spec) -> None:
        """Elastic hot-add: the device (TierSpec or name) joins the
        placement targets at weight zero and the Caption walk re-opens on
        its coordinate — pages climb onto it through the normal actuation
        path, so addition itself moves nothing."""
        if self.topology is None:
            raise ValueError("add_device needs a tier topology")
        self.topology = self.topology.add_device(spec)
        added = self.topology.slows[-1]
        if added.name not in self._device_names:
            self._device_names = self._device_names + (added.name,)
        if (self.mover is not None
                and added.name not in self.mover.topology.slow_names):
            self.mover.update_topology(
                self.mover.topology.add_device(added))
        if (self.arbiter is not None
                and added.name not in self.arbiter.topology.slow_names):
            self.arbiter.add_device(added)
        if (self.caption is not None
                and added.name not in self.caption.topology.slow_names):
            self.caption.add_device(added)

    # -- request management ---------------------------------------------------
    def submit(self, prompt: list[int], max_new_tokens: int = 16,
               slo: str = "batch") -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, list(prompt), max_new_tokens, slo=slo,
                                  submitted_at=time.perf_counter()))
        return rid

    def _admit(self) -> None:
        for i, s in enumerate(self.slots):
            if s is None and self.queue:
                if not self._admission_ok(self.queue[0]):
                    # FIFO head deferred: later requests wait behind it
                    # (ordering preserved; starvation-bounded).
                    break
                req = self.queue.pop(0)
                self._defer_steps = 0
                self.slots[i] = req
                # Latency-SLO admission: pin the slot's pages fast before
                # prefill (migration rides the mover's latency lane).
                if req.slo == "latency":
                    self.cache = self.cache.pin_slot(
                        i, mover=self.mover, telemetry=self.telemetry,
                        fast_tier=self._fast_name, slow_tier=self._slow_name,
                        source=self.buffer_name, donate=self.donate_kv)
                    self.pinned_slots.add(i)
                self._reset_slot(i)
                # Shared-prefix fast path: attach the longest cached
                # prefix by reference and replay ONLY the suffix — the
                # decode-replay prefill (exact; slot-local) starts at
                # the shared boundary instead of token zero.
                shared = 0
                if self.prefix_index is not None:
                    shared = self._attach_prefix(i, req)
                for tok in req.prompt[shared:-1]:
                    self._step_slot_token(i, tok)
                if self.prefix_index is not None:
                    self._promote_prefix(i, req)
                self.prefill_tokens_total += max(len(req.prompt) - 1, 0)
                self.prefill_tokens_avoided += shared

    # -- shared-prefix attach / CoW / promotion --------------------------------
    def _attach_prefix(self, i: int, req: Request) -> int:
        """Match ``req``'s prompt in the prefix index; map fully-matched
        pages into slot ``i`` by reference and copy-on-write the head of
        a partially-matched page into the slot's own tier.  Returns the
        number of prompt tokens the replay loop can skip."""
        idx = self.prefix_index
        nodes, partial, plen = idx.match(req.prompt)
        Pm = self.cache.prefix.slot_pages.shape[1]
        nodes = nodes[:Pm]
        full_rows = len(nodes) * self.cache.page_t
        if nodes:
            idx.acquire(nodes)
            self._slot_refs[i] = nodes
            self.cache = self.cache.attach_prefix(
                i, [n.page for n in nodes])
        if partial is not None and plen > 0:
            # Copy-on-write at the divergence point: the writer gets a
            # PRIVATE copy of the matched head in its own tier-placed
            # pages; the shared page stays immutable for its readers.
            idx.touch(partial)
            idx.cow_copies += 1
            blk = self.cache.prefix
            k_rows = blk.k[:, partial.page, :plen]
            v_rows = blk.v[:, partial.page, :plen]
            self.cache = self.cache.write_token_rows(
                i, full_rows, k_rows, v_rows)
            src_ord = int(blk.page_device[partial.page])
            dst_ord = int(self.cache._host_dev()[i][full_rows
                                                    // self.cache.page_t])
            names = self._device_names
            if src_ord != dst_ord and max(src_ord, dst_ord) < len(names):
                row_b = (self.cache._page_kv_bytes()
                         * plen // self.cache.page_t)
                self.telemetry.record_move(
                    names[src_ord], names[dst_ord], row_b, 0.0,
                    source=self.buffer_name)
        return full_rows + plen

    def _promote_prefix(self, i: int, req: Request) -> None:
        """After prefill, publish the prompt's novel full pages into the
        shared pool so the NEXT request with this prefix shares them."""
        placed = self.prefix_index.insert(req.prompt,
                                          self._slot_refs.get(i, []))
        if not placed:
            return
        pt = self.cache.page_t
        ks, vs = [], []
        for pno, _node in placed:
            k_pg, v_pg = self.cache.gather_token_rows(i, pno * pt, pt)
            ks.append(k_pg)
            vs.append(v_pg)
        self.cache = self.cache.write_prefix_pages(
            [n.page for _, n in placed],
            torch.stack(ks, dim=1), torch.stack(vs, dim=1), device=0)

    # -- cost-model admission ---------------------------------------------------
    def _admission_ok(self, req: Request) -> bool:
        """Admit unless the predicted fast-tier footprint (per-device KV
        bytes at the current operating point, plus this request's slot)
        would crowd latency-class pins AND the demotion migration that
        admission forces cannot hide inside an epoch of decode."""
        if (self.admission != "cost" or req.slo == "latency"
                or self.topology is None):
            return True
        if self._defer_steps >= self.admission_max_defer:
            return True  # starvation bound: the head request gets in
        item = self.cache.k_fast.element_size()
        L, B = self.cache.k_fast.shape[:2]
        K, hd = self.cache.k_fast.shape[3:]
        slot_bytes = 2 * L * self.max_len * K * hd * item
        f = self.cache.slow_fraction(self.pinned_slots)
        n_lat = len(self.pinned_slots)
        n_batch = sum(1 for j, r in enumerate(self.slots)
                      if r is not None and j not in self.pinned_slots) + 1
        pfx_fast = 0
        if self.cache.prefix is not None:
            pdev = self.cache.prefix.page_device.cpu().numpy()
            pfx_fast = (int((pdev == 0).sum())
                        * self.cache._page_kv_bytes())
        predicted = (n_lat * slot_bytes
                     + n_batch * slot_bytes * (1.0 - f) + pfx_fast)
        cap = (self.admission_capacity_bytes
               if self.admission_capacity_bytes is not None
               else self.topology.fast.capacity_bytes)
        cap *= self.admission_watermark
        if predicted <= cap or n_lat == 0 or self.topology.slow is None:
            return True
        # Over the watermark with live pins: admission would force the
        # excess fast bytes onto the slow tier.  Model that demotion as
        # a pipelined stream_copy and admit only if it hides entirely
        # under one epoch of decode compute.
        excess = int(predicted - cap)
        mc = perfmodel.pipelined_move_cost(
            self.topology.fast, self.topology.slow, excess,
            asynchronous=True)
        epoch_steps = (self.caption.cfg.epoch_steps
                       if self.caption is not None else 8)
        oc = perfmodel.overlap_cost(
            mc.seconds, self.modeled_step_seconds() * epoch_steps)
        if oc.exposed_s <= 0.0:
            return True
        self.admission_deferrals += 1
        self._defer_steps += 1
        return False

    def _reset_slot(self, i: int) -> None:
        lengths = self.cache.lengths.clone()
        lengths[i] = 0
        self.cache = self.cache._evolve(lengths=lengths)

    # -- stepping ---------------------------------------------------------------
    def _decode(self, params, cache: TieredKVCache, tokens: torch.Tensor):
        pools = list(cache.k_parts) + list(cache.v_parts)
        if cache.prefix is not None:
            pools += [cache.prefix.k, cache.prefix.v]
        binding = tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                        for t in pools)
        if binding != self._bound:
            self._bound = binding
            self.decode_traces += 1
        return tiered_decode_step(self.cfg, params, cache, tokens)

    def _current_tokens(self) -> torch.Tensor:
        toks = np.zeros((self.max_batch,), np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            toks[i] = (req.generated[-1] if req.generated else req.prompt[-1])
        return torch.as_tensor(toks, device=self.device)

    def _step_slot_token(self, i: int, token: int) -> None:
        toks = np.zeros((self.max_batch,), np.int32)
        toks[i] = token
        _, cache = self._decode(self.params, self.cache,
                                torch.as_tensor(toks, device=self.device))
        # only slot i advances; other slots keep their lengths
        lengths = self.cache.lengths.clone()
        lengths[i] += 1
        self.cache = cache._evolve(lengths=lengths)

    def modeled_step_seconds(self) -> float:
        """Per-decode-step time on the target topology (compute ignored on
        this CPU box; KV streaming dominates decode).  Devices stream on
        their own links, so the step pays the SLOWEST device, plus one
        dependent hop into every device holding pages."""
        if self.topology is None:
            return 0.0
        if self.topology.n_slow > 1 and len(self.cache.device_names) > 2:
            rbd = self.cache.read_bytes_per_device()
            times = [rbd.get(self.cache.device_names[0], 0)
                     / perfmodel.stream_bandwidth(
                         self.topology.fast, OpClass.LOAD, 8)]
            lat = self.topology.fast.chase_latency_ns * 1e-9
            for dev in self.topology.slows:
                # By name: a device the cache's policy rounded away holds
                # no pages and must not inherit a neighbor's bytes.
                b = rbd.get(dev.name, 0)
                if not b:
                    continue
                times.append(b / perfmodel.stream_bandwidth(
                    dev, OpClass.LOAD, 4))
                lat += dev.chase_latency_ns * 1e-9 * self.cfg.n_layers
            return max(times) + lat
        rb = self.cache.read_bytes_per_step()
        fast_t = rb["fast"] / perfmodel.stream_bandwidth(
            self.topology.fast, OpClass.LOAD, 8)
        slow = self.topology.slow
        slow_t = rb["slow"] / perfmodel.stream_bandwidth(
            slow, OpClass.LOAD, 4) if slow is not None and rb["slow"] else 0.0
        # decode also pays one dependent hop into each tier holding pages
        lat = self.topology.fast.chase_latency_ns * 1e-9
        if slow is not None and rb["slow"]:
            lat += slow.chase_latency_ns * 1e-9 * self.cfg.n_layers
        return max(fast_t, slow_t) + lat

    def step(self) -> int:
        """Decode one token for all active slots. Returns #active."""
        self._admit()
        active = [i for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        logits, self.cache = self._decode(
            self.params, self.cache, self._current_tokens())
        step_model_s = self.modeled_step_seconds()
        now = time.perf_counter()
        toks = sample_greedy(logits).cpu().numpy()
        for i in active:
            req = self.slots[i]
            req.generated.append(int(toks[i]))
            req.modeled_seconds += step_model_s
            if req.first_token_at is None:
                req.first_token_at = now
            if len(req.generated) >= req.max_new_tokens:
                req.finished_at = now
                self.done.append(req)
                self.slots[i] = None
                if self.prefix_index is not None:
                    # drop the slot's shared-page references (refcounts
                    # fall; pages stay cached for the next match)
                    self.prefix_index.release(self._slot_refs.pop(i, []))
                    self.cache = self.cache.detach_prefix(i)
                self._reset_slot(i)
                # slot rejoins the batch-class repartition population
                self.pinned_slots.discard(i)
        self._steps += 1
        self._epoch_tokens += len(active)
        self._epoch_modeled_s += step_model_s
        if self._inflight_move_bytes:
            self._inflight_compute_s += step_model_s
        if (self.caption is not None
                and self._steps % self.caption.cfg.epoch_steps == 0):
            self._caption_epoch()
        return len(active)

    # -- async migration/compute overlap ------------------------------------
    def _modeled_move_seconds(self, nbytes: int) -> float:
        """Modeled duration of an in-flight bulk migration (fast<->slow
        pipelined stream_copy on the primary slow route)."""
        if nbytes <= 0 or self.topology is None or self.topology.slow is None:
            return 0.0
        return perfmodel.pipelined_move_cost(
            self.topology.fast, self.topology.slow, int(nbytes),
            asynchronous=True).seconds

    def _drain_migrations(self) -> None:
        """Epoch-boundary fence for overlap mode: collect completions of
        migrations issued without a fence, charge the wall time actually
        spent waiting as stall, and split the modeled move time into
        hidden (ran under decode compute) vs exposed."""
        if self._inflight_move_bytes == 0:
            return
        if self.mover is not None and self.mover.asynchronous:
            t0 = time.perf_counter()
            self.mover.wait_all()
            self.migration_stall_s += time.perf_counter() - t0
        oc = perfmodel.overlap_cost(
            self._modeled_move_seconds(self._inflight_move_bytes),
            self._inflight_compute_s)
        self.telemetry.record_overlap(oc.hidden_s, oc.exposed_s,
                                      source=self.buffer_name)
        self.migration_hidden_s += oc.hidden_s
        self.migration_exposed_s += oc.exposed_s
        self._inflight_move_bytes = 0
        self._inflight_compute_s = 0.0

    def _account_actuation(self, moved_bytes: int, stall_s: float) -> None:
        if moved_bytes <= 0:
            return
        if self.overlap and self.mover is not None \
                and self.mover.asynchronous:
            # unfenced: the move runs under the next epoch's decode
            self._inflight_move_bytes += moved_bytes
        else:
            # fenced: the whole move is exposed decode stall
            move_s = self._modeled_move_seconds(moved_bytes)
            self.telemetry.record_overlap(0.0, move_s,
                                          source=self.buffer_name)
            self.migration_exposed_s += move_s
            self.migration_stall_s += stall_s

    def _retier_prefix(self, fraction: float, *, wait: bool = True) -> None:
        """Tier-aware shared-page placement, actuated with the epoch's
        Caption decision: pages referenced by live slots are
        latency-critical and stay fast; unreferenced (cached-only) pages
        follow the batch population onto the slow tier.  Moves bill each
        page ONCE whatever its refcount — deduplicated traffic."""
        blk = self.cache.prefix
        if blk is None or self.prefix_index is None:
            return
        if len(self.cache.device_names) < 2:
            return
        pdev = blk.page_device.cpu().numpy()
        alloc = np.nonzero(pdev >= 0)[0]
        if alloc.size == 0:
            return
        rc = self.prefix_index.page_refcounts()
        new = pdev.copy()
        for pg in alloc:
            hot = rc.get(int(pg), 0) > 0
            new[pg] = 0 if (hot or fraction <= 0.0) else 1
        self.cache = self.cache.retile_prefix(
            new, mover=self.mover, telemetry=self.telemetry,
            policy_names=self._device_names, source=self.buffer_name,
            wait=wait)

    # -- Caption control loop (§7): sample -> decide -> re-tier ---------------
    def _caption_epoch(self) -> None:
        # Previous epoch's unfenced migrations ran under this epoch's
        # decode steps — drain them before issuing new movement.
        self._drain_migrations()
        # Surface this epoch's modeled KV traffic as route counters, then
        # close the observation window: the controller reads EpochCounters
        # (bandwidths, write share, gauges), not hand-rolled numbers.
        n = self.caption.cfg.epoch_steps
        rb = self.cache.read_bytes_per_step()
        item = self.cache.k_fast.element_size()
        L, B = self.cache.k_fast.shape[:2]
        K, hd = self.cache.k_fast.shape[3:]
        write_slot_b = 2 * L * K * hd * item  # one appended token, one slot
        write_b = write_slot_b * B
        # Only unpinned slots write to the slow tier: slow_fraction() is
        # the unpinned population's operating point, so bill it against
        # the unpinned slot count, not all B slots.
        n_unpinned = B - len(self.pinned_slots)
        dt = max(self._epoch_modeled_s, 1e-9)
        src = self.buffer_name
        multi = len(self._device_names) > 2
        self.telemetry.record_move(self._fast_name, "engine",
                                   rb["fast"] * n, dt, source=src)
        w_slow = int(write_slot_b * n_unpinned * n
                     * self.cache.slow_fraction(self.pinned_slots))
        self.telemetry.record_move("engine", self._fast_name,
                                   write_b * n - w_slow, 0.0, source=src)
        if multi:
            # Per-device billing: reads and appended-token writes land on
            # the real device routes, so the window (and the arbiter's
            # per-device budgets) see each device's own traffic.  Lookups
            # are by NAME — a device the cache's policy rounded away holds
            # no pages and must not be billed a neighbor's bytes.
            rbd = self.cache.read_bytes_per_device()
            w_by_name = dict(zip(self.cache.device_names[1:],
                                 self.cache.weights(self.pinned_slots)))
            total_w = sum(w_by_name.values())
            for dev in self._device_names[1:]:
                if rbd.get(dev):
                    self.telemetry.record_move(dev, "engine",
                                               rbd[dev] * n, dt, source=src)
                w_dev = w_by_name.get(dev, 0.0)
                if w_slow and total_w > 0 and w_dev > 0:
                    self.telemetry.record_move(
                        "engine", dev,
                        int(w_slow * w_dev / total_w), 0.0, source=src)
        else:
            if rb["slow"]:
                self.telemetry.record_move(self._slow_name, "engine",
                                           rb["slow"] * n, dt, source=src)
            if w_slow:
                self.telemetry.record_move("engine", self._slow_name, w_slow,
                                           0.0, source=src)
        pressure = None
        if self.topology is not None:
            kv_fast_bytes = (self.cache.k_fast.numel()
                             + self.cache.v_fast.numel()) * item
            pressure = min(kv_fast_bytes / self.topology.fast.capacity_bytes,
                           1.0)
        before = self.caption.fraction
        tput = self._epoch_tokens / dt
        slo_names = (tuple(self._device_names[1:]) if multi
                     else self._slow_name)
        if self.arbiter is not None:
            decision = self.arbiter.observe_window(
                src, self._epoch_window, tput, mover=self.mover,
                fast_pressure=pressure, slow_name=slo_names, seconds=dt)
        else:
            decision = self.caption.observe_window(
                self._epoch_window, tput, mover=self.mover,
                fast_pressure=pressure, slow_name=slo_names, seconds=dt)
        self._epoch_tokens = 0
        self._epoch_modeled_s = 0.0
        if abs(decision.fraction - before) > 1e-9 or (
                multi and decision.changed):
            active = self._active_slow_names()
            b0 = self.mover.bytes_submitted if self.mover is not None else 0
            t0 = time.perf_counter()
            wait = not self.overlap
            if multi and (len(decision.weights) > 1
                          or (active and active[0] in self._device_names)):
                # Expand the controller's live-device weight vector onto
                # the cache's (union) device ordinals by name — after an
                # elastic remove the two differ, and a removed device
                # must actuate to exactly zero.
                self.cache = self.cache.repartition_weights(
                    self._expand_weights(decision.weights),
                    pinned_slots=self.pinned_slots,
                    mover=self.mover, telemetry=self.telemetry,
                    policy_names=self._device_names, source=src,
                    donate=self.donate_kv, wait=wait)
            else:
                self.cache = self.cache.repartition_fraction(
                    decision.fraction, pinned_slots=self.pinned_slots,
                    mover=self.mover,
                    telemetry=self.telemetry, fast_tier=self._fast_name,
                    slow_tier=self._slow_name, source=src,
                    donate=self.donate_kv, wait=wait)
            if self.cache.prefix is not None:
                self._retier_prefix(decision.fraction, wait=wait)
            moved = ((self.mover.bytes_submitted - b0)
                     if self.mover is not None else 0)
            self._account_actuation(moved, time.perf_counter() - t0)
            self.register_pools()
            # Page rounding may achieve less (or none) of the request: the
            # controller must continue from the real operating point.  With
            # zero tunable slots (everything SLO-pinned) there IS no
            # operating point to read back — feeding 0.0 would corrupt the
            # walk, so the decision stands until slots unpin.
            if n_unpinned > 0:
                if multi and self.caption.n_slow > 1:
                    self.caption.actuated_weights(self._project_weights(
                        self.cache.weights(self.pinned_slots)))
                else:
                    self.caption.actuated(
                        self.cache.slow_fraction(self.pinned_slots))
        self.caption_trace.append((self._steps, self.caption.fraction))

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while (self.queue or any(self.slots)) and steps < max_steps:
            self.step()
            steps += 1
        self._drain_migrations()
        return self.done
