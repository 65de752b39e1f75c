"""BulkMover — the Intel-DSA analogue: centralized, batched, async movement.

The paper's guidelines (§6) for bulk data movement between tiers:
  * use cache-bypassing paths (nt-store / movdir64B) — here the CUDA
    ``stream_copy`` kernel, one grid-stride pass over each slab;
  * batch descriptors to amortize offload latency (Fig. 4b: batch 16/128);
  * submit asynchronously and overlap with compute;
  * limit concurrent writers to the slow tier (controller interference);
  * centralize movement in one daemon instead of per-application access.

``BulkMover`` is that daemon.  It executes real copies, records telemetry,
and also reports *modeled* seconds from the calibrated perfmodel so
benchmarks can reproduce the paper's tier behaviour.

Movement drains through a pool of ``drain_workers`` threads (the DSA
engine count), so the slow-tier writer semaphore and the
``take_peak_writers`` watermark reflect *real* concurrency, not a
synthetic gauge.  Submissions are scheduled route-aware — descriptors
are batched per (src, dst, op) so one batch never mixes routes — and
through two priority lanes: ``LANE_LATENCY`` descriptors (demand
misses, SLO-pinned pages) jump ``LANE_BULK`` repartition traffic.

On the card, :func:`stream_executor` launches each copy on a side stream
after the submitter's ``ready`` event and records a ``done`` event on the
descriptor; whoever consumes the copy makes its own stream wait on that
event (``torch.cuda.current_stream().wait_event``) — the host-side
completion of a :class:`MoveFuture` only says the copy was enqueued.  A
batch whose descriptors each name a tensor ``dst`` (a view of the
caller's staging buffer) is one ``stream_copy`` launch for the whole
batch (:attr:`stream_executor` ``.batch``); descriptors, billing,
telemetry, futures and writer accounting stay one per descriptor.  A
:class:`Segments` payload (a segment list between contiguous bases,
billed as the pages it covers) is one launch of its own.
"""
from __future__ import annotations

import dataclasses
import inspect
import itertools
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import perfmodel
from repro_torch.core.tiers import OpClass, TierSpec, TierTopology
from repro_torch.core.telemetry import GLOBAL_TELEMETRY, Telemetry
from repro_torch.device import DeviceLike, resolve_device

#: priority lanes — lower value drains first.
LANE_LATENCY = 0  #: latency-critical (demand fills, SLO-pinned pages)
LANE_BULK = 1  #: bulk background traffic (repartition, paging)

#: ``Descriptor.dst`` value naming page-locked host memory.
PINNED = "pinned"


def _leaves(payload) -> list:
    """Tensor / ndarray leaves of a payload (a leaf or nested lists,
    tuples and dicts of them)."""
    if isinstance(payload, (list, tuple)):
        return [x for p in payload for x in _leaves(p)]
    if isinstance(payload, dict):
        return [x for p in payload.values() for x in _leaves(p)]
    return [] if payload is None else [payload]


def _tree_map(fn, payload):
    if isinstance(payload, (list, tuple)):
        return type(payload)(_tree_map(fn, p) for p in payload)
    if isinstance(payload, dict):
        return {k: _tree_map(fn, v) for k, v in payload.items()}
    return fn(payload)


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return np.dtype(dtype).itemsize


def _leaf_size(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else int(np.size(x))


@dataclasses.dataclass
class Segments:
    """A payload moved in one ``stream_copy_segments`` launch: the rows of
    ``segs`` copy between the contiguous bases ``srcs`` and ``dsts``
    (HBM or pinned host memory on the card; pageable host tensors take
    the plain version).  ``nbytes`` is what the move bills: whole pages
    of the state it moves, as the reference bills its padded pages."""

    srcs: tuple
    dsts: tuple
    segs: np.ndarray
    nbytes: int

    def on_card(self) -> bool:
        return any(t.is_cuda or t.is_pinned() for t in (*self.srcs, *self.dsts))

    def run(self, device=None) -> tuple:
        from repro_torch.kernels.stream_copy import ops as _stream_ops
        _stream_ops.stream_copy_segments(self.srcs, self.dsts, self.segs,
                                         device=device)
        return self.dsts


@dataclasses.dataclass
class Descriptor:
    """One movement request (DSA work descriptor analogue)."""

    src_tier: str
    dst_tier: str
    payload: Any  # tensor / ndarray (or nested lists/dicts of them) to move
    op: OpClass = OpClass.NT_STORE  # cache-bypass by default (guideline 1)
    on_done: Optional[Callable[[Any], None]] = None
    #: priority lane (LANE_LATENCY jumps LANE_BULK in the drain queue).
    lane: int = LANE_BULK
    #: buffer this traffic is billed to (arbiter attribution), if any.
    source: Optional[str] = None
    #: fused on-route dtype cast (compressed staging): the executor casts
    #: while moving, so the bytes on the wire are the POST-cast bytes.
    out_dtype: Optional[Any] = None
    #: per-descriptor completion handle, set by :meth:`BulkMover.issue`.
    future: Optional["MoveFuture"] = None
    #: destination of the copy: a ``torch.device`` or ``PINNED`` (a new
    #: tensor there), a tensor of the payload's shape (written in place:
    #: a view of the caller's staging buffer), or None (a new tensor
    #: beside the payload).  Neither billed nor batched on.
    dst: Optional[Any] = None
    #: CUDA event after which the payload holds its data (recorded on the
    #: submitter's stream); the executor's stream waits on it.
    ready: Optional[Any] = None
    #: CUDA event recorded after the copy was launched (card executors).
    done: Optional[Any] = None

    @property
    def nbytes(self) -> int:
        """Bytes actually on the route.  With a fused cast the payload
        never travels at its source width — billing the pre-cast size
        would over/under-charge the arbiter."""
        leaves = _leaves(self.payload)
        billed = sum(x.nbytes for x in leaves if isinstance(x, Segments))
        leaves = [x for x in leaves if not isinstance(x, Segments)]
        if self.out_dtype is not None:
            item = _itemsize(self.out_dtype)
            return billed + sum(_leaf_size(x) * item for x in leaves)
        return billed + sum(_leaf_size(x) * _itemsize(x.dtype)
                            for x in leaves)

    @property
    def route(self) -> tuple[str, str, OpClass]:
        return (self.src_tier, self.dst_tier, self.op)


@dataclasses.dataclass
class Completion:
    descriptor: Descriptor
    result: Any
    wall_seconds: float
    modeled_seconds: float


class MoveFuture:
    """Per-descriptor completion handle (the non-blocking issue path).

    ``BulkMover.issue`` attaches one of these to every descriptor and
    returns them immediately; the drain worker fulfils each as its
    descriptor executes.  Callers overlap the migration with compute and
    either poll :meth:`done` at epoch boundaries or fence on
    :meth:`result` when they need the moved bytes (on the card, then also
    wait on the descriptor's ``done`` event)."""

    __slots__ = ("_event", "_completion")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._completion: Optional[Completion] = None

    def _fulfil(self, completion: Completion) -> None:
        self._completion = completion
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float = 60.0) -> Completion:
        if not self._event.wait(timeout):
            raise TimeoutError("MoveFuture.result timed out")
        assert self._completion is not None
        return self._completion


def _dest_kwargs(x: torch.Tensor, dst) -> dict:
    """``torch.empty`` placement for a copy of ``x`` into memory ``dst``."""
    if dst is None:
        return ({"device": x.device} if x.is_cuda or not x.is_pinned()
                else {"device": "cpu", "pin_memory": True})
    if dst == PINNED:
        return {"device": "cpu", "pin_memory": True}
    return {"device": torch.device(dst)}


def _on_card(x: torch.Tensor, dst) -> bool:
    """A copy of ``x`` into ``dst`` is card work: either side in HBM or in
    pinned host memory."""
    if isinstance(dst, torch.Tensor):
        return x.is_cuda or x.is_pinned() or dst.is_cuda or dst.is_pinned()
    return x.is_cuda or x.is_pinned() or dst is not None


def _host_copy(x, out_dtype=None):
    """Plain copy of a numpy array or a pageable host tensor."""
    if isinstance(x, np.ndarray):
        return np.array(x) if out_dtype is None else x.astype(out_dtype)
    return x.to(dtype=out_dtype or x.dtype, copy=True)


def _execute_copy(payload, out_dtype=None, desc: Optional[Descriptor] = None):
    """Plain host copy (the default executor of a mover on the CPU).

    ``out_dtype`` fuses the compressed-staging cast into the move.  Card
    payloads and destinations are refused: on the card every move goes
    through :func:`stream_executor`."""
    dst = desc.dst if desc is not None else None

    def _copy(x):
        if isinstance(x, Segments):
            if x.on_card():
                raise ValueError("card memory moves through stream_executor()")
            return x.run()
        if isinstance(x, torch.Tensor) and _on_card(x, dst):
            raise ValueError("card memory moves through stream_executor()")
        out = _host_copy(x, out_dtype)
        return dst.copy_(out) if isinstance(dst, torch.Tensor) else out

    return _tree_map(_copy, payload)


def stream_executor(*, block_bytes_hint: int = 1 << 20
                    ) -> Callable[..., Any]:
    """Executor that moves payloads through the CUDA ``stream_copy`` kernel.

    Tensors that lie on the card or in pinned host memory take the kernel,
    written into the descriptor's ``dst`` tensor, else into a new tensor
    in its ``dst`` memory (beside the payload when ``dst`` is None).  The
    launch goes on a side stream of the destination card (else the
    current one) that first waits on the descriptor's ``ready`` event; a
    ``done`` event recorded after it is left on the descriptor for the
    consumer to wait on.  Pageable host tensors (the ``modeled`` backend)
    and numpy arrays take the plain copy.

    Its ``batch`` attribute moves a whole batch in one
    ``stream_copy_segments`` launch (one ``done`` event for all) when
    every descriptor carries one contiguous tensor payload and a
    contiguous ``dst`` tensor of its shape, or every one carries a
    :class:`Segments` payload on the card, one dtype a side; for any
    other batch it returns None and the mover executes per descriptor.
    The returned callable is flagged ``pipelined`` so
    ``BulkMover.modeled_cost`` switches to the overlapped-migration
    perfmodel.  It is the default executor of a mover on the card."""
    from repro_torch.kernels.stream_copy import ops as _stream_ops

    streams: dict[torch.device, torch.cuda.Stream] = {}
    lock = threading.Lock()

    def _side(device: torch.device) -> "torch.cuda.Stream":
        with lock:
            s = streams.get(device)
            if s is None:
                s = streams[device] = torch.cuda.Stream(device)
            return s

    def _card(x: torch.Tensor, dst) -> torch.device:
        """The card that runs a copy of ``x`` into ``dst``."""
        if x.is_cuda:
            return x.device
        if isinstance(dst, torch.Tensor) and dst.is_cuda:
            return dst.device
        if dst is not None and not isinstance(dst, torch.Tensor) \
                and dst != PINNED:
            return torch.device(dst)
        # pinned -> pinned, through the current card
        return torch.device("cuda", torch.cuda.current_device())

    def _launch(device, descs, copy) -> None:
        """``copy()`` on ``device``'s side stream after every descriptor's
        ``ready`` event; one ``done`` event for all of them."""
        side = _side(device)
        with torch.cuda.device(device), torch.cuda.stream(side):
            for ready in {id(d.ready): d.ready for d in descs
                          if d is not None and d.ready is not None}.values():
                side.wait_event(ready)
            copy()
            ev = torch.cuda.Event()
            ev.record(side)
        for d in descs:
            if d is not None:
                d.done = ev

    def _execute(payload, out_dtype=None, desc: Optional[Descriptor] = None):
        dst = desc.dst if desc is not None else None

        def _copy(x):
            if isinstance(x, Segments):
                if not x.on_card():
                    return x.run()
                cuda = [t.device for t in (*x.srcs, *x.dsts) if t.is_cuda]
                device = cuda[0] if cuda else torch.device(
                    "cuda", torch.cuda.current_device())
                _launch(device, [desc], lambda: x.run(device))
                return x.dsts
            if isinstance(x, np.ndarray) or not _on_card(x, dst):
                out = _host_copy(x, out_dtype)
                return dst.copy_(out) if isinstance(dst, torch.Tensor) else out
            device = _card(x, dst)
            out = dst if isinstance(dst, torch.Tensor) else torch.empty(
                x.shape, dtype=out_dtype or x.dtype, **_dest_kwargs(x, dst))
            _launch(device, [desc], lambda: _stream_ops.stream_copy(
                x, out=out, device=device))
            return out

        return _tree_map(_copy, payload)

    def _batch_segments(lists: Sequence[Segments],
                        descs: Sequence[Descriptor]) -> Optional[list]:
        """Segment-list payloads of one dtype a side, as one list."""
        if len({t.dtype for x in lists for t in x.srcs}) > 1 or len(
                {t.dtype for x in lists for t in x.dsts}) > 1:
            return None
        srcs, dsts, segs = [], [], []
        for x in lists:
            rows = np.array(x.segs, np.int64, copy=True).reshape(-1, 8)
            rows[:, 0] += len(srcs)
            rows[:, 3] += len(dsts)
            srcs += x.srcs
            dsts += x.dsts
            segs.append(rows)
        cuda = [t.device for t in (*srcs, *dsts) if t.is_cuda]
        device = cuda[0] if cuda else torch.device(
            "cuda", torch.cuda.current_device())
        _launch(device, descs, lambda: _stream_ops.stream_copy_segments(
            srcs, dsts, np.concatenate(segs), device=device))
        return [x.dsts for x in lists]

    def _batch(descs: Sequence[Descriptor]) -> Optional[list]:
        srcs = [d.payload for d in descs]
        dsts = [d.dst for d in descs]
        if descs and all(isinstance(x, Segments) and x.on_card()
                         for x in srcs):
            return _batch_segments(srcs, descs)
        if not descs or not all(
                isinstance(x, torch.Tensor) and isinstance(o, torch.Tensor)
                and x.shape == o.shape and x.is_contiguous()
                and o.is_contiguous()
                and (d.out_dtype is None or d.out_dtype == o.dtype)
                for x, o, d in zip(srcs, dsts, descs)):
            return None
        if len({x.dtype for x in srcs}) > 1 or len({o.dtype for o in dsts}) > 1:
            return None
        numel = np.fromiter((x.numel() for x in srcs), np.int64, len(srcs))
        segs = np.zeros((len(descs), 8), np.int64)
        segs[:, 0] = segs[:, 3] = np.arange(len(descs))
        segs[:, 2] = segs[:, 5] = segs[:, 7] = numel
        segs[:, 6] = 1
        if not any(_on_card(x, o) for x, o in zip(srcs, dsts)):
            _stream_ops.stream_copy_segments(srcs, dsts, segs)
            return dsts
        device = _card(srcs[0], dsts[0])
        _launch(device, descs, lambda: _stream_ops.stream_copy_segments(
            srcs, dsts, segs, device=device))
        return dsts

    _execute.pipelined = True
    _execute.block_bytes = block_bytes_hint
    _execute.batch = _batch
    return _execute


class BulkMover:
    """Centralized movement engine: batching, asynchrony, writer limits,
    a multi-worker drain pool, and priority-lane scheduling."""

    def __init__(
        self,
        topology: TierTopology,
        *,
        batch_size: int = 16,
        asynchronous: bool = True,
        max_writers: int = 2,
        max_readers: int = 8,
        drain_workers: int = 1,
        telemetry: Telemetry = GLOBAL_TELEMETRY,
        execute: Optional[Callable[..., Any]] = None,
        device: DeviceLike = None,
    ):
        #: the device the mover serves (``cuda`` unless the caller names
        #: the CPU); raises without CUDA when not told ``device="cpu"``.
        self.device = resolve_device(device)
        if execute is None:  # the card moves through the kernel only
            execute = (stream_executor() if self.device.type == "cuda"
                       else _execute_copy)
        if batch_size < 1:
            raise ValueError("batch_size >= 1")
        if drain_workers < 1:
            raise ValueError("drain_workers >= 1")
        self.topology = topology
        self.batch_size = batch_size
        self.asynchronous = asynchronous
        self.max_writers = max_writers
        self.max_readers = max_readers
        self.drain_workers = drain_workers
        self.telemetry = telemetry
        self._execute = execute
        # Executors take (payload), (payload, out_dtype) or (payload,
        # out_dtype, descriptor); pass as many as the callable accepts.
        try:
            n_params = len(inspect.signature(execute).parameters)
        except (TypeError, ValueError):
            n_params = 1
        self._execute_args = min(max(n_params, 1), 3)
        #: executor uses the streaming migration kernel — modeled costs
        #: switch to the overlapped-pipeline perfmodel.
        self.pipelined = bool(getattr(execute, "pipelined", False))
        self._pipeline_block_bytes = int(getattr(execute, "block_bytes",
                                                 1 << 20))
        # One writer semaphore PER slow device: the §6 writer limit is a
        # property of each device's controller (Fig. 3 collapse is per
        # controller), so concurrent writers into CXL-A must not throttle
        # CXL-B.  Created lazily per destination tier name.
        self._write_sems: dict[str, threading.Semaphore] = {}
        self._read_sem = threading.Semaphore(max_readers)
        # Writer-concurrency watermarks (global + per device): the §6
        # "limit concurrent writers" signal a controller (core/caption.py)
        # reads each epoch.
        self._writer_lock = threading.Lock()
        self._active_writers = 0
        self.peak_writers = 0
        self._active_by_dev: dict[str, int] = {}
        self.peak_by_dev: dict[str, int] = {}
        # Priority drain queue: entries are (lane, seq, batch); the seq
        # tiebreaker keeps FIFO order within a lane.  None batch = shutdown.
        self._queue: "queue.PriorityQueue[tuple[int, int, Optional[list[Descriptor]]]]" = (
            queue.PriorityQueue())
        self._seq = itertools.count()
        self._completions: "queue.Queue[Completion]" = queue.Queue()
        self._pending = 0
        self._pending_lock = threading.Lock()
        #: notified by a drain worker when the backlog empties (the fence
        #: of ``wait_all`` sleeps on it instead of polling)
        self._idle = threading.Condition(self._pending_lock)
        # Guards the closed flag vs queue puts: without it a submit racing
        # close() could enqueue batches after the workers consumed their
        # shutdown sentinels — work nobody drains, a silent wait_all hang.
        self._lifecycle = threading.Lock()
        self._closed = False
        # Lifetime submission counters (bench_hotpaths/tests introspection):
        # a run-coalesced actuator submits O(runs) descriptors for O(pages)
        # of payload, and these two watermarks make that ratio observable
        # without spelunking telemetry.
        self.descriptors_submitted = 0
        self.bytes_submitted = 0
        self._workers: list[threading.Thread] = []
        if asynchronous:
            for i in range(drain_workers):
                t = threading.Thread(target=self._drain, daemon=True,
                                     name=f"bulkmover-drain-{i}")
                t.start()
                self._workers.append(t)

    # -- cost modeling -------------------------------------------------------
    def _tier(self, name: str) -> TierSpec:
        return self.topology.by_name(name)

    def update_topology(self, topology: TierTopology) -> None:
        """Swap the topology after an elastic add/remove.

        A removed device should stay ledger-visible in the new topology
        (``TierTopology.remove_device(keep_visible=True)``) so queued
        descriptors naming it keep costing and billing; a hot-added
        device must be present before the first descriptor routes to it.
        Per-device writer semaphores/watermarks are keyed by name and
        created lazily, so they carry across the swap untouched."""
        self.topology = topology

    def modeled_cost(self, descs: Sequence[Descriptor]) -> float:
        """Modeled seconds for a descriptor set (DSA model): descriptors
        grouped per route; batching amortizes submission overhead."""
        routes: dict[tuple, list[Descriptor]] = {}
        for d in descs:
            routes.setdefault(d.route, []).append(d)
        total = 0.0
        for (src, dst, op), group in routes.items():
            kwargs = dict(
                n_descriptors=len(group),
                batch_size=self.batch_size,
                asynchronous=self.asynchronous,
                op=op,
                n_streams=min(self.max_writers,
                              self._tier(dst).store_peak_streams),
            )
            if self.pipelined:
                cost = perfmodel.pipelined_move_cost(
                    self._tier(src), self._tier(dst),
                    sum(d.nbytes for d in group),
                    block_bytes=self._pipeline_block_bytes, **kwargs)
            else:
                cost = perfmodel.bulk_move_cost(
                    self._tier(src), self._tier(dst),
                    sum(d.nbytes for d in group), **kwargs)
            total += cost.seconds
        return total

    # -- scheduling ----------------------------------------------------------
    def _schedule(self, descs: Sequence[Descriptor]) -> list[list[Descriptor]]:
        """Route-aware batch formation: one batch never mixes (src, dst, op)
        routes or lanes, so per-batch telemetry and the modeled DSA batch
        cost attribute cleanly.  Latency-lane batches sort first."""
        groups: dict[tuple, list[Descriptor]] = {}
        for d in descs:
            groups.setdefault((d.lane,) + d.route, []).append(d)
        batches = []
        for key in sorted(groups, key=lambda k: k[0]):
            group = groups[key]
            for i in range(0, len(group), self.batch_size):
                batches.append(group[i : i + self.batch_size])
        return batches

    def _write_sem_for(self, dst: str) -> threading.Semaphore:
        with self._writer_lock:
            sem = self._write_sems.get(dst)
            if sem is None:
                sem = self._write_sems[dst] = threading.Semaphore(
                    self.max_writers)
            return sem

    # -- execution -----------------------------------------------------------
    def _run_batch(self, batch: list[Descriptor]) -> list[Completion]:
        """Execute one route-pure batch: through the executor's ``batch``
        entry (one launch for all, made under the first descriptor's
        writer slot) when it takes the batch, else per descriptor.
        Semaphores, watermarks, telemetry, callbacks and futures are per
        descriptor either way."""
        out = []
        modeled = self.modeled_cost(batch)
        batched = getattr(self._execute, "batch", None)
        results = None
        for i, d in enumerate(batch):
            writes_slow = self._tier(d.dst_tier).link_bw is not None
            sem = (self._write_sem_for(d.dst_tier) if writes_slow
                   else self._read_sem)
            with _acquired(sem):
                if writes_slow:
                    with self._writer_lock:
                        self._active_writers += 1
                        self.peak_writers = max(self.peak_writers,
                                                self._active_writers)
                        dev = d.dst_tier
                        self._active_by_dev[dev] = (
                            self._active_by_dev.get(dev, 0) + 1)
                        self.peak_by_dev[dev] = max(
                            self.peak_by_dev.get(dev, 0),
                            self._active_by_dev[dev])
                t0 = time.perf_counter()
                try:
                    if i == 0 and batched is not None:
                        results = batched(batch)
                    if results is not None:
                        result = results[i]
                    else:
                        args = (d.payload, d.out_dtype, d)[:self._execute_args]
                        result = self._execute(*args)
                finally:
                    if writes_slow:
                        with self._writer_lock:
                            self._active_writers -= 1
                            self._active_by_dev[d.dst_tier] -= 1
                dt = time.perf_counter() - t0
            self.telemetry.record_move(
                d.src_tier, d.dst_tier, d.nbytes, dt, descriptors=1,
                batches=0, source=d.source)
            comp = Completion(d, result, dt, modeled / len(batch))
            if d.on_done is not None:
                d.on_done(result)
            # the descriptor lets go of its future: the completion refers
            # back to the descriptor, and that cycle would keep the payload
            # (often a view of a shard its owner is dropping) alive until
            # a garbage collection; on the card that pins a freed shard's
            # page-locked block and the next shard allocates anew
            future, d.future = d.future, None
            if future is not None:
                future._fulfil(comp)
            out.append(comp)
        # One batch record per route present (submission batches are
        # route-pure, but sync callers may hand-build mixed batches; each
        # route must still see its own batch count, not batch[0]'s).
        for src, dst, _ in {d.route for d in batch}:
            self.telemetry.record_move(src, dst, 0, 0.0,
                                       descriptors=0, batches=1)
        return out

    def _drain(self):
        while True:
            _, _, batch = self._queue.get()
            if batch is None:
                return
            n = len(batch)
            for comp in self._run_batch(batch):
                self._completions.put(comp)
            # let go of the batch before sleeping on the queue: a payload
            # is often a view of a shard its owner is dropping
            batch = comp = None
            with self._pending_lock:
                self._pending -= n
                if self._pending == 0:
                    self._idle.notify_all()

    def submit(self, descs: Sequence[Descriptor]) -> list[Completion]:
        """Submit descriptors; sync mode returns completions immediately."""
        descs = list(descs)

        def count_accepted():
            # only ACCEPTED work bumps the observability counters — a
            # rejected submit (after close) must not skew the exact
            # billed-bytes assertions downstream
            self.descriptors_submitted += len(descs)
            self.bytes_submitted += sum(d.nbytes for d in descs)

        if not self.asynchronous:
            return self.run(descs)
        with self._lifecycle:
            if self._closed:
                raise RuntimeError("BulkMover.submit() after close()")
            if not descs:
                return []
            count_accepted()
            with self._pending_lock:
                self._pending += len(descs)
            for b in self._schedule(descs):
                self._queue.put((b[0].lane, next(self._seq), b))
        return []

    def run(self, descs: Sequence[Descriptor]) -> list[Completion]:
        """Execute ``descs`` in the calling thread and return their
        completions in order: a synchronous mover's ``submit``, and on an
        asynchronous one what a caller that fences at once would get
        from ``issue`` and its futures, without the hand-off to a drain
        worker and back.  Batching, billing, telemetry, writer limits,
        futures and the counters are ``submit``'s."""
        descs = list(descs)
        with self._lifecycle:
            if self._closed:
                raise RuntimeError("BulkMover.submit() after close()")
            if not descs:
                return []
            # only ACCEPTED work bumps the observability counters
            self.descriptors_submitted += len(descs)
            self.bytes_submitted += sum(d.nbytes for d in descs)
        order = {id(d): i for i, d in enumerate(descs)}
        out = []
        for b in self._schedule(descs):
            out.extend(self._run_batch(b))
        out.sort(key=lambda c: order[id(c.descriptor)])
        return out

    def issue(self, descs: Sequence[Descriptor]) -> list["MoveFuture"]:
        """Non-blocking submit: returns one :class:`MoveFuture` per
        descriptor instead of fencing.  In async mode the call returns as
        soon as the batches are queued — the caller's decode steps run
        while the drain pool streams the copies, and completions are
        collected at the next epoch boundary (``poll`` /
        ``Future.done``).  In sync mode the copies execute inline and the
        futures come back already fulfilled, so callers need no mode
        branch."""
        descs = list(descs)
        futures = []
        for d in descs:
            if d.future is None:
                d.future = MoveFuture()
            futures.append(d.future)
        self.submit(descs)
        return futures

    @property
    def pending(self) -> int:
        """Descriptors submitted but not yet executed (async backlog)."""
        with self._pending_lock:
            return self._pending

    def take_peak_writers(self, device: Optional[str] = None) -> int:
        """Peak concurrent slow-tier writers since last call (then reset).

        With ``device`` (a slow tier name), the per-device watermark — the
        Fig. 3 collapse is per controller, so an N-device Caption loop
        reads each device's own writer pressure."""
        with self._writer_lock:
            if device is not None:
                peak = self.peak_by_dev.get(device, 0)
                self.peak_by_dev[device] = self._active_by_dev.get(device, 0)
                return peak
            peak, self.peak_writers = self.peak_writers, self._active_writers
            return peak

    def poll(self) -> list[Completion]:
        out = []
        while True:
            try:
                out.append(self._completions.get_nowait())
            except queue.Empty:
                return out

    def wait_all(self, timeout: float = 60.0) -> list[Completion]:
        """Fence: block until every submitted descriptor completed.

        Submissions count as pending before their batches are queued, and
        a drain worker posts a batch's completions before it uncounts
        them, so an empty backlog means every completion can be polled."""
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError("BulkMover.wait_all timed out")
                self._idle.wait(left)
        return self.poll()

    def close(self):
        with self._lifecycle:
            if self._closed:
                return
            self._closed = True
            # Shutdown sentinels sort after every real lane: queued work
            # drains first, and no submit can slip in behind them.
            for _ in self._workers:
                self._queue.put((1 << 30, next(self._seq), None))
        for t in self._workers:
            t.join(timeout=5)
        self._workers = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _acquired:
    def __init__(self, sem: threading.Semaphore):
        self.sem = sem

    def __enter__(self):
        self.sem.acquire()

    def __exit__(self, *exc):
        self.sem.release()
        return False


def double_buffer(items: Iterable[Any], load: Callable[[Any], Any]) -> Iterator[Any]:
    """Prefetch-one pipeline: load(next) overlaps with consumer of current.

    The staging pattern for paged optimizer offload and the data pipeline —
    the software shape of DSA async mode.
    """
    it = iter(items)
    try:
        first = next(it)
    except StopIteration:
        return
    result = {}
    def _load(item, slot):
        result[slot] = load(item)
    cur_t = threading.Thread(target=_load, args=(first, 0))
    cur_t.start()
    slot = 0
    for nxt in it:
        nxt_t = threading.Thread(target=_load, args=(nxt, 1 - slot))
        nxt_t.start()
        cur_t.join()
        yield result.pop(slot)
        cur_t, slot = nxt_t, 1 - slot
    cur_t.join()
    yield result.pop(slot)
