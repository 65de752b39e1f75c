"""Tiered optimizer-state offload — the paper's technique in the optimizer.

AdamW's fp32 master weights and moments for a planner-chosen subset of
parameters live on the slow tier — page-locked host memory behind PCIe on
the card, which the ``stream_copy`` kernel reads and writes in place — as
flat fp32 pages of :data:`PAGE_ELEMS`.  Each step streams every page
through HBM, a run of :data:`WRITEBACK_RUN_PAGES` consecutive pages at a
time: a load is one ``stream_copy_segments`` launch of the run's master,
mu and nu pages (pinned -> HBM, into one of two staging slots), queued
on the calling thread's stream just before the previous run's update;
the update runs in place in the slot in plain torch, and the run goes
back in one launch (HBM -> pinned, straight into the leaf's pinned
views) on a side stream.  The offloaded parameter is reassembled on the
card from the updated master pages; the host never reads a page.  (The
reference loads a page at a time; one launch a page left the card idle
behind the host, and the update is element-wise, so a run gives the same
values.)

A leaf's state is one host allocation (:func:`repro_torch.device.
host_block`) holding master, mu and nu (or the int8 moments and their
block scales) back to back, each padded to whole pages.  Leaves are keyed
by their dotted names; :func:`repro_torch.tree.ref_key` maps a name to the
reference's key.  Bytes billed — the step's ``offload_bytes``, each
writeback descriptor, each repartition's moves and the
``caption.opt_*`` counters — are the reference's, page for page.

Divergences from the reference: parameters and fast moments are updated
in place; moves with a mover run through ``BulkMover.run`` (the calling
thread), and the card's stream waits for each one before it reuses or
frees what the move reads; a reclaimed leaf's master is copied back into
its parameter (which already holds it cast); ``offload_bytes`` is a
Python int.

A step is the span ``repro.offload.step``; inside it each run's load,
update and writeback are the spans ``repro.offload.load``,
``repro.offload.update`` and ``repro.offload.writeback``
(:class:`~repro_torch.core.telemetry.span`).

Access pattern justification (classifier): optimizer state is touched
once per step, sequentially, in page granularity, with zero dependent
chaining — the definition of a bandwidth-bound, slow-tier-tolerant
buffer (§6.1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.mover import BulkMover, Descriptor, Segments
from repro_torch.core.telemetry import GLOBAL_TELEMETRY, span
from repro_torch.device import host_block
from repro_torch.kernels.stream_copy import ops as stream_ops
from repro_torch.optim import adamw
from repro_torch.tree import named_leaves, ref_key

PAGE_ELEMS = 1 << 20  # 4 MiB fp32 pages
QBLOCK = 256  # block size for int8 moment quantization
#: consecutive page writebacks coalesced into one launch (and, with a
#: mover, one descriptor)
WRITEBACK_RUN_PAGES = 8


def _layout(n_pages: int, quantized: bool) -> list[tuple[int, int]]:
    """(byte offset in a leaf's block, bytes a page) of master, mu, nu and,
    when quantized, mu's and nu's block scales."""
    npp = n_pages * PAGE_ELEMS
    if not quantized:
        return [(0, 4 * PAGE_ELEMS), (4 * npp, 4 * PAGE_ELEMS),
                (8 * npp, 4 * PAGE_ELEMS)]
    sb = 4 * PAGE_ELEMS // QBLOCK
    return [(0, 4 * PAGE_ELEMS), (4 * npp, PAGE_ELEMS),
            (5 * npp, PAGE_ELEMS), (6 * npp, sb), (6 * npp + n_pages * sb, sb)]


def _view(buf: torch.Tensor, off: int, nbytes: int, dtype) -> torch.Tensor:
    return buf[off:off + nbytes].view(dtype)


def _seg(src: int, src_off: int, dst: int, dst_off: int, n: int) -> list:
    """One contiguous segment of ``n`` elements."""
    return [src, src_off, n, dst, dst_off, n, 1, n]


@dataclasses.dataclass
class OffloadedLeaf:
    """Slow-tier optimizer state for one parameter: one host block of
    master, mu and nu pages (fp32, or int8 moments with per-block fp32
    scales — block-wise absmax, 8-bit-Adam style — when ``quantized``)."""

    shape: tuple
    dtype: torch.dtype
    n_pages: int
    size: int
    block: torch.Tensor  # uint8, the whole state
    quantized: bool = False
    #: slow device holding this leaf's pages (a tier name for routing).
    device: str = "host"

    def _array(self, i: int, dtype) -> torch.Tensor:
        off, per_page = _layout(self.n_pages, self.quantized)[i]
        return _view(self.block, off, per_page * self.n_pages, dtype)

    @property
    def master(self) -> torch.Tensor:
        return self._array(0, torch.float32)

    @property
    def mu(self) -> torch.Tensor:
        return self._array(1, torch.int8 if self.quantized else torch.float32)

    @property
    def nu(self) -> torch.Tensor:
        return self._array(2, torch.int8 if self.quantized else torch.float32)

    @property
    def mu_scale(self) -> Optional[torch.Tensor]:
        return self._array(3, torch.float32) if self.quantized else None

    @property
    def nu_scale(self) -> Optional[torch.Tensor]:
        return self._array(4, torch.float32) if self.quantized else None

    @property
    def state_bytes(self) -> int:
        """master + mu + nu bytes (scales not counted, as the reference)."""
        return sum(b for _, b in _layout(self.n_pages, self.quantized)[:3]) \
            * self.n_pages


def _q_moments(x: torch.Tensor, *, sqrt_domain: bool = False
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-wise symmetric int8: x (N,) -> (q (N,) int8, scale (N/QB,)),
    rounding half to even.  ``sqrt_domain`` stores sqrt(x) (for the
    non-negative second moment)."""
    xq = torch.sqrt(torch.clamp(x, min=0.0)) if sqrt_domain else x
    blocks = xq.reshape(-1, QBLOCK)
    scale = torch.clamp(torch.amax(torch.abs(blocks), dim=1), min=1e-20) / 127.0
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127)
    return q.to(torch.int8).reshape(-1), scale


def _dq_moments(q: torch.Tensor, scale: torch.Tensor, *,
                sqrt_domain: bool = False) -> torch.Tensor:
    x = (q.reshape(-1, QBLOCK).to(torch.float32) * scale[:, None]).reshape(-1)
    return torch.square(x) if sqrt_domain else x


def _n_pages(size: int) -> int:
    return max(1, -(-size // PAGE_ELEMS))


class TieredAdamW:
    """AdamW with planner-directed moment/master offload to the slow tier."""

    def __init__(
        self,
        cfg: adamw.AdamWConfig,
        *,
        slow_fraction: float = 0.0,
        slow_weights: Optional[Sequence[float]] = None,
        slow_device_names: Optional[Sequence[str]] = None,
        mover: Optional[BulkMover] = None,
        min_offload_bytes: int = 1 << 20,
        quantize_moments: bool = False,
        telemetry=GLOBAL_TELEMETRY,
        source: str = "opt_state",
    ):
        self.cfg = cfg
        if slow_weights is not None:
            slow_fraction = float(sum(slow_weights))
        self.slow_fraction = slow_fraction
        self.slow_weights = (tuple(float(w) for w in slow_weights)
                             if slow_weights is not None else None)
        self.slow_device_names = (tuple(slow_device_names)
                                  if slow_device_names else None)
        self.mover = mover
        self.min_offload_bytes = min_offload_bytes
        self.quantize_moments = quantize_moments
        self.telemetry = telemetry
        #: buffer this optimizer's slow-tier traffic is billed to
        self.source = source

    # -- placement ----------------------------------------------------------
    def _slow_device_names(self) -> tuple[str, ...]:
        if self.mover is not None and self.mover.topology.slows:
            return self.mover.topology.slow_names
        if self.slow_device_names:
            return self.slow_device_names
        return ("host",)

    def _fast_name(self) -> str:
        if self.mover is not None:
            return self.mover.topology.fast.name
        return "hbm"

    def choose_offloaded(self, params) -> list[str]:
        """Greedy knapsack: largest params spill first until the target
        fraction of moment bytes is host-resident (ties in the
        reference's leaf order)."""
        leaves = named_leaves(params)
        total = sum(x.numel() for _, x in leaves)
        target = total * self.slow_fraction
        picked, acc = [], 0
        for key, x in sorted(leaves, key=lambda kv: -kv[1].numel()):
            if acc >= target:
                break
            if x.numel() * 4 < self.min_offload_bytes:
                continue
            picked.append(key)
            acc += x.numel()
        return picked

    def assign_devices(self, params, picked) -> dict[str, str]:
        """Distribute the offloaded leaves across the slow devices: greedy
        largest-first fill against per-device byte targets set by
        ``slow_weights``."""
        names = self._slow_device_names()
        sizes = {k: x.numel() for k, x in named_leaves(params)}
        keys = sorted(picked, key=lambda k: -sizes.get(k, 0))
        if len(names) == 1 or not self.slow_weights:
            return {k: names[0] for k in keys}
        w = list(self.slow_weights[: len(names)])
        w += [0.0] * (len(names) - len(w))
        total_w = sum(w) or 1.0
        total_b = sum(sizes.get(k, 0) for k in keys)
        remaining = [total_b * x / total_w for x in w]
        out = {}
        for k in keys:
            i = max(range(len(names)), key=lambda j: remaining[j])
            out[k] = names[i]
            remaining[i] -= sizes.get(k, 0)
        return out

    # -- state --------------------------------------------------------------
    def _new_leaf(self, x: torch.Tensor, device: str,
                  zero: bool = True) -> OffloadedLeaf:
        n_pages = _n_pages(x.numel())
        q = self.quantize_moments
        nbytes = sum(b for _, b in _layout(n_pages, q)) * n_pages
        stream_ops.HELD.release()  # blocks of finished launches may be reused
        return OffloadedLeaf(
            shape=tuple(x.shape), dtype=x.dtype, n_pages=n_pages,
            size=x.numel(), block=host_block(nbytes, x.device, zero=zero),
            quantized=q, device=device)

    def init(self, params) -> dict:
        picked = set(self.choose_offloaded(params))
        leaves = named_leaves(params)
        dev = leaves[0][1].device
        state = {
            "step": torch.zeros((), dtype=torch.int32, device=dev),
            "fast": {
                "mu": {k: torch.zeros(x.shape, dtype=torch.float32,
                                      device=x.device)
                       for k, x in leaves if k not in picked},
                "nu": {k: torch.zeros(x.shape, dtype=torch.float32,
                                      device=x.device)
                       for k, x in leaves if k not in picked},
            },
            "slow": {},
        }
        devmap = self.assign_devices(params, [k for k, _ in leaves
                                              if k in picked])
        for key, x in leaves:
            if key in picked:
                leaf = self._new_leaf(
                    x, devmap.get(key, self._slow_device_names()[0]))
                # the master: one cast copy of the parameter into its pages
                stream_ops.stream_copy(x.detach().reshape(-1),
                                       out=leaf.master[:leaf.size])
                state["slow"][key] = leaf
        return state

    def repartition_weights(self, params, state, weights: Sequence[float],
                            **kwargs) -> dict:
        """Re-tier to a per-slow-device weight vector: total offload =
        sum(weights); newly offloaded leaves land on devices per the
        vector."""
        self.slow_weights = tuple(float(w) for w in weights)
        return self.repartition(params, state, float(sum(weights)), **kwargs)

    @torch.no_grad()
    def repartition(self, params, state, new_fraction: float, *,
                    mover: Optional[BulkMover] = None,
                    fast_tier: Optional[str] = None,
                    slow_tier: Optional[str] = None) -> dict:
        """Re-tier optimizer state to ``new_fraction``, moving only the
        leaves that transition (the Caption actuation path for opt-state
        buffers).  A newly offloaded leaf's master (from its parameter)
        and moments go to a new host block; a reclaimed leaf's moments
        come back to HBM and its master into its parameter; a leaf whose
        slow device changed is copied block to block.  Each move is one
        descriptor through the mover when there is one, else direct
        launches billed to telemetry."""
        mover = mover if mover is not None else self.mover
        if mover is not None:
            fast_tier = fast_tier or mover.topology.fast.name
            slow = mover.topology.slow
            slow_tier = slow_tier or (slow.name if slow else fast_tier)
        else:
            fast_tier = fast_tier or "hbm"
            slow_tier = slow_tier or "host"
        self.slow_fraction = new_fraction
        new_keys = set(self.choose_offloaded(params))
        old_keys = set(state["slow"])
        devmap = self.assign_devices(params, sorted(new_keys, key=ref_key))
        names = self._slow_device_names()
        if new_keys == old_keys and all(
                state["slow"][k].device == devmap.get(
                    k, state["slow"][k].device)
                for k in old_keys):
            return state
        fast_mu = dict(state["fast"]["mu"])
        fast_nu = dict(state["fast"]["nu"])
        slow: dict[str, OffloadedLeaf] = dict(state["slow"])
        moved_down = moved_up = 0

        for key, x in named_leaves(params):
            if key in new_keys and key not in old_keys:
                device = devmap.get(key, names[0])
                if device not in names and slow_tier in names:
                    device = slow_tier
                leaf = self._new_leaf(x, device, zero=False)
                payload = self._page_out(leaf, x, fast_mu.pop(key),
                                         fast_nu.pop(key))
                slow[key] = leaf
                moved_down += leaf.state_bytes
                dst = device if mover is not None or device != names[0] \
                    else slow_tier
                self._move(fast_tier, dst if dst else slow_tier, payload,
                           mover)
            elif key in old_keys and key not in new_keys:
                leaf = slow.pop(key)
                payload, finish = self._page_in(leaf, x)
                moved_up += leaf.state_bytes
                src = (leaf.device if mover is not None
                       or leaf.device != names[0] else slow_tier)
                self._move(src if src else slow_tier, fast_tier, payload,
                           mover)
                fast_mu[key], fast_nu[key] = finish()
            elif key in old_keys:
                leaf = slow[key]
                want = devmap.get(key, leaf.device)
                if want != leaf.device and want in names:
                    if mover is not None:
                        block = host_block(leaf.block.numel(), x.device,
                                           zero=False)
                        n = leaf.block.numel()
                        self._move(leaf.device, want, [Segments(
                            (leaf.block,), (block,),
                            np.array([_seg(0, 0, 0, 0, n)], np.int64),
                            leaf.state_bytes)], mover)
                        leaf = dataclasses.replace(leaf, block=block)
                    else:
                        self.telemetry.record_move(
                            leaf.device, want, leaf.state_bytes, 0.0,
                            source=self.source)
                    slow[key] = dataclasses.replace(leaf, device=want)
        self.telemetry.bump("caption.opt_repartitions")
        self.telemetry.bump("caption.opt_bytes_down", moved_down)
        self.telemetry.bump("caption.opt_bytes_up", moved_up)
        return {"step": state["step"],
                "fast": {"mu": fast_mu, "nu": fast_nu},
                "slow": slow}

    def _page_out(self, leaf: OffloadedLeaf, x: torch.Tensor,
                  mu: torch.Tensor, nu: torch.Tensor) -> list[Segments]:
        """The moves that page a leaf out: its parameter cast into the
        master pages, then its moments (quantized on the card first when
        the leaf is), into ``leaf``'s block, whose pages' tails past the
        leaf are zeroed here."""
        n, npp = leaf.size, leaf.n_pages * PAGE_ELEMS
        for array in ((leaf.master,) if leaf.quantized
                      else (leaf.master, leaf.mu, leaf.nu)):
            array[n:].zero_()
        master = Segments((x.detach().reshape(-1),), (leaf.master,),
                          np.array([_seg(0, 0, 0, 0, n)], np.int64),
                          leaf.master.nbytes)
        moment_bytes = leaf.mu.nbytes + leaf.nu.nbytes
        if not leaf.quantized:
            return [master, Segments(
                (mu.reshape(-1), nu.reshape(-1)), (leaf.block.view(torch.float32),),
                np.array([_seg(0, 0, 0, npp, n), _seg(1, 0, 0, 2 * npp, n)],
                         np.int64), moment_bytes)]
        parts = []
        for m, sqrt_domain in ((mu, False), (nu, True)):
            padded = torch.zeros(npp, dtype=torch.float32, device=m.device)
            padded[:n] = m.reshape(-1)
            parts.append(_q_moments(padded, sqrt_domain=sqrt_domain))
        (qmu, smu), (qnu, snu) = parts
        srcs = tuple(t.view(torch.uint8) for t in (qmu, qnu, smu, snu))
        lay = _layout(leaf.n_pages, True)
        segs = [_seg(i, 0, 0, lay[i + 1][0], s.numel())
                for i, s in enumerate(srcs)]
        return [master, Segments(srcs, (leaf.block,),
                                 np.array(segs, np.int64), moment_bytes)]

    def _page_in(self, leaf: OffloadedLeaf, x: torch.Tensor):
        """(moves, finish): the moves that bring a leaf back — its master
        into its parameter, its moments (or their int8 pages and scales)
        into HBM — and, once they have run, the fast ``(mu, nu)``."""
        n, npp = leaf.size, leaf.n_pages * PAGE_ELEMS
        master = Segments((leaf.master,), (x.detach().reshape(-1),),
                          np.array([_seg(0, 0, 0, 0, n)], np.int64),
                          leaf.master.nbytes)
        moment_bytes = leaf.mu.nbytes + leaf.nu.nbytes
        if not leaf.quantized:
            mu = torch.empty(leaf.shape, dtype=torch.float32, device=x.device)
            nu = torch.empty(leaf.shape, dtype=torch.float32, device=x.device)
            moves = Segments(
                (leaf.block.view(torch.float32),),
                (mu.reshape(-1), nu.reshape(-1)),
                np.array([_seg(0, npp, 0, 0, n), _seg(0, 2 * npp, 1, 0, n)],
                         np.int64), moment_bytes)
            return [master, moves], lambda: (mu, nu)
        lay = _layout(leaf.n_pages, True)
        lens = [b * leaf.n_pages for _, b in lay[1:]]
        staged = torch.empty(sum(lens), dtype=torch.uint8, device=x.device)
        offs = np.cumsum([0] + lens)
        moves = Segments(
            (leaf.block,), (staged,),
            np.array([_seg(0, lay[i + 1][0], 0, int(offs[i]), lens[i])
                      for i in range(4)], np.int64), moment_bytes)

        def finish():
            part = [staged[int(offs[i]):int(offs[i + 1])] for i in range(4)]
            mu = _dq_moments(part[0].view(torch.int8),
                             part[2].view(torch.float32))
            nu = _dq_moments(part[1].view(torch.int8),
                             part[3].view(torch.float32), sqrt_domain=True)
            return (mu[:n].reshape(leaf.shape).clone(),
                    nu[:n].reshape(leaf.shape).clone())
        return [master, moves], finish

    def _move(self, src: str, dst: str, payload: list,
              mover: Optional[BulkMover]) -> None:
        """Run ``payload``'s launches: one descriptor through ``mover`` (the
        card's stream then waits for it), else directly on the current
        stream, billed to telemetry."""
        if mover is None:
            for seg in payload:
                seg.run()
            self.telemetry.record_move(src, dst, sum(s.nbytes for s in payload),
                                       0.0, source=self.source)
            return
        desc = Descriptor(src, dst, payload, source=self.source)
        _fenced_run(mover, desc)

    def _leaf_dst(self, leaf: OffloadedLeaf) -> str:
        """Routing name for a leaf's pages (valid in the mover's topology)."""
        names = self._slow_device_names()
        return leaf.device if leaf.device in names else names[0]

    def achieved_weights(self, params, state) -> tuple[float, ...]:
        """Per-slow-device share of param elements actually offloaded."""
        names = self._slow_device_names()
        total = sum(x.numel() for _, x in named_leaves(params))
        per = {n: 0 for n in names}
        for leaf in state["slow"].values():
            per[leaf.device if leaf.device in per else names[0]] += leaf.size
        return tuple(per[n] / max(total, 1) for n in names)

    def host_bytes(self, state) -> int:
        return sum(leaf.state_bytes for leaf in state["slow"].values())

    def pinned_bytes(self, state) -> int:
        """Host bytes the slow state holds (scales included)."""
        return sum(leaf.block.numel() for leaf in state["slow"].values())

    def host_bytes_by_device(self, state) -> dict[str, int]:
        """Slow-tier residency per device (capacity accounting)."""
        out: dict[str, int] = {}
        for leaf in state["slow"].values():
            out[leaf.device] = out.get(leaf.device, 0) + leaf.state_bytes
        return out

    def traffic_per_step_bytes(self, state) -> int:
        """Host<->device bytes each step (reads + writes): fp32 master +
        fp32-or-int8 moments, each direction."""
        total = 0
        for leaf in state["slow"].values():
            elems = leaf.n_pages * PAGE_ELEMS
            moment_b = 1 + 4 / QBLOCK if leaf.quantized else 4
            total += int(elems * (4 + 2 * moment_b) * 2)
        return total

    def step_launches(self, state) -> int:
        """``stream_copy`` launches a step makes: one load and one
        writeback a run of :data:`WRITEBACK_RUN_PAGES` pages."""
        return sum(2 * -(-leaf.n_pages // WRITEBACK_RUN_PAGES)
                   for leaf in state["slow"].values())

    # -- step ---------------------------------------------------------------
    @torch.no_grad()
    def step(self, params, grads, state) -> tuple[object, dict, dict]:
        with span("repro.offload.step"):
            grads = adamw.by_name(grads)
            gnorm = adamw.global_norm(grads)
            scale = adamw.clip_scale(gnorm, self.cfg.grad_clip)
            step = state["step"] + 1
            lr, c1, c2 = adamw.coefficients(self.cfg, step)
            slow_keys = state["slow"]
            leaves = named_leaves(params)

            # --- fast subset: the fused update, in place --------------------
            for key, p in leaves:
                if key in slow_keys:
                    continue
                mu, nu = state["fast"]["mu"][key], state["fast"]["nu"][key]
                for pc, gc, mc, nc in adamw.chunks(p, grads[key].contiguous(),
                                                   mu, nu):
                    new_p, new_mu, new_nu = adamw.adam_math(
                        self.cfg, pc.to(torch.float32),
                        gc.to(torch.float32) * scale, mc, nc, lr, c1, c2)
                    mc.copy_(new_mu)
                    nc.copy_(new_nu)
                    pc.copy_(new_p.to(pc.dtype))

            # --- slow subset: paged streaming update -----------------------
            bytes_moved = 0
            dev_bytes: dict[str, int] = {}
            for key, p in leaves:
                if key not in slow_keys:
                    continue
                leaf = state["slow"][key]
                self._page_leaf(leaf, p, grads[key], scale, lr, c1, c2)
                page_bytes = PAGE_ELEMS * 4 * 6 * leaf.n_pages
                bytes_moved += page_bytes
                dst = self._leaf_dst(leaf)
                dev_bytes[dst] = dev_bytes.get(dst, 0) + page_bytes

            if self.mover is None and bytes_moved:
                # No movement engine: still surface the paging traffic per
                # device — half the bytes stream device-ward, half back.
                fast = self._fast_name()
                for dev, b in dev_bytes.items():
                    self.telemetry.record_move(dev, fast, b // 2, 0.0,
                                               source=self.source)
                    self.telemetry.record_move(fast, dev, b // 2, 0.0,
                                               source=self.source)
            new_state = {"step": step, "fast": state["fast"],
                         "slow": state["slow"]}
            metrics = {"grad_norm": gnorm, "lr": lr,
                       "offload_bytes": bytes_moved}
            return params, new_state, metrics

    def _page_leaf(self, leaf: OffloadedLeaf, p: torch.Tensor,
                   g: torch.Tensor, scale, lr, c1, c2) -> None:
        """Stream every page of ``leaf`` through HBM, a run of
        :data:`WRITEBACK_RUN_PAGES` pages at a time: load the run into one
        of two staging slots (one launch, queued on the calling thread
        just before the previous run's update, after the slot's last
        writeback), update it in the slot, write the new parameter's slice
        from the new master, and write the run back (one launch, on the
        mover's side stream or the optimizer's own)."""
        dev = p.device
        card = dev.type == "cuda"
        stream = torch.cuda.current_stream(dev) if card else None
        lay = _layout(leaf.n_pages, leaf.quantized)
        per_page = [b for _, b in lay]
        cap = WRITEBACK_RUN_PAGES
        run_off = [cap * o for o in np.cumsum([0] + per_page).tolist()]
        slots = torch.empty((2, run_off[-1]), dtype=torch.uint8, device=dev)
        done: list = [None, None]  # the last writeback out of each slot
        billed = sum(per_page[:3])
        g_flat = g.reshape(-1)
        p_flat = p.detach().view(-1)
        block = leaf.block
        P = PAGE_ELEMS
        n_runs = -(-leaf.n_pages // cap)

        def segs_of(r: int, to_block: bool) -> np.ndarray:
            first = r * cap
            k = min(cap, leaf.n_pages - first)
            rows = []
            for a, (off, b) in enumerate(lay):
                ends = (off + first * b, run_off[a])
                src, dst = ends[::-1] if to_block else ends
                rows.append(_seg(0, src, 0, dst, k * b))
            return np.array(rows, np.int64)

        def load(r: int) -> None:
            with span("repro.offload.load"):
                if done[r % 2] is not None:  # the slot's last writeback
                    stream.wait_event(done[r % 2])
                stream_ops.stream_copy_segments([block], [slots[r % 2]],
                                                segs_of(r, False))

        load(0)
        for r in range(n_runs):
            if r + 1 < n_runs:
                load(r + 1)
            slot = slots[r % 2]
            first = r * cap
            n = min(cap, leaf.n_pages - first) * P

            def part(a: int, dtype, count: int) -> torch.Tensor:
                return _view(slot, run_off[a], count * dtype.itemsize, dtype)
            with span("repro.offload.update"):
                master = part(0, torch.float32, n)
                if leaf.quantized:
                    qmu, qnu = part(1, torch.int8, n), part(2, torch.int8, n)
                    smu = part(3, torch.float32, n // QBLOCK)
                    snu = part(4, torch.float32, n // QBLOCK)
                    mu = _dq_moments(qmu, smu)
                    nu = _dq_moments(qnu, snu, sqrt_domain=True)
                else:
                    mu = part(1, torch.float32, n)
                    nu = part(2, torch.float32, n)
                lo, hi = first * P, min(first * P + n, leaf.size)
                gp = g_flat[lo:hi]
                if hi - lo < n:
                    gp = torch.cat([gp, gp.new_zeros(n - (hi - lo))])
                ms2, mu2, nu2 = adamw.adam_math(
                    self.cfg, master, gp.to(torch.float32) * scale, mu, nu,
                    lr, c1, c2)
                if leaf.quantized:
                    for (q, sc), out in ((_q_moments(mu2), (qmu, smu)),
                                         (_q_moments(nu2, sqrt_domain=True),
                                          (qnu, snu))):
                        out[0].copy_(q)
                        out[1].copy_(sc)
                else:
                    mu.copy_(mu2)
                    nu.copy_(nu2)
                master.copy_(ms2)
                p_flat[lo:hi].copy_(ms2[:hi - lo].to(p.dtype))
            with span("repro.offload.writeback"):
                payload = Segments((slot,), (block,), segs_of(r, True),
                                   n // P * billed)
                done[r % 2] = self._write_back(payload, leaf, dev)
        # the next reader of the pages (the next step's loads) and of the
        # staging slots waits for the writebacks
        for ev in done:
            if ev is not None:
                stream.wait_event(ev)

    def _write_back(self, payload: Segments, leaf: OffloadedLeaf, dev):
        """Launch one run's writeback after the work queued so far: a
        descriptor through the mover, else directly on the optimizer's
        side stream.  Returns its completion event (None off the card)."""
        if self.mover is not None:
            desc = Descriptor(self._fast_name(), self._leaf_dst(leaf),
                              [payload], source=self.source)
            return _fenced_run(self.mover, desc, wait=False)
        if dev.type != "cuda":
            payload.run()
            return None
        side = self.__dict__.get("_side")
        if side is None or side.device != dev:
            side = self._side = torch.cuda.Stream(dev)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            side.wait_event(ready)
            payload.run(dev)
            ev = torch.cuda.Event()
            ev.record(side)
        return ev


def _fenced_run(mover: BulkMover, desc: Descriptor, wait: bool = True):
    """Run ``desc`` through ``mover`` in the calling thread after the work
    queued so far on the card; returns its ``done`` event (None off the
    card), which the current stream waits on when ``wait``."""
    card = torch.cuda.is_available() and any(
        t.is_cuda or t.is_pinned() for s in desc.payload
        for t in (*s.srcs, *s.dsts))
    if card:
        desc.ready = torch.cuda.Event()
        desc.ready.record()
    mover.run([desc])
    done = desc.done
    if wait and done is not None:
        torch.cuda.current_stream().wait_event(done)
    return done
