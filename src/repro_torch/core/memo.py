"""MEMO — the paper's microbenchmark, on the card.

Two modes:

* **measure** — real timings: sequential load/store/copy bandwidth vs
  lane count, random block access vs block size, and dependent
  pointer-chase latency.  On the card the probes are the hand-written
  ``memo_probe`` kernels (``csrc/memo_probe.cu``) over HBM or over
  page-locked host memory, which they read and write in place through
  unified virtual addressing (``memory="hbm"`` / ``"pinned"``), and the
  copy is the port's ``stream_copy``; on the CPU their plain versions.
  :func:`fit_tier` reads a lane sweep back into a :class:`TierSpec`
  through the perfmodel's own formulas: how ``h100_topology`` is
  calibrated.
* **simulate** — per-tier tables from the calibrated perfmodel
  (``repro_torch.core.perfmodel``), reproducing the paper's Figs. 2/3/4/5
  for the paper testbed and predicting any other topology.

Lanes stand in for the paper's threads: MEMO shards the access across
``lanes`` independent slices, one block of threads each on the card.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import statistics
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import perfmodel
from repro_torch.core.tiers import (H100_HBM, H100_HOST_PINNED, OpClass,
                                    TierSpec, TierTopology)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.memo_probe import ops as probe
from repro_torch.kernels.stream_copy import ops as sc_ops

#: the card's memories a probe may read, and the tier each one is
MEMORIES = {"hbm": H100_HBM, "pinned": H100_HOST_PINNED}
#: the least a scaled launch reads: past the card's 50 MB L2
MIN_WINDOW_BYTES = 64 << 20
#: the share of a sweep's peak that counts as reaching it (fit_tier)
PEAK_SHARE = 0.95
#: ``*_collapse_streams`` of a tier whose sweep never falls
NO_COLLAPSE = 1 << 20
#: lane counts of the calibration sweep: 1 to 4 blocks an SM of 132 SMs
CALIBRATION_LANES = (1, 2, 4, 8, 16, 32, 64, 132, 264, 528)
#: block sizes of the calibration's random-block runs (the reference's)
CALIBRATION_BLOCKS = (1024, 4096, 16384, 65536)
#: a calibration's timed pass: long against a launch, short in sum (the
#: two tiers' calibration takes ~20 s)
PASS_SECONDS = 0.025
#: timed calls of a measurement (the fastest counts, as the reference's)
REPS = 3
#: sets of random starts a timed call rotates through, so that no call
#: of a timing finds its blocks or hops in the L2 an earlier call filled
FRESH_SETS = 8


@dataclasses.dataclass
class Record:
    name: str
    tier: str
    op: str
    lanes: int
    block_bytes: int
    seconds: float
    bytes_moved: int

    @property
    def gbps(self) -> float:
        return self.bytes_moved / self.seconds / 1e9 if self.seconds else 0.0

    def row(self) -> dict:
        return {
            "name": self.name, "tier": self.tier, "op": self.op,
            "lanes": self.lanes, "block_bytes": self.block_bytes,
            "seconds": self.seconds, "GBps": round(self.gbps, 3),
        }


def _time(fn: Callable[[], object], device: torch.device, reps: int = REPS,
          warmup: int = 1) -> float:
    """Seconds of one ``fn()``, the least of ``reps``.  On the card two
    CUDA events bracket each call with the card queued ahead (a sleep
    covers the host's enqueue), so they time the kernels alone; on the
    CPU the host's clock."""
    for _ in range(warmup):
        fn()
    best = float("inf")
    if device.type != "cuda":
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    stream = torch.cuda.current_stream(device)
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # twice the host's enqueue time at <= 2 GHz (H100 boost 1.98)
        torch.cuda._sleep(int(2 * enqueue_s * 2e9))
        start.record(stream)
        fn()
        end.record(stream)
        end.synchronize()
        best = min(best, start.elapsed_time(end) * 1e-3)
    return best


def _resolve(device: DeviceLike, memory: Optional[str]) -> torch.device:
    device = resolve_device(device)
    if memory is not None:
        if memory not in MEMORIES:
            raise ValueError(f"memory is one of {sorted(MEMORIES)}; got "
                             f"{memory!r}")
        if device.type != "cuda":
            raise ValueError(f"memory={memory!r} names the card's memory; "
                             "the CPU measures the host's (memory=None)")
    return device


def _tier(memory: Optional[str]) -> str:
    """A record's tier: ``local`` for the default call, as in the
    reference; else the tier's name."""
    return "local" if memory is None else MEMORIES[memory].name


def _place(t: torch.Tensor, memory: Optional[str],
           device: torch.device) -> torch.Tensor:
    """Host tensor ``t`` in the probed memory: pinned host memory for
    ``pinned``, else the card's HBM (the host on the CPU)."""
    if device.type != "cuda":
        return t
    return t.pin_memory() if memory == "pinned" else t.to(device)


def _windows(launch: Callable[[int, int], object], n: int, quantum: int,
             device: torch.device, pass_seconds: float) -> tuple[float, int]:
    """(seconds, elements) of one ``launch(offset, count)`` over a window
    of an ``n``-element buffer, the window scaled from a first launch's
    rate so a timed pass of launches over rotating windows takes about
    ``pass_seconds``; windows are multiples of ``quantum`` elements, at
    offsets on 16-byte boundaries, and at least ``MIN_WINDOW_BYTES``."""
    least = MIN_WINDOW_BYTES // 4
    count = min(n, least) // quantum * quantum
    if count < quantum:
        raise ValueError(f"a buffer of {n} elements is below one window "
                         f"of {quantum}")
    first = _time(lambda: launch(0, count), device, reps=1)
    rate = count / first
    count = int(min(n, max(least, rate * pass_seconds))) // quantum * quantum
    iters = max(1, round(rate * pass_seconds / count))
    offsets = [(i * count) % (n - count + 1) // 4 * 4 for i in range(iters)]

    def one_pass():
        for off in offsets:
            launch(off, count)
    return _time(one_pass, device) / iters, count


# --------------------------------------------------------------------------
# Real measurements
# --------------------------------------------------------------------------
def measure_sequential(
    nbytes: int = 1 << 26, lanes_list: Sequence[int] = (1, 2, 4, 8), *,
    device: DeviceLike = None, memory: Optional[str] = None,
    pass_seconds: Optional[float] = None,
) -> list[Record]:
    """Load and store bandwidth per lane count, then one copy (HBM into
    the probed memory, the port's ``stream_copy``), as the reference's
    records.  ``memory`` picks HBM or pinned host memory on the card
    (default: HBM, recorded as ``local``).

    With ``pass_seconds`` (calibration) the ``nbytes`` buffer is made once
    and each launch reads a window of it scaled per lane count (see
    :func:`_windows`); a record's ``bytes_moved`` is one launch's bytes
    and ``seconds`` its time."""
    device = _resolve(device, memory)
    tier = _tier(memory)
    n = nbytes // 4
    out = []
    if pass_seconds is None:
        for lanes in lanes_list:
            nn = n - n % lanes
            x = _place(torch.arange(nn, dtype=torch.float32), memory, device)
            s = _time(lambda: probe.seq_load(x, lanes), device)
            out.append(Record("seq", tier, "load", lanes, nbytes, s, nn * 4))
            v = _place(torch.arange(lanes, dtype=torch.float32), None, device)
            s = _time(lambda: probe.seq_store(x, lanes, v), device)
            out.append(Record("seq", tier, "store", lanes, nbytes, s, nn * 4))
            del x
        src = _place(torch.arange(n, dtype=torch.float32), None, device)
        dst = _place(torch.zeros(n, dtype=torch.float32), memory, device)
        s = _time(lambda: sc_ops.stream_copy(src, out=dst), device)
        out.append(Record("seq", tier, "copy", 1, nbytes, s, 2 * n * 4))
        return out
    x = _place(torch.arange(n, dtype=torch.float32), memory, device)
    for lanes in lanes_list:
        v = _place(torch.arange(lanes, dtype=torch.float32), None, device)
        s, count = _windows(
            lambda off, c: probe.seq_load(x[off:off + c], lanes), n,
            4 * lanes, device, pass_seconds)
        out.append(Record("seq", tier, "load", lanes, nbytes, s, count * 4))
        s, count = _windows(
            lambda off, c: probe.seq_store(x[off:off + c], lanes, v), n,
            4 * lanes, device, pass_seconds)
        out.append(Record("seq", tier, "store", lanes, nbytes, s, count * 4))
    src = _place(torch.zeros(n, dtype=torch.float32), None, device)
    s, count = _windows(
        lambda off, c: sc_ops.stream_copy(src[off:off + c],
                                          out=x[off:off + c]), n, 4, device,
        pass_seconds)
    out.append(Record("seq", tier, "copy", 1, nbytes, s, 2 * count * 4))
    return out


def measure_random_block(
    table_bytes: int = 1 << 26,
    block_bytes_list: Sequence[int] = (1024, 4096, 16384, 65536),
    n_blocks: int = 512,
    seed: int = 0, *,
    device: DeviceLike = None, memory: Optional[str] = None,
    pass_seconds: Optional[float] = None,
) -> list[Record]:
    """Random block loads per block size, one lane of ``n_blocks`` blocks
    as in the reference, each timed call on fresh starts.  With
    ``pass_seconds`` the block count grows from a first run's rate so a
    timed run takes about that long."""
    device = _resolve(device, memory)
    tier = _tier(memory)
    out = []
    n = table_bytes // 4
    x = _place(torch.arange(n, dtype=torch.float32), memory, device)
    rng = np.random.default_rng(seed)

    def loads(be: int, k: int) -> Callable[[], object]:
        """A call over ``k`` blocks, each call on the next of
        ``FRESH_SETS`` sets of starts."""
        sets = [_place(torch.from_numpy(rng.integers(
            0, n - be, size=k, dtype=np.int64).astype(np.int32)),
            None, device) for _ in range(FRESH_SETS)]
        fresh = itertools.cycle(sets)
        return lambda: probe.random_block_load(x, next(fresh), be)

    for bb in block_bytes_list:
        be = bb // 4
        k = n_blocks
        if pass_seconds is not None:
            first = _time(loads(be, k), device, reps=1)
            k = max(n_blocks, round(n_blocks * pass_seconds / first))
        s = _time(loads(be, k), device)
        out.append(Record("rand", tier, "load", 1, bb, s, k * bb))
    return out


def single_cycle(n: int, seed: int = 0) -> np.ndarray:
    """An int32 permutation of ``range(n)`` that is one cycle of length
    ``n`` (what Sattolo's algorithm draws, built vectorised: a random
    visiting order, each element pointing at the next), so a chase from
    0 visits every element before it returns."""
    order = np.random.default_rng(seed).permutation(n)
    perm = np.empty(n, np.int32)
    perm[order] = np.roll(order, -1)
    return perm


def measure_pointer_chase(
    n_elems: int = 1 << 22, steps: int = 1 << 16, seed: int = 0, *,
    device: DeviceLike = None, memory: Optional[str] = None,
    cycle: bool = False, pass_seconds: Optional[float] = None,
) -> Record:
    """Dependent loads through a permutation table of ``n_elems`` int32:
    the reference's ``rng.permutation`` chased from 0, or with ``cycle``
    one cycle through every element (:func:`single_cycle`), each call
    from the next of ``FRESH_SETS`` random starts, so that a call's hops
    are an arc of the cycle no earlier call walked.  With
    ``pass_seconds`` the step count grows from a first run's rate so a
    timed run takes about that long."""
    device = _resolve(device, memory)
    tier = _tier(memory)
    rng = np.random.default_rng(seed)
    if cycle:
        table = single_cycle(n_elems, seed)
        fresh = itertools.cycle(rng.integers(0, n_elems, FRESH_SETS).tolist())
    else:
        table = rng.permutation(n_elems).astype(np.int32)
        fresh = itertools.repeat(0)
    perm = _place(torch.from_numpy(table), memory, device)

    def chase(k: int) -> Callable[[], object]:
        return lambda: probe.pointer_chase(perm, k, next(fresh))

    if pass_seconds is not None:
        first = _time(chase(steps), device, reps=1)
        steps = max(steps, round(steps * pass_seconds / first))
    s = _time(chase(steps), device)
    return Record("ptr-chase", tier, "load", 1, 4, s, steps * 4)


# --------------------------------------------------------------------------
# Calibration: a tier's fields from its measured sweeps
# --------------------------------------------------------------------------
def _rates(records: Sequence[Record], name: str,
           op: str) -> dict[int, list[float]]:
    """Bytes/s by lane count of the ``name``/``op`` records, one rate a
    record (records of one key from several runs give several)."""
    rates: dict[int, list[float]] = {}
    for r in records:
        if r.name == name and r.op == op and r.seconds > 0:
            rates.setdefault(r.lanes, []).append(r.bytes_moved / r.seconds)
    return rates


def fit_sweep(rates: dict[int, list[float]]
              ) -> tuple[float, int, int, float]:
    """(peak, peak streams, collapse streams, collapse factor) of one lane
    sweep, given each lane count's rates (one a run).  The curve is each
    count's median rate and the peak its maximum.  A count falls short of
    the peak where every run reads it below ``PEAK_SHARE`` of that peak:
    with one run the plain rule, with several a spread from run to run
    wider than the share cannot place a threshold.  The peak streams are
    the smallest count not short; where counts above them fall short, the
    collapse starts after the last count not short below the first of
    those, and the factor is the curve at the largest count over the
    peak; where none does, no collapse (``NO_COLLAPSE``, 1.0) was
    measured."""
    grid = sorted(rates)
    curve = {n: statistics.median(rates[n]) for n in grid}
    peak = max(curve.values())
    high = [n for n in grid if max(rates[n]) >= PEAK_SHARE * peak]
    peak_n = high[0]
    low = [n for n in grid if n > peak_n and n not in high]
    if not low:
        return peak, peak_n, NO_COLLAPSE, 1.0
    collapse_n = max(n for n in high if n < low[0])
    return peak, peak_n, collapse_n, curve[grid[-1]] / peak


def fit_tier(records: Sequence[Record], base: TierSpec, *,
             capacity_bytes: Optional[int] = None) -> TierSpec:
    """``base`` with the fields a MEMO sweep measures, read through the
    formulas that consume them (``perfmodel.stream_bandwidth`` and
    ``random_block_bandwidth``):

    * ``load_bw``/``store_bw`` and their peak and collapse streams from
      the sequential load and store sweeps (:func:`fit_sweep`);
      ``collapse_factor`` is the lower of the two ops' factors where both
      collapse (one factor serves both in the model);
    * ``nt_store_bw``: the write rate of the copy into the tier (half its
      bytes over its time);
    * ``load_latency_ns`` inverted from ``random_block_bandwidth`` at
      1 KiB blocks and one lane, ``lat = block / per_stream * (seq /
      rand - 1)`` with ``per_stream`` the one-lane sequential load rate;
    * ``chase_latency_ns``: the chase's time per hop;
    * ``capacity_bytes`` when given.

    ``records`` may hold several runs of one calibration: each field
    reads the median of a measurement's runs, and the stream counts the
    spread of them too (:func:`fit_sweep`).  Fields without records keep
    ``base``'s values."""
    fields: dict = {}
    loads = _rates(records, "seq", "load")
    factors = []
    for op, rates in (("load", loads), ("store", _rates(records, "seq",
                                                        "store"))):
        if not rates:
            continue
        peak, peak_n, collapse_n, factor = fit_sweep(rates)
        fields.update({f"{op}_bw": peak, f"{op}_peak_streams": peak_n,
                       f"{op}_collapse_streams": collapse_n})
        if collapse_n != NO_COLLAPSE:
            factors.append(factor)
    if loads:
        fields["collapse_factor"] = min(factors, default=1.0)
    copies = _rates(records, "seq", "copy")
    if copies:
        fields["nt_store_bw"] = statistics.median(copies[1]) / 2
    rand = [r for r in records if r.name == "rand" and r.op == "load"
            and r.block_bytes == 1024 and r.lanes == 1 and r.seconds > 0]
    if rand:
        if 1 not in loads:
            raise ValueError("the latency fit needs a one-lane load record")
        seq = statistics.median(loads[1])
        rand_bw = statistics.median(r.bytes_moved / r.seconds for r in rand)
        lat_s = 1024 / seq * (seq / rand_bw - 1)
        if lat_s <= 0:
            raise ValueError(f"random 1 KiB blocks read at {rand_bw:.4g} B/s,"
                             f" not below one lane's {seq:.4g}: no latency")
        fields["load_latency_ns"] = lat_s * 1e9
    chase = [r for r in records if r.name == "ptr-chase" and r.seconds > 0]
    if chase:
        fields["chase_latency_ns"] = statistics.median(
            r.seconds / (r.bytes_moved // 4) for r in chase) * 1e9
    if capacity_bytes is not None:
        fields["capacity_bytes"] = int(capacity_bytes)
    return dataclasses.replace(base, **fields)


def capacity_bytes(memory: str, device: DeviceLike = None) -> int:
    """The probed memory's size: the card's total memory for ``hbm``, the
    host's physical memory for ``pinned``."""
    if memory == "hbm":
        return torch.cuda.get_device_properties(
            resolve_device(device)).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def calibrate(memory: str, *, device: DeviceLike = None
              ) -> tuple[list[Record], TierSpec]:
    """Measure one of the card's memories and fit its tier: the load and
    store sweep over ``CALIBRATION_LANES`` and the copy on a 1 GiB
    buffer, random blocks and a single-cycle chase over 256 MiB tables
    (all past the 50 MB L2), each timed pass about ``PASS_SECONDS``.
    Returns the records and the fitted :class:`TierSpec` (``base``: the
    tier's preset)."""
    device = _resolve(device, memory)
    records = measure_sequential(1 << 30, CALIBRATION_LANES, device=device,
                                 memory=memory, pass_seconds=PASS_SECONDS)
    records += measure_random_block(1 << 28, CALIBRATION_BLOCKS, 512,
                                    device=device, memory=memory,
                                    pass_seconds=PASS_SECONDS)
    records.append(measure_pointer_chase(
        1 << 26, 1 << 10, device=device, memory=memory, cycle=True,
        pass_seconds=PASS_SECONDS))
    spec = fit_tier(records, MEMORIES[memory],
                    capacity_bytes=capacity_bytes(memory, device))
    return records, spec


# --------------------------------------------------------------------------
# Simulated per-tier tables (calibrated perfmodel)
# --------------------------------------------------------------------------
def simulate_latency(topology: TierTopology) -> list[dict]:
    """Fig. 2 analogue: per-tier latency by instruction class."""
    rows = []
    for t in topology.tiers:
        rows.append({
            "tier": t.name,
            "ld_ns": t.load_latency_ns,
            "st_wb_ns": t.load_latency_ns * t.rfo_traffic_multiplier,
            "nt_st_ns": t.load_latency_ns * 0.75,
            "ptr_chase_ns": t.chase_latency_ns,
        })
    return rows


def simulate_seq_bw(
    topology: TierTopology, lanes: Sequence[int] = (1, 2, 4, 8, 12, 16, 24, 32)
) -> list[dict]:
    """Fig. 3 analogue: sequential bandwidth vs stream count per tier/op."""
    rows = []
    for t in topology.tiers:
        for op in (OpClass.LOAD, OpClass.STORE, OpClass.NT_STORE):
            for L in lanes:
                rows.append({
                    "tier": t.name, "op": op.value, "lanes": L,
                    "GBps": perfmodel.stream_bandwidth(t, op, L) / 1e9,
                })
    return rows


def simulate_random_bw(
    topology: TierTopology,
    blocks: Sequence[int] = (1024, 4096, 16384, 65536, 262144),
    lanes: Sequence[int] = (1, 2, 4, 8, 16),
) -> list[dict]:
    """Fig. 5 analogue."""
    rows = []
    for t in topology.tiers:
        for op in (OpClass.LOAD, OpClass.STORE, OpClass.NT_STORE):
            for bb in blocks:
                for L in lanes:
                    rows.append({
                        "tier": t.name, "op": op.value, "block": bb, "lanes": L,
                        "GBps": perfmodel.random_block_bandwidth(t, op, bb, L) / 1e9,
                    })
    return rows


def simulate_movement(
    topology: TierTopology,
    nbytes: int = 1 << 28,
    page_bytes: int = 4 << 10,
    batches: Sequence[int] = (1, 16, 128),
    engine_streams: int = 4,
) -> list[dict]:
    """Fig. 4b analogue: engine-offloaded bulk movement D2C/C2D/C2C/D2D.

    Tiered-memory systems move data at page granularity (4 KiB/2 MiB —
    paper §6); at 4 KiB the per-descriptor offload latency dominates and
    batching/asynchrony show exactly the Fig. 4b ordering.
    """
    fast, slow = topology.fast, topology.slow or topology.fast
    routes = {
        "D2D": (fast, fast), "D2C": (fast, slow),
        "C2D": (slow, fast), "C2C": (slow, slow),
    }
    n_desc = nbytes // page_bytes
    rows = []
    for route, (src, dst) in routes.items():
        for sync in (True, False):
            for b in batches:
                c = perfmodel.bulk_move_cost(
                    src, dst, nbytes, n_descriptors=n_desc, batch_size=b,
                    asynchronous=not sync, n_streams=engine_streams,
                )
                rows.append({
                    "route": route, "mode": "sync" if sync else "async",
                    "batch": b, "GBps": nbytes / c.seconds / 1e9,
                })
    return rows
