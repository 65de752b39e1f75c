#!/usr/bin/env python3
"""Measurements behind the design of the ``embedding_reduce`` kernel.

    python3 tools/embedding_reduce_probe.py --sweep
    python3 tools/embedding_reduce_probe.py --e2e DIR [DIR ...]
    python3 tools/embedding_reduce_probe.py --pinned-order

Needs a CUDA card and ``nvcc``; prints the card's name and power limit
first.  Not part of the port.

``--sweep`` builds variants of ``src/repro_torch/csrc/embedding_reduce.cu``
through its build-time defines (``ER_THREADS`` threads a block, ``ER_S``
ring stages of ``ER_U`` lookups; into ``build/probe_er/``, one ``nvcc``
each, in parallel) and times each, at the DLRM slice's shape (2048 bags of
80 lookups, 64-wide fp32 rows), with the card queued ahead:

* the table form over a 2^25-row table in HBM (int32 indices, fp32
  weights), against ``embedding_bag`` in the same run;
* the routed form at 0 slow over that table as one shard (int64 rows, no
  weights), with the slice's page maps and with a one-page map, whose
  entries stay cached: the difference is what the map gather costs;
* the routed form at 0.10 slow: an HBM shard and a pinned host shard,
  a random tenth of the 64-row pages in the pinned one, int64 rows and no
  weights, against the per-shard path (one table-form launch per shard).

Every variant's results must equal the default build's bit for bit.

``--e2e DIR`` runs, for the ``repro_torch`` package under ``DIR/src``
(this checkout or another one, for instance a parent commit unpacked
into ``build/``), the DLRM slice's end-to-end numbers at 0 and 0.10 slow
through ``InterleavedTensor.bag_reduce``: bags/s over an epoch, the
device's busy share in a profiled epoch, host microseconds per call
(uninstrumented and under cProfile) and device kernels per call.  Each
DIR runs in a process of its own, in the order given.

``--pinned-order`` reads the uniform DLRM cell's pinned rows (8,192 bags of
80 lookups, 90% of them pinned: 589,824 random 256-byte rows) out of a
pinned table whose span is cut to 1, 4, 8 and 28.8 GiB (the cell's
pinned shard), and prints the pinned GB/s of each reading:

* ``gather``: a plain gather kernel (``GATHER_SRC``, built into
  ``build/probe_er/``) copying the rows into HBM, over the same rows in
  random order, ordered by 64 KiB and by 2 MiB region (random within
  one), in full address order, and a sequential range of as many rows;
  at several depths (loads a thread, blocks a SM);
* ``today``: the routed kernel over an HBM shard of a ninth of the
  span's rows and the pinned span, uniform indices, with the indices as
  drawn and sorted (so a bag reads a run of ordered rows);
* ``staged``: the routed form's staged path on the same call, its pinned
  rows ordered by regions of 2^16 and 2^21 bytes and unordered (one
  region), bit-equal to today's kernel; then where a staged call's
  device time goes, kernel by kernel;
* ``lookups``: today's kernel against the staged path as the batch
  shrinks (K = 80, B from 8,192 down to 16; a new batch each call), over
  the 8 and 28.8 GiB spans: what sets ``STAGE_MIN_LOOKUPS``.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "probe_er"
#: (ER_THREADS, ER_S, ER_U); the first is the source's default
VARIANTS = ((128, 4, 4), (128, 2, 4), (128, 3, 4), (128, 6, 4), (128, 8, 4),
            (128, 4, 2), (128, 4, 8), (128, 8, 2), (64, 4, 4), (64, 8, 4),
            (256, 4, 4), (256, 3, 2))
ROWS_LOG2 = 25

#: --pinned-order: the uniform cell's batch and its pinned rows
ORDER_BAGS, ORDER_LOOKUPS, ORDER_DIM = 8192, 80, 64
ORDER_PINNED = ORDER_BAGS * ORDER_LOOKUPS * 9 // 10
#: pinned spans (rows of 256 bytes): 1, 4, 8 GiB and the cell's shard
ORDER_SPANS = (("1", 1 << 22), ("4", 1 << 24), ("8", 1 << 25),
               ("28.8", (1 << 27) * 9 // 10))
#: (loads in flight a thread, blocks of 256 threads a SM; 0: one pass)
GATHER_DEPTHS = ((1, 0), (4, 0), (4, 1), (4, 4), (8, 8))
#: the staged path's orders: regions of 2^k bytes (62: one region)
STAGED_REGIONS = (62, 16, 21)
#: bags of 80 lookups in the threshold sweep, and its batches a size
SWEEP_BAGS = (8192, 2048, 1024, 512, 256, 128, 64, 16)
SWEEP_POOL = 24
GATHER_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int U, bool CA>
__global__ void gather(const char* __restrict__ src, const int64_t* __restrict__ rows,
                       uint4* __restrict__ dst, int64_t n_vec, int64_t row_bytes) {
  const int64_t rv = row_bytes / 16;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x * U + threadIdx.x; base < n_vec;
       base += (int64_t)gridDim.x * blockDim.x * U) {
    uint4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = base + (int64_t)u * blockDim.x;
      if (i < n_vec) {
        const int64_t s = i / rv;
        const uint4* p = reinterpret_cast<const uint4*>(src + rows[s] * row_bytes) + (i - s * rv);
        v[u] = CA ? __ldca(p) : __ldcg(p);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = base + (int64_t)u * blockDim.x;
      if (i < n_vec) dst[i] = v[u];
    }
  }
}
template <int U, bool CA>
int run(const void* src, const int64_t* rows, void* dst, int64_t n_vec, int64_t row_bytes,
        int blocks, cudaStream_t s) {
  const int64_t full = (n_vec + 256 * U - 1) / (256 * U);
  const int64_t grid = blocks > 0 && blocks < full ? blocks : full;
  gather<U, CA><<<(unsigned)grid, 256, 0, s>>>(static_cast<const char*>(src), rows,
                                                static_cast<uint4*>(dst), n_vec, row_bytes);
  return (int)cudaGetLastError();
}
extern "C" int probe_gather(const void* src, const int64_t* rows, void* dst, int64_t n_rows,
                            int64_t row_bytes, int u, int ca, int blocks, void* stream) {
  const int64_t n_vec = n_rows * row_bytes / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PG(U) return ca ? run<U, true>(src, rows, dst, n_vec, row_bytes, blocks, s) \
                        : run<U, false>(src, rows, dst, n_vec, row_bytes, blocks, s)
  if (u == 1) PG(1);
  if (u == 4) PG(4);
  if (u == 8) PG(8);
#undef PG
  return (int)cudaErrorInvalidValue;
}
"""


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def build(common) -> dict:
    """One shared library per variant, built in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for t, s, u in VARIANTS:
        name = f"t{t}_s{s}_u{u}"
        procs[name] = subprocess.Popen(
            [common.nvcc_path(), *common.NVCC_FLAGS, f"-DER_THREADS={t}",
             f"-DER_S={s}", f"-DER_U={u}", "-o", str(OUT / f"lib{name}.so"),
             str(common.CSRC / "embedding_reduce.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log[-4000:]}")
        spills, fn, regs = [], "", []
        for ln in log.splitlines():
            if "Function properties for" in ln:
                fn = ln.split("for")[-1].strip()
            elif "registers" in ln:
                regs.append(int(ln.split("Used")[1].split()[0]))
            elif "spill" in ln and not ln.strip().startswith(
                    "0 bytes stack frame, 0 bytes spill stores"):
                spills.append(f"{fn}: {' '.join(ln.split())}")
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        print(f"build/{name},functions={len(regs)},max_registers="
              f"{max(regs, default=0)},spilling_functions={len(spills)}",
              flush=True)
        for line in spills:
            print(f"build/{name}/spill,{line}", flush=True)
    return libs


def use(lib) -> None:
    """Route the port's wrappers to ``lib``'s entry points."""
    from repro_torch.kernels.embedding_reduce import kernel
    for name, args in (("repro_embedding_reduce", kernel._TABLE_ARGS),
                       ("repro_bag_reduce_routed", kernel._ROUTED_ARGS)):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
        kernel._fns[name] = fn


def sweep() -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import common
    from repro_torch.kernels.embedding_reduce import ops, ref
    libs = build(common)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    B, K, D, pr = cs.BAG, cs.LOOKUPS, cs.DIM, cs.PAGE_ROWS
    rows = 1 << ROWS_LOG2
    table = torch.randint(-8, 9, (rows, D), dtype=torch.float32,
                          generator=gen, device=dev)
    idx = torch.randint(0, rows, (B, K), generator=gen, device=dev)
    idx32 = idx.to(torch.int32)
    w = torch.ones((B, K), device=dev)
    # 0.10 slow: a random tenth of the pages in a pinned shard
    n_pages = rows // pr
    slow = torch.rand(n_pages, generator=gen, device=dev) < 0.10
    pd = slow.to(torch.int8)
    pl = torch.empty(n_pages, dtype=torch.int64, device=dev)
    n_slow = int(slow.sum())
    pl[slow] = torch.arange(n_slow, device=dev)
    pl[~slow] = torch.arange(n_pages - n_slow, device=dev)
    fast_rows = table.view(n_pages, pr, D)[~slow].reshape(-1, D).contiguous()
    slow_rows = table.view(n_pages, pr, D)[slow].reshape(-1, D).cpu()
    parts = (fast_rows, slow_rows.pin_memory())
    del slow_rows
    dev_of, _ = ref.route(idx, pd, pl, pr)
    slow_lookups = int((dev_of == 1).sum())
    print(f"shape,bags={B},lookups={K},dim={D},rows={rows},"
          f"slow_pages={n_slow},slow_lookups={slow_lookups}", flush=True)
    # 0 slow: the table as one shard, with the slice's page maps and with
    # one page (its maps always cached): what the map gather costs
    maps0 = (torch.zeros(n_pages, dtype=torch.int8, device=dev),
             torch.arange(n_pages, device=dev), pr)
    maps1 = (torch.zeros(1, dtype=torch.int8, device=dev),
             torch.zeros(1, dtype=torch.int64, device=dev), rows)
    lib_ms = cs.time_ms(lambda: torch.nn.functional.embedding_bag(
        idx32, table, mode="sum", per_sample_weights=w), queue_ahead=True)
    first = {}
    for name, lib in libs.items():
        use(lib)
        table_out = ops.embedding_reduce(table, idx32, w)
        routed_out = ops.bag_reduce_routed(parts, pd, pl, pr, idx)
        per_shard = ref.reduce_shards(parts, *ref.route(idx, pd, pl, pr),
                                      torch.ones((B, K), device=dev),
                                      ops.embedding_reduce)
        torch.cuda.synchronize()
        first.setdefault("table", table_out)
        first.setdefault("routed", routed_out)
        assert torch.equal(table_out, first["table"]), name
        assert torch.equal(routed_out, first["routed"]), name
        assert torch.equal(routed_out, per_shard), name
        for maps in (maps0, maps1):
            assert torch.equal(ops.bag_reduce_routed((table,), *maps, idx),
                               table_out), name
        f0_ms = [cs.time_ms(lambda m=m: ops.bag_reduce_routed((table,), *m,
                                                              idx),
                            iters=50, queue_ahead=True)
                 for m in (maps0, maps1)]
        t_ms = cs.time_ms(lambda: ops.embedding_reduce(table, idx32, w),
                          iters=50, queue_ahead=True)
        r_ms = cs.time_ms(lambda: ops.bag_reduce_routed(parts, pd, pl, pr,
                                                        idx),
                          iters=20, queue_ahead=True)
        s_ms = cs.time_ms(lambda: ref.reduce_shards(
            parts, *ref.route(idx, pd, pl, pr),
            torch.ones((B, K), device=dev), ops.embedding_reduce),
            iters=20, queue_ahead=True)
        print(f"sweep/{name},table_ms={t_ms:.4f},embedding_bag_ms="
              f"{lib_ms:.4f},routed_f0_ms={f0_ms[0]:.4f},"
              f"routed_f0_one_page_ms={f0_ms[1]:.4f},"
              f"routed_f010_ms={r_ms:.4f},"
              f"per_shard_f010_ms={s_ms:.4f},equal_to_default=1", flush=True)


def gather_lib(common):
    """The probe's plain gather kernel, built from ``GATHER_SRC``."""
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / "gather.cu", OUT / "libgather.so"
    src.write_text(GATHER_SRC)
    subprocess.run([common.nvcc_path(), *common.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    out = ctypes.CDLL(str(lib))
    out.probe_gather.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    out.probe_gather.restype = ctypes.c_int
    return out


def ordered(rows, shift: int):
    """``rows`` ordered by ``rows >> shift`` (random order within a
    bucket: the sort is stable over rows drawn at random)."""
    import torch
    return rows[torch.sort(rows >> shift, stable=True).indices]


def staged_kernels_ms(call) -> str:
    """Device ms of one ``call()`` by kernel, from the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    def name(key: str) -> str:
        found = re.search(r"(\w+_kernel)", key)
        return found.group(1) if found else re.sub(r"\W+", "_", key)[:32]

    return ",".join(
        f"{name(e.key)}={e.self_device_time_total / 1e3 / e.count:.4f}"
        for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def host_us(call, n: int = 20) -> float:
    """Host microseconds of a call while the card sleeps: the enqueue
    alone, never a wait for the card."""
    import time
    import torch
    call()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(0.2 * 2e9))  # ~0.1-0.2 s at <= 2 GHz
    t0 = time.perf_counter()
    for _ in range(n):
        call()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def profiled_top(call, n: int = 20, top: int = 8) -> str:
    """The functions of most own host time a call, under cProfile."""
    import cProfile
    import pstats
    import torch
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(n):
        call()
    pr.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(pr).stats
    best = sorted(((func, tt / n * 1e6) for (_, _, func), (_, _, tt, _, _)
                   in stats.items()), key=lambda x: -x[1])[:top]
    return ";".join(f"{f}={us:.1f}" for f, us in best)


def pinned_order() -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import common
    from repro_torch.kernels.embedding_reduce import kernel, ops
    lib = gather_lib(common)
    defaults = (kernel.STAGE_MIN_LOOKUPS, kernel.REGION_LOG2)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    D, row_bytes = ORDER_DIM, ORDER_DIM * 4
    top = ORDER_SPANS[-1][1]
    pinned = torch.empty((top, D), dtype=torch.float32, pin_memory=True)
    chunk = torch.randn((1 << 22, D), generator=gen, device=dev)
    for r0 in range(0, top, chunk.shape[0]):
        n = min(chunk.shape[0], top - r0)
        chunk.add_(1.0)
        pinned[r0:r0 + n].copy_(chunk[:n])
    del chunk
    torch.cuda.synchronize()
    N = ORDER_PINNED
    dst = torch.empty((N, D), dtype=torch.float32, device=dev)
    stream = common.stream_handle(dev)

    def gather(rows, u, blocks, ca=1):
        err = lib.probe_gather(pinned.data_ptr(), rows.data_ptr(),
                               dst.data_ptr(), N, row_bytes, u, ca, blocks,
                               stream)
        common.check(err, "probe_gather")

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for span, span_rows in ORDER_SPANS:
        rows = torch.randint(0, span_rows, (N,), generator=gen, device=dev)
        start = int(torch.randint(0, span_rows - N, (1,), generator=gen,
                                  device=dev))
        orders = {"random": rows, "64KiB": ordered(rows, 8),
                  "2MiB": ordered(rows, 13), "address": ordered(rows, 0),
                  "sequential": torch.arange(start, start + N, device=dev)}
        if span == ORDER_SPANS[0][0]:
            gather(orders["random"], 4, 0)
            torch.cuda.synchronize()
            want = pinned.index_select(0, orders["random"].cpu())
            assert torch.equal(dst.cpu(), want), "probe gather is wrong"
        for order, r in orders.items():
            for u, bps in GATHER_DEPTHS:
                ms = cs.time_ms(lambda: gather(r, u, bps * sms), iters=10,
                                warmup=2, queue_ahead=True)
                print(f"order/{span}GiB,gather,{order},u={u},blocks_per_sm="
                      f"{bps or 'all'},ms={ms:.4f},pinned_GBps="
                      f"{N * row_bytes / ms / 1e6:.2f}", flush=True)
        # today's routed kernel: an HBM ninth beside the pinned span
        n_hp, n_pp = span_rows // 9 // 64, span_rows // 64
        hbm = torch.randn((n_hp * 64, D), generator=gen, device=dev)
        perm = torch.randperm(n_hp + n_pp, generator=gen, device=dev)
        pd = torch.ones(n_hp + n_pp, dtype=torch.int8, device=dev)
        pd[perm[:n_hp]] = 0
        pl = torch.empty(n_hp + n_pp, dtype=torch.int64, device=dev)
        pl[perm[:n_hp]] = torch.arange(n_hp, device=dev)
        pl[perm[n_hp:]] = torch.arange(n_pp, device=dev)
        parts = (hbm, pinned[:n_pp * 64])
        idx = torch.randint(0, (n_hp + n_pp) * 64,
                            (ORDER_BAGS, ORDER_LOOKUPS), generator=gen,
                            device=dev)
        n_pin = int((pd[idx // 64] == 1).sum())

        def routed(ix, region=None):
            """Today's kernel (``region`` None) or the staged path."""
            kernel.STAGE_MIN_LOOKUPS = kernel.MAX_ROWS if region is None else 1
            kernel.REGION_LOG2 = region or defaults[1]
            return ops.bag_reduce_routed(parts, pd, pl, 64, ix)

        for order, ix in (("random", idx),
                          ("address", ordered(idx.reshape(-1), 0).reshape(
                              idx.shape))):
            ms = cs.time_ms(lambda: routed(ix), iters=10, warmup=2,
                            queue_ahead=True)
            print(f"order/{span}GiB,today,{order},pinned_lookups={n_pin},"
                  f"ms={ms:.4f},pinned_GBps="
                  f"{n_pin * row_bytes / ms / 1e6:.2f}", flush=True)
        want = routed(idx)
        for region in STAGED_REGIONS:
            assert torch.equal(routed(idx, region), want), region
            ms = cs.time_ms(lambda: routed(idx, region), iters=10, warmup=2,
                            queue_ahead=True)
            print(f"order/{span}GiB,staged,region_log2={region},"
                  f"pinned_lookups={n_pin},ms={ms:.4f},pinned_GBps="
                  f"{n_pin * row_bytes / ms / 1e6:.2f},equal_to_today=1",
                  flush=True)
        print(f"order/{span}GiB,staged_kernels_ms,"
              + staged_kernels_ms(lambda: routed(idx, defaults[1])),
              flush=True)
        if span in ("8", "28.8"):
            for B in SWEEP_BAGS:
                # a new batch each call, so no call finds its rows in L2
                pool = torch.randint(0, (n_hp + n_pp) * 64,
                                     (SWEEP_POOL, B, ORDER_LOOKUPS),
                                     generator=gen, device=dev)
                turn = iter(range(1 << 30))
                today = cs.time_ms(lambda: routed(
                    pool[next(turn) % SWEEP_POOL]), iters=20, warmup=2,
                    queue_ahead=True)
                staged = cs.time_ms(lambda: routed(
                    pool[next(turn) % SWEEP_POOL], defaults[1]), iters=20,
                    warmup=2, queue_ahead=True)
                print(f"lookups/{span}GiB,B={B},K={ORDER_LOOKUPS},"
                      f"lookups={B * ORDER_LOOKUPS},today_ms={today:.4f},"
                      f"staged_ms={staged:.4f},"
                      f"staged_over_today={staged / today:.3f}", flush=True)
            print(f"host/{span}GiB,B={ORDER_BAGS},today_us="
                  f"{host_us(lambda: routed(idx)):.1f},staged_us="
                  f"{host_us(lambda: routed(idx, defaults[1])):.1f},"
                  f"staged_top_us=" + profiled_top(
                      lambda: routed(idx, defaults[1])), flush=True)
        kernel.STAGE_MIN_LOOKUPS, kernel.REGION_LOG2 = defaults
        del hbm, parts, pd, pl, perm, idx, want
        torch.cuda.empty_cache()


def e2e_one(src: str) -> None:
    """End-to-end numbers for the package under ``src``."""
    sys.path.insert(0, src)
    import torch
    import chip_smoke as cs
    from repro_torch.core import (CaptionConfig, CaptionController,
                                  InterleavedTensor, MemPolicy, h100_topology)
    from repro_torch.core.telemetry import Telemetry
    import repro_torch
    assert Path(repro_torch.__file__).resolve().is_relative_to(
        Path(src).resolve()), repro_torch.__file__
    dev = torch.device("cuda")
    topo = h100_topology()
    fast, slow = topo.fast.name, topo.slow.name
    rows = 1 << ROWS_LOG2
    n_pages = rows // cs.PAGE_ROWS
    headroom = CaptionController(
        topo, CaptionConfig(max_fraction=0.5)).headroom_pages(n_pages)
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randint(-8, 9, (rows, cs.DIM), dtype=torch.float32,
                          generator=gen, device=dev)
    it = InterleavedTensor.from_array(
        table, MemPolicy.weighted((fast, slow), (1, 0)), cs.PAGE_ROWS,
        headroom=headroom, device=dev)
    del table
    batches = [torch.randint(0, rows, (cs.BAG, cs.LOOKUPS), generator=gen,
                             device=dev) for _ in range(4)]
    want = [it.bag_reduce(b) for b in batches]
    for f in (0.0, 0.10):
        it = it.repartition_fraction(f, fast_tier=fast, slow_tier=slow,
                                     telemetry=Telemetry(), donate=True)
        for b, w in zip(batches, want):
            assert torch.equal(it.bag_reduce(b), w)
        rates = sorted(cs.epoch_rate(it, batches) for _ in range(3))
        busy = cs.device_busy_share(lambda: cs.bags(it, batches))
        host = cs.host_cost(it, batches)
        print(f"e2e/{src}/f{f:.2f},bags_per_s={rates[1]:.0f},"
              f"bags_per_s_min={rates[0]:.0f},bags_per_s_max={rates[2]:.0f},"
              f"device_busy_share={busy},"
              f"host_us_per_bag_reduce={host['host_us']:.1f},"
              f"cprofile_us_per_bag_reduce={host['cprofile_us']:.1f},"
              f"kernels_per_bag_reduce={host['kernels']}", flush=True)
        print(f"e2e/{src}/f{f:.2f}/host_top,us_per_bag_reduce," + ",".join(
            f"{name}={us:.1f}" for name, us in host["top"]), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--e2e", nargs="*", default=[], metavar="DIR")
    ap.add_argument("--pinned-order", action="store_true")
    ap.add_argument("--e2e-one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("embedding_reduce_probe: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    if args.e2e_one:
        e2e_one(str(Path(args.e2e_one).resolve() / "src"))
        return 0
    print(card_line(), flush=True)
    if args.sweep or args.pinned_order:
        sys.path.insert(0, str(ROOT / "src"))
    if args.sweep:
        sweep()
    if args.pinned_order:
        pinned_order()
    for d in args.e2e:
        subprocess.run([sys.executable, __file__, "--e2e-one", d], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
