#!/usr/bin/env python3
"""Measurements behind the design of the ``embedding_reduce`` kernel.

    python3 tools/embedding_reduce_probe.py --sweep
    python3 tools/embedding_reduce_probe.py --e2e DIR [DIR ...]

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
"""
from __future__ import annotations

import argparse
import ctypes
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
    if args.sweep:
        sys.path.insert(0, str(ROOT / "src"))
        sweep()
    for d in args.e2e:
        subprocess.run([sys.executable, __file__, "--e2e-one", d], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
