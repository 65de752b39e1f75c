#!/usr/bin/env python3
"""Measurements behind the design of the ``stream_copy`` kernel.

    python3 tools/stream_copy_probe.py [--parent DIR] [--only NAME,NAME]
                                       [--moves] [--no-sweep]

Needs a CUDA card and ``nvcc``; prints the card's name and power limit
first.  Not part of the port: it calls the kernel's C entry points itself.

The sweep builds variants of ``src/repro_torch/csrc/stream_copy.cu``
through the build-time options the source defines (``SC_U`` loads a
thread keeps in flight, ``SC_BPS`` blocks an SM,
``SC_BULK`` the ``cp.async.bulk`` ring for row pieces of that many bytes
or more, ``SC_BULK_RANGE`` the bytes a block's range needs for it,
``SC_STAGES`` and ``SC_CHUNK`` its ring; into ``build/probe_stream_copy/``, one ``nvcc`` each, in
parallel), and with ``--parent DIR`` the same file of another tree (for
instance the parent commit unpacked into ``build/parent``) with the same
flags.  It checks each against the plain version (a ragged, unaligned,
row-strided segment list), then times each on the four routes (HBM and
pinned host memory, each way) with the card queued ahead:

* a 256 KiB slab (a DLRM walk's run: 16 pages x 64 rows x 64 fp32) and a
  256 MiB slab, one-segment launches;
* a mover batch: 16 segments of 256 KiB in one launch (a DLRM move's
  gather launch);
* a walk-shaped move: 8192 segments of 256 KiB (2 GiB) gathered from
  scattered places into one buffer, in one launch and as 8192
  one-segment launches (the parent's only way);
* ``copy_`` of the same bytes as one contiguous slab beside each (on
  the host's clock for pinned -> pinned, which ``copy_`` runs on the CPU).

``--moves`` then runs the DLRM slice's actuation audit (a 2^25 x 64 fp32
table, 0 -> 0.25 -> 0.10 -> 0 slow through a ``BulkMover`` on
``stream_executor()``, donated, as ``chip_smoke.py`` phase 4 does) in
this tree and, with ``--parent``, in the parent's, each in its own
process: every move's seconds, GB/s, descriptors and ``stream_copy``
launches with the mover's drain thread (as the smoke runs it), then the
same moves with a synchronous mover under cProfile, split into
allocation (``torch.empty``/``zeros``, ``pin_memory``), kernel (the
launch wrappers' own time), synchronize (host waits on the card),
landing (host-side ``index_copy_`` and its wrapper) and the rest (the
per-descriptor Python: descriptors, futures, telemetry, batching).
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

OUT = ROOT / "build" / "probe_stream_copy"
#: (name, defines); the first is the source's default build
VARIANTS = (
    ("default", ()),
    ("bulk_always", ("-DSC_BULK_RANGE=0",)),
    ("bulk_range_16k", ("-DSC_BULK_RANGE=16384",)),
    ("bulk_range_1m", ("-DSC_BULK_RANGE=1048576",)),
    ("u1", ("-DSC_U=1",)),
    ("u8_bps2", ("-DSC_U=8", "-DSC_BPS=2")),
    ("no_bulk", ("-DSC_BULK=0",)),
    ("no_bulk_u8_bps2", ("-DSC_BULK=0", "-DSC_U=8", "-DSC_BPS=2")),
    ("bulk_64k", ("-DSC_BULK=65536",)),
    ("bulk_s8_c4k", ("-DSC_STAGES=8", "-DSC_CHUNK=4096")),
)
ROUTES = ("hbm->hbm", "pinned->hbm", "hbm->pinned", "pinned->pinned")
RUN = 16 * 64 * 64 * 4  # bytes: a DLRM walk's run of 16 pages
WALK = 8192  # runs in the walk-shaped move (2 GiB)
PCIE_BW, HBM_BW = 64e9, 3.35e12


def card_line() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def build(common, only, parent) -> dict:
    """name -> (library, ptxas log) for every variant, built in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = str(common.CSRC / "stream_copy.cu")
    jobs = {name: (list(flags), src) for name, flags in VARIANTS
            if not only or name in only}
    if parent:
        jobs["parent"] = ([], str(Path(parent) / "src" / "repro_torch" /
                                  "csrc" / "stream_copy.cu"))
    procs = {name: subprocess.Popen(
        [common.nvcc_path(), *common.NVCC_FLAGS, *flags, "-o",
         str(OUT / f"lib{name}.so"), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (flags, path) in jobs.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} did not build:\n{log[-4000:]}")
        libs[name] = (ctypes.CDLL(str(OUT / f"lib{name}.so")), log)
    return libs


def ptxas_report(log: str) -> tuple[int, int, int]:
    """Most registers of any kernel, most static shared bytes, and the
    number of functions that spill."""
    regs = smem = spills = 0
    for ln in log.splitlines():
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            regs = max(regs, int(m.group(1)))
            s = re.search(r"(\d+) bytes smem", ln)
            smem = max(smem, int(s.group(1)) if s else 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and m.groups() != ("0", "0"):
            spills += 1
    return regs, smem, spills


class Entry:
    """A variant's C entry points, called with the wrappers' arguments."""

    def __init__(self, lib):
        from repro_torch.kernels.stream_copy import kernel
        self.one = lib.repro_stream_copy
        self.one.argtypes = kernel._argtypes
        self.one.restype = ctypes.c_int
        self.segs = getattr(lib, "repro_stream_copy_segments", None)
        if self.segs is not None:
            self.segs.argtypes = kernel._seg_argtypes
            self.segs.restype = ctypes.c_int

    def copy(self, src, out):
        """One slab (contiguous, or 2-D row-strided), as ``kernel.stream_copy``."""
        from repro_torch.kernels import common
        from repro_torch.kernels.stream_copy import kernel
        import torch
        common.check(self.one(src.data_ptr(), out.data_ptr(),
                              *kernel.slab_args(src, out),
                              common.stream_handle(torch.device("cuda"))),
                     "probe launch")

    def upload(self, srcs, dsts, segs):
        """The launch table on the card (built and copied once)."""
        import numpy as np
        import torch
        from repro_torch.kernels.stream_copy import kernel
        table, prefix, s_code, d_code = kernel.launch_table(srcs, dsts, segs)
        buf = torch.from_numpy(np.concatenate([table.reshape(-1), prefix])
                               ).cuda()
        return (buf, buf.data_ptr(), buf.data_ptr() + table.size * 8,
                len(table), int(prefix[-1]), s_code, d_code)

    def launch(self, up):
        from repro_torch.kernels import common
        import torch
        _, t, p, n, total, s_code, d_code = up
        common.check(self.segs(t, p, n, total, s_code, d_code,
                               common.stream_handle(torch.device("cuda"))),
                     "probe launch")


def check(entry, name: str) -> None:
    """A ragged, unaligned, row-strided segment list (one row repeated
    with source stride 0) on every route and dtype pair, against the
    plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels.stream_copy import ref
    segs = np.array([(0, 0, 1024, 0, 0, 1024, 1, 1024),
                     (0, 1024, 1, 0, 2048, 1, 1, 1),
                     (0, 1027, 300, 0, 2051, 310, 4, 253),
                     (0, 3000, 0, 0, 3300, 8, 5, 4),
                     (0, 4096, 65536, 0, 4800, 65536, 1, 65536 + 5)],
                    np.int64)
    n = 0
    for route in ROUTES:
        sm, dm = route.split("->")
        for sdt, odt in ((torch.float32, torch.float32),
                         (torch.float32, torch.bfloat16),
                         (torch.bfloat16, torch.float32)):
            host = torch.randn(80000).to(sdt)
            want = torch.full((80000,), -7.0, dtype=odt)
            ref.stream_copy_segments([host], [want], segs)
            src = host.cuda() if sm == "hbm" else host.pin_memory()
            dst = torch.full((80000,), -7.0, dtype=odt)
            dst = dst.cuda() if dm == "hbm" else dst.pin_memory()
            entry.launch(entry.upload([src], [dst], segs))
            torch.cuda.synchronize()
            if not torch.equal(dst.cpu(), want):
                raise AssertionError(f"{name}: {route} {sdt}->{odt}")
            n += 1
    print(f"check/{name},cases={n},bit_exact=1", flush=True)


def sweep(args) -> None:
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import common
    only = {n for n in args.only.split(",") if n}
    libs = build(common, only, args.parent)
    entries = {}
    for name, (lib, log) in libs.items():
        regs, smem, spills = ptxas_report(log)
        fit = getattr(lib, "repro_stream_copy_blocks_per_sm", None)
        blocks = (f"{fit(0)}/{fit(1)}" if fit is not None else "n/a")
        print(f"build/{name},max_registers={regs},max_static_smem={smem},"
              f"spilling_functions={spills},blocks_per_sm_copy/cast={blocks}",
              flush=True)
        entries[name] = Entry(lib)
    for name, e in entries.items():
        if e.segs is not None:  # the parent has the one-segment entry only
            check(e, name)
    walk_bytes = WALK * RUN
    elems = walk_bytes // 4
    hbm = [torch.empty(elems, device="cuda") for _ in range(2)]
    pin = [torch.empty(elems, pin_memory=True) for _ in range(2)]
    hbm[0].uniform_()
    pin[0].copy_(hbm[0].cpu())
    mem = {"hbm": hbm, "pinned": pin}
    perm = np.random.default_rng(0).permutation(WALK)
    run = RUN // 4
    walk = np.zeros((WALK, 8), np.int64)
    walk[:, 1] = perm * run
    walk[:, 4] = np.arange(WALK) * run
    walk[:, [2, 5, 7]] = run
    walk[:, 6] = 1
    names = list(entries)
    for route in ROUTES:
        sm, dm = route.split("->")
        src, dst = mem[sm][0], mem[dm][1]
        bound = {}
        for label, nbytes in (("256KiB", RUN), ("256MiB", 1 << 28),
                              ("batch16", 16 * RUN), ("walk", walk_bytes)):
            pcie = nbytes / PCIE_BW
            bound[label] = (2 * nbytes / HBM_BW if route == "hbm->hbm"
                            else pcie) * 1e3
        row = {}
        for label, nbytes in (("256KiB", RUN), ("256MiB", 1 << 28)):
            n_el = nbytes // 4
            s, d = src[:n_el], dst[:n_el]
            times = {n: cs.time_ms(lambda e=e: e.copy(s, d), queue_ahead=True)
                     for n, e in entries.items()}
            times["copy_"] = cs.copy_ms(d, s)
            row[label] = times
        # a mover batch: 16 of the walk's segments, the main path's gather
        times = {}
        for n in names:
            e = entries[n]
            if e.segs is not None:
                up = e.upload([src], [dst], walk[:16])
                times[n] = cs.time_ms(lambda: e.launch(up), queue_ahead=True)
        row["batch16"] = times
        # walk-shaped: one launch (segment variants), or 8192 launches
        times = {}
        views = [(src[p * run:(p + 1) * run], dst[i * run:(i + 1) * run])
                 for i, p in enumerate(perm.tolist())]
        for n in names:
            e = entries[n]
            if e.segs is not None:
                up = e.upload([src], [dst], walk)
                times[n] = cs.time_ms(lambda: e.launch(up), iters=4,
                                      warmup=1, queue_ahead=True)

            if n not in ("default", "parent"):
                continue

            def many(e=e):
                for s, d in views:
                    e.copy(s, d)

            times[f"{n}_8192_launches"] = cs.time_ms(many, iters=2, warmup=1,
                                                     queue_ahead=True)
        times["copy_"] = cs.copy_ms(dst, src, iters=4)
        row["walk"] = times
        for label, times in row.items():
            print(f"time/{route}/{label},bound_ms={bound[label]:.4f}," +
                  ",".join(f"{n}={t:.4f}" for n, t in times.items()),
                  flush=True)
    del hbm, pin


def moves_child(tree: str) -> int:
    """The actuation audit in ``tree``'s package (this process imports it
    from ``tree/src``): unprofiled moves with an asynchronous mover, then
    profiled moves with a synchronous one."""
    import cProfile
    import pstats
    sys.path.insert(0, str(Path(tree) / "src"))
    import torch
    from repro_torch.core import (BulkMover, CaptionConfig, CaptionController,
                                  InterleavedTensor, MemPolicy, h100_topology,
                                  stream_executor)
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.kernels.stream_copy import ops as sc_ops
    import repro_torch
    label = "parent" if Path(tree).resolve() != ROOT else "change"
    assert Path(repro_torch.__file__).resolve().is_relative_to(
        Path(tree).resolve()), repro_torch.__file__
    dev = torch.device("cuda")
    topo = h100_topology()
    fast, slow = topo.fast.name, topo.slow.name
    rows, dim, page_rows = 1 << 25, 64, 64
    n_pages = rows // page_rows
    headroom = CaptionController(topo, CaptionConfig(max_fraction=0.5)
                                 ).headroom_pages(n_pages)
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randint(-8, 9, (rows, dim), dtype=torch.float32,
                          generator=gen, device=dev)
    it = InterleavedTensor.from_array(
        table, MemPolicy.weighted((fast, slow), (1, 0)), page_rows,
        headroom=headroom, device=dev)
    del table
    torch.cuda.synchronize()
    page_bytes = page_rows * dim * 4
    for mode in ("async", "profiled"):
        with BulkMover(topo, batch_size=16, telemetry=Telemetry(),
                       execute=stream_executor(), device=dev,
                       asynchronous=mode == "async") as mover:
            for f in (0.25, 0.10, 0.0):
                before = int(round(it.slow_fraction() * n_pages))
                d0 = mover.descriptors_submitted
                sc_ops.LAUNCHES.reset()
                pr = cProfile.Profile() if mode == "profiled" else None
                t0 = time.perf_counter()
                if pr is not None:
                    pr.enable()
                it = it.repartition_fraction(f, mover=mover, fast_tier=fast,
                                             slow_tier=slow, donate=True)
                torch.cuda.synchronize()
                if pr is not None:
                    pr.disable()
                sec = time.perf_counter() - t0
                delta = abs(int(round(it.slow_fraction() * n_pages)) - before)
                billed = delta * page_bytes
                print(f"moves/{label}/{mode}/f{f:.2f},seconds={sec:.3f},"
                      f"GBps={billed / sec / 1e9:.3f},delta_pages={delta},"
                      f"descriptors={mover.descriptors_submitted - d0},"
                      f"launches={sc_ops.LAUNCHES.count}", flush=True)
                if pr is not None:
                    split(pstats.Stats(pr), sec, f"{label}/f{f:.2f}")
    return 0


def split(stats, total: float, label: str) -> None:
    """A profiled move's seconds by what the host spent them on."""
    own = {}
    for (fname, _, func), (_, _, tt, _, _) in stats.stats.items():
        if func in ("<built-in method torch.empty>",
                    "<built-in method torch.zeros>",
                    "<method 'pin_memory' of 'torch._C.TensorBase' objects>"):
            key = "allocation"
        elif func in ("stream_copy", "stream_copy_segments") and \
                fname.endswith("kernel.py"):
            key = "kernel"
        elif "synchronize" in func:
            key = "synchronize"
        elif "index_copy_" in func or func == "donated_update" or \
                "record_stream" in func:
            key = "landing"
        else:
            key = "rest"
        own[key] = own.get(key, 0.0) + tt
    prof = sum(own.values())
    top = sorted(((f"{Path(fn).name}:{func}", tt) for (fn, _, func),
                  (_, _, tt, _, _) in stats.stats.items()),
                 key=lambda x: -x[1])[:8]
    print(f"split/{label},seconds={total:.3f},profiled_s={prof:.3f}," +
          ",".join(f"{k}_s={own.get(k, 0.0):.3f}" for k in
                   ("allocation", "kernel", "synchronize", "landing",
                    "rest")) +
          ",top=" + ";".join(f"{n}={t:.3f}" for n, t in top), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--parent", help="a tree whose stream_copy is timed "
                                     "beside (and whose moves, with --moves)")
    ap.add_argument("--only", default="",
                    help="comma-separated variant names (default: all)")
    ap.add_argument("--moves", action="store_true",
                    help="the actuation audit, profiled, in each tree")
    ap.add_argument("--no-sweep", action="store_true",
                    help="skip the variant sweep")
    ap.add_argument("--moves-child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("stream_copy_probe: CUDA is not available", file=sys.stderr)
        return 1
    if args.moves_child:
        return moves_child(args.moves_child)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    print(card_line(), flush=True)
    if not args.no_sweep:
        sweep(args)
    if args.moves:
        trees = [str(ROOT)] + ([args.parent] if args.parent else [])
        for tree in trees:
            env = dict(os.environ, PYTHONPATH="")
            proc = subprocess.run([sys.executable, __file__, "--moves-child",
                                   tree], env=env, text=True,
                                  capture_output=True)
            print(proc.stdout, end="", flush=True)
            if proc.returncode:
                print(proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
