#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py            # the full slice: 8 GiB DLRM table
    python3 chip_smoke.py --sweep    # and a static slow-fraction sweep

It needs a CUDA card and the checkout's ``src/`` beside it, and fails
(non-zero exit, no result line) otherwise.  Phases, each raising on a
wrong result or a missing kernel launch:

1. device: card name and power limit; build both CUDA kernels from
   ``src/repro_torch/csrc`` (one ``nvcc`` each, in parallel).
2. ``embedding_reduce`` against its plain version: fp32 and bf16 tables in
   HBM and in pinned host memory, duplicate indices, zero weights.
3. ``stream_copy`` against its plain version: the ragged row sweep on the
   HBM->HBM, pinned->HBM and HBM->pinned routes, with both casts.
4. the slice: a 2^25 x 64 fp32 embedding table (8 GiB) paged with
   ``page_rows=64`` over an HBM shard and a pinned host shard; an
   actuation audit (0 -> 0.25 -> 0.10 slow, donated, through
   ``BulkMover(execute=stream_executor())``); then a Caption walk from
   0% slow on measured bag throughput.  Kernel launch counts are reset
   right before the walk and read right after it.  ``--sweep`` then
   measures bags/s at fixed slow fractions (not part of the main path).

Prints the card line, per-phase lines, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BW = 3.35e12  # bytes/s, H100 SXM data sheet (700 W)
PCIE_BW = 64e9  # bytes/s, PCIe Gen5 x16 one direction (data sheet)
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores (data sheet)
BF16_TOL = dict(atol=0.3, rtol=0.05)
BAG, LOOKUPS, DIM, PAGE_ROWS = 2048, 80, 64, 64


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3,
            queue_ahead: bool = False) -> float:
    """Mean time of ``fn()`` over ``iters`` calls between two CUDA events.

    Without ``queue_ahead`` the host's launch gaps count (the end-to-end
    view).  With it the card first sleeps while the host enqueues every
    call, so the events time the device work alone: a kernel's time, not
    the rate at which Python can launch it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if queue_ahead:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        # twice the host time of all calls, at <= 2 GHz (H100 boost 1.98)
        torch.cuda._sleep(int(2 * iters * (time.perf_counter() - t0) * 2e9))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> dict:
    import torch
    from repro_torch.kernels import common
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices={torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = common.build()
    build_s = time.perf_counter() - t0
    for kname, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas[{kname}] {line.strip()}")
    log(f"phase1/build,seconds={build_s:.2f},built={sorted(logs)}")
    return {"name": name, "card": card, "build_s": build_s}


def device_busy_share(fn) -> str:
    """Share of a profiled window the card spent in kernels (the profiler
    is on, so the window runs slower than an unprofiled one); "not
    measured" when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us = sum(getattr(e, "self_device_time_total", 0.0)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA)
    if busy_us <= 0:
        return "not measured"
    return f"{busy_us / wall_us:.3f}"


def _pinned(t):
    return t.cpu().pin_memory()


def phase_embedding_reduce(stats: dict) -> None:
    """Kernel == plain version on the card: dtypes x memories x cases."""
    import torch
    from repro_torch.kernels.embedding_reduce import kernel, ops, ref
    from repro_torch.kernels.stream_copy.kernel import pointer_info
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for mem in ("hbm", "pinned"):
            for V, D, B, K in ((4096, 64, 256, 80), (300, 24, 17, 5),
                               (64, 512, 3, 33)):
                table = torch.randn((V, D), generator=g).to(dtype)
                idx = torch.randint(0, V, (B, K), generator=g,
                                    dtype=torch.int32)
                idx[:, 1] = idx[:, 0]  # duplicate lookups
                w = torch.rand((B, K), generator=g).to(dtype)
                w[:, ::7] = 0  # rows of zero weight: no load, exact +0
                tab = table.to(dev) if mem == "hbm" else _pinned(table)
                if mem == "pinned":
                    kind, dptr = pointer_info(tab)
                    assert kind == 1 and dptr == tab.data_ptr(), (kind, dptr)
                got = kernel.embedding_reduce(tab, idx.to(dev), w.to(dev), dev)
                want = ref.embedding_reduce(table.to(dev), idx.to(dev),
                                            w.to(dev))
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                if dtype == torch.float32:
                    assert torch.equal(got, want), (mem, V, D, B, K, err)
                else:
                    torch.testing.assert_close(got.float(), want.float(),
                                               **BF16_TOL)
                worst = max(worst, err)
                log(f"phase2/embedding_reduce/{str(dtype)[6:]}/{mem}/"
                    f"V{V}xD{D}xB{B}xK{K},max_abs_err={err:.3g}")
    # random-row read rate of a pinned host table over PCIe (UVA reads)
    V = 1 << 22
    table = torch.randint(-8, 9, (V, DIM), dtype=torch.float32, generator=g)
    tab = _pinned(table)
    idx = torch.randint(0, V, (BAG, LOOKUPS), generator=g,
                        dtype=torch.int32).to(dev)
    w = torch.ones((BAG, LOOKUPS), device=dev)
    ms = time_ms(lambda: ops.embedding_reduce(tab, idx, w), iters=10,
                 queue_ahead=True)
    rate = BAG * LOOKUPS * DIM * 4 / (ms * 1e-3)
    log(f"phase2/embedding_reduce/pinned_random_rows,ms={ms:.4f},"
        f"rows_GBps={rate / 1e9:.2f}")
    stats["pinned_row_GBps"] = rate / 1e9
    stats["embedding_reduce_err"] = worst
    ops.LAUNCHES.reset()


def phase_stream_copy(stats: dict) -> None:
    """Kernel == plain copy, bit-exact, on all three routes and both casts."""
    import torch
    from repro_torch.kernels.stream_copy import ops, ref
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(2)
    shapes = [(1, 8), (7, 16), (100, 16), (300, 8), (513, 4), (5, 1),
              (64, 3), (1024, 128), (16 * PAGE_ROWS, DIM)]  # last: a run
    casts = [(torch.float32, None), (torch.float32, torch.bfloat16),
             (torch.bfloat16, torch.float32), (torch.bfloat16, None)]
    routes = {"hbm->hbm": ("hbm", "hbm"), "pinned->hbm": ("pinned", "hbm"),
              "hbm->pinned": ("hbm", "pinned")}
    n, worst = 0, 0.0
    for rname, (smem, dmem) in routes.items():
        for shape in shapes:
            for sdt, odt in casts:
                numel = shape[0] * shape[1]
                buf = torch.randn(numel + 1, generator=g).to(sdt)
                if smem == "pinned":
                    buf = _pinned(buf)
                for offset in (0, 1):  # 16-byte vectors, then scalar path
                    host = buf[offset: offset + numel].cpu().view(shape)
                    src = buf[offset: offset + numel].view(shape)
                    if smem == "hbm":
                        src = torch.empty(numel + 1, dtype=sdt, device=dev)
                        src[offset: offset + numel].copy_(host.reshape(-1))
                        src = src[offset: offset + numel].view(shape)
                    out_dt = odt or sdt
                    out = (torch.empty(shape, dtype=out_dt, device=dev)
                           if dmem == "hbm" else torch.empty(
                               shape, dtype=out_dt, pin_memory=True))
                    ops.stream_copy(src, out=out)
                    torch.cuda.synchronize()
                    want = ref.stream_copy(host, odt)
                    got = out.cpu()
                    worst = max(worst, float(
                        (got.float() - want.float()).abs().max()))
                    assert torch.equal(got, want), (rname, shape, sdt, odt,
                                                    offset)
                    n += 1
    log(f"phase3/stream_copy/ragged_sweep,cases={n},bit_exact=1,"
        f"max_abs_err={worst}")
    # route rates on a 256 MiB slab (kernel vs copy_), and the slice's run
    # slab (16 pages x 64 rows x 64 fp32 = 256 KiB)
    for rname, (smem, dmem) in routes.items():
        for rows in (1 << 20, 16 * PAGE_ROWS):
            host = torch.randn((rows, DIM), generator=g)
            src = host.to(dev) if smem == "hbm" else _pinned(host)
            out = (torch.empty_like(src, device=dev) if dmem == "hbm"
                   else torch.empty(src.shape, pin_memory=True))
            ops.stream_copy(src, out=out)  # the timed slab, checked first
            torch.cuda.synchronize()
            got = out.cpu()
            worst = max(worst, float((got - host).abs().max()))
            assert torch.equal(got, ref.stream_copy(host)), (rname, rows)
            nbytes = src.numel() * 4
            k_ms = time_ms(lambda: ops.stream_copy(src, out=out), queue_ahead=True)
            lib_ms = time_ms(lambda: out.copy_(src), queue_ahead=True)
            # the plain version, then the move into the destination memory
            # (host work for a pinned source: timed with the host's gaps)
            p_ms = time_ms(lambda: out.copy_(ref.stream_copy(src)))
            bound = (2 * nbytes / HBM_BW if rname == "hbm->hbm"
                     else nbytes / PCIE_BW)
            log(f"phase3/stream_copy/{rname}/rows{rows},bytes={nbytes},"
                f"ms={k_ms:.4f},plain_ms={p_ms:.4f},copy_ms={lib_ms:.4f},"
                f"bound_ms={bound * 1e3:.4f},"
                f"GBps={nbytes / (k_ms * 1e-3) / 1e9:.2f}")
            stats[f"copy/{rname}/{rows}"] = (k_ms, p_ms, lib_ms, bound * 1e3,
                                              nbytes)
    stats["stream_copy_err"] = worst
    ops.LAUNCHES.reset()


def epoch_rate(it, batches) -> float:
    """Bags/s of one epoch of ``it.bag_reduce``: three windows of 32
    batches, and their median, so one window stalled by the shared host
    does not steer the walk."""
    rates = []
    for _ in range(3):
        ms = time_ms(lambda: [it.bag_reduce(b) for b in batches], iters=8,
                     warmup=1)
        rates.append(BAG * len(batches) / (ms * 1e-3))
    return sorted(rates)[1]


def phase_slice(stats: dict, rows_log2: int, sweep: bool) -> dict:
    import torch
    from repro_torch.core import (BulkMover, CaptionConfig, CaptionController,
                                  EpochMetrics, InterleavedTensor, MemPolicy,
                                  h100_topology, stream_executor)
    from repro_torch.core.donation import FULL_SHARD_COPIES
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.kernels.embedding_reduce import ops as er_ops, ref as er_ref
    from repro_torch.kernels.stream_copy import ops as sc_ops
    from repro_torch.kernels.stream_copy.kernel import pointer_info
    dev = torch.device("cuda")
    topo = h100_topology()
    fast, slow = topo.fast.name, topo.slow.name
    cfg = CaptionConfig(max_fraction=0.5)
    rows = 1 << rows_log2
    while True:
        n_pages = rows // PAGE_ROWS
        headroom = CaptionController(topo, cfg).headroom_pages(n_pages)
        pinned_bytes = headroom * PAGE_ROWS * DIM * 4
        try:  # the one refusal the slice tolerates: halve and say so
            probe = torch.empty(pinned_bytes, dtype=torch.uint8,
                                pin_memory=True)
            del probe
            break
        except RuntimeError as e:
            log(f"phase4/cut,pinned {pinned_bytes} bytes refused ({e});"
                f" table halved to {rows // 2} rows")
            rows //= 2
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    table = torch.randint(-8, 9, (rows, DIM), dtype=torch.float32,
                          generator=gen, device=dev)
    it = InterleavedTensor.from_array(
        table, MemPolicy.weighted((fast, slow), (1, 0)), PAGE_ROWS,
        headroom=headroom, device=dev)
    del table
    torch.cuda.synchronize()
    log(f"phase4/table,rows={rows},dim={DIM},bytes={rows * DIM * 4},"
        f"pages={it.n_pages},headroom_pages={headroom},"
        f"shard_bytes={[p.numel() * 4 for p in it.parts]},"
        f"build_s={time.perf_counter() - t0:.2f}")
    kind, dptr = pointer_info(it.parts[1])
    assert kind == 1 and dptr == it.parts[1].data_ptr(), (kind, dptr)
    log(f"phase4/uva,pinned_shard_type={kind},device_ptr_equal=1")

    batches = [torch.randint(0, rows, (BAG, LOOKUPS), generator=gen,
                             device=dev) for _ in range(4)]
    ones = torch.ones((BAG, LOOKUPS), device=dev)
    want = [it.bag_reduce(b) for b in batches]

    # kernel vs plain vs library at the slice's shapes (fast shard, f=0:
    # local row == logical row)
    fast_part = it.parts[0]
    idx0 = batches[0].to(torch.int32)  # the kernel's index width
    got = er_ops.embedding_reduce(fast_part, idx0, ones)
    plain = er_ref.embedding_reduce(fast_part, idx0, ones)
    lib = torch.nn.functional.embedding_bag(idx0, fast_part, mode="sum",
                                            per_sample_weights=ones)
    torch.cuda.synchronize()
    assert torch.equal(got, plain) and torch.equal(want[0], plain)
    er_err = float((got - plain).abs().max())
    k_ms = time_ms(lambda: er_ops.embedding_reduce(fast_part, idx0, ones),
                   queue_ahead=True)
    p_ms = time_ms(lambda: er_ref.embedding_reduce(fast_part, idx0, ones),
                   iters=5, queue_ahead=True)
    l_ms = time_ms(lambda: torch.nn.functional.embedding_bag(
        idx0, fast_part, mode="sum", per_sample_weights=ones),
        queue_ahead=True)
    k_host_ms = time_ms(lambda: er_ops.embedding_reduce(fast_part, idx0,
                                                        ones))
    # rows, int32 indices and fp32 weights read once; the output written
    nbytes = (BAG * LOOKUPS * (DIM * 4 + 4 + 4) + BAG * DIM * 4)
    flops = 2 * BAG * LOOKUPS * DIM
    er_bound = max(nbytes / HBM_BW, flops / FP32_FLOPS) * 1e3
    log(f"phase4/embedding_reduce/hbm,ms={k_ms:.4f},plain_ms={p_ms:.4f},"
        f"library_ms={l_ms:.4f},bound_ms={er_bound:.4f},bytes={nbytes},"
        f"ms_with_host_gaps={k_host_ms:.4f},"
        f"library_max_abs_err={float((lib - plain).abs().max()):.3g},"
        f"rows_GBps={BAG * LOOKUPS * DIM * 4 / (k_ms * 1e-3) / 1e9:.2f}")

    # actuation audit (fig11_caption.py:262-299 on the card)
    page_bytes = PAGE_ROWS * it.row_bytes
    ptrs = [p.data_ptr() for p in it.parts]
    tel = Telemetry()
    FULL_SHARD_COPIES.reset()
    with BulkMover(topo, batch_size=16, telemetry=tel,
                   execute=stream_executor(), device=dev) as mover:
        for f in (0.25, 0.10, 0.0):
            before_slow = int(round(it.slow_fraction() * it.n_pages))
            b0, d0 = mover.bytes_submitted, mover.descriptors_submitted
            t0 = time.perf_counter()
            it = it.repartition_fraction(f, mover=mover, fast_tier=fast,
                                         slow_tier=slow, donate=True)
            torch.cuda.synchronize()
            act_s = time.perf_counter() - t0
            delta = abs(int(round(it.slow_fraction() * it.n_pages))
                        - before_slow)
            billed = mover.bytes_submitted - b0
            descs = mover.descriptors_submitted - d0
            assert delta > 0 and billed == delta * page_bytes, (billed, delta)
            assert descs < delta, (descs, delta)
            for b, w in zip(batches, want):
                assert torch.equal(it.bag_reduce(b), w), f
            assert [p.data_ptr() for p in it.parts] == ptrs
            assert FULL_SHARD_COPIES.count == 0
            log(f"phase4/audit/f{f:.2f},delta_pages={delta},billed={billed},"
                f"descriptors={descs},seconds={act_s:.3f},"
                f"GBps={billed / act_s / 1e9:.2f},bags_bit_equal=1,"
                f"data_ptr_same=1,full_shard_copies=0")

        # membind-fast reference and the measured Caption walk
        membind = epoch_rate(it, batches)
        log(f"phase4/membind_fast,bags_per_s={membind:.0f}")
        ctl = CaptionController(topo, cfg, initial_fraction=0.0)
        er_ops.LAUNCHES.reset()
        sc_ops.LAUNCHES.reset()
        trajectory = []
        for epoch in range(48):
            rate = epoch_rate(it, batches)
            d = ctl.observe(EpochMetrics(throughput=rate))
            t0 = time.perf_counter()
            it = it.repartition_fraction(d.fraction, mover=mover,
                                         fast_tier=fast, slow_tier=slow,
                                         donate=True)
            torch.cuda.synchronize()
            ctl.actuated(it.slow_fraction())
            trajectory.append((epoch, round(it.slow_fraction(), 4), rate))
            log(f"phase4/walk/epoch{epoch:02d},f={it.slow_fraction():.4f},"
                f"bags_per_s={rate:.0f},phase={d.phase.value},"
                f"actuation_s={time.perf_counter() - t0:.3f},"
                f"reason={d.reason}")
            if ctl.converged:
                break
        launches = {"embedding_reduce": er_ops.LAUNCHES.count,
                    "stream_copy": sc_ops.LAUNCHES.count}
    for b, w in zip(batches, want):
        assert torch.equal(it.bag_reduce(b), w)
    assert [p.data_ptr() for p in it.parts] == ptrs
    final = epoch_rate(it, batches)
    log(f"phase4/walk/final,f={it.slow_fraction():.4f},converged="
        f"{int(ctl.converged)},epochs={len(trajectory)},"
        f"bags_per_s={final:.0f},membind_bags_per_s={membind:.0f},"
        f"launches={launches}")
    for name, count in launches.items():
        assert count > 0, f"{name} was never launched on the main path"
    landed = it.slow_fraction()
    if sweep:
        sweep_fractions(it, batches, want, landed)
    run = stats[f"copy/hbm->pinned/{16 * PAGE_ROWS}"]
    return {
        "launches": launches,
        "er": {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
               "bound_ms": er_bound,
               "err": max(er_err, stats["embedding_reduce_err"])},
        "sc": {"ms": run[0], "plain_ms": run[1], "library_ms": run[2],
               "bound_ms": run[3], "nbytes": run[4],
               "err": stats["stream_copy_err"]},
    }


def sweep_fractions(it, batches, want, landed: float) -> None:
    """Bags/s at fixed slow fractions: is the walk's landing point worth
    its pages?  Moves without a mover (``stream_copy`` on the current
    stream); the busy share comes from a profiled window."""
    import torch
    from repro_torch.core import h100_topology
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.kernels.stream_copy import ops as sc_ops
    topo = h100_topology()
    fast, slow = topo.fast.name, topo.slow.name
    sweep = {}
    sc_ops.LAUNCHES.reset()
    for f in (0.0, 0.05, 0.10, 0.15, 0.20, 0.30, 0.50):
        it = it.repartition_fraction(f, fast_tier=fast, slow_tier=slow,
                                     telemetry=Telemetry(), donate=True)
        sweep[f] = epoch_rate(it, batches)
        busy = device_busy_share(lambda: [it.bag_reduce(b) for b in batches])
        log(f"phase4/sweep/f{f:.2f},bags_per_s={sweep[f]:.0f},"
            f"device_busy_share={busy}")
    moves = sc_ops.LAUNCHES.reset()
    assert moves > 0, "the sweep's page moves did not launch stream_copy"
    best = max(sweep, key=sweep.get)
    log(f"phase4/sweep/best,f={best:.2f},bags_per_s={sweep[best]:.0f},"
        f"landed_f={landed:.4f},membind_bags_per_s={sweep[0.0]:.0f},"
        f"stream_copy_launches={moves}")
    for b, w in zip(batches, want):
        assert torch.equal(it.bag_reduce(b), w)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--rows-log2", type=int, default=25,
                    help="table rows as a power of two (default 25: 8 GiB)")
    ap.add_argument("--sweep", action="store_true",
                    help="after the walk, measure bags/s at fixed fractions")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = phase_device()
    stats: dict = {}
    phase_embedding_reduce(stats)
    phase_stream_copy(stats)
    res = phase_slice(stats, args.rows_log2, args.sweep)
    er, sc = res["er"], res["sc"]
    kernels = [
        {"name": "embedding_reduce", "route": "cuda",
         "source": "src/repro_torch/csrc/embedding_reduce.cu",
         "replaces": "src/repro/kernels/embedding_reduce/kernel.py:35",
         "launches": res["launches"]["embedding_reduce"],
         "max_abs_err": er["err"], "ms": er["ms"], "plain_ms": er["plain_ms"],
         "bound_ms": er["bound_ms"], "bound_by": "bytes",
         "library_ms": er["library_ms"]},
        {"name": "stream_copy", "route": "cuda",
         "source": "src/repro_torch/csrc/stream_copy.cu",
         "replaces": "src/repro/kernels/stream_copy/kernel.py:102",
         "launches": res["launches"]["stream_copy"],
         "max_abs_err": sc["err"], "ms": sc["ms"],
         "plain_ms": sc["plain_ms"],
         "bound_ms": sc["bound_ms"], "bound_by": "bytes",
         "library_ms": sc["library_ms"]},
    ]
    print(card["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
