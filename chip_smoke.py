#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py            # both slices: DLRM table, then serving
    python3 chip_smoke.py --sweep    # and a static slow-fraction sweep

It needs a CUDA card and the checkout's ``src/`` beside it, and fails
(non-zero exit, no result line) otherwise.  Phases, each raising on a
wrong result or a missing kernel launch:

1. device: card name and power limit; build the three CUDA kernels from
   ``src/repro_torch/csrc`` (one ``nvcc`` each, in parallel).
2. ``embedding_reduce`` against its plain version: fp32 and bf16 tables in
   HBM and in pinned host memory, duplicate indices, zero weights.
3. ``stream_copy`` against its plain version: the ragged row sweep on the
   HBM->HBM, pinned->HBM and HBM->pinned routes, with both casts, on
   contiguous slabs and on row-strided 2-D views.
4. the slice: a 2^25 x 64 fp32 embedding table (8 GiB) paged with
   ``page_rows=64`` over an HBM shard and a pinned host shard; an
   actuation audit (0 -> 0.25 -> 0.10 slow, donated, through
   ``BulkMover(execute=stream_executor())``); then a Caption walk from
   0% slow on measured bag throughput.  Kernel launch counts are reset
   right before the walk and read right after it.  ``--sweep`` then
   measures bags/s at fixed slow fractions (not part of the main path).
5. ``decode_attention`` against its plain version, both forms, fp32 and
   bf16, K/V in HBM and in pinned host memory, ragged lengths (1 and T),
   a fully masked partition row; the append scatter likewise; then the
   partial form's time at the serving shape against its plain version,
   ``scaled_dot_product_attention`` (timed only) and its byte bound.
6. the serving slice: starcoder2-3b at full width and depth, bf16, random
   weights from a seeded generator, a ``ServingEngine`` over 16 slots of
   4096 positions (HBM pool + pinned pool sized by the Caption headroom),
   Caption + arbiter + ``BulkMover(execute=stream_executor())``.  It
   answers 8 requests (one step held against plain attention on the
   card), then fills all 16 slots to 3072 positions with
   ``write_token_rows`` and runs a 12-epoch Caption walk, with counts
   reset right before the walk and read right after.  One decode step on
   an epoch that holds slow pages is held against plain attention, and
   every slot's written rows are read back bit-equal through its page
   map.
   ``--profile`` then shows where a decode step's time goes.

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
    # the row-strided route (a KV run slab is one contiguous row per layer,
    # rows a pool's layer stride apart): the same sweep, each side a column
    # window of a wider buffer whose rows start on 16-byte boundaries
    # (offset 0, width a multiple of 8 elements: the vector body) or off
    # them (offset 1: the scalar body)
    n2, n_vec = 0, 0
    for rname, (smem, dmem) in routes.items():
        for rows, cols in shapes:
            for sdt, odt in casts:
                out_dt = odt or sdt
                for s_off, d_off in ((0, 0), (0, 1), (1, 0), (1, 1)):
                    sw = -(-cols // 8) * 8 + 8 if s_off == 0 else cols + 3
                    dw = -(-cols // 8) * 8 + 8 if d_off == 0 else cols + 5
                    host = torch.randn((rows, sw), generator=g).to(sdt)
                    src = host.to(dev) if smem == "hbm" else _pinned(host)
                    dst = (torch.zeros((rows, dw), dtype=out_dt, device=dev)
                           if dmem == "hbm" else torch.zeros(
                               (rows, dw), dtype=out_dt, pin_memory=True))
                    s_win = src[:, s_off:s_off + cols]
                    d_win = dst[:, d_off:d_off + cols]
                    n_vec += all(x % 16 == 0 for x in (
                        s_win.data_ptr(), d_win.data_ptr(),
                        s_win.stride(0) * s_win.element_size(),
                        d_win.stride(0) * d_win.element_size()))
                    ops.stream_copy(s_win, out=d_win)
                    torch.cuda.synchronize()
                    want = ref.stream_copy(host[:, s_off:s_off + cols], odt)
                    got = dst.cpu()
                    win = got[:, d_off:d_off + cols].clone()
                    worst = max(worst, float(
                        (win.float() - want.float()).abs().max()))
                    assert torch.equal(win, want), (rname, rows, cols, s_off,
                                                    d_off)
                    got[:, d_off:d_off + cols] = 0
                    assert not got.any(), (rname, rows, cols, "outside")
                    n2 += 1
    assert n_vec >= n2 // 4, (n_vec, n2)
    log(f"phase3/stream_copy/row_strided_sweep,cases={n2},"
        f"vector_body_cases={n_vec},bit_exact=1,max_abs_err={worst}")
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


DA_SWEEP = ((2, 8, 2, 32, 128), (1, 4, 4, 64, 256), (3, 8, 1, 16, 64),
            (2, 16, 16, 32, 128))  # tests/test_kernels.py:76-78
SERVE_B, SERVE_T, SERVE_VALID, SERVE_PAGE = 16, 4096, 3072, 64
SERVE_H, SERVE_K, SERVE_HD = 24, 2, 128  # starcoder2-3b
DEVICE = "cuda"


def _plain_attend(q, k, v, valid):
    """The plain partial form on the card (pinned K/V copied over first)."""
    from repro_torch.kernels.decode_attention import ref
    return ref.attend_partial(q, k.to(q.device), v.to(q.device),
                              valid.to(q.device))


def check_partial(q, k, v, valid, tol: float) -> float:
    """The partial form through its wrapper against the plain version on
    the card (pinned K/V copied over for the plain side): (acc, m, l) on
    every row with a valid position, the normalised result everywhere,
    and (0, -1e30, 0) on a fully masked row.  Returns the max abs error."""
    import torch
    from repro_torch.kernels.decode_attention import ops, ref
    acc, m, l = ops.attend_partial(q, k, v, valid)
    ra, rm, rl = _plain_attend(q, k, v, valid)
    torch.cuda.synchronize()
    rows = valid.any(1)
    err = max([0.0] + [float((x - y)[rows].abs().max())
                       for x, y in ((acc, ra), (m, rm), (l, rl))
                       if bool(rows.any())])
    torch.testing.assert_close(acc[rows], ra[rows], atol=tol, rtol=tol * 10)
    torch.testing.assert_close(m[rows], rm[rows], atol=tol, rtol=tol)
    torch.testing.assert_close(l[rows], rl[rows], atol=tol, rtol=tol * 10)
    assert bool((m[~rows] == ref.NEG_INF).all()) and not l[~rows].any()
    merged_k = torch.where(rows[:, None, None],
                           acc / l.clamp_min(1e-30)[..., None], 0)
    merged_p = torch.where(rows[:, None, None],
                           ra / rl.clamp_min(1e-30)[..., None], 0)
    torch.testing.assert_close(merged_k, merged_p, atol=tol, rtol=tol * 10)
    return err


def serve_caption(cfg, topo):
    """The serving slice's Caption controller (it also sizes the pinned
    pool: ``headroom_pages`` per slot)."""
    from repro_torch.core import CaptionConfig, CaptionController
    from repro_torch.serving.engine import kv_access_profile
    return CaptionController.from_profile(
        kv_access_profile(cfg, SERVE_B, SERVE_T, page_t=SERVE_PAGE,
                          item_bytes=2), topo, CaptionConfig(epoch_steps=8))


def phase_decode_attention(stats: dict) -> None:
    """Kernel == plain version: forms x dtypes x memories x shapes; then
    both pools' partitions at the serving shape, and its time there."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import h100_topology
    from repro_torch.kernels.decode_attention import kernel, ops, ref
    from repro_torch.models import registry
    dev = torch.device(DEVICE)
    g = torch.Generator(device="cpu").manual_seed(5)
    worst, n = 0.0, 0
    shapes = DA_SWEEP + ((SERVE_B, SERVE_H, SERVE_K, SERVE_HD, 1024),)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for mem in ("hbm", "pinned"):
            for B, H, K, hd, T in shapes:
                q = torch.randn((B, H, hd), generator=g).to(dtype)
                k = torch.randn((B, T, K, hd), generator=g).to(dtype)
                v = torch.randn((B, T, K, hd), generator=g).to(dtype)
                lengths = torch.randint(1, T + 1, (B,), generator=g)
                lengths[0], lengths[-1] = 1, T
                valid = torch.rand((B, T), generator=g) < 0.6
                valid[0] = False  # a fully masked partition row
                kk = k.to(dev) if mem == "hbm" else _pinned(k)
                vv = v.to(dev) if mem == "hbm" else _pinned(v)
                qd, ld, vd = q.to(dev), lengths.to(dev), valid.to(dev)
                got = ops.decode_attention(qd, kk, vv, ld)
                want = ref.decode_attention(qd, k.to(dev), v.to(dev), ld)
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, atol=tol, rtol=tol * 10)
                err = max(float((got - want).abs().max()),
                          check_partial(qd, kk, vv, vd, tol))
                worst = max(worst, err)
                n += 1
                log(f"phase5/decode_attention/{str(dtype)[6:]}/{mem}/"
                    f"B{B}xH{H}xK{K}xhd{hd}xT{T},max_abs_err={err:.3g}")
    # the append scatter, both memories, with the cast and dropped rows
    for mem in ("hbm", "pinned"):
        for dtype in (torch.float32, torch.bfloat16):
            pool = torch.randn((3, 5, 10, 2, 16), generator=g).to(dtype)
            kp, vp = ((torch.empty_like(pool, device=dev).copy_(pool)
                       if mem == "hbm" else _pinned(pool)) for _ in range(2))
            kn = torch.randn((5, 2, 16), generator=g).to(dev)
            vn = torch.randn((5, 2, 16), generator=g).to(dev)
            rows = torch.tensor([0, 9, 10, -1, 3], device=dev)
            ops.kv_append(kp[1], vp[1], rows, kn, vn)
            wk, wv = pool.clone(), pool.clone()
            ref.kv_append(wk[1], wv[1], rows.cpu(), kn.cpu(), vn.cpu())
            torch.cuda.synchronize()
            assert torch.equal(kp.cpu(), wk) and torch.equal(vp.cpu(), wv)
    log(f"phase5/decode_attention/sweep,cases={n},max_abs_err={worst:.3g},"
        f"kv_append_bit_exact=1")
    # the serving shapes, bf16: the HBM pool's partition (16 x 4096, 3072
    # valid) and the pinned pool's (16 x its headroom rows, whole pages
    # valid at random, one slot with none)
    B, H, K, hd, T = SERVE_B, SERVE_H, SERVE_K, SERVE_HD, SERVE_T
    cfg = registry.get("starcoder2-3b").cfg
    t_slow = serve_caption(cfg, h100_topology()).headroom_pages(
        SERVE_T // SERVE_PAGE) * SERVE_PAGE
    stats["t_slow"] = t_slow
    pages = torch.rand((B, t_slow // SERVE_PAGE), generator=g) < 0.5
    pages[0] = False
    valid_slow = pages.repeat_interleave(SERVE_PAGE, 1).to(dev)
    kp, vp = (_pinned(torch.randn((B, t_slow, K, hd), generator=g).to(
        torch.bfloat16)) for _ in range(2))
    q = torch.randn((B, H, hd), device=dev).to(torch.bfloat16)
    err_slow = check_partial(q, kp, vp, valid_slow, 2e-2)
    k = torch.randn((B, T, K, hd), device=dev).to(torch.bfloat16)
    v = torch.randn((B, T, K, hd), device=dev).to(torch.bfloat16)
    valid = (torch.arange(T, device=dev)[None] < SERVE_VALID).expand(
        B, T).contiguous()
    err = check_partial(q, k, v, valid, 2e-2)
    worst = max(worst, err, err_slow)
    log(f"phase5/decode_attention/serving_pools,hbm=B{B}xT{T},"
        f"hbm_splits={kernel.splits_for(B, K, T)},hbm_max_abs_err={err:.3g},"
        f"pinned=B{B}xT{t_slow},pinned_splits="
        f"{kernel.splits_for(B, K, t_slow)},pinned_max_abs_err="
        f"{err_slow:.3g}")
    splits = kernel.splits_for(B, K, T)
    k_ms = time_ms(lambda: ops.attend_partial(q, k, v, valid),
                   queue_ahead=True)
    p_ms = time_ms(lambda: ref.attend_partial(q, k, v, valid), iters=5,
                   queue_ahead=True)
    mask = valid[:, None, None, :]
    q4, k4, v4 = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    l_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, enable_gqa=True), queue_ahead=True)
    kv_bytes = 2 * B * SERVE_VALID * K * hd * 2
    # q and the mask read; fp32 acc (B,H,hd), m and l (B,H) written
    nbytes = (kv_bytes + q.numel() * 2 + valid.numel()
              + B * H * hd * 4 + 2 * B * H * 4)
    flops = 4 * B * SERVE_VALID * H * hd
    bound = max(nbytes / HBM_BW, flops / FP32_FLOPS) * 1e3
    log(f"phase5/decode_attention/serving_shape,splits={splits},"
        f"ms={k_ms:.4f},plain_ms={p_ms:.4f},library_ms={l_ms:.4f},"
        f"bound_ms={bound:.4f},bytes={nbytes},"
        f"GBps={kv_bytes / (k_ms * 1e-3) / 1e9:.2f},"
        f"bound_share={bound / k_ms:.3f},max_abs_err={err:.3g}")
    # the HBM partition's rows read in place from pinned host memory
    kp, vp = _pinned(k.cpu()), _pinned(v.cpu())
    pin_ms = time_ms(lambda: ops.attend_partial(q, kp, vp, valid), iters=5,
                     queue_ahead=True)
    log(f"phase5/decode_attention/pinned_pool,ms={pin_ms:.4f},"
        f"GBps={kv_bytes / (pin_ms * 1e-3) / 1e9:.2f}")
    stats["da"] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                   "bound_ms": bound, "err": worst,
                   "pinned_GBps": kv_bytes / (pin_ms * 1e-3) / 1e9}
    ops.LAUNCHES.reset()
    ops.APPEND_LAUNCHES.reset()


def profile_steps(eng, n: int = 4) -> None:
    """Where a long-context decode step's time goes: wall ms per step, the
    device's time and busy share in a profiled window (the profiler slows
    the host), the kernels by device time, and the host functions by own
    time under cProfile (which slows Python calls more)."""
    import cProfile
    import io
    import pstats
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def steps():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    step_ms = steps()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_ms = steps()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in dev)
    log(f"phase6/profile,steps={n},step_ms={step_ms:.2f},"
        f"profiled_step_ms={prof_ms:.2f},"
        f"device_ms_per_step={busy_us / n / 1e3:.3f},"
        f"device_busy_share={busy_us / n / 1e3 / prof_ms:.3f}")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"phase6/profile/kernel,ms_per_step="
            f"{e.self_device_time_total / n / 1e3:.4f},"
            f"calls_per_step={e.count / n:.0f},name={e.key[:70]}")
    pr = cProfile.Profile()
    pr.enable()
    cprof_ms = steps()
    pr.disable()
    out = io.StringIO()
    pstats.Stats(pr, stream=out).sort_stats("tottime").print_stats(14)
    log(f"phase6/profile/host,cprofile_step_ms={cprof_ms:.2f}")
    for line in out.getvalue().splitlines():
        if line.strip()[:1].isdigit():
            log("phase6/profile/host," + " ".join(line.split()))


def uncounted(fn):
    """``fn()`` with every kernel's launch count put back after it: the
    launches a check makes against a plain version are not the main
    path's."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.embedding_reduce import ops as er_ops
    from repro_torch.kernels.stream_copy import ops as sc_ops
    counters = (da_ops.LAUNCHES, da_ops.APPEND_LAUNCHES, er_ops.LAUNCHES,
                sc_ops.LAUNCHES)
    saved = [c.count for c in counters]
    try:
        return fn()
    finally:
        for c, n in zip(counters, saved):
            c.count = n


def check_step_logits(eng, params) -> dict:
    """One decode step of the engine's cache with the kernels against the
    same step with plain attention on the card: finite logits, max abs
    error under 0.5, greedy tokens equal on every active slot whose top-2
    gap exceeds 4x that error.  Neither step is kept."""
    import torch
    from repro_torch.serving.kv_cache import tiered_decode_step
    toks = eng._current_tokens()
    active = [i for i, r in enumerate(eng.slots) if r is not None]
    got, _ = tiered_decode_step(eng.cfg, params, eng.cache, toks)
    want, _ = tiered_decode_step(eng.cfg, params, eng.cache, toks,
                                 attend=_plain_attend)
    torch.cuda.synchronize()
    got, want = got[active].float(), want[active].float()
    err = float((got - want).abs().max())
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 4 * err
    same = torch.argmax(got, -1) == torch.argmax(want, -1)
    assert torch.isfinite(got).all() and err < 0.5, err
    assert bool(same[clear].all()), (same, clear)
    return {"err": err, "greedy_equal": int(same.all()),
            "compared": f"{int(clear.sum())}/{len(active)}"}


def check_run_slabs(cache) -> None:
    """``stream_copy`` at the serving run-slab shape, on real pool views:
    (L, 8 pages x page_t x K x hd) rows a pool layer apart, HBM pool ->
    pinned staging (the retile's route) and pinned pool -> HBM, bit-equal
    to the plain copy; then the first route's time."""
    import torch
    from repro_torch.kernels.stream_copy import ops, ref
    dev = cache.k_parts[0].device
    for d, out_mem in ((0, {"pin_memory": True}), (1, {"device": dev})):
        slab = cache._run_slab(cache.k_parts, d, 3, 0, 8)
        out = torch.empty(slab.shape, dtype=slab.dtype, **out_mem)
        ops.stream_copy(slab, out=out, device=dev)
        want = ref.stream_copy(slab)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu().view(torch.int16),
                           want.cpu().view(torch.int16)), d
    slab = cache._run_slab(cache.k_parts, 0, 3, 0, 8)
    out = torch.empty(slab.shape, dtype=slab.dtype, pin_memory=True)
    ms = time_ms(lambda: ops.stream_copy(slab, out=out, device=dev),
                 queue_ahead=True)
    nbytes = slab.numel() * slab.element_size()
    log(f"phase6/run_slab,shape={tuple(slab.shape)},row_stride="
        f"{slab.stride(0)},routes=hbm->pinned;pinned->hbm,bit_exact=1,"
        f"bytes={nbytes},hbm_to_pinned_ms={ms:.4f},"
        f"GBps={nbytes / (ms * 1e-3) / 1e9:.2f},"
        f"bound_ms={nbytes / PCIE_BW * 1e3:.4f}")


def fill_rows(gen, L: int, K: int, hd: int):
    """Slot by slot, the K and V rows the walk's slots are filled with."""
    import torch
    for _ in range(SERVE_B):
        yield [torch.randn((L, SERVE_VALID, K, hd), generator=gen,
                           device=DEVICE).to(torch.bfloat16)
               for _ in range(2)]


def read_back(cache, L: int, K: int, hd: int) -> int:
    """Every slot's written rows gathered through its page map, from
    whichever pool holds each page now, bit-equal to what was written
    (the fill's generator replayed).  Returns how many of the written
    pages lie in the pinned pool."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    for i, (k_rows, v_rows) in enumerate(fill_rows(gen, L, K, hd)):
        k_got, v_got = cache.gather_token_rows(i, 0, SERVE_VALID)
        assert torch.equal(k_got, k_rows) and torch.equal(v_got, v_rows), i
    return int((cache._host_dev()[:, :SERVE_VALID // SERVE_PAGE] != 0).sum())


WALK_EPOCHS = 12


def phase_serving(stats: dict, profile: bool) -> dict:
    """starcoder2-3b at full width and depth behind the tiered KV cache."""
    import numpy as np
    import torch
    from repro_torch.core import (BulkMover, CaptionArbiter, budgeted_config,
                                  h100_topology, stream_executor)
    from repro_torch.core.donation import FULL_SHARD_COPIES
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.stream_copy import ops as sc_ops
    from repro_torch.models import registry
    from repro_torch.serving.engine import ServingEngine
    dev = torch.device(DEVICE)
    arch = registry.get("starcoder2-3b")
    cfg = arch.cfg
    t0 = time.perf_counter()
    params = arch.module.init(cfg, torch.Generator(device=dev).manual_seed(0),
                              device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"phase6/model,arch={cfg.name},layers={cfg.n_layers},"
        f"d_model={cfg.d_model},heads={cfg.n_heads}/{cfg.n_kv_heads},"
        f"params={n_params},init_s={time.perf_counter() - t0:.2f}")
    topo = h100_topology()
    caption = serve_caption(cfg, topo)
    arbiter = CaptionArbiter(topo, budgeted_config(topo, 0.0))
    mover = BulkMover(topo, execute=stream_executor(), device=dev)
    try:
        eng = ServingEngine(cfg, params, max_batch=SERVE_B, max_len=SERVE_T,
                            page_t=SERVE_PAGE, topology=topo, caption=caption,
                            arbiter=arbiter, mover=mover, device=dev)
        cache = eng.cache
        # phase 5 checked the pinned pool's partition at this length
        assert cache.k_parts[1].shape[2] == stats["t_slow"], (
            cache.k_parts[1].shape, stats["t_slow"])
        log(f"phase6/pools,hbm_bytes={2 * cache.k_parts[0].numel() * 2},"
            f"pinned_bytes={2 * cache.k_parts[1].numel() * 2},"
            f"headroom_pages={cache.slow_headroom},"
            f"pinned={int(cache.k_parts[1].is_pinned())},"
            f"boundedness={caption.boundedness.value}")
        rng = np.random.default_rng(0)
        t0 = time.perf_counter()
        for _ in range(8):
            eng.submit(rng.integers(0, cfg.vocab, size=16).tolist(),
                       max_new_tokens=32)
        for _ in range(16):
            eng.step()
        # one step held against plain attention, on the same cache
        first = check_step_logits(eng, params)
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        answered = time.perf_counter() - t0
        assert len(done) == 8 and all(len(r.generated) == 32 for r in done)
        log(f"phase6/answer,requests={len(done)},new_tokens=32,"
            f"seconds={answered:.2f},logits_max_abs_err={first['err']:.4g},"
            f"greedy_equal={first['greedy_equal']},greedy_compared="
            f"{first['compared']},"
            f"slow_fraction={eng.cache.slow_fraction():.4f}")

        # long context: every slot filled to 3072 positions, then the walk
        steps = 8 * WALK_EPOCHS
        for _ in range(SERVE_B):
            eng.submit([int(rng.integers(0, cfg.vocab))],
                       max_new_tokens=steps + 32)
        eng.step()  # admits all 16
        while eng._steps % caption.cfg.epoch_steps:
            eng.step()  # so that each window below is one Caption epoch
        L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
        gen = torch.Generator(device=dev).manual_seed(1)
        for i, rows in enumerate(fill_rows(gen, L, K, hd)):
            eng.cache = eng.cache.write_token_rows(i, 0, *rows)
        torch.cuda.synchronize()
        cache = eng.cache
        ptrs = [p.data_ptr() for p in cache.k_parts + cache.v_parts]
        page_b = cache._page_kv_bytes()
        kv_read = 2 * L * SERVE_B * SERVE_VALID * K * hd * 2
        log(f"phase6/filled,slots={SERVE_B},positions={SERVE_VALID},"
            f"kv_bytes_per_step={kv_read},weight_bytes={n_params * 2}")
        check_run_slabs(cache)
        # the context grew 200x: the walk re-opens on the new workload
        caption.reopen("long-context decode")
        FULL_SHARD_COPIES.reset()
        da_ops.LAUNCHES.reset()
        da_ops.APPEND_LAUNCHES.reset()
        sc_ops.LAUNCHES.reset()
        slow_check = None
        for epoch in range(WALK_EPOCHS):
            dev_before = eng.cache._host_dev().copy()
            b0 = mover.bytes_submitted
            modeled_s = 0.0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(8):
                modeled_s += eng.modeled_step_seconds()
                assert eng.step() == SERVE_B
            end.record()
            end.synchronize()
            measured = SERVE_B * 8 / (start.elapsed_time(end) * 1e-3)
            delta = int((eng.cache._host_dev() != dev_before).sum())
            billed = mover.bytes_submitted - b0
            assert billed == delta * page_b, (billed, delta, page_b)
            f = eng.cache.slow_fraction()
            log(f"phase6/walk/epoch{epoch:02d},tokens_per_s={measured:.1f},"
                f"modeled_tokens_per_s={SERVE_B * 8 / modeled_s:.1f},"
                f"slow_fraction={f:.4f},delta_pages={delta},billed={billed},"
                f"decode_attention_launches={da_ops.LAUNCHES.count},"
                f"stream_copy_launches={sc_ops.LAUNCHES.count},"
                f"phase={caption.phase.value}")
            if slow_check is None and f > 0:
                # the first epoch that leaves pages in the pinned pool:
                # the next step, kernels against plain attention, and the
                # written rows read back
                slow_check = uncounted(lambda: check_step_logits(eng, params))
                slow_check.update(
                    where=f"walk_epoch{epoch:02d}", slow_fraction=f,
                    pinned_pages=uncounted(lambda: read_back(eng.cache, L, K,
                                                             hd)))
        launches = {"decode_attention": da_ops.LAUNCHES.count,
                    "kv_append": da_ops.APPEND_LAUNCHES.count,
                    "stream_copy": sc_ops.LAUNCHES.count}
        cache = eng.cache
        assert [p.data_ptr() for p in cache.k_parts + cache.v_parts] == ptrs
        assert FULL_SHARD_COPIES.count == 0, FULL_SHARD_COPIES.count
        assert eng.decode_traces == 1, eng.decode_traces
        for name, count in launches.items():
            assert count > 0, f"{name} was never launched on the serving path"
        lengths = cache.lengths.cpu()
        assert int(lengths.min()) == SERVE_VALID + steps, lengths
        log(f"phase6/walk/final,epochs={WALK_EPOCHS},"
            f"slow_fraction={cache.slow_fraction():.4f},"
            f"data_ptr_same=1,full_shard_copies=0,decode_traces=1,"
            f"launches={launches}")
        if slow_check is None:
            # the walk never left pages slow at an epoch's end: move 5%
            # there (donated, through the mover) and check that step
            eng.cache = eng.cache.repartition_fraction(0.05, mover=mover,
                                                       donate=True)
            f = eng.cache.slow_fraction()
            assert f > 0, f
            slow_check = check_step_logits(eng, params)
            slow_check.update(where="after_walk", slow_fraction=f,
                              pinned_pages=read_back(eng.cache, L, K, hd))
        log(f"phase6/slow_step_check,where={slow_check['where']},"
            f"slow_fraction={slow_check['slow_fraction']:.4f},"
            f"logits_max_abs_err={slow_check['err']:.4g},"
            f"greedy_equal={slow_check['greedy_equal']},"
            f"greedy_compared={slow_check['compared']},kv_read_back_bit_equal"
            f"=1,written_pages_in_pinned_pool={slow_check['pinned_pages']}")
        # and once more where the walk left the pages
        assert [p.data_ptr() for p in eng.cache.k_parts
                + eng.cache.v_parts] == ptrs
        slow_pages = read_back(eng.cache, L, K, hd)
        log(f"phase6/kv_read_back,slots={SERVE_B},positions={SERVE_VALID},"
            f"bit_equal=1,written_pages_in_pinned_pool={slow_pages}")
        if profile:
            profile_steps(eng)
    finally:
        mover.close()
    return {"launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--rows-log2", type=int, default=25,
                    help="table rows as a power of two (default 25: 8 GiB)")
    ap.add_argument("--sweep", action="store_true",
                    help="after the walk, measure bags/s at fixed fractions")
    ap.add_argument("--profile", action="store_true",
                    help="after the serving walk, profile a few decode "
                         "steps (device time by kernel, host time by "
                         "function)")
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
    phase_decode_attention(stats)
    serve = phase_serving(stats, args.profile)
    da = stats["da"]
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
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:65",
         "launches": serve["launches"]["decode_attention"],
         "max_abs_err": da["err"], "ms": da["ms"], "plain_ms": da["plain_ms"],
         "bound_ms": da["bound_ms"], "bound_by": "bytes",
         "library_ms": da["library_ms"]},
    ]
    print(card["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
