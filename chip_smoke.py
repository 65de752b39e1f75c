#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py            # the slices, the figures, MEMO
    python3 chip_smoke.py --full-gates   # and the full-size hot-path and
                                         # serving gates

It needs a CUDA card and the checkout's ``src/`` beside it, and fails
(non-zero exit, no result line) otherwise.  Phases, each raising on a
wrong result or a missing kernel launch:

1. device: card name and power limit; build the five CUDA kernels from
   ``src/repro_torch/csrc`` (one ``nvcc`` each, in parallel); fail if
   ``-Xptxas -v`` reports a spill in any of them.
2. ``embedding_reduce`` against its plain version: fp32 and bf16 tables in
   HBM and in pinned host memory, int32 and int64 indices, duplicate
   indices, zero weights, the scalar path, column tiles, bags longer than
   the staging area; its routed form (one launch per ``bag_reduce``)
   against the per-shard path of table-form launches, bit for bit: two
   and three shards (HBM + pinned, one drained), both dtypes, negative and
   out-of-range rows, given weights or none.
3. ``stream_copy`` against its plain version: the ragged row sweep on the
   HBM->HBM, pinned->HBM and HBM->pinned routes, with both casts, on
   contiguous slabs and on row-strided 2-D views (one-segment launches);
   the segment-list form, one launch for segments of 4 B to 4 MiB
   (ragged, unaligned, row-strided, a repeated row) on all four routes
   (pinned->pinned too) and all dtype pairs; then per route a 256 KiB
   and a 256 MiB slab and a walk-shaped move (8192 runs of 256 KiB from
   scattered places, one launch against 8192 one-segment launches), each
   beside ``copy_`` and its byte bound.
4. the slice: a 2^25 x 64 fp32 embedding table (8 GiB) paged with
   ``page_rows=64`` over an HBM shard and a pinned host shard; both
   forms of ``embedding_reduce`` timed against their plain versions,
   ``embedding_bag`` and their byte bounds; an actuation audit (0 -> 0.25
   -> 0.10 -> 0 slow, donated, through
   ``BulkMover(execute=stream_executor())``; each move's ``stream_copy``
   launches at most one a batch of 16 descriptors plus one landing), with
   the routed form timed against the per-shard path at each step;
   membind-fast bags/s, device
   busy share and host time per ``bag_reduce`` call; then a Caption walk
   from 0% slow on measured bag throughput (an epoch's signal: the median
   of five windows, the collector paused).  Kernel launch counts are
   reset right before the walk and read right after it;
   ``embedding_reduce``'s must equal the walk's ``bag_reduce`` calls and
   ``stream_copy``'s stay within the same bound summed over its moves.
   Then a static sweep measures bags/s at 0-0.25 slow and at the walk's
   landing point, and prints fig11's three bounds against it as values
   (landing within 0.05 of the best static fraction, at least
   membind-fast, at least 0.95 of the best static rate).
5. ``decode_attention`` against its plain version, both forms, fp32 and
   bf16, K/V in HBM and in pinned host memory, ragged lengths (1 and T),
   a fully masked partition row, stablelm-12b's head dim 160,
   recurrentgemma-9b's 16 x 1 heads of 256 (with its 2048-position
   window as the mask), deepseek-moe-16b's 16 x 16 heads of 128 (one
   query head a KV head) over 1024 positions; an fp32 q that bf16 cannot hold over bf16 K/V
   (held to 2e-5); valid tiles only at the end of T; the append scatter
   likewise; then the partial form's time at the serving shape against
   its plain version, ``scaled_dot_product_attention`` (timed only) and
   its byte bound, and the pinned pool's rate.
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
7. ``wkv6`` against its plain version: the shapes of the reference's
   kernel tests in fp32, T = 1 and T = 1000, the rwkv slice's prefill
   shape (16 x 1024 x 64 heads x 64, bf16 r/k/v, fp32 w, nonzero u and
   starting state) and decode shape (T = 1), the ring's ragged last chunk
   (T = 15, 17, 33) and the model's decay distribution (w = exp(-exp(x)),
   x in [-6, 3]) at head dims 16, 32 and 64 in fp32 and bf16, views that
   are not 16-byte aligned, inputs in pinned host memory, the state
   carried across two calls, ``state_out`` aliasing ``state``; then its
   time at both shapes against its plain version and its byte bound,
   with the blocks an SM holds.
8. the rwkv slice: rwkv6-7b at full width and depth, bf16, random weights
   from a seeded generator; the recurrent state placed by the planner
   (pinned to HBM).  A prefill of 16 prompts of 1024 tokens, then 64
   greedy decode steps over the recurrent state, with counts reset right
   before and read right after (32 x 65 ``wkv6`` launches).  The prefill's
   last logits and one decode step are held against the same with the
   plain recurrence, and a decode replay of 8 tokens against ``forward``
   over the prompt and those tokens.  ``--profile`` also profiles a few of
   its decode steps.

9. the figures: the port's figure scripts (``repro_torch.benchmarks``) on
   the card at the reference's sizes, each asserting the reference's
   claims: fig2-fig5 (their measured rows through ``memo_probe`` and
   ``stream_copy`` on HBM; fig2's chase over a 256 MiB single cycle),
   fig6 (its engine rows decoding through ``decode_attention``), the
   examples ``quickstart`` (a chase, the planner, one routed
   ``embedding_reduce`` launch held to the dense sum) and
   ``serve_tiered_kv`` (four serving runs), fig8 (its measured row one routed ``embedding_reduce`` launch
   over an HBM and a pinned shard, held to the dense sum), fig10 (its
   actuation through ``stream_copy`` over an HBM and two pinned shards),
   fig11 (its audit through the default mover's ``stream_copy``, within
   the launch bound, and one shard binding across its walk), fig11's
   control plane (smoke), ``bench_hotpaths`` (smoke, with its speedup
   gates), ``bench_serving`` (smoke: tokens equal across the four
   modes, ``decode_attention`` every decode step), ``bench_hotness``
   (smoke: its five sections over an HBM and three pinned shards) and
   the ``dlrm_embedding`` example, and ``fig_elastic`` (full: the
   controller timeline, then internvl2-2b ``.tiny()`` losing ``cxl-c``
   mid-decode, its drain through ``stream_copy``, the tokens equal to a
   run with no kill); fig8's semantic section runs with fig8.  Prints
   every row,
   each script's seconds and launches, and the phase's launches by
   kernel.
10. MEMO: each ``memo_probe`` entry point against its plain version on
   HBM and on pinned host memory, bit-equal; then, counts reset just
   before and read just after, ``memo.calibrate`` of both tiers: load and
   store over 1-528 lanes and a ``stream_copy`` into the tier on a 1 GiB
   buffer, random 1-64 KiB blocks and a single-cycle chase over 256 MiB
   tables, every record and the fitted ``TierSpec`` fields printed; then
   each entry point against its plain version again, bit-equal, at the
   shapes the calibration and fig2 gave it, on both memories; then
   ``seq_load``'s time at 528 lanes over 1 GiB beside its plain version
   and byte bound, its outputs compared too.
11. semantic DLRM: the DLRM slice's table (2^25 x 64 fp32, one key a
   page) on ``h100_topology()`` with HBM holding 0.10 of the pages, Zipf
   (1.1) traffic over a random key permutation.  Counts reset just
   before and read just after: the lookups feed a ``HotnessLedger``,
   the blind placement's bags/s, one semantic ``retier`` through the
   mover (bag sums bit-equal, promoted pages > 0, ``stream_copy``
   launches within one a batch of 16 descriptors plus one), the
   semantic placement's bags/s (must beat blind), then a
   ``HotSetCoordinator`` walk on measured bags/s with a hot-set flip
   once it converged (must re-open and converge again).
   ``embedding_reduce`` launches must equal the ``bag_reduce`` calls.
12. MoE: deepseek-moe-16b at full width and depth, bf16, random weights
   from a seeded generator.  Counts reset just before and read just
   after: a prefill of 8 prompts of 512 tokens
   (``forward_with_aux(last_only=True)``), then 32 greedy
   ``decode_step``s over ``init_cache(8, 1024)`` (exactly 28 x 32
   ``decode_attention`` launches).  One decode step is held against the
   plain attention and a decode replay of 8 tokens against ``forward``;
   the prefill's ``expert_counts`` feed a ``HotnessLedger`` that
   re-tiers unit 0's expert up-projections (64 x 2048 x 1408 bf16) as a
   ``SemanticTensor`` over HBM and pinned memory, its ``to_array()`` and
   the logits rebuilt from it bit-equal to the originals.
13. training: starcoder2-3b at full width and depth, bf16, random
   weights from a seeded generator, ``TokenPipeline(seed=17)``, batch 8 x
   seq 128 (the reference driver's defaults).  The planner's
   optimizer-state split on ``h100_topology()``; 4 fused AdamW steps
   with remat (losses finite, step ms, peak HBM); one gradient fed to
   ``adamw.apply`` and to ``TieredAdamW(slow_fraction=0.25)`` (one
   stacked MLP leaf, 1080 pages of pinned fp32 state): new parameters
   within one bf16 spacing past lr x 2^-10 (the fused update clips in
   bf16, which moves a first step's g / (|g| + eps) by <= 2^-10), the pinned
   master cast to bf16 equal to the new parameter, the step's
   ``stream_copy`` launches, counted from 0 around it, equal to one a
   page load plus one a writeback run of 8, ``offload_bytes`` the
   reference's formula; a repartition 0.25 -> 0 -> 0.25 through
   ``BulkMover(execute=stream_executor())``, the state bit-equal, billed
   bytes equal to ``caption.opt_bytes_{down,up}``, two launches a
   descriptor at most; the tiered step's times (without and with a
   mover), paging GB/s against the PCIe byte bound and the pinned tier's
   modeled rate, the device-busy share, host pinned bytes; then
   ``train.main`` at starcoder2-3b ``.tiny()`` (fp32) on the card and on
   the CPU from the same weights, 12 steps, fused and ``--offload-fraction
   0.5 --caption``: losses within 1e-4, Caption decisions identical.
14. families: recurrentgemma-9b (38 layers, 16 x 256 heads on one KV
   head, a 2048-row ring) and whisper-large-v3 (32 + 32 layers, 1500
   encoder frames) at full size, bf16, random weights.  Counts reset
   just before and read just after 64 greedy decode steps at batch 8
   (``decode_attention`` 12 a step for recurrentgemma, one an attention
   unit; 64 for whisper, its self- and cross-attention); whisper's
   encode of 8 x 1500 frames and ``prepare_cross`` first.  Tokens/s and
   a step's busy share; a step against plain attention; an fp32 cut (1
   unit + 1 tail layer; 2 encoder + 2 decoder layers) replayed against
   its forward within the reference test's 5e-3; the kernel at the full
   ring shape against its plain version.  Training: whisper-large-v3 at
   full size through ``train.main`` with fused AdamW (batch 8 x 128
   and its frames: step ms, peak HBM, the loss on batch 0 lower after a
   step on it); ``loss_and_grad`` ms at full width of rwkv6-7b (2
   layers), deepseek-moe-16b (the dense layer and one MoE unit) and
   recurrentgemma-9b (1 unit + 1 tail); rwkv's fp32 gradients through
   the kernel against the plain recurrence's, ``wkv6`` launched once a
   layer in the forward, the recomputing backward's ms; the tiny driver
   on the card against the CPU for the four families; and
   ``examples/train_tiny_lm`` at its defaults (the loss falls).
15. the elastic runtime: (a) internvl2-2b at full size, bf16, random
   weights, a ``ServingEngine`` of 8 slots x 4096 positions in pages of
   64 over HBM and three pinned pools, each its own device
   (``host-a/b/c``, policy (5, 1, 1, 1)), Caption + arbiter + a
   ``BulkMover`` on ``stream_copy``; 8 requests of 2048-token prompts
   (their K/V from the full-sequence forward), 64 new tokens each, slot 0
   at the latency SLO.  A ``HeartbeatMonitor`` and a ``FaultInjector``
   beat every step; ``host-c`` dies after step 16 and is drained through
   ``remove_device(monitor=)``: billed bytes equal to its pages x the
   page's KV bytes, no page left on it, slot 0 all in HBM, ``stream_copy``
   launches (from 0 around the drain) within one a route-pure batch of
   16 descriptors plus one landing, the next step against plain attention,
   every slot's prompt rows read back bit-equal; then revive, re-add and
   one more request.  ``decode_attention`` launches equal one a layer and
   pool every step; tokens equal a run with no kill up to a request's
   first difference, which must be a token whose top-2 gap is within 4x
   the measured logit error.  (b) starcoder2-3b at full width, 2 layers,
   fused AdamW, batch 8 x 128: two uninterrupted stretches agree to the
   bit, then three ``ResilientLoop`` runs of 6 steps from one state
   (uninterrupted; a worker killed at step 3 with checkpoints every 2; a
   failure at step 1 before any checkpoint) end in states and losses
   equal to the bit; checkpoint save and restore seconds and GB/s.
16. the pod-lowering tooling: ``launch/dryrun.lower_cell`` traces (fake
   tensors, in parallel worker processes, before any card work) the
   cells of the four timed steps and ``test_dryrun_machinery_small_mesh``'s
   (internvl2-2b, 512 x 8, n_micro 2) against the card's memory: FLOPs,
   eager bytes, argument and activation peak bytes, ``peak_per_device``
   and ``fits_hbm`` beside ``total_memory``.  Then the steps of
   ``launch/steps.py`` at full size, timed with CUDA events and the host
   clock after one untimed step: (a) starcoder2-3b ``make_train_step``,
   batch 8 x 128, fused AdamW, n_micro 1 and 2 from one state over two
   steps (losses within 5e-3, then 1e-2; gradient norms within 1e-2
   relative; the parameters' changes from the start apart by under lr/10
   on average and a tenth of their L2; the first step's RMS change within
   (lr/4, 2 lr)); (b) whisper-large-v3 ``make_train_step`` at 8 x 128
   and its 1500 frames;
   (c) starcoder2-3b ``make_serve_step`` over a bf16 16 x 4096 cache
   filled to 3072 positions, 16 steps with counts from 0 (exactly 30 x 16
   ``decode_attention`` launches), then a step against plain attention;
   (d) rwkv6-7b ``make_prefill_step`` at 16 x 1024 without the chunked
   policy (exactly 32 ``wkv6`` launches), its logits against the forward
   with every layer's kernel call held to the plain recurrence.  Each
   step beside its record's roofline terms (compute, memory, tier, the
   dominant one), ``mfu`` (model FLOPs over the time at 989 TFLOP/s) and
   ``x_bound`` (the time over the largest term); (a) and (b) print the
   dry run's ``peak_per_device`` beside ``max_memory_allocated``.
17. the routed form's staged path as the DLRM benchmark cells call it:
   ``InterleavedTensor.bag_reduce`` on their table (2^27 x 64 fp32, one
   page in ten in HBM, a 28.8 GiB pinned shard) with batches of 8,192 x
   80 int32 rows, uniform (the uniform cell) and with 8.2% of the lookups
   pinned (the Zipf cell's share).  Counts reset just before and read just
   after four calls: six launches and one staged call each.  The sums are
   held bit for bit against the one-launch kernel and the plain routed
   version (pinned shard copied to the card); the staged path's time
   beside the one-launch kernel's, the plain version's and a bound of
   the pinned rows at the SM read rate of a sequential pinned range
   (``stream_copy``, measured here) against the rest at HBM's rate; the
   pinned lookups per 64 KiB of the pinned span.
``--full-gates`` then runs ``bench_hotpaths`` (4096 pages, the
repartition timed the reference's one-pass way) and ``bench_serving``
at full size, with their gates.

Prints the card line, per-phase lines, a ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import gc
import json
import re
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


def copy_ms(dst, src, iters: int = 20) -> float:
    """``dst.copy_(src)``'s time: CUDA events with the card queued ahead,
    or the host's clock when both sides are host memory (``copy_`` then
    runs on the CPU, where the events see nothing)."""
    if dst.is_cuda or src.is_cuda:
        return time_ms(lambda: dst.copy_(src), iters=iters, warmup=1,
                       queue_ahead=True)
    dst.copy_(src)
    t0 = time.perf_counter()
    for _ in range(iters):
        dst.copy_(src)
    return (time.perf_counter() - t0) / iters * 1e3


def phase_device() -> dict:
    import torch
    from repro_torch.kernels import common
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    uuid = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid", "--format=csv,noheader"],
        capture_output=True, text=True)
    log(f"gpu_uuid={uuid.stdout.strip() or 'not read'}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices={torch.cuda.device_count()}")
    t0 = time.perf_counter()
    logs = common.build()
    build_s = time.perf_counter() - t0
    spills = []
    for kname, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas[{kname}] {line.strip()}")
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                              line)
            if found and found.groups() != ("0", "0"):
                spills.append(f"{kname}: {line.strip()}")
    log(f"phase1/build,seconds={build_s:.2f},built={sorted(logs)},"
        f"spilling_kernels={len(spills)}")
    if spills:
        raise RuntimeError("kernels spill registers: " + "; ".join(spills))
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


def kernels_per_call(fn) -> int:
    """Device kernels one ``fn()`` launches, from a profiled call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA)


def _pinned(t):
    return t.cpu().pin_memory()


def phase_embedding_reduce(stats: dict) -> None:
    """Kernel == plain version on the card: dtypes x memories x cases; the
    routed form == the per-shard kernel path; the pinned row rate."""
    import torch
    from repro_torch.kernels.embedding_reduce import kernel, ops, ref
    from repro_torch.kernels.stream_copy.kernel import pointer_info
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for mem in ("hbm", "pinned"):
            for V, D, B, K in ((4096, 64, 256, 80), (300, 24, 17, 5),
                               (64, 512, 3, 33), (1000, 64, 9, 600)):
                table = torch.randn((V, D), generator=g).to(dtype)
                idx = torch.randint(0, V, (B, K), generator=g)
                idx[:, 1] = idx[:, 0]  # duplicate lookups
                w = torch.rand((B, K), generator=g).to(dtype)
                w[:, ::7] = 0  # rows of zero weight: no load, exact +0
                tab = table.to(dev) if mem == "hbm" else _pinned(table)
                if mem == "pinned":
                    kind, dptr = pointer_info(tab)
                    assert kind == 1 and dptr == tab.data_ptr(), (kind, dptr)
                want = ref.embedding_reduce(table.to(dev), idx.to(dev),
                                            w.to(dev))
                for idt in (torch.int32, torch.int64):  # read as given
                    got = kernel.embedding_reduce(tab, idx.to(dev, idt),
                                                  w.to(dev), dev)
                    torch.cuda.synchronize()
                    err = float((got.float() - want.float()).abs().max())
                    if dtype == torch.float32:
                        assert torch.equal(got, want), (mem, V, D, B, K, err)
                    else:
                        torch.testing.assert_close(got.float(), want.float(),
                                                   **BF16_TOL)
                    worst = max(worst, err)
                log(f"phase2/embedding_reduce/{str(dtype)[6:]}/{mem}/"
                    f"V{V}xD{D}xB{B}xK{K},int32_int64,max_abs_err={err:.3g}")
    routed_cases(g)
    # random-row read rate of a pinned host table over PCIe (UVA reads)
    V = 1 << 22
    table = torch.randint(-8, 9, (V, DIM), dtype=torch.float32, generator=g)
    tab = _pinned(table)
    idx = torch.randint(0, V, (BAG, LOOKUPS), generator=g).to(dev)
    w = torch.ones((BAG, LOOKUPS), device=dev)
    ms = time_ms(lambda: ops.embedding_reduce(tab, idx, w), iters=10,
                 queue_ahead=True)
    rate = BAG * LOOKUPS * DIM * 4 / (ms * 1e-3)
    log(f"phase2/embedding_reduce/pinned_random_rows,ms={ms:.4f},"
        f"rows_GBps={rate / 1e9:.2f}")
    stats["pinned_row_GBps"] = rate / 1e9
    stats["embedding_reduce_err"] = worst
    ops.LAUNCHES.reset()


def routed_cases(g) -> None:
    """The routed form (one launch per ``bag_reduce``) against the
    per-shard path of table-form launches, bit for bit: two and three
    shards (HBM + pinned), a drained shard, both dtypes, the vector and
    the scalar path, int32 and int64 indices with negative and
    out-of-range rows, given weights or none."""
    import torch
    from repro_torch.core import InterleavedTensor, MemPolicy
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.kernels.embedding_reduce import ops
    dev = torch.device("cuda")
    three = ("fast", "cxl-a", "cxl-b")
    cases = ((("fast", "slow"), (3, 1), None, 64), (three, (4, 2, 2), None, 64),
             (three, (4, 2, 2), "cxl-a", 64), (three, (2, 1, 1), None, 24))
    for dtype in (torch.float32, torch.bfloat16):
        for names, weights, drained, D in cases:
            rows, page_rows = 64 * 257, 64
            table = torch.randn((rows, D), generator=g).to(dtype)
            it = InterleavedTensor.from_array(
                table, MemPolicy.weighted(names, weights), page_rows,
                headroom=64, device=dev)
            if drained:
                it = it.drain_device(drained, telemetry=Telemetry(),
                                     donate=True)
            assert all(p.is_pinned() for p in it.parts[1:])
            idx = torch.randint(-3 * page_rows, rows + 3 * page_rows,
                                (256, 80), generator=g)
            idx[:, 1] = idx[:, 0]
            w = torch.rand((256, 80), generator=g)
            w[:, ::7] = 0
            for wts in (w.to(dev, dtype), None):
                for idt in (torch.int32, torch.int64):
                    ix = idx.to(dev, idt)
                    before = ops.LAUNCHES.count
                    got = it.bag_reduce(ix, wts)
                    assert ops.LAUNCHES.count == before + 1
                    want = it.bag_reduce(ix, wts,
                                         reduce_fn=ops.embedding_reduce)
                    torch.cuda.synchronize()
                    assert torch.equal(got, want), (names, drained, dtype)
            log(f"phase2/bag_reduce_routed/{str(dtype)[6:]}/"
                f"shards{len(it.parts)}{'_drained' if drained else ''}/D{D},"
                f"slow_pages={it.valid_page_counts()[1:]},"
                f"equal_to_per_shard_kernels=1,launches_per_call=1")


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
    seg_sweep(g, casts)
    # route rates on a 256 MiB slab (kernel vs copy_), and the slice's run
    # slab (16 pages x 64 rows x 64 fp32 = 256 KiB), one-segment launches
    for rname, (smem, dmem) in ROUTES4.items():
        for rows in (1 << 20, 16 * PAGE_ROWS):
            host = torch.randn((rows, DIM), generator=g)
            src = _place(host, smem)
            out = _place(torch.empty(src.shape), dmem)
            ops.stream_copy(src, out=out)  # the timed slab, checked first
            torch.cuda.synchronize()
            got = out.cpu()
            worst = max(worst, float((got - host).abs().max()))
            assert torch.equal(got, ref.stream_copy(host)), (rname, rows)
            nbytes = src.numel() * 4
            k_ms = time_ms(lambda: ops.stream_copy(src, out=out), queue_ahead=True)
            lib_ms = copy_ms(out, src)
            # the plain version, then the move into the destination memory
            # (host work for a pinned source: timed with the host's gaps)
            p_ms = time_ms(lambda: out.copy_(ref.stream_copy(src)))
            bound = copy_bound(rname, nbytes)
            log(f"phase3/stream_copy/{rname}/rows{rows},bytes={nbytes},"
                f"ms={k_ms:.4f},plain_ms={p_ms:.4f},copy_ms={lib_ms:.4f},"
                f"bound_ms={bound:.4f},"
                f"GBps={nbytes / (k_ms * 1e-3) / 1e9:.2f}")
            stats[f"copy/{rname}/{rows}"] = (k_ms, p_ms, lib_ms, bound,
                                              nbytes)
    walk_moves(stats, g)
    stats["stream_copy_err"] = worst
    ops.LAUNCHES.reset()


#: the four routes of the segment-list sweep and the timed copies
ROUTES4 = {"hbm->hbm": ("hbm", "hbm"), "pinned->hbm": ("pinned", "hbm"),
           "hbm->pinned": ("hbm", "pinned"),
           "pinned->pinned": ("pinned", "pinned")}
RUN_BYTES = 16 * PAGE_ROWS * DIM * 4  # a DLRM walk's run: 256 KiB
WALK_RUNS = 8192  # runs in a walk-shaped move: 2 GiB, the audit's first


def _place(t, mem: str):
    return t.to("cuda") if mem == "hbm" else t.pin_memory()


def copy_bound(route: str, nbytes: int) -> float:
    """ms: each byte read once and written once, over PCIe when either
    side is pinned host memory (one direction each way), else over HBM."""
    if route == "hbm->hbm":
        return 2 * nbytes / HBM_BW * 1e3
    return nbytes / PCIE_BW * 1e3


def seg_list():
    """Segments of 1 element (4 B fp32) to 2^20 elements (4 MiB fp32),
    back to back with gaps: aligned, ragged, unaligned on either side,
    row-strided (aligned and not), one row repeated (source stride 0) and
    a contiguous multi-row block.  Returns (source elements, destination
    elements, segments)."""
    import numpy as np
    #: (rows, cols, source pad, destination pad, source extra stride,
    #: destination extra stride); a source extra stride of -1 repeats
    #: one row
    specs = [(1, 4, 0, 0, 0, 0), (1, 1, 1, 3, 0, 0), (1, 17, 3, 0, 0, 0),
             (1, 1000, 0, 0, 0, 0), (30, 1000, 0, 0, 32, 40),
             (30, 1000, 1, 1, 3, 5), (5, 4, 0, 0, -1, 4),
             (1, 4096, 0, 0, 0, 0), (1, 65539, 4, 0, 0, 0),
             (1, 262144, 0, 0, 0, 0), (1, 1048576, 0, 2, 0, 0),
             (64, 4096, 0, 0, 0, 0)]
    segs, s, d = [], 0, 0
    for rows, cols, sp, dp, se, de in specs:
        ss = 0 if se < 0 else cols + se
        ds = cols + de
        segs.append((0, s + sp, ss, 0, d + dp, ds, rows, cols))
        s += sp + (cols if ss == 0 else rows * ss) + 8
        d += dp + rows * ds + 8
        s, d = -(-s // 16) * 16, -(-d // 16) * 16
    return s, d, np.array(segs, np.int64)


def seg_sweep(g, casts) -> None:
    """The segment-list form: one launch moves the whole list, on every
    route and dtype pair, bit-exact against the plain version, nothing
    outside the segments written."""
    import torch
    from repro_torch.kernels.stream_copy import ops, ref
    n_src, n_dst, segs = seg_list()
    n = 0
    for rname, (smem, dmem) in ROUTES4.items():
        for sdt, odt in casts:
            out_dt = odt or sdt
            host = torch.randn(n_src, generator=g).to(sdt)
            want = torch.full((n_dst,), -7.0, dtype=out_dt)
            ref.stream_copy_segments([host], [want], segs)
            dst = _place(torch.full((n_dst,), -7.0, dtype=out_dt), dmem)
            before = ops.LAUNCHES.count
            ops.stream_copy_segments([_place(host, smem)], [dst], segs)
            torch.cuda.synchronize()
            assert ops.LAUNCHES.count == before + 1, rname
            assert torch.equal(dst.cpu(), want), (rname, sdt, odt)
            n += 1
    log(f"phase3/stream_copy/segment_sweep,cases={n},segments={len(segs)},"
        f"smallest_bytes=4,largest_bytes={4 << 20},bit_exact=1,"
        f"max_abs_err=0.0")


def walk_moves(stats: dict, g) -> None:
    """A walk-shaped move on each route: 8192 runs of 256 KiB read from
    scattered places into one 2 GiB buffer, as one segment-list launch and
    as 8192 one-segment launches, with ``copy_`` of the same bytes as one
    contiguous slab beside them; the HBM -> pinned move (a move's landing
    into the slow shard) also against the plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels.stream_copy import ops, ref
    run = RUN_BYTES // 4
    elems = WALK_RUNS * run
    nbytes = elems * 4
    mem = {"hbm": [torch.empty(elems, device="cuda") for _ in range(2)],
           "pinned": [torch.empty(elems, pin_memory=True) for _ in range(2)]}
    mem["hbm"][0].uniform_(generator=None)
    mem["pinned"][0].copy_(mem["hbm"][0])
    perm = np.random.default_rng(3).permutation(WALK_RUNS)
    segs = np.zeros((WALK_RUNS, 8), np.int64)
    segs[:, 1] = perm * run
    segs[:, 4] = np.arange(WALK_RUNS) * run
    segs[:, [2, 5, 7]] = run
    segs[:, 6] = 1
    for rname, (smem, dmem) in ROUTES4.items():
        src, dst = mem[smem][0], mem[dmem][1]
        views = [(src[p * run:(p + 1) * run], dst[i * run:(i + 1) * run])
                 for i, p in enumerate(perm.tolist())]
        dst.zero_()
        ops.stream_copy_segments([src], [dst], segs)
        torch.cuda.synchronize()
        k = torch.from_numpy(perm) if smem == "pinned" else torch.as_tensor(
            perm, device="cuda")
        want = src.view(WALK_RUNS, run).index_select(0, k)
        assert torch.equal(dst.view(WALK_RUNS, run).to(want.device), want), \
            rname
        del want
        k_ms = time_ms(lambda: ops.stream_copy_segments([src], [dst], segs),
                       iters=5, warmup=1, queue_ahead=True)

        def many():
            for s_, d_ in views:
                ops.stream_copy(s_, out=d_)

        m_ms = time_ms(many, iters=2, warmup=1, queue_ahead=True)
        lib_ms = copy_ms(dst, src, iters=5)
        bound = copy_bound(rname, nbytes)
        p_ms = None
        if rname == "hbm->pinned":
            p_ms = time_ms(lambda: ref.stream_copy_segments([src], [dst],
                                                            segs),
                           iters=1, warmup=0)
        log(f"phase3/stream_copy/{rname}/walk_{WALK_RUNS}x256KiB,"
            f"bytes={nbytes},ms={k_ms:.4f},launches=1,"
            f"one_segment_launches_ms={m_ms:.4f},copy_ms={lib_ms:.4f},"
            f"bound_ms={bound:.4f},GBps={nbytes / (k_ms * 1e-3) / 1e9:.2f}"
            + (f",plain_ms={p_ms:.4f}" if p_ms is not None else ""))
        stats[f"walk/{rname}"] = (k_ms, p_ms, lib_ms, bound, nbytes, m_ms)
    del mem
    torch.cuda.empty_cache()


#: ``InterleavedTensor.bag_reduce`` calls made through ``bags``
BAG_CALLS = 0


def bags(it, batches) -> list:
    """One ``it.bag_reduce`` per batch, counted in ``BAG_CALLS``."""
    global BAG_CALLS
    BAG_CALLS += len(batches)
    return [it.bag_reduce(b) for b in batches]


#: windows of an epoch's signal (their median counts)
EPOCH_WINDOWS = 5


def epoch_rate(it, batches) -> float:
    """Bags/s of one epoch of ``it.bag_reduce``: ``EPOCH_WINDOWS`` windows
    of 8 x ``len(batches)`` calls with the garbage collector paused, as
    ``bench_hotpaths`` times its passes, and their median, so a window
    stalled by the shared host does not steer the walk."""
    from repro_torch.benchmarks.common import gc_paused
    rates = []
    with gc_paused():
        for _ in range(EPOCH_WINDOWS):
            ms = time_ms(lambda: bags(it, batches), iters=8, warmup=1)
            rates.append(BAG * len(batches) / (ms * 1e-3))
    return sorted(rates)[EPOCH_WINDOWS // 2]


def host_cost(it, batches, reps: int = 8) -> dict:
    """Host time per ``bag_reduce`` call: the enqueue time while the card
    sleeps (uninstrumented), and the call's cumulative time under
    cProfile over ``reps`` epochs with the functions of most own time;
    and the device kernels one call runs."""
    import cProfile
    import pstats
    import torch
    bags(it, batches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bags(it, batches)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2 * (time.perf_counter() - t0) * 2e9))
    t0 = time.perf_counter()
    bags(it, batches)
    host_us = (time.perf_counter() - t0) / len(batches) * 1e6
    torch.cuda.synchronize()
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(reps):
        bags(it, batches)
    pr.disable()
    torch.cuda.synchronize()
    stats = pstats.Stats(pr).stats
    calls = reps * len(batches)
    cprof_us = next(ct / nc * 1e6 for (fname, _, func), (_, nc, _, ct, _)
                    in stats.items() if func == "bag_reduce"
                    and fname.endswith("interleave.py"))
    top = sorted(((func, tt / calls * 1e6) for (_, _, func), (_, _, tt, _, _)
                  in stats.items()), key=lambda x: -x[1])[:8]
    return {"host_us": host_us, "cprofile_us": cprof_us, "top": top,
            "kernels": kernels_per_call(lambda: it.bag_reduce(batches[0]))}


def routed_vs_per_shard(it, idx, label: str) -> dict:
    """The routed launch against the per-shard path (one table-form launch
    per shard and the eager routing around them) on one batch: equal bits,
    device times with the card queued ahead, and the routed form's bound:
    HBM rows, indices and page maps over HBM's rate against the pinned
    rows over PCIe's, whichever is longer."""
    import torch
    from repro_torch.kernels.embedding_reduce import ops as er_ops

    def routed():
        return it.bag_reduce(idx)

    def per_shard():
        return it.bag_reduce(idx, reduce_fn=er_ops.embedding_reduce)

    assert torch.equal(routed(), per_shard()), label
    r_ms = time_ms(routed, queue_ahead=True)
    s_ms = time_ms(per_shard, queue_ahead=True)
    dev, _ = it._route(idx)
    n = idx.numel()
    n_slow = int((dev >= 1).sum())
    hbm = (n - n_slow) * DIM * 4 + n * (8 + 1 + 8) + idx.shape[0] * DIM * 4
    pcie = n_slow * DIM * 4
    bound = max(hbm / HBM_BW, pcie / PCIE_BW) * 1e3
    log(f"phase4/{label}/routed_vs_per_shard,slow_lookups={n_slow},"
        f"routed_ms={r_ms:.4f},per_shard_ms={s_ms:.4f},"
        f"bound_ms={bound:.4f},hbm_bytes={hbm},pcie_bytes={pcie},"
        f"bit_equal=1")
    return {"routed_ms": r_ms, "per_shard_ms": s_ms, "bound_ms": bound}


def phase_slice(stats: dict, rows_log2: int) -> dict:
    global BAG_CALLS
    import torch
    from repro_torch.core import (BulkMover, CaptionConfig, CaptionController,
                                  EpochMetrics, InterleavedTensor, MemPolicy,
                                  h100_topology, stream_executor)
    from repro_torch.benchmarks.common import launch_bound
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

    # both forms vs plain vs library at the slice's shapes (fast shard,
    # f=0: local row == logical row)
    fast_part = it.parts[0]
    idx64 = batches[0]  # the main path's indices: int64, read as given
    idx0 = idx64.to(torch.int32)
    got = er_ops.embedding_reduce(fast_part, idx0, ones)
    plain = er_ref.embedding_reduce(fast_part, idx0, ones)
    lib = torch.nn.functional.embedding_bag(idx64, fast_part, mode="sum",
                                            per_sample_weights=ones)
    torch.cuda.synchronize()
    assert torch.equal(got, plain) and torch.equal(want[0], plain)
    assert torch.equal(er_ops.embedding_reduce(fast_part, idx64, ones), plain)
    er_err = float((got - plain).abs().max())
    k_ms = time_ms(lambda: er_ops.embedding_reduce(fast_part, idx0, ones),
                   queue_ahead=True)
    k64_ms = time_ms(lambda: er_ops.embedding_reduce(fast_part, idx64, ones),
                     queue_ahead=True)
    p_ms = time_ms(lambda: er_ref.embedding_reduce(fast_part, idx0, ones),
                   iters=5, queue_ahead=True)
    l_ms = time_ms(lambda: torch.nn.functional.embedding_bag(
        idx64, fast_part, mode="sum", per_sample_weights=ones),
        queue_ahead=True)
    k_host_ms = time_ms(lambda: er_ops.embedding_reduce(fast_part, idx0,
                                                        ones))
    # rows, int32 indices and fp32 weights read once; the output written
    nbytes = (BAG * LOOKUPS * (DIM * 4 + 4 + 4) + BAG * DIM * 4)
    flops = 2 * BAG * LOOKUPS * DIM
    er_bound = max(nbytes / HBM_BW, flops / FP32_FLOPS) * 1e3
    log(f"phase4/embedding_reduce/hbm,ms={k_ms:.4f},ms_int64={k64_ms:.4f},"
        f"plain_ms={p_ms:.4f},library_ms={l_ms:.4f},bound_ms={er_bound:.4f},"
        f"bytes={nbytes},bound_share={er_bound / k_ms:.3f},"
        f"ms_with_host_gaps={k_host_ms:.4f},"
        f"library_max_abs_err={float((lib - plain).abs().max()):.3g},"
        f"rows_GBps={BAG * LOOKUPS * DIM * 4 / (k_ms * 1e-3) / 1e9:.2f}")
    # the routed form as the main path calls it: int64 global rows, no
    # weights; the plain routed version over the fast shard alone (at f=0
    # it owns every page)
    pd, pl = it.page_device, it.page_local
    r_plain = er_ref.bag_reduce_routed((fast_part,), pd, pl, PAGE_ROWS, idx64)
    assert torch.equal(it.bag_reduce(idx64), r_plain)
    r_ms = time_ms(lambda: it.bag_reduce(idx64), queue_ahead=True)
    rp_ms = time_ms(lambda: er_ref.bag_reduce_routed(
        (fast_part,), pd, pl, PAGE_ROWS, idx64), iters=5, queue_ahead=True)
    rl_ms = time_ms(lambda: torch.nn.functional.embedding_bag(
        idx64, fast_part, mode="sum"), queue_ahead=True)
    # rows, int64 indices, one int8 and one int64 map entry per lookup
    # read once; the output written
    r_bytes = BAG * LOOKUPS * (DIM * 4 + 8 + 1 + 8) + BAG * DIM * 4
    r_bound = max(r_bytes / HBM_BW, flops / FP32_FLOPS) * 1e3
    log(f"phase4/bag_reduce_routed/f0.00,ms={r_ms:.4f},plain_ms={rp_ms:.4f},"
        f"library_ms={rl_ms:.4f},bound_ms={r_bound:.4f},bytes={r_bytes},"
        f"bound_share={r_bound / r_ms:.3f},max_abs_err=0")

    # actuation audit (fig11_caption.py:262-299 on the card)
    page_bytes = PAGE_ROWS * it.row_bytes
    ptrs = [p.data_ptr() for p in it.parts]
    tel = Telemetry()
    forms = {}
    FULL_SHARD_COPIES.reset()
    with BulkMover(topo, batch_size=16, telemetry=tel,
                   execute=stream_executor(), device=dev) as mover:
        for f in (0.25, 0.10, 0.0):
            before_slow = int(round(it.slow_fraction() * it.n_pages))
            b0, d0 = mover.bytes_submitted, mover.descriptors_submitted
            sc_ops.LAUNCHES.reset()
            t0 = time.perf_counter()
            it = it.repartition_fraction(f, mover=mover, fast_tier=fast,
                                         slow_tier=slow, donate=True)
            torch.cuda.synchronize()
            act_s = time.perf_counter() - t0
            sc_launches = sc_ops.LAUNCHES.reset()
            delta = abs(int(round(it.slow_fraction() * it.n_pages))
                        - before_slow)
            billed = mover.bytes_submitted - b0
            descs = mover.descriptors_submitted - d0
            assert delta > 0 and billed == delta * page_bytes, (billed, delta)
            assert descs < delta, (descs, delta)
            # one gather launch per batch of 16 descriptors, one landing
            assert 0 < sc_launches <= launch_bound([descs]), (sc_launches,
                                                            descs)
            for b, w in zip(batches, want):
                assert torch.equal(it.bag_reduce(b), w), f
            forms[f] = routed_vs_per_shard(it, batches[0], f"audit/f{f:.2f}")
            assert [p.data_ptr() for p in it.parts] == ptrs
            assert FULL_SHARD_COPIES.count == 0
            log(f"phase4/audit/f{f:.2f},delta_pages={delta},billed={billed},"
                f"descriptors={descs},stream_copy_launches={sc_launches},"
                f"launch_bound={launch_bound([descs])},seconds={act_s:.3f},"
                f"GBps={billed / act_s / 1e9:.2f},bags_bit_equal=1,"
                f"data_ptr_same=1,full_shard_copies=0")

        # membind-fast reference and the measured Caption walk
        membind = epoch_rate(it, batches)
        busy = device_busy_share(lambda: bags(it, batches))
        host = host_cost(it, batches)
        log(f"phase4/membind_fast,bags_per_s={membind:.0f},"
            f"device_busy_share={busy},"
            f"host_us_per_bag_reduce={host['host_us']:.1f},"
            f"cprofile_us_per_bag_reduce={host['cprofile_us']:.1f},"
            f"kernels_per_bag_reduce={host['kernels']}")
        ctl = CaptionController(topo, cfg, initial_fraction=0.0)
        BAG_CALLS = 0
        er_ops.LAUNCHES.reset()
        sc_ops.LAUNCHES.reset()
        trajectory = []
        walk_bound = 0
        for epoch in range(48):
            rate = epoch_rate(it, batches)
            d = ctl.observe(EpochMetrics(throughput=rate))
            d0 = mover.descriptors_submitted
            t0 = time.perf_counter()
            it = it.repartition_fraction(d.fraction, mover=mover,
                                         fast_tier=fast, slow_tier=slow,
                                         donate=True)
            torch.cuda.synchronize()
            walk_bound += launch_bound([mover.descriptors_submitted - d0])
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
        calls = BAG_CALLS
    assert launches["embedding_reduce"] == calls, (launches, calls)
    assert launches["stream_copy"] <= walk_bound, (launches, walk_bound)
    for b, w in zip(batches, want):
        assert torch.equal(it.bag_reduce(b), w)
    assert [p.data_ptr() for p in it.parts] == ptrs
    final = epoch_rate(it, batches)
    log(f"phase4/walk/final,f={it.slow_fraction():.4f},converged="
        f"{int(ctl.converged)},epochs={len(trajectory)},"
        f"bags_per_s={final:.0f},membind_bags_per_s={membind:.0f},"
        f"launches={launches},bag_reduce_calls={calls},"
        f"stream_copy_launch_bound={walk_bound}")
    for name, count in launches.items():
        assert count > 0, f"{name} was never launched on the main path"
    bounds = sweep_fractions(it, batches, want, it.slow_fraction())
    run = stats["walk/hbm->pinned"]
    slab = stats[f"copy/hbm->pinned/{16 * PAGE_ROWS}"]
    return {
        "launches": launches,
        "fig11_bounds": bounds,
        "er": {"ms": r_ms, "plain_ms": rp_ms, "library_ms": rl_ms,
               "bound_ms": r_bound, "table_ms": k_ms,
               "table_bound_ms": er_bound, "table_library_ms": l_ms,
               "routed_f010_ms": forms[0.10]["routed_ms"],
               "per_shard_f010_ms": forms[0.10]["per_shard_ms"],
               "err": max(er_err, stats["embedding_reduce_err"])},
        "sc": {"ms": run[0], "plain_ms": run[1], "library_ms": run[2],
               "bound_ms": run[3], "nbytes": run[4],
               "one_segment_launches_ms": run[5],
               "slab_256KiB": {"ms": slab[0], "plain_ms": slab[1],
                               "library_ms": slab[2], "bound_ms": slab[3]},
               "err": stats["stream_copy_err"]},
    }


#: phase 4's static sweep of slow fractions (fig11's bounds are read
#: against it)
SWEEP = (0.0, 0.05, 0.10, 0.15, 0.20, 0.25)


def sweep_fractions(it, batches, want, landed: float) -> dict:
    """Bags/s at fixed slow fractions and at the walk's landing point,
    measured one after another; then fig11's three bounds
    (``benchmarks/fig11_caption.py:117-119``) read against the sweep, as
    values.  Moves without a mover (``stream_copy`` on the current
    stream)."""
    import torch
    from repro_torch.core import h100_topology
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.kernels.stream_copy import ops as sc_ops
    topo = h100_topology()
    fast, slow = topo.fast.name, topo.slow.name
    sweep = {}
    sc_ops.LAUNCHES.reset()
    for f in sorted(set(SWEEP) | {landed}):
        it = it.repartition_fraction(f, fast_tier=fast, slow_tier=slow,
                                     telemetry=Telemetry(), donate=True)
        sweep[f] = epoch_rate(it, batches)
        log(f"phase4/sweep/f{f:.6f},bags_per_s={sweep[f]:.0f}"
            + (",walk_landing=1" if f == landed else ""))
    moves = sc_ops.LAUNCHES.reset()
    assert moves > 0, "the sweep's page moves did not launch stream_copy"
    for b, w in zip(batches, want):
        assert torch.equal(it.bag_reduce(b), w)
    static = {f: r for f, r in sweep.items() if f in SWEEP}
    best = max(static, key=static.get)
    land, membind = sweep[landed], sweep[0.0]
    bounds = {"landed_f": landed, "best_static_f": best,
              "landing_gap": abs(landed - best),
              "landing_bags_per_s": land, "membind_bags_per_s": membind,
              "best_static_bags_per_s": static[best],
              "landing_share_of_best": land / static[best]}
    log(f"phase4/sweep/best,f={best:.2f},bags_per_s={static[best]:.0f},"
        f"stream_copy_launches={moves}")
    log(f"phase4/fig11_bounds,landed_f={landed:.4f},best_static_f={best:.2f},"
        f"landing_gap={bounds['landing_gap']:.4f},"
        f"gap_within_0.05={int(bounds['landing_gap'] <= 0.05)},"
        f"landing_bags_per_s={land:.0f},membind_bags_per_s={membind:.0f},"
        f"landing_at_least_membind={int(land >= membind)},"
        f"best_static_bags_per_s={static[best]:.0f},"
        f"landing_share_of_best={bounds['landing_share_of_best']:.4f},"
        f"share_at_least_0.95={int(bounds['landing_share_of_best'] >= 0.95)}")
    return bounds


#: phase 17: the DLRM benchmark cells' table (cxlbench/configs/
#: dlrm-merci-hbm10.json: 2^27 rows of 64 fp32, one page in ten in HBM)
#: and batch (8,192 bags of 80 lookups)
CELL_ROWS_LOG2, CELL_BAGS, CELL_HBM_PAGES = 27, 8192, (1, 9)
#: the Zipf cell's share of lookups in pinned memory (1 - its
#: hbm_lookup_share, 0.918 in the benchmark's ledger)
SPARSE_PINNED_SHARE = 0.082


def staged_batch(it, pinned_share: float | None, gen):
    """A cell-shaped batch of int32 global rows (as the benchmark draws
    them): uniform over the table when ``pinned_share`` is None, else that
    share of the lookups uniform over the pinned pages and the rest over
    the HBM pages."""
    import torch
    dev = it.page_device.device
    shape = (CELL_BAGS, LOOKUPS)
    if pinned_share is None:
        return torch.randint(0, it.n_pages * PAGE_ROWS, shape, generator=gen,
                             device=dev, dtype=torch.int32)
    pages = [torch.nonzero(it.page_device == d).flatten() for d in (0, 1)]
    pinned = torch.rand(shape, generator=gen, device=dev) < pinned_share
    pick = [p[torch.randint(0, p.numel(), shape, generator=gen, device=dev)]
            for p in pages]
    page = torch.where(pinned, pick[1], pick[0])
    within = torch.randint(0, PAGE_ROWS, shape, generator=gen, device=dev)
    return (page * PAGE_ROWS + within).to(torch.int32)


def phase_staged() -> dict:
    """Phase 17: the routed form's staged path as the DLRM cells call it,
    through ``InterleavedTensor.bag_reduce`` on the cells' table (28.8 GiB
    pinned shard) and batch shape."""
    import torch
    from repro_torch.core import InterleavedTensor, MemPolicy, h100_topology
    from repro_torch.kernels.embedding_reduce import kernel, ops, ref
    from repro_torch.kernels.stream_copy import ops as sc_ops
    dev = torch.device("cuda")
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()  # pinned blocks cached by earlier phases
    topo = h100_topology()
    gen = torch.Generator(device=dev).manual_seed(17)
    t0 = time.perf_counter()
    table = torch.randn((1 << CELL_ROWS_LOG2, DIM), generator=gen,
                        device=dev)
    it = InterleavedTensor.from_array(
        table, MemPolicy.weighted((topo.fast.name, topo.slow.name),
                                  CELL_HBM_PAGES), PAGE_ROWS, device=dev)
    del table
    torch.cuda.synchronize()
    fast_part, slow_part = it.parts
    assert fast_part.is_cuda and slow_part.is_pinned()
    row_bytes = DIM * 4
    span = slow_part.shape[0] * row_bytes
    log(f"phase17/table,rows={1 << CELL_ROWS_LOG2},pinned_bytes={span},"
        f"hbm_bytes={fast_part.numel() * 4},"
        f"build_s={time.perf_counter() - t0:.2f}")
    # the plain routed version over both shards on the card
    slow_card = slow_part.to(dev)
    pd, pl = it.page_device, it.page_local
    n = CELL_BAGS * LOOKUPS
    assert kernel.stages([False, True], n, 4)
    # the SM read rate of a sequential pinned range (stream_copy)
    seq_rows = n
    seq_dst = torch.empty((seq_rows, DIM), device=dev)
    seq_src = slow_part[slow_part.shape[0] // 2:][:seq_rows]
    seq_ms = time_ms(lambda: sc_ops.stream_copy(seq_src, out=seq_dst),
                     iters=10, queue_ahead=True)
    seq_rate = seq_rows * row_bytes / (seq_ms * 1e-3)
    log(f"phase17/pinned_sequential,bytes={seq_rows * row_bytes},"
        f"ms={seq_ms:.4f},GBps={seq_rate / 1e9:.2f}")
    del seq_dst
    out = {}
    for label, share in (("uniform", None), ("sparse", SPARSE_PINNED_SHARE)):
        batches = [staged_batch(it, share, gen) for _ in range(4)]
        n_pin = int((pd[batches[0].long() // PAGE_ROWS] == 1).sum())
        want = [ref.bag_reduce_routed((fast_part, slow_card), pd, pl,
                                      PAGE_ROWS, b) for b in batches]
        ops.LAUNCHES.reset()
        ops.STAGED.reset()
        got = [it.bag_reduce(b) for b in batches]
        torch.cuda.synchronize()
        launches, staged = ops.LAUNCHES.reset(), ops.STAGED.reset()
        assert staged == len(batches), (label, staged)
        assert launches == kernel.STAGED_KERNELS * len(batches), launches
        threshold = kernel.STAGE_MIN_LOOKUPS
        kernel.STAGE_MIN_LOOKUPS = kernel.MAX_ROWS
        try:
            one = [it.bag_reduce(b) for b in batches]
            torch.cuda.synchronize()
            assert ops.LAUNCHES.reset() == len(batches)
            assert ops.STAGED.reset() == 0
            one_ms = time_ms(lambda: it.bag_reduce(batches[0]), iters=10,
                             queue_ahead=True)
        finally:
            kernel.STAGE_MIN_LOOKUPS = threshold
        for g_, o_, w_ in zip(got, one, want):
            assert torch.equal(g_, o_) and torch.equal(g_, w_), label
        ms = time_ms(lambda: it.bag_reduce(batches[0]), iters=10,
                     queue_ahead=True)
        p_ms = time_ms(lambda: ref.bag_reduce_routed(
            (fast_part, slow_card), pd, pl, PAGE_ROWS, batches[0]), iters=3,
            warmup=1, queue_ahead=True)
        # pinned rows at the sequential SM rate against HBM rows, int32
        # indices, one int8 and one int64 map entry a lookup and the output
        # at HBM's rate, whichever is longer
        pcie = n_pin * row_bytes
        hbm = ((n - n_pin) * row_bytes + n * (4 + 1 + 8)
               + CELL_BAGS * row_bytes)
        bound = max(pcie / seq_rate, hbm / HBM_BW) * 1e3
        per_64k = n_pin / (span / 65536)
        log(f"phase17/staged/{label},lookups={n},pinned_lookups={n_pin},"
            f"pinned_lookups_per_64KiB={per_64k:.4f},ms={ms:.4f},"
            f"one_launch_ms={one_ms:.4f},plain_ms={p_ms:.4f},"
            f"bound_ms={bound:.4f},bound_share={bound / ms:.3f},"
            f"pinned_GBps={pcie / (ms * 1e-3) / 1e9:.2f},"
            f"one_launch_pinned_GBps={pcie / (one_ms * 1e-3) / 1e9:.2f},"
            f"launches_per_call={launches // len(batches)},"
            f"staged_calls={staged},bit_equal_one_launch=1,bit_equal_plain=1")
        out[label] = {"ms": ms, "one_launch_ms": one_ms, "plain_ms": p_ms,
                      "bound_ms": bound, "launches": launches,
                      "staged_calls": staged,
                      "pinned_lookups_per_64KiB": per_64k}
        del batches, want, got, one
    del it, fast_part, slow_part, slow_card
    gc.collect()
    torch.cuda.empty_cache()
    if hasattr(torch._C, "_host_emptyCache"):
        torch._C._host_emptyCache()
    return out


DA_SWEEP =((2, 8, 2, 32, 128), (1, 4, 4, 64, 256), (3, 8, 1, 16, 64),
            (2, 16, 16, 32, 128))  # tests/test_kernels.py:76-78
SERVE_B, SERVE_T, SERVE_VALID, SERVE_PAGE = 16, 4096, 3072, 64
SERVE_H, SERVE_K, SERVE_HD = 24, 2, 128  # starcoder2-3b
DEVICE = "cuda"


def _plain_attend(q, k, v, valid):
    """The plain partial form on the card (pinned K/V copied over first)."""
    from repro_torch.kernels.decode_attention import ref
    return ref.attend_partial(q, k.to(q.device), v.to(q.device),
                              valid.to(q.device))


def compare_partials(got, want, rows, tol: float, rtol: float) -> float:
    """Hold a partial triple ``got`` = (acc, m, l) to ``want`` on ``rows``
    (the rows with a valid position): acc, l and the normalised result to
    atol ``tol`` and ``rtol``, m to ``tol`` both ways; ``got``'s fully
    masked rows to (0, -1e30, 0).  Returns the max abs error."""
    import torch
    from repro_torch.kernels.decode_attention import ref
    (acc, m, l), (ra, rm, rl) = got, want
    err = max([0.0] + [float((x - y)[rows].abs().max())
                       for x, y in ((acc, ra), (m, rm), (l, rl))
                       if bool(rows.any())])
    torch.testing.assert_close(acc[rows], ra[rows], atol=tol, rtol=rtol)
    torch.testing.assert_close(m[rows], rm[rows], atol=tol, rtol=tol)
    torch.testing.assert_close(l[rows], rl[rows], atol=tol, rtol=rtol)
    assert bool((m[~rows] == ref.NEG_INF).all()) and not l[~rows].any()
    merged_k = torch.where(rows[:, None, None],
                           acc / l.clamp_min(1e-30)[..., None], 0)
    merged_p = torch.where(rows[:, None, None],
                           ra / rl.clamp_min(1e-30)[..., None], 0)
    torch.testing.assert_close(merged_k, merged_p, atol=tol, rtol=rtol)
    return err


def check_partial(q, k, v, valid, tol: float, rtol: float = None) -> float:
    """The partial form through its wrapper against the plain version on
    the card (pinned K/V copied over for the plain side), held by
    :func:`compare_partials` (``rtol`` 10 ``tol`` unless given).  Returns
    the max abs error."""
    import torch
    from repro_torch.kernels.decode_attention import ops
    got = ops.attend_partial(q, k, v, valid)
    want = _plain_attend(q, k, v, valid)
    torch.cuda.synchronize()
    return compare_partials(got, want, valid.any(1), tol,
                            tol * 10 if rtol is None else rtol)


def check_both(q, k, v, lengths, valid, mem: str, tol: float) -> float:
    """Both forms through their wrappers, K/V in ``mem`` ("hbm" or
    "pinned"), against the plain versions on the card; max abs error."""
    import torch
    from repro_torch.kernels.decode_attention import ops, ref
    dev = torch.device(DEVICE)
    kk = k.to(dev) if mem == "hbm" else _pinned(k)
    vv = v.to(dev) if mem == "hbm" else _pinned(v)
    qd, ld, vd = q.to(dev), lengths.to(dev), valid.to(dev)
    got = ops.decode_attention(qd, kk, vv, ld)
    want = ref.decode_attention(qd, k.to(dev), v.to(dev), ld)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=tol, rtol=tol * 10)
    return max(float((got - want).abs().max()),
               check_partial(qd, kk, vv, vd, tol))


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
    shapes = DA_SWEEP + ((SERVE_B, SERVE_H, SERVE_K, SERVE_HD, 1024),
                         (2, 32, 8, 160, 256),  # stablelm-12b's heads
                         (2, 16, 1, 160, 96),  # hd 160 at 16 heads a group
                         (2, 16, 1, 256, 128),  # recurrentgemma-9b's heads
                         (4, 16, 1, 256, 1000),
                         (8, 16, 16, 128, 1024))  # deepseek-moe-16b: G = 1
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
                err = check_both(q, k, v, lengths, valid, mem, tol)
                worst = max(worst, err)
                n += 1
                log(f"phase5/decode_attention/{str(dtype)[6:]}/{mem}/"
                    f"B{B}xH{H}xK{K}xhd{hd}xT{T},max_abs_err={err:.3g}")
            # recurrentgemma-9b's local attention: 16 x 1 heads of 256, a
            # 2048-position window before each row's length as the mask
            B, H, K, hd, T, win = 4, 16, 1, 256, 4096, 2048
            q = torch.randn((B, H, hd), generator=g).to(dtype)
            k = torch.randn((B, T, K, hd), generator=g).to(dtype)
            v = torch.randn((B, T, K, hd), generator=g).to(dtype)
            lengths = torch.tensor([1, 1000, 2748, T])
            t = torch.arange(T)[None]
            valid = (t < lengths[:, None]) & (t >= lengths[:, None] - win)
            err = check_both(q, k, v, lengths, valid, mem, tol)
            worst = max(worst, err)
            n += 1
            log(f"phase5/decode_attention/{str(dtype)[6:]}/{mem}/window{win}"
                f"/B{B}xH{H}xK{K}xhd{hd}xT{T},max_abs_err={err:.3g}")
    # bf16 K/V with an fp32 q that bf16 cannot hold: the kernel splits q
    # and P into bf16 high and low halves.  Held to 2e-5 on the normalised
    # rows: the kernel reads a few 1e-6 there, while q rounded to bf16 or
    # P without its low half (tools/decode_attention_probe.py) land above.
    for B, H, K, hd, T in ((SERVE_B, SERVE_H, SERVE_K, SERVE_HD, 1024),
                           (2, 16, 1, 256, 512)):
        q = torch.randn((B, H, hd), generator=g).to(dev)
        assert not torch.equal(q, q.bfloat16().float())  # off the bf16 grid
        k, v = (torch.randn((B, T, K, hd), generator=g).to(
            dev, torch.bfloat16) for _ in range(2))
        lengths = torch.randint(1, T + 1, (B,), generator=g).to(dev)
        got = ops.decode_attention(q, k, v, lengths)
        want = ref.decode_attention(q, k, v, lengths)
        rounded = ref.decode_attention(q.bfloat16(), k, v, lengths)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        err_bf16_q = float((rounded - want).abs().max())
        assert err <= 2e-5 < err_bf16_q, (err, err_bf16_q)
        valid = (torch.rand((B, T), generator=g) < 0.6).to(dev)
        valid[0] = False
        err_partial = check_partial(q, k, v, valid, 2e-2)
        worst = max(worst, err, err_partial)
        n += 1
        log(f"phase5/decode_attention/fp32_q_bf16_kv/B{B}xH{H}xK{K}xhd{hd}"
            f"xT{T},normalised_err={err:.3g},held_to=2e-5,bf16_rounded_q_err="
            f"{err_bf16_q:.3g},partial_max_abs_err={err_partial:.3g}")
    # valid tiles only at the end of T: every split shares those few tiles
    B, H, K, hd, T = SERVE_B, SERVE_H, SERVE_K, SERVE_HD, SERVE_T
    q, k, v = (torch.randn(shape, generator=g).to(dev, torch.bfloat16)
               for shape in ((B, H, hd), (B, T, K, hd), (B, T, K, hd)))
    valid = torch.zeros((B, T), dtype=torch.bool)
    valid[:, T - 200:] = torch.rand((B, 200), generator=g) < 0.7
    valid[1] = False
    valid = valid.to(dev)
    err = check_partial(q, k, v, valid, 2e-2)
    worst = max(worst, err)
    n += 1
    tiles = int(valid.view(B, -1, kernel.TILE).any(-1).sum(1).max())
    log(f"phase5/decode_attention/bf16/hbm/tail_tiles/B{B}xT{T},valid_tiles="
        f"{tiles},splits={kernel.splits_for(B, K, T)},max_abs_err={err:.3g}")
    # long rows: hd 256 with an fp32 q (the bf16 body's largest shared
    # memory), one split a row, 1563 tiles a block (the kernel refills its
    # table every 32); K/V shared by every sequence (stride 0), so a few
    # rows are held against the plain version
    B, H, K, hd, T = 50, 16, 1, 256, 100_000
    q = torch.randn((B, H, hd), generator=g).to(dev)
    k1, v1 = (torch.randn((1, T, K, hd), generator=g).to(dev, torch.bfloat16)
              for _ in range(2))
    lengths = torch.randint(1, T + 1, (B,), generator=g).to(dev)
    lengths[0] = T
    # every fifth tile wholly masked: the table's refills skip them
    valid = ((torch.rand((B, T), generator=g) < 0.6)
             & (torch.arange(T) // kernel.TILE % 5 != 2)).to(dev)
    got = ops.decode_attention(q, k1.expand(B, T, K, hd),
                               v1.expand(B, T, K, hd), lengths)
    acc, m, l = ops.attend_partial(q, k1.expand(B, T, K, hd),
                                   v1.expand(B, T, K, hd), valid)
    err_n = err = 0.0
    for b in (0, 1, B - 1):
        row = slice(b, b + 1)
        want = ref.decode_attention(q[row], k1, v1, lengths[row])
        torch.testing.assert_close(got[row], want, atol=2e-5, rtol=2e-4)
        err_n = max(err_n, float((got[row] - want).abs().max()))
        for x, y, rtol in zip((acc, m, l), _plain_attend(
                q[row], k1, v1, valid[row]), (0.2, 2e-2, 0.2)):
            torch.testing.assert_close(x[row], y, atol=2e-2, rtol=rtol)
            err = max(err, float((x[row] - y).abs().max()))
    worst = max(worst, err, err_n)
    n += 1
    log(f"phase5/decode_attention/bf16/hbm/long_rows/B{B}xH{H}xK{K}xhd{hd}"
        f"xT{T},splits={kernel.splits_for(B, K, T)},normalised_err="
        f"{err_n:.3g},max_abs_err={err:.3g}")
    del q, k1, v1, got, acc, m, l
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
    # the HBM partition's rows read in place from pinned host memory
    kp, vp = _pinned(k.cpu()), _pinned(v.cpu())
    pin_ms = time_ms(lambda: ops.attend_partial(q, kp, vp, valid), iters=5,
                     queue_ahead=True)
    pin_gbps = kv_bytes / (pin_ms * 1e-3) / 1e9
    per_call = kernels_per_call(lambda: ops.attend_partial(q, k, v, valid))
    log(f"phase5/decode_attention/serving_shape,splits={splits},"
        f"launches_per_call={per_call},"
        f"ms={k_ms:.4f},plain_ms={p_ms:.4f},library_ms={l_ms:.4f},"
        f"bound_ms={bound:.4f},bytes={nbytes},"
        f"GBps={kv_bytes / (k_ms * 1e-3) / 1e9:.2f},"
        f"bound_share={bound / k_ms:.3f},pinned_GBps={pin_gbps:.2f},"
        f"max_abs_err={err:.3g}")
    log(f"phase5/decode_attention/pinned_pool,ms={pin_ms:.4f},"
        f"GBps={pin_gbps:.2f}")
    stats["da"] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                   "bound_ms": bound, "err": worst,
                   "pinned_GBps": pin_gbps}
    ops.LAUNCHES.reset()
    ops.APPEND_LAUNCHES.reset()


def profile_steps(step, label: str, n: int = 4) -> None:
    """Where a decode step's time goes: wall ms per ``step()``, the
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
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    step_ms = steps()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_ms = steps()
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in dev)
    log(f"{label}/profile,steps={n},step_ms={step_ms:.2f},"
        f"profiled_step_ms={prof_ms:.2f},"
        f"device_ms_per_step={busy_us / n / 1e3:.3f},"
        f"device_busy_share={busy_us / n / 1e3 / prof_ms:.3f}")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"{label}/profile/kernel,ms_per_step="
            f"{e.self_device_time_total / n / 1e3:.4f},"
            f"calls_per_step={e.count / n:.0f},name={e.key[:70]}")
    pr = cProfile.Profile()
    pr.enable()
    cprof_ms = steps()
    pr.disable()
    out = io.StringIO()
    pstats.Stats(pr, stream=out).sort_stats("tottime").print_stats(14)
    log(f"{label}/profile/host,cprofile_step_ms={cprof_ms:.2f}")
    for line in out.getvalue().splitlines():
        if line.strip()[:1].isdigit():
            log(f"{label}/profile/host," + " ".join(line.split()))


def uncounted(fn):
    """``fn()`` with every kernel's launch count put back after it: the
    launches a check makes against a plain version are not the main
    path's."""
    counters = tuple(launch_counts().values())
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
    from repro_torch.serving.kv_cache import tiered_decode_step
    toks = eng._current_tokens()
    active = [i for i, r in enumerate(eng.slots) if r is not None]
    got, _ = tiered_decode_step(eng.cfg, params, eng.cache, toks)
    want, _ = tiered_decode_step(eng.cfg, params, eng.cache, toks,
                                 attend=_plain_attend)
    return check_greedy(got[active], want[active], "serving step", 0.5)


def check_run_slabs(cache) -> None:
    """``stream_copy`` at the serving run-slab shape, on real pool views:
    (L, 8 pages x page_t x K x hd) rows a pool layer apart, HBM pool ->
    pinned staging (the retile's route) and pinned pool -> HBM, bit-equal
    to the plain copy; then the first route's time."""
    import torch
    from repro_torch.kernels.stream_copy import ops, ref
    dev = cache.k_parts[0].device
    for d, out_mem in ((0, {"pin_memory": True}), (1, {"device": dev})):
        slab = cache.k_parts[d][:, 3, :8 * cache.page_t].flatten(1)
        out = torch.empty(slab.shape, dtype=slab.dtype, **out_mem)
        ops.stream_copy(slab, out=out, device=dev)
        want = ref.stream_copy(slab)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu().view(torch.int16),
                           want.cpu().view(torch.int16)), d
    slab = cache.k_parts[0][:, 3, :8 * cache.page_t].flatten(1)
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
            f"arbiter_budget_Bps={arbiter.cfg.slow_bw_budget:.6g},"
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
            profile_steps(eng.step, "phase6")
    finally:
        mover.close()
    return {"launches": launches}


WKV_SWEEP = ((2, 64, 2, 16), (1, 128, 4, 32), (2, 32, 1, 64))  # tests/test_kernels.py:106-108
RWKV_B, RWKV_T, RWKV_STEPS, RWKV_REPLAY = 16, 1024, 64, 8
RWKV_H, RWKV_HD = 64, 64  # rwkv6-7b: d_model 4096 in heads of 64
#: fp32 logits of the rwkv slice against the plain recurrence and the
#: forward replay (other GEMM shapes): summation order through 32 layers
RWKV_FP32_BOUND = 1e-2
#: wkv6 against its plain version.  fp32 inputs: the reference's 1e-4.
#: bf16 r/k/v: both sides get the same bf16 values and compute in fp32,
#: so they differ by summation order only and the same tolerance holds.
WKV_TOL = dict(atol=1e-4, rtol=1e-5)


def _wkv_inputs(g, B, T, H, hd, rkv_dtype, decay: str = "reference"):
    """r, k, v, w, u, state on the card, drawn as the reference's kernel
    tests draw them (w in (0.5, 1)), with a nonzero u and starting state.
    ``decay="model"`` draws w as the model makes it, exp(-exp(x)), with x
    uniform in [-6, 3]: w from ~2e-9 (the state all but wiped in one
    step) to ~0.9975."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=g, device=DEVICE)

    r, k, v = ((randn(B, T, H, hd) * s).to(rkv_dtype) for s in (0.5, 0.5, 1))
    if decay == "model":
        x = torch.rand((B, T, H, hd), generator=g, device=DEVICE) * 9 - 6
        w = torch.exp(-torch.exp(x))
    else:
        w = torch.sigmoid(randn(B, T, H, hd)) * 0.5 + 0.5
    return r, k, v, w, randn(H, hd) * 0.1, randn(B, H, hd, hd) * 0.1


def check_wkv(r, k, v, w, u, s0, *, alias: bool = False) -> float:
    """``wkv6`` through its wrapper against the plain version on the card:
    y and the final state; with ``alias`` the state is updated in place.
    Returns the max abs error."""
    import torch
    from repro_torch.kernels.wkv6 import ops, ref
    state = s0.clone()
    y, s = ops.wkv6(r, k, v, w, u, state, state_out=state if alias else None)
    y_p, s_p = ref.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert (s is state) == alias
    torch.testing.assert_close(y, y_p, **WKV_TOL)
    torch.testing.assert_close(s, s_p, **WKV_TOL)
    return max(float((y - y_p).abs().max()), float((s - s_p).abs().max()))


def wkv_bound(r, w) -> tuple[float, str]:
    """The least time for one call (ms) and what sets it: r, k, v, w read
    and y written once, the state read and written once (u is
    negligible), over the HBM rate; or ~4 fp32 operations per
    (b, t, h, i, j) over the fp32 rate."""
    B, T, H, hd = r.shape
    n = B * T * H * hd
    nbytes = 3 * n * r.element_size() + n * w.element_size() + 4 * n \
        + 2 * B * H * hd * hd * 4
    by_bytes, by_ops = nbytes / HBM_BW, 4 * n * hd / FP32_FLOPS
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def phase_wkv6(stats: dict) -> None:
    """Kernel == plain version on every listed shape; then its time at the
    rwkv slice's prefill and decode shapes."""
    import torch
    from repro_torch.kernels.wkv6 import kernel, ops, ref
    g = torch.Generator(device=DEVICE).manual_seed(7)
    f32, bf16 = torch.float32, torch.bfloat16
    B, T, H, hd = RWKV_B, RWKV_T, RWKV_H, RWKV_HD
    ref_w, model_w = "reference", "model"
    cases = [(shape, f32, ref_w) for shape in WKV_SWEEP] + [
        ((2, 1, 4, 64), f32, ref_w), ((2, 1000, 4, 64), f32, ref_w),
        ((2, 1, 4, 64), bf16, ref_w), ((2, 1000, 4, 64), bf16, ref_w),
        ((B, T, H, hd), bf16, ref_w), ((B, 1, H, hd), bf16, ref_w)]
    # the ring's ragged last chunk (8 steps a chunk, two a pass in the
    # default build: T = 15, 17, 33 end 1, 2 and 4 chunks in, on an odd
    # step), and the model's decay distribution, at every head dim
    cases += [((2, t, 2, d), dtype, ref_w) for d in (16, 32, 64)
              for t in (15, 17, 33) for dtype in (f32, bf16)]
    cases += [((2, 37, 2, d), dtype, model_w) for d in (16, 32, 64)
              for dtype in (f32, bf16)]
    cases += [((B, T, H, hd), bf16, model_w)]
    worst = 0.0
    for shape, dtype, decay in cases:
        err = check_wkv(*_wkv_inputs(g, *shape, dtype, decay))
        worst = max(worst, err)
        log(f"phase7/wkv6/{str(dtype)[6:]}/B{shape[0]}xT{shape[1]}xH{shape[2]}"
            f"xhd{shape[3]},w={decay},max_abs_err={err:.3g}")
    # views that are not 16-byte aligned (r, k, v one element into a
    # wider buffer; w likewise): the ring copies them element by element
    for dtype in (f32, bf16):
        r, k, v, w, u, s0 = _wkv_inputs(g, 2, 33, 2, 64, dtype, model_w)
        wide = [torch.zeros((2, 33, 2, 66), dtype=a.dtype, device=DEVICE)
                for a in (r, k, v, w)]
        for buf, a in zip(wide, (r, k, v, w)):
            buf[..., 1:65] = a
        r, k, v, w = (buf[..., 1:65] for buf in wide)
        assert r.data_ptr() % 16 != 0
        err = check_wkv(r, k, v, w, u, s0)
        worst = max(worst, err)
        log(f"phase7/wkv6/unaligned/{str(dtype)[6:]}/B2xT33xH2xhd64,"
            f"max_abs_err={err:.3g}")
    # r, k, v, w in pinned host memory, read in place by the copies
    r, k, v, w, u, s0 = _wkv_inputs(g, 2, 33, 2, 64, bf16, model_w)
    y, s = ops.wkv6(*(_pinned(a) for a in (r, k, v, w)), u, s0)
    y_p, s_p = ref.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_p, **WKV_TOL)
    torch.testing.assert_close(s, s_p, **WKV_TOL)
    err = max(float((y - y_p).abs().max()), float((s - s_p).abs().max()))
    worst = max(worst, err)
    log(f"phase7/wkv6/pinned/bfloat16/B2xT33xH2xhd64,max_abs_err={err:.3g}")
    # the state carried across two calls (an odd split) against one call
    for shape, cut in (((1, 64, 2, 16), 32), ((B, T, H, hd), T // 2 + 1)):
        r, k, v, w, u, s0 = _wkv_inputs(g, *shape, bf16)
        y_a, s_a = ops.wkv6(r[:, :cut], k[:, :cut], v[:, :cut], w[:, :cut],
                            u, s0)
        y_b, s_b = ops.wkv6(r[:, cut:], k[:, cut:], v[:, cut:], w[:, cut:],
                            u, s_a, state_out=s_a)
        y_p, s_p = ref.wkv6(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        y = torch.cat([y_a, y_b], 1)
        torch.testing.assert_close(y, y_p, **WKV_TOL)
        torch.testing.assert_close(s_b, s_p, **WKV_TOL)
        err = max(float((y - y_p).abs().max()), float((s_b - s_p).abs().max()))
        worst = max(worst, err)
        log(f"phase7/wkv6/state_carry/B{shape[0]}xT{shape[1]}xH{shape[2]}"
            f"xhd{shape[3]},split={cut},max_abs_err={err:.3g}")
    # state_out aliasing state, at the decode and prefill shapes
    for t in (1, T):
        err = check_wkv(*_wkv_inputs(g, B, t, H, hd, bf16), alias=True)
        worst = max(worst, err)
        log(f"phase7/wkv6/alias/B{B}xT{t}xH{H}xhd{hd},max_abs_err={err:.3g}")
    per_sm = kernel.blocks_per_sm(bf16, f32, hd)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for t, label in ((T, "prefill"), (1, "decode")):
        # At T = 1 the state (16.8 MB in, 16.8 MB out) would stay in the
        # 50 MB L2 between back-to-back calls, where on the path a whole
        # step's weights pass between two calls of one layer: rotate
        # through four sets of inputs, 134 MB in all.
        sets = [_wkv_inputs(g, B, t, H, hd, bf16)
                for _ in range(1 if t > 1 else 4)]
        outs = [torch.empty_like(x[5]) for x in sets]
        turn = [0]

        def call(fn, **kw):
            i = turn[0] = (turn[0] + 1) % len(sets)
            return fn(*sets[i], **{k: v[i] for k, v in kw.items()})

        k_ms = time_ms(lambda: call(ops.wkv6, state_out=outs),
                       queue_ahead=True)
        p_ms = time_ms(lambda: call(ref.wkv6), iters=2 if t > 1 else 12,
                       warmup=1, queue_ahead=True)
        bound, bound_by = wkv_bound(sets[0][0], sets[0][3])
        if label == "prefill":  # the kernels line's shape
            stats["wkv"] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                            "bound_by": bound_by}
        log(f"phase7/wkv6/{label}_shape,B{B}xT{t}xH{H}xhd{hd},ms={k_ms:.4f},"
            f"plain_ms={p_ms:.4f},bound_ms={bound:.4f},bound_by={bound_by},"
            f"bound_share={bound / k_ms:.3f},library_ms=none,"
            f"blocks={B * H},resident_blocks_per_sm={per_sm},sms={sms}")
    log(f"phase7/wkv6/sweep,cases={len(cases) + 7},max_abs_err={worst:.3g}")
    stats["wkv"]["err"] = worst
    ops.LAUNCHES.reset()


def check_greedy(got, want, what: str, bound=None) -> dict:
    """Finite logits, max abs error under ``bound`` (when given), greedy
    tokens equal on every row whose top-2 gap (in ``want``) exceeds 4x
    that error."""
    import torch
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 4 * err
    same = torch.argmax(got, -1) == torch.argmax(want, -1)
    assert bool(torch.isfinite(got).all()), what
    assert bound is None or err < bound, (what, err, bound)
    assert bool(same[clear].all()), (what, same, clear)
    return {"err": err, "greedy_equal": int(same.all()),
            "compared": f"{int(clear.sum())}/{clear.numel()}",
            "logits_std": float(want.std())}


def checked_wkv(errors: list):
    """A ``wkv=`` function that runs the kernel and the plain version on
    the same inputs (the model's own, layer by layer), holds the kernel's
    y and state to the plain ones and passes the plain ones on.  Both sum
    in fp32 in other orders, so the tolerance is the fp32 one scaled by
    the largest magnitude; ``errors`` gets each call's largest error
    relative to that magnitude."""
    import torch
    from repro_torch.kernels.wkv6 import ops, ref

    def wkv(r, k, v, w, u, state, *, state_out=None):
        y, s = ops.wkv6(r, k, v, w, u, state)
        y_p, s_p = ref.wkv6(r, k, v, w, u, state, state_out=state_out)
        rel = 0.0
        for got, want in ((y, y_p), (s, s_p)):
            scale = max(1.0, float(want.abs().max()))
            torch.testing.assert_close(got, want, atol=1e-4 * scale,
                                       rtol=1e-5)
            rel = max(rel, float((got - want).abs().max()) / scale)
        errors.append(rel)
        return y_p, s_p

    return wkv


def place_rwkv_state(cfg, param_bytes: int):
    """The planner's placement of the slice's buffers on the card: the
    weights (hard-pinned: this slice serves them from HBM) and the
    recurrent state, which its class pins to the fast tier."""
    from repro_torch.core import h100_topology
    from repro_torch.core.classifier import AccessProfile
    from repro_torch.core.planner import BufferReq, plan
    from repro_torch.core.policy import BufferClass
    B, L = RWKV_B, cfg.n_layers
    state_bytes = L * B * RWKV_H * RWKV_HD * RWKV_HD * 4
    # a decode step: every weight read once; the state read and written
    # once, one dependent update per token
    compute_s = 2 * param_bytes / 2 * B / 989e12
    reqs = [
        BufferReq("params", BufferClass.PARAMS, param_bytes,
                  AccessProfile(param_bytes, 0, dependent_chain=1,
                                parallelism=1024, granularity=4 << 20,
                                compute_seconds=compute_s), pin_fast=True),
        BufferReq("recurrent_state", BufferClass.RECURRENT_STATE, state_bytes,
                  AccessProfile(state_bytes, state_bytes,
                                dependent_chain=RWKV_T,
                                parallelism=B * RWKV_H,
                                granularity=RWKV_HD * RWKV_HD * 4,
                                compute_seconds=compute_s)),
    ]
    p = plan(reqs, h100_topology(), compute_seconds=compute_s)
    d = p.decisions["recurrent_state"]
    assert d.slow_fraction == 0.0 and "pinned" in d.reason, d
    assert p.decisions["params"].slow_fraction == 0.0
    log(f"phase8/placement,state_bytes={state_bytes},"
        f"state_tier={d.policy.tiers[0]},state_slow_fraction="
        f"{d.slow_fraction},state_reason={d.reason},"
        f"state_boundedness={d.boundedness.value},param_bytes={param_bytes}")
    return state_bytes


def phase_rwkv(stats: dict, profile: bool) -> dict:
    """rwkv6-7b at full width and depth: a prefill, then greedy decode
    steps over the recurrent state, every WKV recurrence through wkv6."""
    import torch
    from repro_torch.kernels.wkv6 import ops as wkv_ops, ref as wkv_ref
    from repro_torch.models import registry
    dev = torch.device(DEVICE)
    gc.collect()
    torch.cuda.empty_cache()
    arch = registry.get("rwkv6-7b")
    cfg, mod = arch.cfg, arch.module
    assert (cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim) == (
        RWKV_H, RWKV_HD)
    t0 = time.perf_counter()
    params = mod.init(cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"phase8/model,arch={cfg.name},layers={cfg.n_layers},"
        f"d_model={cfg.d_model},heads={RWKV_H}x{RWKV_HD},d_ff={cfg.d_ff},"
        f"vocab={cfg.vocab_padded},params={n_params},"
        f"param_count_analytic={cfg.param_count()},param_bytes={param_bytes},"
        f"init_s={time.perf_counter() - t0:.2f}")
    state_bytes = place_rwkv_state(cfg, param_bytes)
    B, T, steps, L = RWKV_B, RWKV_T, RWKV_STEPS, cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab, (B, T), generator=gen, device=dev)

    def prefill(tokens, p=params, **kw):
        logits, states = mod.forward(cfg, p, tokens, return_states=True,
                                     last_only=True, **kw)
        cache = dict(zip(("tm", "cm", "wkv"), states),
                     len=torch.full((B,), tokens.shape[1], dtype=torch.int32,
                                    device=dev))
        return logits[:, -1], cache

    # warm-up (cuBLAS heuristics, the kernel library's first load)
    _, cache = prefill(prompt[:, :32])
    for i in range(2):
        mod.decode_step(cfg, params, cache, prompt[:, i])
    del cache
    torch.cuda.synchronize()

    # the main path: counts reset right before, read right after
    wkv_ops.LAUNCHES.reset()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    logits, cache = prefill(prompt)
    ev[1].record()
    first = logits
    tok = torch.argmax(logits, -1)
    generated = [tok]
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    bad += (~torch.isfinite(logits)).sum()
    for _ in range(steps):
        logits, cache = mod.decode_step(cfg, params, cache, tok)
        bad += (~torch.isfinite(logits)).sum()
        tok = torch.argmax(logits, -1)
        generated.append(tok)
    ev[2].record()
    ev[2].synchronize()
    launches = wkv_ops.LAUNCHES.count
    assert launches == L * (1 + steps), launches
    assert int(bad) == 0, f"{int(bad)} non-finite logits"
    assert cache["wkv"].device.type == dev.type
    assert cache["wkv"].numel() * 4 == state_bytes
    assert cache["len"].tolist() == [T + steps] * B
    prefill_ms, decode_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    log(f"phase8/serve,batch={B},prompt={T},new_tokens={steps},"
        f"prefill_ms={prefill_ms:.2f},"
        f"prefill_tokens_per_s={B * T / (prefill_ms * 1e-3):.1f},"
        f"decode_ms_per_step={decode_ms / steps:.3f},"
        f"decode_tokens_per_s={B * steps / (decode_ms * 1e-3):.1f},"
        f"wkv6_launches={launches},logits_finite=1,"
        f"peak_mem_bytes={torch.cuda.max_memory_allocated()}")

    extra = torch.stack(generated[:RWKV_REPLAY], 1)

    def replay(p):
        """Decode replay against forward over the prompt and 8 tokens:
        (the prefill's and 8 steps' logits, forward's at those places)."""
        full = mod.forward(cfg, p, torch.cat([prompt, extra], 1))
        logits, c = prefill(prompt, p)
        outs = [logits]
        for i in range(RWKV_REPLAY):
            logits, c = mod.decode_step(cfg, p, c, extra[:, i])
            outs.append(logits)
        return torch.stack(outs, 1), full[:, T - 1:]

    def checks():
        res = {}
        # the prefill's last logits against the plain recurrence; every
        # layer's kernel call held to the plain one on the path's inputs
        pre_errs, step_errs = [], []
        plain, _ = prefill(prompt, wkv=checked_wkv(pre_errs))
        res["prefill_vs_plain"] = check_greedy(first, plain, "prefill")
        # one decode step from where the run stopped, kernel vs plain
        a = {k: v.clone() for k, v in cache.items()}
        b = {k: v.clone() for k, v in cache.items()}
        got, _ = mod.decode_step(cfg, params, a, tok)
        want, _ = mod.decode_step(cfg, params, b, tok,
                                  wkv=checked_wkv(step_errs))
        res["step_vs_plain"] = check_greedy(got, want, "decode step")
        res["replay_vs_forward"] = check_greedy(*replay(params), "replay")
        assert len(pre_errs) == len(step_errs) == L
        log(f"phase8/wkv6_per_layer,layers={L},prefill_max_rel_err="
            f"{max(pre_errs):.3g},step_max_rel_err={max(step_errs):.3g}")
        # The same weights in fp32: bf16 rounding no longer hides a wrong
        # result, so the logits are held to a bound.
        p32 = mod.RwkvParams(
            params.embed.float(),
            {g: {k: v.float() for k, v in grp.items()}
             for g, grp in params.layers.tree().items()},
            {k: v.float() for k, v in params.final_norm.items()},
            params.lm_head.float())
        got, _ = prefill(prompt, p32)
        want, _ = prefill(prompt, p32, wkv=wkv_ref.wkv6)
        res["fp32/prefill_vs_plain"] = check_greedy(got, want, "fp32 prefill",
                                                    RWKV_FP32_BOUND)
        res["fp32/replay_vs_forward"] = check_greedy(
            *replay(p32), "fp32 replay", RWKV_FP32_BOUND)
        return res

    for name, res in uncounted(checks).items():
        log(f"phase8/{name},logits_max_abs_err={res['err']:.4g},"
            f"logits_std={res['logits_std']:.4g},"
            f"greedy_equal={res['greedy_equal']},"
            f"greedy_compared={res['compared']}")
    gc.collect()
    if profile:
        state = {"cache": cache, "tok": tok}

        def one_step():
            logits, state["cache"] = mod.decode_step(cfg, params,
                                                     state["cache"],
                                                     state["tok"])
            state["tok"] = torch.argmax(logits, -1)

        profile_steps(one_step, "phase8")
    return {"launches": {"wkv6": launches},
            "prefill_tokens_per_s": B * T / (prefill_ms * 1e-3),
            "decode_tokens_per_s": B * steps / (decode_ms * 1e-3)}


#: tier fields phase 10 fits (``memo.fit_tier``), in the order printed
TIER_FIELDS = ("load_bw", "store_bw", "nt_store_bw", "load_latency_ns",
               "chase_latency_ns", "load_peak_streams", "store_peak_streams",
               "load_collapse_streams", "store_collapse_streams",
               "collapse_factor", "capacity_bytes")


def memo_checks(g) -> int:
    """Each probe entry point against its plain version on HBM and on
    pinned memory, bit-equal: integer-valued tables whose sums stay below
    2^24 are exact in any order.  Ragged lane slices, views off a 16-byte
    boundary, starts outside the table (clamped), odd block lengths, two
    lanes of starts, and a single-cycle chase.  Returns the cases run."""
    import torch
    from repro_torch.core import memo
    from repro_torch.kernels.memo_probe import ops, ref
    cases = 0
    for mem in ("hbm", "pinned"):
        for n, lanes, off in ((1024, 1, 0), (4096, 4, 0), (1 << 20, 528, 0),
                              (1 << 20, 132, 1), (100_003, 7, 3),
                              (6, 3, 1)):
            nn = n - n % lanes
            host = torch.randint(-8, 9, (nn + off,), generator=g,
                                 dtype=torch.float32)
            x = _place(host, mem)[off:]
            assert torch.equal(ops.seq_load(x, lanes).cpu(),
                               ref.seq_load(host[off:], lanes)), (mem, n,
                                                                  lanes, off)
            v = torch.randint(-8, 9, (lanes,), generator=g).float()
            ops.seq_store(x, lanes, v)
            torch.cuda.synchronize()
            assert torch.equal(x.cpu(), ref.seq_store(host[off:].clone(),
                                                      lanes, v)), (mem, n)
            cases += 2
        n = 1 << 18
        host = torch.randint(-8, 9, (n,), generator=g, dtype=torch.float32)
        x = _place(host, mem)
        for be, shape in ((256, (512,)), (37, (4, 300)), (1, (64,)),
                          (16384, (2, 16))):
            starts = torch.randint(-64, n + 64, shape, generator=g,
                                   dtype=torch.int32)
            got = ops.random_block_load(x, starts.cuda(), be)
            assert torch.equal(got.cpu(), ref.random_block_load(
                host, starts, be)), (mem, be, shape)
            cases += 1
        perm = torch.from_numpy(memo.single_cycle(1 << 16, 1))
        for steps, start in ((0, 0), (1, 5), (10_000, 0), (10_000, 4321)):
            got = ops.pointer_chase(_place(perm, mem), steps, start)
            assert int(got) == int(ref.pointer_chase(perm, steps, start)), (
                steps, start)
            cases += 1
    torch.cuda.synchronize()
    return cases


def card_generator():
    import torch
    return torch.Generator(device="cuda").manual_seed(10)


def memo_full_checks(g, records: dict) -> float:
    """Each probe entry point against its plain version at the shapes
    the calibration (``records``, by memory) and fig2 gave it, on HBM and
    on pinned memory: ``seq_load`` and ``seq_store`` on each sweep
    point's window of a 1 GiB buffer, ``random_block_load`` at each block
    size and count over a 256 MiB table, ``pointer_chase`` at the
    calibration's and fig2's steps through the 2^26-entry single cycle.
    The tables hold integers in [-8, 8] drawn on the card: a lane's
    partial sums, walks of such steps (about 2^16 in standard deviation
    at 2^28 elements), stay far below 2^24, where fp32 adds integers
    exactly in any order, so the sums compare bit for bit.  Returns the
    largest difference (asserted 0)."""
    import torch
    from repro_torch.benchmarks import fig2_latency
    from repro_torch.core import memo
    from repro_torch.kernels.memo_probe import ops, ref
    err = 0.0

    def same(got, want, what) -> None:
        nonlocal err
        d = (got.cpu().double() - want.cpu().double()).abs().max().item()
        err = max(err, d)
        assert d == 0, (what, d)

    n = (1 << 30) // 4
    host = torch.randint(-8, 9, (n,), generator=card_generator(),
                         dtype=torch.float32, device="cuda").cpu()
    table = host[:(1 << 28) // 4]
    perm = torch.from_numpy(memo.single_cycle(1 << 26, 0))
    for mem in ("hbm", "pinned"):
        sweep = [r for r in records[mem] if r.name == "seq"]
        x = _place(host, mem)
        want = x.clone()  # ``seq_store``'s plain version writes here
        for r in sweep:
            if r.op != "load":
                continue
            count = r.bytes_moved // 4
            off = (n - count) // 8 * 4  # a 16-byte aligned window's start
            win = x[off:off + count]
            same(ops.seq_load(win, r.lanes), ref.seq_load(win, r.lanes),
                 (mem, "seq_load", r.lanes, count))
        for r in sweep:
            if r.op != "store":
                continue
            count = r.bytes_moved // 4
            off = (n - count) // 8 * 4
            v = torch.randint(-8, 9, (r.lanes,), generator=g).float()
            ops.seq_store(x[off:off + count], r.lanes, v)
            ref.seq_store(want[off:off + count], r.lanes,
                          v.to(want.device))
            torch.cuda.synchronize()
            assert torch.equal(x, want), (mem, "seq_store", r.lanes, count)
        del x, want
        t = _place(table, mem)
        for r in records[mem]:
            if r.name != "rand":
                continue
            be, k = r.block_bytes // 4, r.bytes_moved // r.block_bytes
            starts = torch.randint(0, t.numel() - be, (k,), generator=g,
                                   dtype=torch.int32)
            same(ops.random_block_load(t, starts.cuda(), be),
                 ref.random_block_load(t, starts.to(t.device), be),
                 (mem, "random_block_load", be, k))
        del t
        p = _place(perm, mem)
        chase = [r.bytes_moved // 4 for r in records[mem]
                 if r.name == "ptr-chase"]
        for steps in chase + [fig2_latency.CHASE_STEPS]:
            for start in torch.randint(0, 1 << 26, (2,), generator=g):
                same(ops.pointer_chase(p, steps, int(start)),
                     ref.pointer_chase(perm, steps, int(start)),
                     (mem, "pointer_chase", steps, int(start)))
        del p
    torch.cuda.synchronize()
    return err


def phase_memo(stats: dict) -> dict:
    """Phase 10: MEMO's measure mode on the card.  The probes against
    their plain versions at small, ragged shapes; then, counts reset just
    before and read just after, the calibration of both tiers
    (``memo.calibrate``: the load and store lane sweep and the copy on
    1 GiB, random blocks and a single-cycle chase over 256 MiB tables),
    every record and the fitted fields printed; then the probes against
    their plain versions at the calibration's shapes
    (:func:`memo_full_checks`), and ``seq_load``'s time at its widest
    sweep point beside its plain version and byte bound, its outputs
    compared too."""
    import torch
    from repro_torch.core import memo
    from repro_torch.kernels.memo_probe import ops, ref
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    g = torch.Generator(device="cpu").manual_seed(10)
    cases = memo_checks(g)
    log(f"phase10/checks,cases={cases},bit_equal=1,max_abs_err=0")
    ops.LAUNCHES.reset()
    fitted, records = {}, {}
    for mem in ("hbm", "pinned"):
        t0 = time.perf_counter()
        records[mem], spec = memo.calibrate(mem)
        for r in records[mem]:
            log(f"phase10/{mem}/record,{r.name},{r.op},lanes={r.lanes},"
                f"block_bytes={r.block_bytes},bytes={r.bytes_moved},"
                f"seconds={r.seconds:.6g},GBps={r.gbps:.3f}")
        fitted[mem] = {k: getattr(spec, k) for k in TIER_FIELDS}
        log(f"phase10/{mem}/fitted,tier={spec.name},seconds="
            f"{time.perf_counter() - t0:.2f}," + ",".join(
                f"{k}={v if isinstance(v, int) else format(v, '.6g')}"
                for k, v in fitted[mem].items()))
    launches = ops.LAUNCHES.count
    assert launches > 0, "the calibration did not launch memo_probe"
    t0 = time.perf_counter()
    err = memo_full_checks(g, records)
    log(f"phase10/full_checks,bit_equal=1,max_abs_err={err},"
        f"seconds={time.perf_counter() - t0:.2f}")
    # the widest sweep point: 528 lanes over 1 GiB of HBM
    lanes, n = memo.CALIBRATION_LANES[-1], (1 << 30) // 4
    n -= n % lanes
    x = torch.randint(-8, 9, (n,), generator=card_generator(),
                      dtype=torch.float32, device="cuda")
    got, want = ops.seq_load(x, lanes), ref.seq_load(x, lanes)
    err = max(err, (got - want).abs().max().item())
    assert err == 0, ("seq_load at the timed shape", err)
    k_ms = time_ms(lambda: ops.seq_load(x, lanes), iters=10,
                   queue_ahead=True)
    p_ms = time_ms(lambda: ref.seq_load(x, lanes), iters=10,
                   queue_ahead=True)
    bound = (n * 4 + lanes * 4) / HBM_BW * 1e3
    log(f"phase10/seq_load/hbm/lanes{lanes},bytes={n * 4},ms={k_ms:.4f},"
        f"plain_ms={p_ms:.4f},library_ms={p_ms:.4f},bound_ms={bound:.4f},"
        f"GBps={n * 4 / (k_ms * 1e-3) / 1e9:.2f},max_abs_err={err},"
        f"launches={launches},seconds={time.perf_counter() - t_phase:.2f}")
    del x
    stats["memo"] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                     "launches": launches, "fitted": fitted, "err": err}
    return stats["memo"]


def launch_counts() -> dict:
    """Every kernel's launch count (``kv_append`` is ``decode_attention``'s
    append kernel)."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.embedding_reduce import ops as er_ops
    from repro_torch.kernels.memo_probe import ops as memo_ops
    from repro_torch.kernels.stream_copy import ops as sc_ops
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    return {"embedding_reduce": er_ops.LAUNCHES, "stream_copy":
            sc_ops.LAUNCHES, "decode_attention": da_ops.LAUNCHES,
            "kv_append": da_ops.APPEND_LAUNCHES, "wkv6": wkv_ops.LAUNCHES,
            "memo_probe": memo_ops.LAUNCHES}


def phase_figures() -> dict:
    """The port's figure scripts on the card, each raising on a failed
    claim; returns each script's launches by kernel."""
    import torch
    from repro_torch.benchmarks import (bench_hotness, bench_hotpaths,
                                        bench_serving, fig2_latency,
                                        fig3_seq_bw, fig4_dsa, fig5_random,
                                        fig6_redis, fig8_dlrm, fig10_dsb,
                                        fig11_caption, fig_elastic)
    from repro_torch.examples import (dlrm_embedding, quickstart,
                                      serve_tiered_kv)
    gc.collect()
    torch.cuda.empty_cache()
    payloads = {"fig8": {}, "fig10": {}, "fig11": {}}
    examples = {}

    def example(name, fn):
        """An example's printed lines go to stdout; its result is kept."""
        examples[name] = fn([])
        return []
    figures = (
        ("fig2", fig2_latency.run),
        ("fig3", fig3_seq_bw.run),
        ("fig4", fig4_dsa.run),
        ("fig5", fig5_random.run),
        ("fig6", fig6_redis.run),
        ("quickstart", lambda: example("quickstart", quickstart.main)),
        ("serve_tiered_kv", lambda: example("serve_tiered_kv",
                                            serve_tiered_kv.main)),
        ("fig8", lambda: fig8_dlrm.run(payload=payloads["fig8"])),
        ("fig10", lambda: fig10_dsb.run(payload=payloads["fig10"])),
        ("fig11", lambda: fig11_caption.run(payload=payloads["fig11"])),
        ("fig11_control", lambda: fig11_caption.run_control(smoke=True)[0]),
        ("hotpaths", lambda: bench_hotpaths.run(smoke=True)[0]),
        ("serving", lambda: bench_serving.run(smoke=True)[0]),
        ("hotness", lambda: bench_hotness.run(smoke=True)[0]),
        ("dlrm_embedding", lambda: example("dlrm_embedding",
                                           dlrm_embedding.main)),
        ("elastic", fig_elastic.run),
    )
    counters = launch_counts()
    for c in counters.values():
        c.reset()
    per_figure = {}
    t_phase = time.perf_counter()
    for name, fn in figures:
        before = {k: c.count for k, c in counters.items()}
        t0 = time.perf_counter()
        rows = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        for row in rows:
            log(f"phase9/row,{row}")
        per_figure[name] = {k: c.count - before[k]
                            for k, c in counters.items()
                            if c.count != before[k]}
        log(f"phase9/{name},seconds={seconds:.2f},claims=validated,"
            f"launches={per_figure[name]}")
    total = {k: c.count for k, c in counters.items()}
    log(f"phase9/launches,seconds={time.perf_counter() - t_phase:.2f},"
        f"by_kernel={total}")
    fig8 = payloads["fig8"]["measured"]
    assert fig8["launches"] == 1 and fig8["backend"] == "pinned", fig8
    act, audit = payloads["fig10"]["actuation"], payloads["fig11"]["audit"]
    assert 0 < act["stream_copy_launches"] <= act["launch_bound"], act
    assert all(n > 0 for n in audit["stream_copy_launches"]), audit
    assert per_figure["serving"].get("decode_attention", 0) > 0, per_figure
    assert per_figure["hotpaths"].get("stream_copy", 0) > 0, per_figure
    for name in ("fig2", "fig3", "fig5", "quickstart"):
        assert per_figure[name].get("memo_probe", 0) > 0, (name, per_figure)
    for name in ("fig3", "fig4"):
        assert per_figure[name].get("stream_copy", 0) > 0, (name, per_figure)
    for name in ("fig6", "serve_tiered_kv", "elastic"):
        assert per_figure[name].get("decode_attention", 0) > 0, (
            name, per_figure)
    # the drain and the SLO pin move pages through the mover's kernel
    assert per_figure["elastic"].get("stream_copy", 0) > 0, per_figure
    assert per_figure["quickstart"].get("embedding_reduce") == 1, per_figure
    # fig8: the measured row's warm and timed launches, and the semantic
    # section's two bag_reduce calls over an HBM and three pinned shards
    assert per_figure["fig8"].get("embedding_reduce") == 4, per_figure
    assert payloads["fig8"]["semantic"]["speedup"] > 1, payloads["fig8"]
    for name in ("hotness", "dlrm_embedding"):
        assert per_figure[name].get("embedding_reduce", 0) > 0, per_figure
        assert per_figure[name].get("stream_copy", 0) > 0, per_figure
    assert per_figure["dlrm_embedding"]["embedding_reduce"] == 2, per_figure
    dlrm = examples["dlrm_embedding"]
    assert dlrm["drift"] == 0.0 and dlrm["hot_inf_s"] > dlrm["blind_inf_s"]
    quick = examples["quickstart"]
    assert quick["max_abs_err"] <= fig8_dlrm.MEASURED_ATOL, quick
    assert [len(done) for done in examples["serve_tiered_kv"]] == [8] * 4
    log(f"phase9/checks,quickstart_max_abs_err={quick['max_abs_err']:.3g},"
        f"fig8_max_abs_err={fig8['max_abs_err']:.3g},"
        f"fig8_atol={fig8['atol']},fig10_stream_copy_launches="
        f"{act['stream_copy_launches']},fig10_launch_bound="
        f"{act['launch_bound']},fig11_audit_stream_copy_launches="
        f"{audit['stream_copy_launches']},fig11_audit_descriptors="
        f"{audit['descriptors']}")
    return {"per_figure": per_figure, "launches": total}


def phase_full_gates() -> None:
    """``--full-gates``: ``bench_hotpaths`` at 4096 pages (the repartition
    gate on the reference's timing, one pass of each path) and
    ``bench_serving`` at full size.  Every gate's result is printed; then
    the phase fails if any gate failed."""
    import torch
    from repro_torch.benchmarks import bench_hotpaths, bench_serving
    gc.collect()
    torch.cuda.empty_cache()
    failed = []
    t0 = time.perf_counter()
    out = bench_hotpaths.measure(smoke=False)
    for row in bench_hotpaths.csv_rows(out):
        log(f"full/row,{row}")
    rep, act = out["repartition"], out["actuation"]
    log(f"full/hotpaths/repartition/one_pass,pages={rep['n_pages']},"
        f"speedup={rep['speedup']:.3f},legacy_s={rep['legacy_s']:.6f},"
        f"new_s={rep['new_s']:.6f}")
    log(f"full/hotpaths/actuation,speedup={act['speedup']:.3f},"
        f"cow_s={act['cow_s']:.6f},donated_s={act['donated_s']:.6f},"
        f"cow_copies={act['cow_full_shard_copies']},donated_copies="
        f"{act['donated_full_shard_copies']},epochs={act['epochs']}")
    try:
        bench_hotpaths.check(out)
    except AssertionError as e:
        failed.append(f"bench_hotpaths: {e}")
    log(f"full/hotpaths,seconds={time.perf_counter() - t0:.2f},"
        f"gates_held={int(not failed)}")
    t0 = time.perf_counter()
    payload = bench_serving.measure(smoke=False)
    for row in bench_serving.csv_rows(payload):
        log(f"full/row,{row}")
    m = payload["modes"]
    n_failed = len(failed)
    try:
        bench_serving.check(payload)
    except AssertionError as e:
        failed.append(f"bench_serving: {e}")
    log(f"full/serving,goodput_speedup="
        f"{payload['sharing_goodput_speedup']:.3f},prefill_reduction="
        f"{payload['prefill_token_reduction']:.3f},stall_sync_s="
        f"{m['sync']['migration_stall_s']:.6f},stall_overlap_s="
        f"{m['overlap']['migration_stall_s']:.6f},hidden_s="
        f"{m['overlap']['migration_hidden_s']:.6f},goodput_sync="
        f"{m['sync']['goodput_tok_s']:.1f},goodput_overlap="
        f"{m['overlap']['goodput_tok_s']:.1f},"
        f"seconds={time.perf_counter() - t0:.2f},"
        f"gates_held={int(len(failed) == n_failed)}")
    if failed:
        raise AssertionError("full-size gates failed: " + "; ".join(failed))


#: phase 11: the HBM share of the pages, the keys' Zipf exponent, the
#: decay of the hotness ledger and the walk's epochs at most
SEM_BUDGET, SEM_ALPHA, SEM_DECAY, SEM_WALK = 0.10, 1.1, 0.5, 30


def zipf_traffic(n_keys: int, gen, device, n_batches: int = 4) -> tuple:
    """``n_batches`` batches of BAG x LOOKUPS rows drawn Zipf(SEM_ALPHA) over
    a random permutation of ``n_keys`` keys of PAGE_ROWS rows (a uniform
    row within the key), made on the card; and the keys' lookup counts."""
    import torch
    perm = torch.randperm(n_keys, generator=gen, device=device)
    p = 1.0 / (1.0 + torch.arange(n_keys, device=device,
                                  dtype=torch.float64)) ** SEM_ALPHA
    cdf = torch.cumsum(p / p.sum(), 0)
    batches, counts = [], torch.zeros(n_keys, dtype=torch.int64,
                                      device=device)
    for _ in range(n_batches):
        u = torch.rand((BAG, LOOKUPS), generator=gen, device=device,
                       dtype=torch.float64)
        rank = torch.clamp_max(torch.searchsorted(cdf, u), n_keys - 1)
        keys = perm[rank]
        counts += torch.bincount(keys.reshape(-1), minlength=n_keys)
        batches.append(keys * PAGE_ROWS + torch.randint(
            0, PAGE_ROWS, keys.shape, generator=gen, device=device))
    return batches, counts.cpu().numpy()


def hbm_lookup_share(st, batches) -> float:
    """Share of the batches' lookups whose page lies in HBM (device 0)."""
    import torch
    dev = st.it.page_device
    hits = sum(int((dev[b // PAGE_ROWS] == 0).sum()) for b in batches)
    return hits / sum(b.numel() for b in batches)


def move_routes(st, new_dev) -> list:
    """Route-pure runs (a mover's descriptors) of a move to ``new_dev``,
    counted by route: a mover batch never mixes routes, so the move's
    ``stream_copy`` bound is ``launch_bound`` of these counts."""
    import numpy as np
    old_dev, old_local = st.it._host_map()
    delta = np.nonzero(np.asarray(new_dev) != old_dev)[0]
    routes: dict = {}
    for s, d, _, _ in st.it._move_runs(delta, old_dev, old_local,
                                       np.asarray(new_dev, np.int8)):
        routes[(s, d)] = routes.get((s, d), 0) + 1
    return list(routes.values())


def phase_semantic(stats: dict, rows_log2: int) -> dict:
    """Semantic DLRM: the DLRM slice's table on ``h100_topology()`` with
    HBM holding SEM_BUDGET of the pages, Zipf traffic; blind placement
    against a semantic re-tier at the same page budget, then a
    HotSetCoordinator walk on measured bags/s with a hot-set flip."""
    global BAG_CALLS
    import numpy as np
    import torch
    from repro_torch.benchmarks.common import launch_bound
    from repro_torch.core import (BulkMover, CaptionConfig, CaptionController,
                                  EpochMetrics, HotnessLedger,
                                  HotSetCoordinator, SemanticTensor,
                                  h100_topology, stream_executor)
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.kernels.embedding_reduce import ops as er_ops
    from repro_torch.kernels.stream_copy import ops as sc_ops
    dev = torch.device(DEVICE)
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    topo = h100_topology()
    names = (topo.fast.name, topo.slow.name)
    rows = 1 << rows_log2
    n_keys = rows // PAGE_ROWS  # one key a page
    weights = (1.0 - SEM_BUDGET,)
    gen = torch.Generator(device=dev).manual_seed(11)
    table = torch.randint(-8, 9, (rows, DIM), dtype=torch.float32,
                          generator=gen, device=dev)
    st = SemanticTensor.from_array(
        table, rows_per_key=PAGE_ROWS, weights=weights, device_names=names,
        page_rows=PAGE_ROWS, ledger=HotnessLedger(n_keys, decay=SEM_DECAY),
        headroom=1024, placement="blind", device=dev)
    del table
    torch.cuda.synchronize()
    ptrs = [p.data_ptr() for p in st.it.parts]
    log(f"phase11/table,rows={rows},keys={n_keys},bytes={rows * DIM * 4},"
        f"hbm_pages={int((st.key_device() == 0).sum())},"
        f"shard_bytes={[p.numel() * 4 for p in st.it.parts]},"
        f"build_s={time.perf_counter() - t_phase:.2f}")
    batches, counts = zipf_traffic(n_keys, gen, dev)
    want = [st.it.bag_reduce(b) for b in batches]
    top = np.sort(counts)[::-1]
    zipf_share = float(top[:int(round(SEM_BUDGET * n_keys))].sum()
                       / top.sum())

    counters = launch_counts()
    for c in counters.values():
        c.reset()
    BAG_CALLS = 0
    # the lookups feed the ledger (SemanticTensor.bag_reduce records them)
    for b in batches:
        st.bag_reduce(b)
    BAG_CALLS += len(batches)
    st.ledger.tick()
    blind_rate = epoch_rate(st.it, batches)
    blind_share = hbm_lookup_share(st, batches)
    blind_ledger_share = st.hot_traffic_share()
    routes = move_routes(st, st.plan_assignment(weights))
    mover = BulkMover(topo, execute=stream_executor(), device=dev)
    tel = Telemetry()
    sc0 = sc_ops.LAUNCHES.count
    d0 = mover.descriptors_submitted
    t0 = time.perf_counter()
    try:
        st = st.retier(weights, mover=mover, telemetry=tel, donate=True)
        torch.cuda.synchronize()
    finally:
        mover.close()
    move_s = time.perf_counter() - t0
    descs = mover.descriptors_submitted - d0
    sc_move = sc_ops.LAUNCHES.count - sc0
    r = st.last_retier
    assert r["promoted_pages"] > 0, r
    assert descs == sum(routes), (descs, routes)
    assert 0 < sc_move <= launch_bound(routes), (sc_move, routes)
    assert [p.data_ptr() for p in st.it.parts] == ptrs
    for b, w in zip(batches, want):
        got = st.bag_reduce(b)
        assert torch.equal(got, w), "semantic re-tier changed a bag sum"
    BAG_CALLS += len(batches)
    sem_rate = epoch_rate(st.it, batches)
    sem_share = hbm_lookup_share(st, batches)
    log(f"phase11/retier,moved_pages={r['moved_pages']},"
        f"promoted_pages={r['promoted_pages']},"
        f"demoted_pages={r['demoted_pages']},descriptors={descs},"
        f"descriptors_by_route={routes},stream_copy_launches={sc_move},"
        f"launch_bound={launch_bound(routes)},seconds={move_s:.3f},"
        f"GBps={r['moved_pages'] * PAGE_ROWS * DIM * 4 / move_s / 1e9:.2f},"
        f"bags_bit_equal=1,data_ptr_same=1")
    log(f"phase11/placement,hbm_share_of_pages={SEM_BUDGET},"
        f"zipf_share_of_hottest_keys={zipf_share:.4f},"
        f"blind_bags_per_s={blind_rate:.0f},"
        f"semantic_bags_per_s={sem_rate:.0f},"
        f"speedup={sem_rate / blind_rate:.3f},"
        f"blind_hbm_lookup_share={blind_share:.4f},"
        f"semantic_hbm_lookup_share={sem_share:.4f},"
        f"blind_ledger_hot_share={blind_ledger_share:.4f},"
        f"semantic_ledger_hot_share={st.hot_traffic_share():.4f}")
    assert sem_rate > blind_rate, (sem_rate, blind_rate)
    assert sem_share > blind_share, (sem_share, blind_share)

    # the hot set as a walked coordinate on measured bags/s
    cfg = CaptionConfig(epoch_steps=1, probe_epochs=1, step=0.02,
                        min_step=0.01, hysteresis=0.005, drift_threshold=0.0,
                        write_damp=False)
    # from 0.02 above the capacity floor: the walk probes up, then down
    ctl = CaptionController(topo, cfg, initial_fraction=1.0 - SEM_BUDGET
                            + 0.02, min_fraction=1.0 - SEM_BUDGET)
    coord = HotSetCoordinator(st, ctl, drift_threshold=0.5, donate=True)
    flip_at = None
    for epoch in range(SEM_WALK):
        if ctl.converged and flip_at is None:
            batches, counts = zipf_traffic(n_keys, gen, dev)
            want = [coord.st.it.bag_reduce(b) for b in batches]
            BAG_CALLS += len(batches)
            flip_at = epoch
        coord.st.ledger.record(counts)
        rate = epoch_rate(coord.st.it, batches)
        sc0 = sc_ops.LAUNCHES.count
        t0 = time.perf_counter()
        before = coord.st
        d = coord.epoch(EpochMetrics(throughput=rate))
        torch.cuda.synchronize()
        moved = coord.st.last_retier["moved_pages"] \
            if coord.st is not before else 0
        sc_epoch = sc_ops.LAUNCHES.count - sc0
        # a move without a mover: one gather launch and one landing
        assert sc_epoch == (2 if moved else 0), (sc_epoch, moved)
        log(f"phase11/walk/epoch{epoch:02d},f={ctl.fraction:.4f},"
            f"bags_per_s={rate:.0f},phase={d.phase.value},"
            f"drift={coord.drift():.3f},reopens={coord.reopens},"
            f"moved_pages={moved},stream_copy_launches={sc_epoch},"
            f"hbm_lookup_share={hbm_lookup_share(coord.st, batches):.4f},"
            f"seconds={time.perf_counter() - t0:.3f}")
        if flip_at is not None and ctl.converged and coord.reopens:
            break
    launches = {"embedding_reduce": er_ops.LAUNCHES.count,
                "stream_copy": sc_ops.LAUNCHES.count}
    calls = BAG_CALLS
    assert flip_at is not None, "the walk never converged before the flip"
    assert coord.reopens >= 1, "hot-set drift did not re-open the walk"
    assert ctl.converged, "the walk did not converge again after the flip"
    assert launches["embedding_reduce"] == calls, (launches, calls)
    for b, w in zip(batches, want):
        assert torch.equal(coord.st.it.bag_reduce(b), w)
    final = epoch_rate(coord.st.it, batches)
    log(f"phase11/walk/final,f={ctl.fraction:.4f},flip_epoch={flip_at},"
        f"reopens={coord.reopens},converged=1,bags_per_s={final:.0f},"
        f"hbm_lookup_share={hbm_lookup_share(coord.st, batches):.4f},"
        f"launches={launches},bag_reduce_calls={calls},"
        f"seconds={time.perf_counter() - t_phase:.2f}")
    out = {"launches": launches, "blind_bags_per_s": blind_rate,
           "semantic_bags_per_s": sem_rate}
    stats["semantic"] = out
    del st, coord, want, batches
    gc.collect()
    torch.cuda.empty_cache()
    return out


MOE_B, MOE_T, MOE_STEPS, MOE_CACHE, MOE_REPLAY = 8, 512, 32, 1024, 8
#: unit 0's expert stack: HBM holds this share of its pages
MOE_BUDGET = 0.25
#: MoE units of the fp32 copy the checks hold to a bound
MOE_FP32_UNITS = 3


def checked_attend(errors: list):
    """An ``attend=`` function that runs the ``decode_attention`` kernel
    and its plain version on the same inputs (the layer's own), holds the
    normalised outputs together (fp32 sums of bf16 K/V in other orders:
    phase 5's bf16 tolerance) and passes the plain partials on;
    ``errors`` gets each call's max abs error."""
    import torch
    from repro_torch.kernels.decode_attention import ops, ref

    def attend(q, k, v, valid):
        acc, m, l = ops.attend_partial(q, k, v, valid)
        ra, rm, rl = ref.attend_partial(q, k, v, valid)
        got = acc / l.clamp_min(1e-30)[..., None]
        want = ra / rl.clamp_min(1e-30)[..., None]
        torch.testing.assert_close(got, want, atol=2e-2, rtol=0.2)
        errors.append(float((got - want).abs().max()))
        return ra, rm, rl

    return attend


def moe_fp32_cut(cfg, params, units: int):
    """The leading dense layers and the first ``units`` MoE units of
    ``params`` in fp32, with the config cut to their depth."""
    import dataclasses
    from repro_torch.models.moe import MoEParams
    t = f32_tree({"units": params.units.tree(),
                  "final_norm": params.final_norm.tree(),
                  "head": params.head_dense.tree() if params.head_dense
                  else {}}, {"units": units})
    cut = MoEParams(params.embed.float(), t["head"] or None, t["units"],
                    t["final_norm"],
                    None if params.lm_head is None else params.lm_head.float())
    c = dataclasses.replace(cfg, param_dtype="float32",
                            n_layers=cfg.moe.first_dense
                            + units * cfg.moe.every)
    return c, cut


def phase_moe(stats: dict) -> dict:
    """deepseek-moe-16b at full width and depth, bf16, random weights: a
    prefill with ``forward_with_aux(last_only=True)``, then greedy
    ``decode_step``s over ``init_cache``, every attention through
    ``decode_attention``; then the router's counts re-tier unit 0's
    expert stack as a SemanticTensor over HBM and pinned memory."""
    import dataclasses
    import torch
    from repro_torch.benchmarks.common import launch_bound
    from repro_torch.core import (BulkMover, HotnessLedger, SemanticTensor,
                                  h100_topology, stream_executor)
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.stream_copy import ops as sc_ops
    from repro_torch.models import registry
    dev = torch.device(DEVICE)
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    arch = registry.get("deepseek-moe-16b")
    cfg, mod = arch.cfg, arch.module
    params = mod.init(cfg, torch.Generator(device=dev).manual_seed(0),
                      device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"phase12/model,arch={cfg.name},layers={cfg.n_layers},"
        f"d_model={cfg.d_model},heads={cfg.n_heads}x{cfg.resolved_head_dim}"
        f",kv_heads={cfg.n_kv_heads},experts={cfg.moe.n_experts},"
        f"top_k={cfg.moe.top_k},params={n_params},"
        f"param_bytes={sum(p.numel() * p.element_size() for p in params.parameters())},"
        f"init_s={time.perf_counter() - t_phase:.2f}")
    B, T, steps, L = MOE_B, MOE_T, MOE_STEPS, cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(5)
    prompt = torch.randint(0, cfg.vocab, (B, T), generator=gen, device=dev)

    # warm-up (cuBLAS heuristics, the kernel library's first load)
    mod.forward_with_aux(cfg, params, prompt[:, :32], last_only=True)
    warm = mod.init_cache(cfg, B, 8, device=dev)
    for i in range(2):
        mod.decode_step(cfg, params, warm, prompt[:, i])
    del warm
    torch.cuda.synchronize()

    counters = launch_counts()
    for c in counters.values():
        c.reset()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    logits, aux = mod.forward_with_aux(cfg, params, prompt, last_only=True)
    ev[1].record()
    prefill_logits = logits[:, -1]
    cache = mod.init_cache(cfg, B, MOE_CACHE, device=dev)
    tok = torch.argmax(prefill_logits, -1)
    generated = [tok]
    bad = (~torch.isfinite(logits)).sum()
    for _ in range(steps):
        logits, cache = mod.decode_step(cfg, params, cache, tok)
        bad += (~torch.isfinite(logits)).sum()
        tok = torch.argmax(logits, -1)
        generated.append(tok)
    ev[2].record()
    ev[2].synchronize()
    launches = {k: c.count for k, c in counters.items() if c.count}
    assert launches.get("decode_attention") == L * steps, launches
    assert int(bad) == 0, f"{int(bad)} non-finite logits"
    assert cache["len"].tolist() == [steps] * B
    counts = aux["expert_counts"].cpu()
    prefill_ms, decode_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    log(f"phase12/serve,batch={B},prompt={T},new_tokens={steps},"
        f"cache_positions={MOE_CACHE},prefill_ms={prefill_ms:.2f},"
        f"prefill_tokens_per_s={B * T / (prefill_ms * 1e-3):.1f},"
        f"decode_ms_per_step={decode_ms / steps:.3f},"
        f"decode_tokens_per_s={B * steps / (decode_ms * 1e-3):.1f},"
        f"launches={launches},dropped={float(aux['dropped']):.4f},"
        f"expert_counts_sum={int(counts.sum())},logits_finite=1,"
        f"peak_mem_bytes={torch.cuda.max_memory_allocated()}")
    busy = device_busy_share(
        lambda: mod.decode_step(cfg, params, cache, tok))

    def checks():
        from repro_torch.kernels.decode_attention import ref as da_ref
        res = {}
        # one decode step from where the run stopped, kernel vs plain; each
        # layer's kernel call held to the plain one on the layer's inputs
        errs = []
        a = {k: v.clone() for k, v in cache.items()}
        b = {k: v.clone() for k, v in cache.items()}
        got, _ = mod.decode_step(cfg, params, a, tok)
        want, _ = mod.decode_step(cfg, params, b, tok,
                                  attend=checked_attend(errs))
        res["step_vs_plain"] = check_greedy(got, want, "decode step")
        assert len(errs) == L, len(errs)
        log(f"phase12/decode_attention_per_layer,layers={L},"
            f"max_abs_err={max(errs):.3g}")
        extra = torch.stack(generated[:MOE_REPLAY], 1)
        # forward over B x 8 tokens gives each expert 8 slots and drops
        # overflow, where a decode step (B tokens) drops none: the
        # replay compares the two with capacity for every token (the
        # reference's tiny config is dropless for the same reason)
        dropless = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))

        def replay(c_, p_):
            c_ = dataclasses.replace(c_, moe=dropless.moe)
            full = mod.forward(c_, p_, extra)
            cc = mod.init_cache(c_, B, MOE_REPLAY, device=dev)
            outs = []
            for i in range(MOE_REPLAY):
                lg, cc = mod.decode_step(c_, p_, cc, extra[:, i])
                outs.append(lg)
            return torch.stack(outs, 1), full
        res["replay_vs_forward"] = check_greedy(*replay(cfg, params),
                                                "replay")
        # bf16 rounding flips near-tied routing choices of random weights;
        # the same weights in fp32 (the dense layer and three units: the
        # whole model in fp32 would not fit beside it) are held to a bound
        c32, p32 = moe_fp32_cut(cfg, params, MOE_FP32_UNITS)
        res["fp32/replay_vs_forward"] = check_greedy(
            *replay(c32, p32), "fp32 replay", RWKV_FP32_BOUND)
        a = mod.init_cache(c32, B, MOE_REPLAY, device=dev)
        b = mod.init_cache(c32, B, MOE_REPLAY, device=dev)
        for i in range(MOE_REPLAY):
            got, a = mod.decode_step(c32, p32, a, extra[:, i])
            want, b = mod.decode_step(c32, p32, b, extra[:, i],
                                      attend=da_ref.attend_partial)
        res["fp32/step_vs_plain"] = check_greedy(got, want, "fp32 step",
                                                 RWKV_FP32_BOUND)
        return res

    for name, res in uncounted(checks).items():
        log(f"phase12/{name},logits_max_abs_err={res['err']:.4g},"
            f"logits_std={res['logits_std']:.4g},"
            f"greedy_equal={res['greedy_equal']},"
            f"greedy_compared={res['compared']}")
    del cache

    # the router's dispatch counts place unit 0's expert up-projections
    topo = h100_topology()
    w_up = params.units["moe"]["experts"]["w_up"]
    E, D, F = w_up.shape[1:]
    ledger = HotnessLedger(E, decay=0.5)
    ledger.record(counts)
    original = w_up[0].clone()
    st = SemanticTensor.from_array(
        w_up[0].reshape(E * D, F), rows_per_key=D, weights=(1 - MOE_BUDGET,),
        device_names=(topo.fast.name, topo.slow.name), page_rows=D // 4,
        ledger=ledger, headroom=E * 4, placement="blind", device=dev)
    blind_share = st.hot_traffic_share()
    routes = move_routes(st, st.plan_assignment((1 - MOE_BUDGET,)))
    mover = BulkMover(topo, execute=stream_executor(), device=dev)
    sc0, d0 = sc_ops.LAUNCHES.count, mover.descriptors_submitted
    t0 = time.perf_counter()
    try:
        st = st.retier((1 - MOE_BUDGET,), mover=mover, telemetry=Telemetry(),
                       donate=True)
        torch.cuda.synchronize()
    finally:
        mover.close()
    move_s = time.perf_counter() - t0
    descs = mover.descriptors_submitted - d0
    sc_move = sc_ops.LAUNCHES.count - sc0
    r = st.last_retier
    assert r["promoted_pages"] > 0, r
    assert descs == sum(routes) and 0 < sc_move <= launch_bound(routes), (
        descs, routes, sc_move)
    rebuilt = st.to_array().reshape(E, D, F)
    assert torch.equal(rebuilt, original), "expert stack changed"

    def relogits():
        sub = prompt[:2]
        base = mod.forward(cfg, params, sub, last_only=True)
        w_up[0].copy_(rebuilt)
        try:
            again = mod.forward(cfg, params, sub, last_only=True)
        finally:
            w_up[0].copy_(original)
        return base, again

    base, again = uncounted(relogits)
    assert torch.equal(base, again), "logits changed with the re-tiered stack"
    log(f"phase12/experts,unit=0,stack_bytes={original.numel() * 2},"
        f"hbm_share_of_pages={MOE_BUDGET},moved_pages={r['moved_pages']},"
        f"promoted_pages={r['promoted_pages']},descriptors={descs},"
        f"descriptors_by_route={routes},stream_copy_launches={sc_move},"
        f"launch_bound={launch_bound(routes)},seconds={move_s:.3f},"
        f"blind_hot_share={blind_share:.4f},"
        f"semantic_hot_share={st.hot_traffic_share():.4f},"
        f"to_array_bit_equal=1,logits_bit_equal=1,"
        f"device_busy_share_decode_step={busy},"
        f"seconds={time.perf_counter() - t_phase:.2f}")
    out = {"launches": launches, "retier_stream_copy_launches": sc_move,
           "decode_tokens_per_s": B * steps / (decode_ms * 1e-3),
           "prefill_tokens_per_s": B * T / (prefill_ms * 1e-3),
           "busy": busy}
    stats["moe"] = out
    del st, params, original, rebuilt
    gc.collect()
    torch.cuda.empty_cache()
    return out


#: phase 13: the reference driver's defaults (batch, seq, data seed), the
#: tiered share, the fused steps and the card-against-CPU run's steps
TRAIN_B, TRAIN_S, TRAIN_SEED, TRAIN_SLOW = 8, 128, 17, 0.25
TRAIN_FUSED_STEPS, TRAIN_TIMED_STEPS, TRAIN_TINY_STEPS = 4, 3, 12
#: the tiny driver's tiered run under Caption (phases 13 and 14)
TINY_TIERED = ["--offload-fraction", "0.5", "--caption",
               "--caption-epoch-steps", "4"]


def bf16_gap(a, b, slack: float) -> tuple[float, float, float]:
    """(max |a - b|, max |a - b| in bf16 spacings at max(|a|, |b|), max of
    |a - b| - slack in those spacings): how far two bf16 tensors are apart,
    and past an absolute ``slack``."""
    import torch
    a, b = a.float(), b.float()
    m = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(m)) - 7)
    d = (a - b).abs()
    return (float(d.max()), float((d / ulp).max()),
            float(((d - slack).clamp(min=0) / ulp).max()))


def pinned_stats() -> str:
    """The pinned allocator's byte counts (what it holds, rounding
    included), where this PyTorch reports them."""
    import torch
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is None:
        return "not read"
    return "|".join(f"{k}={v}" for k, v in stats().items()
                    if "bytes" in k and "current" in k) or "not read"


def train_tiny(arch_id: str, device: str, extra: list, tree) -> tuple:
    """``train.main`` at ``arch_id``'s ``.tiny()`` (fp32) from the weights
    ``tree`` (numpy): (losses, the Caption lines it printed)."""
    import contextlib
    import io
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import train
    from repro_torch.models.registry import get_config
    cfg = get_config(arch_id).tiny()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        losses = train.main(
            ["--arch", arch_id, "--tiny", "--steps", str(TRAIN_TINY_STEPS),
             "--batch", "2", "--seq", "16", "--ckpt-every", "100",
             "--log-every", "6", "--device", device,
             "--ckpt-dir", str(ROOT / "build" / "train_ckpt"), *extra],
            params=params_from_jax(cfg, tree, device=device))
    return losses, [ln for ln in out.getvalue().splitlines()
                    if ln.startswith("caption")]


def phase_training(stats: dict, profile: bool = False) -> dict:
    """starcoder2-3b at full width and depth, bf16, random weights: the
    planner's optimizer-state split on ``h100_topology()``; fused AdamW
    steps with remat; one gradient fed to fused AdamW and to
    ``TieredAdamW(slow_fraction=0.25)`` (new parameters within one bf16
    ulp, the pinned master read back equal to the new parameter, the
    step's ``stream_copy`` launches equal to one a page plus one a run of
    8); a repartition round trip 0.25 -> 0 -> 0.25 through the mover,
    bit-equal; the tiered step's times, paging rate and busy share; then
    ``train.main`` at the tiny config on the card and on the CPU."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import BulkMover, h100_topology, stream_executor
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels.stream_copy import ops as sc_ops
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.optim import adamw, offload, schedules
    from repro_torch.tree import named_leaves
    dev = torch.device(DEVICE)
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    arch = registry.get("starcoder2-3b")
    cfg, mod = arch.cfg, arch.module
    params = mod.init(cfg, torch.Generator(device=dev).manual_seed(13),
                      device=dev)
    leaves = named_leaves(params)
    n_params = sum(p.numel() for _, p in leaves)
    topo = h100_topology()
    _, plan_frac, _ = train.plan_optimizer(n_params, topo)
    log(f"phase13/model,arch={cfg.name},layers={cfg.n_layers},d_model="
        f"{cfg.d_model},heads={cfg.n_heads}x{cfg.resolved_head_dim},"
        f"kv_heads={cfg.n_kv_heads},d_ff={cfg.d_ff},vocab={cfg.vocab_padded},"
        f"params={n_params},param_bytes="
        f"{sum(p.numel() * p.element_size() for _, p in leaves)},"
        f"init_s={time.perf_counter() - t_phase:.2f}")
    log(f"phase13/plan,opt_state_bytes={12 * n_params},"
        f"planned_slow_fraction={plan_frac:.4f},topology=h100")
    opt_cfg = adamw.AdamWConfig(lr=3e-4, schedule=schedules.warmup_cosine(
        10, 100))
    data = TokenPipeline(DataConfig(vocab=cfg.vocab_padded, batch=TRAIN_B,
                                    seq=TRAIN_S, seed=TRAIN_SEED))

    def batch_at(s):
        return {k: torch.as_tensor(v).to(dev)
                for k, v in data.batch_at(s).items()}

    # (b) fused AdamW with remat
    state = adamw.init_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_ms, grad_ms, losses = [], [], []
    for s in range(TRAIN_FUSED_STEPS):
        b = batch_at(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = mod.loss_and_grad(cfg, params, b, remat=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        adamw.apply(opt_cfg, params, grads, state)
        del grads
        torch.cuda.synchronize()
        fused_ms.append((time.perf_counter() - t0) * 1e3)
        grad_ms.append((t1 - t0) * 1e3)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    assert all(np.isfinite(losses)), losses
    log(f"phase13/fused,steps={TRAIN_FUSED_STEPS},losses={losses},"
        f"step_ms={[round(x, 2) for x in fused_ms]},"
        f"loss_and_grad_ms={[round(x, 2) for x in grad_ms]},"
        f"peak_hbm_bytes={peak}")
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # (c) one gradient, both optimizers
    batch = batch_at(TRAIN_FUSED_STEPS)
    _, grads = mod.loss_and_grad(cfg, params, batch, remat=True)
    fused_new = {k: p.detach().clone() for k, p in leaves}
    state = adamw.init_state(fused_new)
    adamw.apply(opt_cfg, fused_new, grads, state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    tel = Telemetry()
    opt = offload.TieredAdamW(opt_cfg, slow_fraction=TRAIN_SLOW, telemetry=tel,
                              slow_device_names=topo.slow_names)
    t0 = time.perf_counter()
    st = opt.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    (key, leaf), = st["slow"].items()
    assert all(lf.block.is_pinned() for lf in st["slow"].values())
    want_launches = opt.step_launches(st)
    torch.cuda.synchronize()
    sc_ops.LAUNCHES.reset()
    t0 = time.perf_counter()
    _, st, m = opt.step(params, grads, st)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = sc_ops.LAUNCHES.reset()
    assert launches == want_launches, (launches, want_launches)
    want_bytes = offload.PAGE_ELEMS * 4 * 6 * leaf.n_pages
    assert m["offload_bytes"] == want_bytes, (m["offload_bytes"], want_bytes)
    # The fused update clips in bf16 (g * bf16(scale), rounded: relative
    # error <= 2^-8), the tiered one in fp32.  At step 1 the update is
    # g / (|g| + eps), which such an error moves by at most 2^-10, so the
    # new parameters may differ by lr * 2^-10 before their bf16 rounding:
    # each element is held to one bf16 spacing past that.
    equal = sum(torch.equal(p, fused_new[k]) for k, p in leaves)
    slack = float(m["lr"]) * 2.0 ** -10
    gaps = [bf16_gap(p, fused_new[k], slack) for k, p in leaves]
    max_abs = max(g[0] for g in gaps)
    ulps = max(g[1] for g in gaps)
    past = max(g[2] for g in gaps)
    assert past <= 1.0, (past, ulps, max_abs, slack)
    p_off = dict(leaves)[key]
    master_bf16 = leaf.master[:leaf.size].to(dev).to(p_off.dtype).view(
        p_off.shape)
    assert torch.equal(master_bf16, p_off), "pinned master != new parameter"
    del fused_new, master_bf16
    log(f"phase13/one_step,offloaded={key},pages={leaf.n_pages},"
        f"leaves_bit_equal={equal}/{len(leaves)},max_abs_diff={max_abs:.3g},"
        f"max_bf16_spacings={ulps:.1f},clip_slack={slack:.3g},"
        f"max_spacings_past_slack={past:.3f},"
        f"grad_norm={float(m['grad_norm']):.4f},pinned_master_bit_equal=1,"
        f"stream_copy_launches={launches},launch_formula={want_launches},"
        f"offload_bytes={m['offload_bytes']},init_s={init_s:.2f},"
        f"first_step_ms={step_s * 1e3:.1f}")

    # (d) a repartition round trip through the mover; the state is kept
    # on the card to compare, so the freed pinned block can be reused
    rtel = Telemetry()
    state_bytes = leaf.state_bytes
    before = leaf.block.to(dev)
    old_ptr = leaf.block.data_ptr()
    p_before = p_off.clone()
    del leaf
    with BulkMover(topo, telemetry=rtel, execute=stream_executor(),
                   device=dev) as mover:
        opt.telemetry = rtel
        sc_ops.LAUNCHES.reset()
        t0 = time.perf_counter()
        st = opt.repartition(params, st, 0.0, mover=mover)
        torch.cuda.synchronize()
        up_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        st = opt.repartition(params, st, TRAIN_SLOW, mover=mover)
        torch.cuda.synchronize()
        down_s = time.perf_counter() - t0
        rep_launches = sc_ops.LAUNCHES.reset()
        descs = mover.descriptors_submitted
    opt.telemetry = tel
    back = st["slow"][key]
    # the moments come back bit-equal; the master comes back as its
    # parameter, which holds it in bf16 (the reference also rebuilds a
    # paged-out master from the parameter)
    old = dataclasses.replace(back, block=before)
    now = dataclasses.replace(back, block=back.block.to(dev))
    assert torch.equal(now.mu, old.mu) and torch.equal(now.nu, old.nu)
    assert torch.equal(now.master, old.master.to(p_off.dtype).float())
    assert torch.equal(p_off, p_before)
    reused = int(back.block.data_ptr() == old_ptr)
    del old, now
    billed = sum(r.bytes_moved for r in rtel.routes.values())
    down = rtel.counters["caption.opt_bytes_down"]
    up = rtel.counters["caption.opt_bytes_up"]
    assert billed == down + up == 2 * state_bytes, (billed, down, up)
    assert descs == 2 and rep_launches <= 2 * descs, (descs, rep_launches)
    del before, p_before
    log(f"phase13/repartition,descriptors={descs},stream_copy_launches="
        f"{rep_launches},launch_bound={2 * descs},billed_bytes={billed},"
        f"opt_bytes_down={int(down)},opt_bytes_up={int(up)},"
        f"page_in_s={up_s:.3f},page_out_s={down_s:.3f},"
        f"page_in_GBps={state_bytes / up_s / 1e9:.2f},"
        f"page_out_GBps={state_bytes / down_s / 1e9:.2f},"
        f"moments_bit_equal=1,master_equals_parameter=1,"
        f"pinned_block_reused={reused}")

    # (e) times
    def tiered_step():
        opt.step(params, grads, st)

    step_ms = []
    for _ in range(TRAIN_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tiered_step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    with BulkMover(topo, telemetry=Telemetry(), execute=stream_executor(),
                   device=dev) as mover:
        opt.mover = mover
        mover_ms = []
        for _ in range(TRAIN_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tiered_step()
            torch.cuda.synchronize()
            mover_ms.append((time.perf_counter() - t0) * 1e3)
        opt.mover = None
    full_ms = []
    for s in range(2):
        b = batch_at(TRAIN_FUSED_STEPS + 1 + s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, g2 = mod.loss_and_grad(cfg, params, b, remat=True)
        opt.step(params, g2, st)
        del g2
        torch.cuda.synchronize()
        full_ms.append((time.perf_counter() - t0) * 1e3)
        assert np.isfinite(float(loss))
    busy = device_busy_share(tiered_step)
    if profile:
        profile_steps(tiered_step, "phase13/tiered_step", n=2)
    paged = 2 * state_bytes
    best = min(step_ms) / 1e3
    duplex_bound_s = state_bytes / PCIE_BW
    slow = topo.slows[0]
    model_s = state_bytes / slow.load_bw + state_bytes / slow.store_bw
    log(f"phase13/times,tiered_step_ms={[round(x, 1) for x in step_ms]},"
        f"tiered_step_mover_ms={[round(x, 1) for x in mover_ms]},"
        f"train_step_ms={[round(x, 1) for x in full_ms]},"
        f"fused_step_ms={[round(x, 1) for x in fused_ms]},"
        f"paged_bytes={paged},paging_GBps={paged / best / 1e9:.2f},"
        f"pcie_bound_ms={duplex_bound_s * 1e3:.1f},pcie_one_way_bound_ms="
        f"{2 * duplex_bound_s * 1e3:.1f},h100_topology_ms={model_s * 1e3:.1f},"
        f"busy={busy},host_block_bytes={opt.pinned_bytes(st)},"
        f"host_state_bytes={opt.host_bytes(st)},"
        f"host_allocator={pinned_stats()}")
    del grads, st, opt, params, leaves, p_off, back
    gc.collect()
    torch.cuda.empty_cache()

    # (f) the card against the CPU at the tiny config, same weights
    tiny = registry.get("starcoder2-3b").tiny().cfg
    tree = numpy_tree(mod.init(tiny, 3, device="cpu"))
    tiny_runs = {}
    for label, extra in (("fused", []), ("tiered_caption", TINY_TIERED)):
        card_l, card_c = train_tiny("starcoder2-3b", "cuda", extra, tree)
        cpu_l, cpu_c = train_tiny("starcoder2-3b", "cpu", extra, tree)
        diff = float(np.abs(np.array(card_l) - np.array(cpu_l)).max())
        assert diff <= 1e-4 and card_c == cpu_c, (label, diff, card_c, cpu_c)
        tiny_runs[label] = diff
        log(f"phase13/tiny_{label},steps={TRAIN_TINY_STEPS},"
            f"max_loss_diff={diff:.3g},caption_decisions={len(card_c)},"
            f"final_loss={card_l[-1]:.4f}")
    out = {"launches": {"training_step": launches,
                        "training_repartition": rep_launches},
           "tiered_step_ms": step_ms, "fused_step_ms": fused_ms,
           "ulps": ulps, "past_slack": past, "tiny": tiny_runs}
    log(f"phase13/done,seconds={time.perf_counter() - t_phase:.2f}")
    stats["training"] = out
    return out


#: phase 14: recurrentgemma-9b's and whisper-large-v3's decodes (batch,
#: steps, cache rows), the fp32 replay's tokens and bound (the reference
#: test's), the full-width training cuts' batch and the tiny runs' steps
FAM_B, FAM_STEPS, FAM_REPLAY, FAM_REPLAY_BOUND = 8, 64, 8, 5e-3
RG_CACHE, WHISPER_CACHE = 4096, 448  # 448: whisper's decoder context
#: kernel-path gradients of the rwkv cut against the plain path's, fp32:
#: each leaf within this share of its largest magnitude (the kernel's y
#: sums in another order; the backward is the same recomputation)
WKV_GRAD_REL = 1e-3
#: the ring-shape kernel check's limit (atol; rtol on acc, l and the
#: normalised output), ~10x the error bf16 inputs leave at this shape; a
#: skipped 256-row block must fail it (the check asserts that it does)
RING_TOL, RING_RTOL = 2e-3, 1e-2
FAM_TINY = ("rwkv6-7b", "deepseek-moe-16b", "recurrentgemma-9b",
            "whisper-large-v3")


def f32_tree(tree: dict, cut: dict = None) -> dict:
    """``tree`` (a ParamTree's ``tree()``) in fp32, the stacks named in
    ``cut`` cut to their first ``cut[name]`` entries."""
    import torch
    cut = cut or {}

    def walk(node, n):
        return {k: walk(v, n) if isinstance(v, dict) else
                (v if n is None else v[:n]).to(torch.float32)
                for k, v in node.items()}
    return {k: walk(v, cut.get(k)) if isinstance(v, dict)
            else v.to(torch.float32) for k, v in tree.items()}


def numpy_tree(params) -> dict:
    """A port parameter module as the reference's nested tree of numpy
    arrays (what ``params_from_jax`` reads)."""
    out: dict = {}
    for name, p in params.named_parameters():
        node = out
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.detach().cpu().numpy()
    return out


def greedy_decode(mod, cfg, params, cache, tok, steps: int) -> tuple:
    """``steps`` greedy decode steps from ``tok``: (ms, the last logits,
    the cache, the next token), the logits finite throughout."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    bad = torch.zeros((), dtype=torch.int64, device=tok.device)
    ev[0].record()
    for _ in range(steps):
        logits, cache = mod.decode_step(cfg, params, cache, tok)
        bad += (~torch.isfinite(logits)).sum()
        tok = torch.argmax(logits, -1)
    ev[1].record()
    ev[1].synchronize()
    assert int(bad) == 0, f"{int(bad)} non-finite logits"
    return ev[0].elapsed_time(ev[1]), logits, cache, tok


def replay(mod, cfg, params, toks, dev, attend=None, **fwd) -> tuple:
    """(decode logits step by step (B,T,V), forward logits) over
    ``toks`` (B,T) from an empty cache; ``attend`` goes to
    ``decode_step``, ``fwd`` to ``forward``."""
    import torch
    B, T = toks.shape
    full = mod.forward(cfg, params, toks, **fwd)
    cache = mod.init_cache(cfg, B, T, device=dev)
    if "frames" in fwd:
        xk, xv = mod.prepare_cross(cfg, params,
                                   mod.encode(cfg, params, fwd["frames"]))
        cache["xk"], cache["xv"] = xk, xv
    outs = []
    for i in range(T):
        lg, cache = mod.decode_step(cfg, params, cache, toks[:, i],
                                    attend=attend)
        outs.append(lg)
    return torch.stack(outs, 1), full


def clone_cache(cache: dict) -> dict:
    """A copy of a decode cache's mutable tensors (the read-only cross
    K/V ``xk``/``xv`` shared)."""
    import torch
    return {k: (v.clone() if torch.is_tensor(v) and k not in ("xk", "xv")
                else clone_cache(v) if isinstance(v, dict) else v)
            for k, v in cache.items()}


def family_decode(stats: dict, arch_id: str, dev, profile: bool = False
                  ) -> dict:
    """One family at full width and depth, bf16, random weights: greedy
    decode steps with counts reset just before and read just after, the
    busy share of a step, then an fp32 cut's decode replay against its
    forward and a step against plain attention."""
    import dataclasses
    import torch
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.models import registry
    arch = registry.get(arch_id)
    cfg, mod = arch.cfg, arch.module
    audio = cfg.family == "audio"
    t0 = time.perf_counter()
    params = mod.init(cfg, torch.Generator(device=dev).manual_seed(14),
                      device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"phase14/{arch_id}/model,layers={cfg.n_layers},d_model="
        f"{cfg.d_model},heads={cfg.n_heads}x{cfg.resolved_head_dim},"
        f"kv_heads={cfg.n_kv_heads},vocab={cfg.vocab_padded},"
        f"params={n_params},param_bytes={2 * n_params},"
        f"init_s={time.perf_counter() - t0:.2f}")
    B, steps = FAM_B, FAM_STEPS
    gen = torch.Generator(device=dev).manual_seed(15)
    tok = torch.randint(0, cfg.vocab, (B,), generator=gen, device=dev)
    fwd, out = {}, {}
    max_len = WHISPER_CACHE if audio else RG_CACHE
    if audio:
        frames = torch.randn((B, cfg.encoder.n_ctx, cfg.d_model),
                             generator=gen, device=dev).to(torch.bfloat16)
        mod.encode(cfg, params, frames[:1, :64])  # warm-up
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        enc = mod.encode(cfg, params, frames)
        ev[1].record()
        xk, xv = mod.prepare_cross(cfg, params, enc)
        ev[2].record()
        ev[2].synchronize()
        out["encode_ms"] = ev[0].elapsed_time(ev[1])
        out["prepare_cross_ms"] = ev[1].elapsed_time(ev[2])
        assert bool(torch.isfinite(enc).all())
        del enc

    def new_cache(n):
        cache = mod.init_cache(cfg, B, n, device=dev)
        if audio:
            cache["xk"], cache["xv"] = xk, xv
        return cache
    warm = new_cache(8)
    greedy_decode(mod, cfg, params, warm, tok, 2)  # warm-up
    del warm
    cache = new_cache(max_len)
    counters = launch_counts()
    for c in counters.values():
        c.reset()
    decode_ms, logits, cache, tok = greedy_decode(mod, cfg, params, cache,
                                                  tok, steps)
    launches = {k: c.count for k, c in counters.items() if c.count}
    per_step = launches.get("decode_attention", 0) / steps
    want = 2 * cfg.n_layers if audio else len(params.unit_trees())
    assert per_step == want, (launches, want)
    assert cache["len"].tolist() == [steps] * B
    busy = device_busy_share(
        lambda: mod.decode_step(cfg, params, cache, tok))
    if profile:
        profile_steps(lambda: mod.decode_step(cfg, params, cache, tok),
                      f"phase14/{arch_id}/decode_step")
        if audio:
            profile_steps(lambda: mod.encode(cfg, params, frames),
                          f"phase14/{arch_id}/encode", n=2)
    out.update(decode_ms_per_step=decode_ms / steps,
               decode_tokens_per_s=B * steps / (decode_ms * 1e-3),
               launches=launches, launches_per_step=per_step, busy=busy)
    log(f"phase14/{arch_id}/decode,batch={B},steps={steps},"
        f"cache_rows={cache['k'].shape[2]},"
        + (f"encode_frames={cfg.encoder.n_ctx},encode_ms="
           f"{out['encode_ms']:.2f},prepare_cross_ms="
           f"{out['prepare_cross_ms']:.2f}," if audio else "")
        + f"decode_ms_per_step={decode_ms / steps:.3f},"
        f"decode_tokens_per_s={out['decode_tokens_per_s']:.1f},"
        f"decode_attention_launches_per_step={per_step:.0f},"
        f"launches={launches},device_busy_share_decode_step={busy},"
        f"peak_mem_bytes={torch.cuda.max_memory_allocated()}")

    def checks():
        res = {}
        errs = []
        a, b = clone_cache(cache), clone_cache(cache)
        got, _ = mod.decode_step(cfg, params, a, tok)
        ref_out, _ = mod.decode_step(cfg, params, b, tok,
                                     attend=checked_attend(errs))
        res["step_vs_plain"] = check_greedy(got, ref_out, "decode step")
        assert len(errs) == want, len(errs)
        # an fp32 cut at full width: the decode replay against forward
        if audio:
            c32 = dataclasses.replace(
                cfg, param_dtype="float32", n_layers=2,
                encoder=dataclasses.replace(cfg.encoder, n_layers=2))
            p32 = type(params)(f32_tree(params.tree(), {"enc_layers": 2,
                                                        "dec_layers": 2}))
            fwd["frames"] = frames[:2].float()
            rb = 2
        else:
            c32 = dataclasses.replace(cfg, param_dtype="float32",
                                      n_layers=len(cfg.block_pattern) + 1)
            p32 = type(params)(f32_tree(params.tree(), {"units": 1,
                                                        "tail_rec": 1}))
            assert p32.n_units == 1 and p32.n_tail == 1
            rb = B
        toks = torch.randint(0, cfg.vocab, (rb, FAM_REPLAY), generator=gen,
                             device=dev)
        got, full = replay(mod, c32, p32, toks, dev, **fwd)
        res["fp32/replay_vs_forward"] = check_greedy(
            got, full, "fp32 replay", FAM_REPLAY_BOUND)
        want_p, _ = replay(mod, c32, p32, toks, dev,
                           attend=da_ref.attend_partial, **fwd)
        res["fp32/replay_vs_plain_attention"] = check_greedy(
            got, want_p, "fp32 plain", FAM_REPLAY_BOUND)
        log(f"phase14/{arch_id}/decode_attention_per_layer,"
            f"calls={len(errs)},max_abs_err={max(errs):.3g}")
        return res

    for name, res in uncounted(checks).items():
        log(f"phase14/{arch_id}/{name},logits_max_abs_err={res['err']:.4g},"
            f"bound={FAM_REPLAY_BOUND if 'fp32' in name else 'none'},"
            f"logits_std={res['logits_std']:.4g},"
            f"greedy_equal={res['greedy_equal']},"
            f"greedy_compared={res['compared']}")
        out[name] = res["err"]
    del cache, params
    if audio:
        del xk, xv, frames
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ring_kernel_check(dev) -> dict:
    """``decode_attention``'s partial form at recurrentgemma-9b's ring
    shape (B 8, 2048 rows, 16 query heads on one KV head of 256, bf16),
    lengths past the ring and short of it, against its plain version at
    a limit set from bf16 rounding (``RING_TOL``, ``RING_RTOL``); the
    plain version with one 256-row block skipped must fail that limit.
    Its time beside the plain version's and its byte bound."""
    import torch
    from repro_torch.kernels.decode_attention import ops
    g = torch.Generator(device=dev).manual_seed(16)
    B, T, H, K, hd = FAM_B, 2048, 16, 1, 256
    q = torch.randn((B, H, hd), generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn((B, T, K, hd), generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn((B, T, K, hd), generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.tensor([2049, 2600, 3000, 4095, 2048, 4096, 2047, 1],
                           device=dev)
    valid = torch.arange(T, device=dev)[None] < torch.clamp_max(
        lengths + 1, T)[:, None]
    err = check_partial(q, k, v, valid, RING_TOL, RING_RTOL)
    # a planted fault: rows 512-767 skipped wherever they are valid
    skip = valid.clone()
    skip[:, 512:768] = False
    rows = valid.any(1)
    want = _plain_attend(q, k, v, valid)
    fault = _plain_attend(q, k, v, skip)
    fault_err = max(float((x - y)[rows].abs().max())
                    for x, y in zip(fault, want))
    try:
        compare_partials(fault, want, rows, RING_TOL, RING_RTOL)
        caught = False
    except AssertionError:
        caught = True
    assert caught, f"a skipped 256-row block passes the limit ({fault_err})"
    ms = time_ms(lambda: ops.attend_partial(q, k, v, valid),
                 queue_ahead=True)
    plain_ms = time_ms(lambda: _plain_attend(q, k, v, valid), iters=5)
    nbytes = 2 * k.numel() * 2 + q.numel() * 2 + valid.numel() \
        + B * H * (hd + 2) * 4
    out = {"err": err, "fault_err": fault_err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": nbytes / HBM_BW * 1e3}
    log(f"phase14/ring_kernel,B={B},rows={T},heads={H}x{hd},kv_heads={K},"
        f"lengths={lengths.tolist()},max_abs_err={err:.3g},atol={RING_TOL},"
        f"rtol={RING_RTOL},skipped_block_max_abs_err={fault_err:.3g},"
        f"skipped_block_fails_the_limit={caught},"
        f"ms={ms:.4f},plain_ms={plain_ms:.4f},"
        f"bound_ms={out['bound_ms']:.4f}")
    return out


def family_training(dev, profile: bool = False) -> dict:
    """Training on the card for the families the dense slice left out."""
    import contextlib
    import dataclasses
    import io
    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.examples import train_tiny_lm
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6 import ref as wkv_ref
    from repro_torch.launch import train
    from repro_torch.models import registry
    out = {}

    # whisper-large-v3 at full size through train.main, fused AdamW
    arch = registry.get("whisper-large-v3")
    cfg, mod = arch.cfg, arch.module
    params = mod.init(cfg, torch.Generator(device=dev).manual_seed(17),
                      device=dev)
    data = TokenPipeline(DataConfig(vocab=cfg.vocab_padded, batch=TRAIN_B,
                                    seq=TRAIN_S, seed=TRAIN_SEED))
    b0 = {k: torch.as_tensor(v).to(dev) for k, v in data.batch_at(0).items()}
    b0["frames"] = torch.as_tensor(np.random.default_rng(0).normal(
        size=(TRAIN_B, cfg.encoder.n_ctx, cfg.d_model)),
        dtype=torch.float32).to(dev, torch.bfloat16)
    with torch.no_grad():
        loss0 = float(mod.loss(cfg, params, b0))
    argv = ["--arch", "whisper-large-v3", "--offload-fraction", "0.0",
            "--device", DEVICE, "--ckpt-every", "1000", "--log-every", "1",
            "--ckpt-dir", str(ROOT / "build" / "train_ckpt")]
    text = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # one step on batch 0 at the reference test's lr (1e-3: train.main's
    # schedule gives a one-step run 0.1 of --lr); the default lr's first
    # step moves few bf16 weights past their rounding
    with contextlib.redirect_stdout(text):
        first = train.main(argv + ["--steps", "1", "--lr", "1e-2"],
                           params=params)
    with torch.no_grad():
        loss1 = float(mod.loss(cfg, params, b0))
    assert loss1 < loss0, (loss0, loss1)
    with contextlib.redirect_stdout(text):
        losses = train.main(argv + ["--steps", "4"], params=params)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [float(m) for m in re.findall(r"(\d+) ms/step", text.getvalue())]
    assert all(np.isfinite(first + losses)), losses
    out["whisper"] = {"step_ms": step_ms[2:], "peak": peak,
                      "loss0": loss0, "loss1": loss1}
    if profile:
        from repro_torch.optim import adamw
        opt_cfg, state = adamw.AdamWConfig(), adamw.init_state(params)

        def fused_step():
            _, grads = mod.loss_and_grad(cfg, params, b0, remat=True)
            adamw.apply(opt_cfg, params, grads, state)
        profile_steps(fused_step, "phase14/whisper-large-v3/train_step", n=2)
        del state
    log(f"phase14/whisper-large-v3/train,batch={TRAIN_B},seq={TRAIN_S},"
        f"frames={cfg.encoder.n_ctx},optimizer=fused_adamw,remat=1,"
        f"same_batch_loss_before={loss0:.5f},after_one_step={loss1:.5f},"
        f"losses={[round(x, 4) for x in losses]},"
        f"step_ms_first_call={step_ms[:1]},step_ms_steady={step_ms[2:]},"
        f"peak_hbm_bytes={peak}")
    del params, b0
    gc.collect()
    torch.cuda.empty_cache()

    # loss_and_grad at full width, cut in depth
    cuts = {"rwkv6-7b": {"n_layers": 2},
            "deepseek-moe-16b": {"n_layers": 2},  # the head dense + 1 unit
            "recurrentgemma-9b": {"n_layers": 4}}  # 1 unit + 1 tail
    for arch_id, cut in cuts.items():
        arch = registry.get(arch_id)
        cfg = dataclasses.replace(arch.cfg, **cut)
        mod = arch.module
        data = TokenPipeline(DataConfig(vocab=cfg.vocab_padded,
                                        batch=TRAIN_B, seq=TRAIN_S,
                                        seed=TRAIN_SEED))
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in data.batch_at(0).items()}
        for dtype in ("bfloat16", "float32") if arch_id == "rwkv6-7b" \
                else ("bfloat16",):
            c = dataclasses.replace(cfg, param_dtype=dtype)
            params = mod.init(c, torch.Generator(device=dev).manual_seed(18),
                              device=dev)
            if arch_id == "recurrentgemma-9b":
                assert params.n_units == 1 and params.n_tail == 1
            ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, grads = mod.loss_and_grad(c, params, batch, remat=True)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            assert np.isfinite(float(loss))
            if profile and dtype == "bfloat16":
                profile_steps(lambda: mod.loss_and_grad(c, params, batch,
                                                        remat=True),
                              f"phase14/{arch_id}/loss_and_grad", n=2)
                wkv_ops.LAUNCHES.reset()
            line = (f"phase14/{arch_id}/loss_and_grad,dtype={dtype},"
                    f"layers={c.n_layers},batch={TRAIN_B},seq={TRAIN_S},"
                    f"remat=1,ms={[round(x, 2) for x in ms]},"
                    f"loss={float(loss):.5f}")
            if arch_id == "rwkv6-7b":
                # train.main's call (remat=True), the counts reset just
                # before it and read just after: one launch a layer in
                # the forward and one a layer again in the backward's
                # recomputation
                wkv_ops.LAUNCHES.reset()
                _, grads = mod.loss_and_grad(c, params, batch, remat=True)
                step_launches = wkv_ops.LAUNCHES.reset()
                assert step_launches == 2 * c.n_layers, step_launches
                out["wkv6_training_launches"] = step_launches
                # a side figure: without remat, one launch a layer
                mod.loss_and_grad(c, params, batch)
                fwd_launches = wkv_ops.LAUNCHES.reset()
                assert fwd_launches == c.n_layers, fwd_launches
                line += (f",wkv6_launches_training_step={step_launches},"
                         f"wkv6_launches_without_remat={fwd_launches}")
                t0 = time.perf_counter()
                _, plain = mod.loss_and_grad(c, params, batch, remat=True,
                                             wkv=wkv_ref.wkv6)
                torch.cuda.synchronize()
                plain_ms = (time.perf_counter() - t0) * 1e3
                assert wkv_ops.LAUNCHES.count == 0
                line += f",plain_wkv_loss_and_grad_ms={plain_ms:.2f}"
                if dtype == "float32":
                    rel = max(float((grads[k] - plain[k]).abs().max())
                              / max(float(plain[k].abs().max()), 1e-30)
                              for k in plain)
                    assert rel <= WKV_GRAD_REL, rel
                    out["wkv6_grad_rel"] = rel
                    line += (f",grads_vs_plain_path_max_rel={rel:.3g},"
                             f"tol_rel={WKV_GRAD_REL},leaves={len(plain)}")
                    bwd = wkv_backward_ms(c, params, batch, dev)
                    out["wkv6_backward_ms"] = bwd
                    line += f",wkv6_backward_ms_per_layer={bwd:.2f}"
                del plain
            log(line)
            out.setdefault("loss_and_grad_ms", {})[f"{arch_id}/{dtype}"] = ms
            del params, grads
            gc.collect()
            torch.cuda.empty_cache()

    # the tiny driver, card against CPU; rwkv's wkv6 launches counted over
    # the card's run (remat: two a layer a step)
    for arch_id in FAM_TINY:
        arch = registry.get(arch_id)
        tree = numpy_tree(arch.module.init(arch.cfg.tiny(), 3, device="cpu"))
        wkv_ops.LAUNCHES.reset()
        card_l, card_c = train_tiny(arch_id, "cuda", TINY_TIERED, tree)
        if arch_id == "rwkv6-7b":
            n = wkv_ops.LAUNCHES.count
            assert n == TRAIN_TINY_STEPS * 2 * arch.cfg.tiny().n_layers, n
            out["wkv6_tiny_driver_launches"] = n
        cpu_l, cpu_c = train_tiny(arch_id, "cpu", TINY_TIERED, tree)
        diff = float(np.abs(np.array(card_l) - np.array(cpu_l)).max())
        assert diff <= 1e-4 and card_c == cpu_c, (arch_id, diff, card_c,
                                                  cpu_c)
        out.setdefault("tiny", {})[arch_id] = diff
        log(f"phase14/{arch_id}/tiny_driver,steps={TRAIN_TINY_STEPS},"
            f"tiered_caption=1,max_loss_diff={diff:.3g},"
            + (f"wkv6_launches={out['wkv6_tiny_driver_launches']},"
               if arch_id == "rwkv6-7b" else "") +
            f"caption_decisions={len(card_c)},final_loss={card_l[-1]:.4f}")

    # the ~100M example at its defaults
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        losses = train_tiny_lm.main(
            ["--device", DEVICE, "--ckpt-dir",
             str(ROOT / "build" / "train_100m")])
    out["tiny_lm"] = (losses[0], losses[-1])
    log(f"phase14/train_tiny_lm,steps={len(losses)},first_loss="
        f"{losses[0]:.4f},final_loss={losses[-1]:.4f},"
        f"seconds={time.perf_counter() - t0:.2f}")
    return out


def wkv_backward_ms(cfg, params, batch, dev) -> float:
    """The recomputing backward of one ``wkv6`` call at the model's
    shapes (B x T, rwkv6-7b's 64 heads of 64): ms of ``Wkv6Fn.backward``
    alone (the plain recurrence's forward and its autograd)."""
    import torch
    from repro_torch.kernels.wkv6 import ops
    B, T = batch["tokens"].shape
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    g = torch.Generator(device=dev).manual_seed(19)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)
    xs = [rnd(B, T, H, hd) for _ in range(3)] + [
        torch.sigmoid(rnd(B, T, H, hd)), rnd(H, hd), rnd(B, H, hd, hd)]
    xs = [x.requires_grad_(True) for x in xs]
    y, s = ops.wkv6(*xs)
    gy = torch.randn_like(y)

    def backward():
        torch.autograd.grad(y, xs, gy, retain_graph=True)
    return time_ms(backward, iters=3, warmup=1)


def phase_families(stats: dict, profile: bool = False) -> dict:
    """recurrentgemma-9b and whisper-large-v3 decoding at full size, the
    ring-shape kernel check, then training for the four families the
    dense slice left out.  ``profile`` adds where a decode step's, an
    encode's and a training step's time goes."""
    import torch
    dev = torch.device(DEVICE)
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {"rglru": family_decode(stats, "recurrentgemma-9b", dev, profile),
           "whisper": family_decode(stats, "whisper-large-v3", dev, profile),
           "ring": ring_kernel_check(dev),
           "training": family_training(dev, profile)}
    log(f"phase14/done,seconds={time.perf_counter() - t_phase:.2f}")
    stats["families"] = out
    return out


#: phase 15 (a): internvl2-2b at full size, 8 slots of 4096 positions in
#: pages of 64, prompts of 2048 tokens, 64 new tokens, ``host-c`` killed
#: after decode step 16 (the monitor's timeout is 1.5 steps)
EL_B, EL_T, EL_PAGE, EL_PROMPT, EL_NEW, EL_KILL = 8, 4096, 64, 2048, 64, 16
EL_HOSTS = ("host-a", "host-b", "host-c")
#: phase 15 (b): starcoder2-3b at full width, 2 layers, 6 steps; F fails at
#: step 3 (checkpoints every 2), S at step 1 (before any checkpoint)
RES_LAYERS, RES_STEPS, RES_EVERY, RES_FAIL_F, RES_FAIL_S = 2, 6, 2, 3, 1


def elastic_topology_h100():
    """HBM and three page-locked host pools, each its own device (they
    share one PCIe link, which the modeled rates do not know)."""
    import dataclasses
    from repro_torch.core import H100_HBM, H100_HOST_PINNED, TierTopology
    return TierTopology(fast=H100_HBM, slows=tuple(
        dataclasses.replace(H100_HOST_PINNED, name=n) for n in EL_HOSTS))


def prefill_kv(cfg, params, tokens):
    """Each layer's rotated K and V of ``tokens`` (B, S): two (L, B, S, K,
    hd) tensors, from the full-sequence forward."""
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer
    from repro_torch.models.common import apply_norm, apply_rope
    ks, vs = [], []
    with torch.no_grad():
        x, positions = transformer.embed_tokens(params, tokens)
        for lp in params.layer_trees():
            h = apply_norm(x, lp["ln1"], cfg.norm)
            _, k, v = attn._project_qkv(h, lp["attn"], cfg.n_heads,
                                        cfg.n_kv_heads, cfg.resolved_head_dim)
            ks.append(apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
                      if cfg.rope else k)
            vs.append(v)
            x = transformer._layer_fwd(cfg, x, lp, positions)
    return torch.stack(ks), torch.stack(vs)


def elastic_engine(cfg, params, topo, dev):
    """The serving engine of phase 15 (a): Caption seeded at the policy's
    weights, the arbiter, a synchronous mover on ``stream_copy``."""
    from repro_torch.core import (BulkMover, CaptionArbiter, CaptionConfig,
                                  CaptionController, MemPolicy,
                                  stream_executor)
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.serving.engine import ServingEngine
    names = (topo.fast.name,) + topo.slow_names
    caption = CaptionController(topo, CaptionConfig(epoch_steps=8),
                                initial_weights=(1 / 8,) * 3)
    tel = Telemetry()
    mover = BulkMover(topo, asynchronous=False, execute=stream_executor(),
                      telemetry=tel, device=dev)
    eng = ServingEngine(cfg, params, max_batch=EL_B, max_len=EL_T,
                        page_t=EL_PAGE, topology=topo,
                        policy=MemPolicy.weighted(names, (5, 1, 1, 1)),
                        caption=caption, arbiter=CaptionArbiter(topo),
                        mover=mover, telemetry=tel, device=dev)
    return eng, mover, tel


def elastic_serve(cfg, params, prompts, kv, dev, kill: bool,
                  audit: dict) -> dict:
    """One run of phase 15 (a): the prompts' K/V written into their slots,
    decode to the end with heartbeats every step; with ``kill``, host-c
    dies after step EL_KILL, is drained through ``remove_device(monitor=)``
    as ``fig_elastic`` does it, then revived, re-added and given one more
    request.  Returns each request's tokens, every step's top-2 logit
    gaps, the tokens/s of each stretch and the ``decode_attention``
    launches."""
    import torch
    from repro_torch.benchmarks.common import launch_bound
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.stream_copy import ops as sc_ops
    from repro_torch.runtime.elastic import FaultInjector
    from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor,
                                                     WorkerFailure)
    topo = elastic_topology_h100()
    eng, mover, tel = elastic_engine(cfg, params, topo, dev)
    names = (topo.fast.name,) + topo.slow_names
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    gaps = []  # every step's top-2 logit gap a slot, on the host
    want_da = [0]

    inner = eng._decode

    def decode(p, cache, tokens):
        want_da[0] += L * sum(1 for t in cache.k_parts if t.shape[2])
        logits, cache = inner(p, cache, tokens)
        top2 = torch.topk(logits.float(), 2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).cpu())
        return logits, cache
    eng._decode = decode
    try:
        for i in range(EL_B):
            # the prompt's last token is the request; its first 2047 are
            # already in the slot (a prefill outside the engine's replay)
            eng.submit([int(prompts[i, -1])], max_new_tokens=EL_NEW,
                       slo="latency" if i == 0 else "batch")
        eng._admit()
        assert eng.pinned_slots == {0}, eng.pinned_slots
        for i in range(EL_B):
            eng.cache = eng.cache.write_token_rows(i, 0, kv[0][:, i],
                                                   kv[1][:, i])
        torch.cuda.synchronize()
        mon = HeartbeatMonitor(timeout=1.5)
        da_ops.LAUNCHES.reset()
        times = {"pre_kill": [], "undetected": [], "post_drain": [],
                 "post_readd": []}
        with FaultInjector(mon) as inj:
            steps, seg = 0, "pre_kill"
            while eng.queue or any(eng.slots):
                steps += 1
                now = float(steps)
                active = sum(r is not None for r in eng.slots)
                if kill and steps == 4:
                    audit["busy_share"] = device_busy_share(eng.step)
                    times["pre_kill"].clear()  # steps 1-3 warm the run up
                else:
                    t0 = time.perf_counter()
                    eng.step()
                    times[seg].append((active, time.perf_counter() - t0))
                inj.beat_alive(topo.slow_names, now=now)
                if kill and steps == EL_KILL:
                    inj.kill("host-c")
                    seg = "undetected"
                try:
                    mon.check(now=now)
                except WorkerFailure:
                    (name,) = mon.dead_workers(now=now)
                    dev_map = eng.cache.page_device.cpu().numpy()
                    assert (dev_map[0] == 0).all(), "slot 0 left HBM"
                    dead = int((dev_map == 3).sum())
                    pre = {d: (tel.route(name, d).bytes_moved,
                               tel.route(name, d).descriptors)
                           for d in names}
                    torch.cuda.synchronize()
                    sc_ops.LAUNCHES.reset()
                    t0 = time.perf_counter()
                    eng.remove_device(name, monitor=mon)
                    torch.cuda.synchronize()
                    drain_s = time.perf_counter() - t0
                    launches = sc_ops.LAUNCHES.reset()
                    billed = sum(tel.route(name, d).bytes_moved - pre[d][0]
                                 for d in names)
                    descs = [tel.route(name, d).descriptors - pre[d][1]
                             for d in names]
                    page_b = eng.cache._page_kv_bytes()
                    dev_map = eng.cache.page_device.cpu().numpy()
                    assert dead > 0, "host-c held no page at the kill"
                    assert billed == dead * page_b, (billed, dead, page_b)
                    assert not (dev_map == 3).any(), "pages left on host-c"
                    assert (dev_map[0] == 0).all(), "slot 0 left HBM"
                    assert 0 < launches <= launch_bound(descs), (
                        launches, descs)
                    mon.check(now=now)  # recovery acknowledged
                    audit.update(
                        device=name, detected_at_step=steps,
                        dead_pages=dead, page_kv_bytes=page_b,
                        drain_bytes=billed, drain_s=drain_s,
                        drain_descriptors=descs,
                        drain_stream_copy_launches=launches,
                        drain_launch_bound=launch_bound(descs),
                        weights_after=dict(zip(
                            eng.caption.topology.slow_names,
                            (round(w, 6) for w in eng.caption.weights))))
                    # after the drain: the kernels against plain attention
                    # on the next step, and every slot's prompt rows read
                    # back through its page map
                    check = uncounted(lambda: check_step_logits(eng, params))
                    for i in range(EL_B):
                        k_got, v_got = uncounted(
                            lambda: eng.cache.gather_token_rows(
                                i, 0, EL_PROMPT - 1))
                        assert torch.equal(k_got, kv[0][:, i]) and \
                            torch.equal(v_got, kv[1][:, i]), i
                    audit["check"] = check
                    seg = "post_drain"
            if kill:
                assert audit.get("device") == "host-c", audit
                inj.revive("host-c")
                eng.add_device("host-c")
                assert eng.topology.slow_names == EL_HOSTS
                eng.submit([int(prompts[0, -1])], max_new_tokens=EL_NEW)
                seg = "post_readd"
                while eng.queue or any(eng.slots):
                    t0 = time.perf_counter()
                    eng.step()
                    times[seg].append((1, time.perf_counter() - t0))
                mon.check(now=float(steps))
        torch.cuda.synchronize()
        da_launches = da_ops.LAUNCHES.count
        assert da_launches == want_da[0], (da_launches, want_da[0])
        done = {r.rid: list(r.generated) for r in eng.done}
        assert len(done) == EL_B + int(kill), sorted(done)
        assert all(len(t) == EL_NEW for t in done.values()), done
        rates = {k: (sum(a for a, _ in v) / sum(s for _, s in v)
                     if v else 0.0) for k, v in times.items()}
        return {"tokens": done, "gaps": gaps, "rates": rates,
                "decode_attention": da_launches,
                "per_step": want_da[0] / len(gaps),
                "slow_fraction": eng.cache.slow_fraction(eng.pinned_slots)}
    finally:
        mover.close()


def elastic_tokens_agree(kill: dict, clean: dict, err: float) -> dict:
    """Each request's tokens against the clean run's, up to its first
    difference: that token must be one whose top-2 gap in the clean run
    is at most 4x the measured logit error (past it the inputs differ)."""
    compared = differed = 0
    for rid in range(EL_B):
        got, want = kill["tokens"][rid], clean["tokens"][rid]
        for j, (a, b) in enumerate(zip(got, want)):
            compared += 1
            if a != b:
                gap = float(clean["gaps"][j][rid])
                assert gap <= 4 * err, (rid, j, gap, err)
                differed += 1
                break
    return {"compared": compared, "first_differences": differed}


def elastic_serving(stats: dict) -> dict:
    """Phase 15 (a): internvl2-2b at full size losing a pinned device
    mid-decode, against a run that loses nothing."""
    import numpy as np
    import torch
    from repro_torch.models import registry
    dev = torch.device(DEVICE)
    t0 = time.perf_counter()
    arch = registry.get("internvl2-2b")
    cfg = arch.cfg
    params = arch.module.init(cfg, torch.Generator(device=dev).manual_seed(25),
                              device=dev)
    n_params = sum(p.numel() for p in params.parameters())
    rng = np.random.default_rng(25)
    prompts = rng.integers(0, cfg.vocab, size=(EL_B, EL_PROMPT))
    kv = prefill_kv(cfg, params, torch.as_tensor(prompts[:, :-1], device=dev))
    torch.cuda.synchronize()
    kv_bytes = (2 * cfg.n_layers * EL_B * EL_T * cfg.n_kv_heads
                * cfg.resolved_head_dim * 2)
    log(f"phase15/serving_model,arch={cfg.name},layers={cfg.n_layers},"
        f"d_model={cfg.d_model},heads={cfg.n_heads}x"
        f"{cfg.resolved_head_dim},kv_heads={cfg.n_kv_heads},vocab="
        f"{cfg.vocab},params={n_params},param_bytes={2 * n_params},"
        f"slots={EL_B},positions={EL_T},page_t={EL_PAGE},prompt={EL_PROMPT},"
        f"new_tokens={EL_NEW},kv_cache_bytes={kv_bytes},"
        f"setup_s={time.perf_counter() - t0:.2f}")
    audit: dict = {}
    t0 = time.perf_counter()
    killed = elastic_serve(cfg, params, prompts, kv, dev, True, audit)
    kill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    clean = elastic_serve(cfg, params, prompts, kv, dev, False, {})
    clean_s = time.perf_counter() - t0
    agree = elastic_tokens_agree(killed, clean, audit["check"]["err"])
    gb = audit["drain_bytes"] / 1e9
    check = audit["check"]
    log(f"phase15/drain,device={audit['device']},detected_at_step="
        f"{audit['detected_at_step']},dead_pages={audit['dead_pages']},"
        f"page_kv_bytes={audit['page_kv_bytes']},drain_bytes="
        f"{audit['drain_bytes']},bytes_equal_dead_pages_x_page=1,"
        f"drain_ms={audit['drain_s'] * 1e3:.2f},drain_GBps="
        f"{gb / audit['drain_s']:.3f},pcie_bound_ms="
        f"{audit['drain_bytes'] / PCIE_BW * 1e3:.3f},descriptors_by_route="
        f"{audit['drain_descriptors']},stream_copy_launches="
        f"{audit['drain_stream_copy_launches']},launch_bound="
        f"{audit['drain_launch_bound']},weights_after_reseed="
        f"{audit['weights_after']}")
    log(f"phase15/after_drain_check,logits_max_abs_err={check['err']:.4g},"
        f"greedy_equal={check['greedy_equal']},greedy_compared="
        f"{check['compared']},prompt_rows_read_back_bit_equal=1")
    log(f"phase15/serving,requests_done={len(killed['tokens'])},dropped=0,"
        f"tokens_per_s_pre_kill={killed['rates']['pre_kill']:.1f},"
        f"tokens_per_s_post_drain={killed['rates']['post_drain']:.1f},"
        f"tokens_per_s_post_readd={killed['rates']['post_readd']:.1f},"
        f"tokens_per_s_clean={clean['rates']['pre_kill']:.1f},"
        f"busy_share={audit['busy_share']},decode_attention_launches="
        f"{killed['decode_attention']},per_step={killed['per_step']:.1f},"
        f"clean_run_launches={clean['decode_attention']},"
        f"tokens_compared={agree['compared']},first_differences="
        f"{agree['first_differences']},kill_run_s={kill_s:.2f},"
        f"clean_run_s={clean_s:.2f}")
    return {"launches": {"decode_attention": killed["decode_attention"],
                         "stream_copy":
                             audit["drain_stream_copy_launches"]}}


def state_diff(tree, snap: dict) -> list:
    """Paths of the state's tensor leaves that differ in a bit from
    ``snap``, a ``fault_tolerance._snapshot`` of it."""
    import torch
    from repro_torch.tree import flatten, name
    return [name(p) for p, x in flatten(tree) if isinstance(x, torch.Tensor)
            and not torch.equal(x.cpu(), snap[p])]


def resilient_training() -> dict:
    """Phase 15 (b): starcoder2-3b at full width, cut to 2 layers, fused
    AdamW; three ``ResilientLoop`` runs from one initial state (written
    back in place before each), whose final states must be equal to the
    bit."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import registry
    from repro_torch.optim import adamw, schedules
    from repro_torch.runtime.elastic import FaultInjector
    from repro_torch.runtime.fault_tolerance import (HeartbeatMonitor,
                                                     ResilientLoop, _restore,
                                                     _snapshot)
    from repro_torch.tree import named_leaves
    dev = torch.device(DEVICE)
    arch = registry.get("starcoder2-3b")
    cfg = dataclasses.replace(arch.cfg, n_layers=RES_LAYERS)
    mod = arch.module
    params = mod.init(cfg, torch.Generator(device=dev).manual_seed(15),
                      device=dev)
    opt_cfg = adamw.AdamWConfig(lr=3e-4, schedule=schedules.warmup_cosine(
        10, 100))
    data = TokenPipeline(DataConfig(vocab=cfg.vocab_padded, batch=TRAIN_B,
                                    seq=TRAIN_S, seed=TRAIN_SEED))
    state = {"params": params, "opt": adamw.init_state(params)}
    state_bytes = sum(x.numel() * x.element_size()
                      for _, x in named_leaves(state)
                      if isinstance(x, torch.Tensor))
    n_params = sum(p.numel() for _, p in named_leaves(params))
    initial = _snapshot(state)
    n_leaves = sum(isinstance(x, torch.Tensor) for x in initial.values())
    root = ROOT / "build" / "resilient_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    log(f"phase15/training_model,arch={cfg.name},layers={cfg.n_layers},"
        f"d_model={cfg.d_model},heads={cfg.n_heads}x{cfg.resolved_head_dim},"
        f"kv_heads={cfg.n_kv_heads},d_ff={cfg.d_ff},vocab={cfg.vocab_padded},"
        f"params={n_params},state_bytes={state_bytes},batch={TRAIN_B}x"
        f"{TRAIN_S},free_disk_bytes={free}")
    losses: list = []
    step_ms: list = []

    def step_fn(st, s):
        batch = {k: torch.as_tensor(v).to(dev)
                 for k, v in data.batch_at(s).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads = mod.loss_and_grad(cfg, st["params"], batch, remat=True)
        _, opt, _ = adamw.apply(opt_cfg, st["params"], grads, st["opt"])
        losses.append((s, float(loss)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return {"params": st["params"], "opt": opt}

    # two uninterrupted stretches from one state agree to the bit, or a
    # replay could not
    state = _restore(state, initial)
    for s in range(2):
        state = step_fn(state, s)
    first = _snapshot(state)
    state = _restore(state, initial)
    for s in range(2):
        state = step_fn(state, s)
    diff = state_diff(state, first)
    assert not diff, f"two runs of steps 0-1 differ in {diff}"
    del first
    log(f"phase15/determinism,steps=2,runs=2,leaves_bit_equal="
        f"{n_leaves}/{n_leaves},losses={[x for _, x in losses]}")

    ckpt_times = {"save": [], "restore": []}

    def timed_checkpointer(directory):
        ck = Checkpointer(str(directory), asynchronous=False, keep=1)
        for what in ("save", "restore"):
            fn = getattr(ck, what)

            def wrapped(*a, _fn=fn, _what=what, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
                ckpt_times[_what].append(time.perf_counter() - t0)
                return out
            setattr(ck, what, wrapped)
        return ck

    def failing_at(at):
        """A failure injector: at step ``at`` (once) the FaultInjector
        kills worker-0, two seconds pass on the monitor's clock, and its
        check raises WorkerFailure; the next call revives the worker."""
        mon = HeartbeatMonitor(timeout=1.5)
        inj = FaultInjector(mon)
        clock = [0.0]
        workers = ("worker-0", "worker-1")

        def injector(step):
            clock[0] += 1.0
            if "worker-0" in inj.dead:
                inj.revive("worker-0")
                inj.beat_alive(workers, now=clock[0])
                mon.check(now=clock[0])
            inj.beat_alive(workers, now=clock[0])
            if step == at and not inj.log:
                inj.kill("worker-0")
                clock[0] += 2.0
                inj.beat_alive(workers, now=clock[0])
            mon.check(now=clock[0])
        return injector, inj

    runs = {}
    final = None
    for run, every, fail in (("U", 100, None), ("F", RES_EVERY, RES_FAIL_F),
                             ("S", 100, RES_FAIL_S)):
        state = _restore(state, initial)
        losses.clear()
        step_ms.clear()
        injector, inj = failing_at(fail) if fail is not None else (None,
                                                                    None)
        loop = ResilientLoop(timed_checkpointer(root / run),
                             checkpoint_every=every)
        t0 = time.perf_counter()
        out = loop.run({"step": 0, **state}, step_fn, RES_STEPS,
                       failure_injector=injector)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        state = {"params": out["params"], "opt": out["opt"]}
        assert out["step"] == RES_STEPS, out["step"]
        by_step: dict = {}
        for s, x in losses:  # a replayed step gives its first loss again
            assert by_step.setdefault(s, x) == x, (run, s, by_step[s], x)
        runs[run] = {"restarts": loop.restarts, "losses": by_step,
                     "executed_steps": len(losses), "seconds": run_s,
                     "step_ms": list(step_ms),
                     "log": [a for _, a, _ in inj.log] if inj else []}
        if final is None:
            final = _snapshot(state)
        else:
            diff = state_diff(state, final)
            assert not diff, f"{run} differs from U in {diff}"
            assert by_step == runs["U"]["losses"], (run, by_step)
        shutil.rmtree(root / run)
    assert runs["U"]["restarts"] == 0
    assert runs["F"]["restarts"] == runs["S"]["restarts"] == 1, runs
    assert runs["F"]["log"] == runs["S"]["log"] == ["kill", "revive"], runs
    assert runs["F"]["executed_steps"] == RES_STEPS + RES_FAIL_F - 2
    assert runs["S"]["executed_steps"] == RES_STEPS + RES_FAIL_S
    shutil.rmtree(root, ignore_errors=True)
    ck_bytes = state_bytes
    save_s = sorted(ckpt_times["save"])
    restore_s = ckpt_times["restore"]
    assert len(restore_s) == 1, ckpt_times
    log(f"phase15/resilient,runs=U;F;S,final_states_bit_equal=1,"
        f"leaves={n_leaves},losses={[runs['U']['losses'][s] for s in range(RES_STEPS)]},"
        f"losses_equal=1,restarts=U{runs['U']['restarts']};F"
        f"{runs['F']['restarts']};S{runs['S']['restarts']},executed_steps="
        f"U{runs['U']['executed_steps']};F{runs['F']['executed_steps']};S"
        f"{runs['S']['executed_steps']},run_s="
        + ";".join(f"{k}{v['seconds']:.2f}" for k, v in runs.items())
        + f",step_ms_U={[round(x, 2) for x in runs['U']['step_ms']]}")
    log(f"phase15/checkpoint,bytes={ck_bytes},saves={len(save_s)},"
        f"save_s={[round(x, 3) for x in save_s]},save_GBps_median="
        f"{ck_bytes / save_s[len(save_s) // 2] / 1e9:.3f},restore_s="
        f"{restore_s[0]:.3f},restore_GBps={ck_bytes / restore_s[0] / 1e9:.3f}")
    return {"runs": runs}


def release_host_cache() -> str:
    """Free what the earlier phases left: HBM blocks and the page-locked
    blocks PyTorch's host allocator keeps for reuse (it never returns
    them itself; the machine's host memory is 96 GiB).  Returns the call
    this PyTorch offers for the latter ("none" where it has none)."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    for owner, name in ((torch.accelerator, "empty_host_cache"),
                        (torch._C, "_host_emptyCache")):
        fn = getattr(owner, name, None)
        if fn is not None:
            fn()
            return name
    return "none"


def phase_elastic(stats: dict) -> dict:
    """Phase 15: the elastic runtime on the card at full width."""
    import resource
    log(f"phase15/host,pinned_before={pinned_stats()},released_by="
        f"{release_host_cache()},pinned_after={pinned_stats()}")
    t_phase = time.perf_counter()
    serving = elastic_serving(stats)
    release_host_cache()
    training = resilient_training()
    log(f"phase15/done,seconds={time.perf_counter() - t_phase:.2f},"
        f"pinned={pinned_stats()},max_rss_bytes="
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}")
    return {"serving": serving, "training": training}


# ---------------------------------------------------------------------------
# Phase 16: the pod-lowering tooling on one card
# ---------------------------------------------------------------------------
STEPS_SERVE_B, STEPS_SERVE_T, STEPS_SERVE_FILL, STEPS_SERVE_N = 16, 4096, 3072, 16
STEPS_PREFILL_B, STEPS_PREFILL_T = 16, 1024
STEPS_TIMED = 2
DENSE_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (data sheet, 700 W)


def steps_cells():
    """(label, arch, shape, lower_cell keywords) of phase 16's dry runs:
    the four timed steps at their shapes (training at phase 13's batch,
    fused: what is timed), and ``test_dryrun_machinery_small_mesh``'s
    cell."""
    from repro_torch.launch.shapes import ShapeSpec
    train = ShapeSpec("steps_train", TRAIN_S, TRAIN_B, "train")
    return [
        ("a/n_micro=1", "starcoder2-3b", train,
         {"n_micro": 1, "offload": False}),
        ("a/n_micro=2", "starcoder2-3b", train,
         {"n_micro": 2, "offload": False}),
        ("b", "whisper-large-v3", train, {"n_micro": 1, "offload": False}),
        ("c", "starcoder2-3b", ShapeSpec("steps_serve", STEPS_SERVE_T,
                                         STEPS_SERVE_B, "decode"), {}),
        # the plain recurrence's work, which the timed step's kernel does
        ("d", "rwkv6-7b", ShapeSpec("steps_prefill", STEPS_PREFILL_T,
                                    STEPS_PREFILL_B, "prefill"),
         {"wkv_chunked": False}),
        ("small_mesh_cell", "internvl2-2b",
         ShapeSpec("train_tiny", 512, 8, "train"), {"n_micro": 2}),
    ]


def print_dry(label: str, rec: dict, total: int) -> None:
    mem = rec["memory"]
    log(f"phase16/dryrun/{label},arch={rec['arch']},shape={rec['shape']},"
        f"kind={rec['kind']},n_micro={rec['n_micro']},offload_opt="
        f"{rec['offload_opt']},flops={rec['hlo']['flops_per_device']:.6e},"
        f"bytes={rec['hlo']['hbm_bytes_per_device']:.6e},"
        f"argument_bytes={mem['argument_bytes']},activation_peak_bytes="
        f"{mem['activation_peak_bytes']},peak_per_device="
        f"{mem['peak_per_device']},fits_hbm={rec['fits_hbm']},"
        f"total_memory={total},model_flops={rec['model_flops_total']:.6e},"
        f"trace_s={rec['trace_s']}")


def beside_roofline(label: str, rec: dict, ms: float) -> dict:
    """A measured step beside its dry-run record's roofline terms."""
    from repro_torch.benchmarks import roofline
    t = roofline.terms(rec)
    bound = max(t["compute_s"], t["memory_s"], t["collective_s"],
                t["tier_s"])
    out = {"ms": ms, "compute_s": t["compute_s"], "memory_s": t["memory_s"],
           "tier_s": t["tier_s"], "dominant": t["dominant"],
           "mfu": rec["model_flops_total"] / (ms * 1e-3 * DENSE_BF16_FLOPS),
           "x_bound": ms * 1e-3 / bound}
    log(f"phase16/roofline/{label},ms={ms:.3f},compute_s={t['compute_s']:.6f},"
        f"memory_s={t['memory_s']:.6f},tier_s={t['tier_s']:.6f},"
        f"dominant={t['dominant']},mfu={out['mfu']:.4f},"
        f"x_bound={out['x_bound']:.3f}")
    return out


def timed_steps(step, n: int) -> tuple[float, float]:
    """(CUDA events' ms, the host clock's ms) a call of ``step()`` over
    ``n`` calls after one untimed call, the window synchronised."""
    import torch
    step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        step()
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    ev_ms = start.elapsed_time(end) / n
    return ev_ms, host_ms


AGREE_STEPS = 2  # (a)'s steps held n_micro 2 against 1, on batches 0, 1
# (a)'s loss limits a step: the first from one state; the second at
# parameters the first step's bf16 rounding has already set apart (a few
# per cent of the change), still a small share of what a step moves a loss
LOSS_GAP = (5e-3, 1e-2)


def update_gap(params, snap: dict, first: dict, dev) -> dict:
    """``params``' change from ``first`` against ``snap``'s (the other
    n_micro's after as many steps), leaf by leaf in fp32 on the card:
    the RMS of ``snap``'s change, the RMS and the mean of the gap between
    the two changes, the gap's L2 over the change's, and the largest
    parameter gap."""
    import torch
    n, sq_ref, sq_gap, abs_gap, worst = 0, 0.0, 0.0, 0.0, 0.0
    with torch.no_grad():
        for k, p in params.named_parameters():
            f = first[k].to(dev).float()
            ref = snap[k].to(dev).float() - f
            gap = (p.float() - f) - ref
            n += p.numel()
            sq_ref += float(torch.sum(ref * ref))
            sq_gap += float(torch.sum(gap * gap))
            abs_gap += float(torch.sum(gap.abs()))
            worst = max(worst, float(gap.abs().max()))
    return {"rms_change": (sq_ref / n) ** 0.5, "rms_gap": (sq_gap / n) ** 0.5,
            "mean_abs_gap": abs_gap / n,
            "rel_gap": (sq_gap / sq_ref) ** 0.5 if sq_ref else float("inf"),
            "param_gap": worst}


def check_update_gap(gap: dict, lr: float, step: int) -> None:
    """(a)'s limits on one step's :func:`update_gap`.  AdamW's first
    update is ~lr a parameter, rounded to the bf16 grid (|p| < 2^-4 for
    all but a few of the 0.02-std weights, whose grid is finer than lr),
    so its RMS lies within (lr/4, 2 lr).  The two gradients differ only by
    bf16 rounding (n_micro 1 keeps bf16 gradients, 2 sums them in fp32),
    so the changes part only where an update lands near a rounding
    boundary, by one bf16 spacing: the mean gap stays below lr/10 and the
    gap's L2 below a tenth of the change's.  Skipping the update, or
    taking one micro-batch's gradient (which flips the sign of a large
    share of updates), breaks them."""
    if step == 0:
        assert lr / 4 < gap["rms_change"] < 2 * lr, gap
    assert gap["mean_abs_gap"] < lr / 10, gap
    assert gap["rel_gap"] < 0.1, gap
    assert gap["param_gap"] < 5e-2, gap


def steps_training(records: dict, dev) -> dict:
    """(a) starcoder2-3b through ``make_train_step`` at n_micro 1 and 2
    from one state: two steps on two batches, the losses within
    :data:`LOSS_GAP`, gradient norms within 1e-2 relative, and each
    parameter's change from the start held n_micro 2 against 1
    (:func:`check_update_gap`); (b) whisper-large-v3's training step."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    out = {}
    arch = registry.get("starcoder2-3b")
    cfg = arch.cfg
    params = arch.module.init(cfg, torch.Generator(device=dev)
                              .manual_seed(13), device=dev)
    first = {k: p.detach().to("cpu", copy=True)
             for k, p in params.named_parameters()}
    data = TokenPipeline(DataConfig(vocab=cfg.vocab_padded, batch=TRAIN_B,
                                    seq=TRAIN_S, seed=TRAIN_SEED))
    batches = [{k: torch.as_tensor(v).to(dev)
                for k, v in data.batch_at(i).items()}
               for i in range(AGREE_STEPS)]
    opt_cfg = adamw.AdamWConfig()
    losses, norms, snaps, gaps = {}, {}, {}, {}
    for n_micro in (1, 2):
        with torch.no_grad():
            for k, p in params.named_parameters():
                p.copy_(first[k])
        state = adamw.init_state(params)
        fn = steps.make_train_step(arch, opt_cfg, n_micro=n_micro)
        for i, batch in enumerate(batches):
            _, state, m = fn(params, state, batch)
            losses[n_micro, i] = float(m["loss"])
            norms[n_micro, i] = float(m["grad_norm"])
            if n_micro == 1:
                snaps[i] = {k: p.detach().to("cpu", copy=True)
                            for k, p in params.named_parameters()}
            else:
                gaps[i] = update_gap(params, snaps[i], first, dev)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()  # a step's peak, not the check's
        ev_ms, host_ms = timed_steps(lambda: fn(params, state, batches[0]),
                                     STEPS_TIMED)
        peak = torch.cuda.max_memory_allocated()
        label = f"a/n_micro={n_micro}"
        log(f"phase16/steps/{label},arch={cfg.name},batch={TRAIN_B}x"
            f"{TRAIN_S},loss_first={losses[n_micro, 0]:.6f},step_ms="
            f"{ev_ms:.3f},host_ms={host_ms:.3f},peak_hbm_bytes={peak},"
            f"dryrun_peak_per_device="
            f"{records[label]['memory']['peak_per_device']}")
        out[label] = beside_roofline(label, records[label], ev_ms)
        out[label]["peak_hbm_bytes"] = peak
        del state
    for i in range(AGREE_STEPS):
        loss_gap = abs(losses[1, i] - losses[2, i])
        norm_gap = abs(norms[2, i] / norms[1, i] - 1)
        g = gaps[i]
        log(f"phase16/steps/a/n_micro_agree,step={i + 1},lr={opt_cfg.lr},"
            f"loss_gap={loss_gap:.3e},grad_norm={norms[1, i]:.6f},"
            f"grad_norm_rel_gap={norm_gap:.3e},rms_change="
            f"{g['rms_change']:.3e},rms_gap={g['rms_gap']:.3e},mean_abs_gap="
            f"{g['mean_abs_gap']:.3e},rel_gap={g['rel_gap']:.3e},"
            f"param_gap={g['param_gap']:.3e}")
        assert np.isfinite(losses[1, i]) and loss_gap < LOSS_GAP[i], loss_gap
        assert norm_gap < 1e-2, norm_gap
        check_update_gap(g, opt_cfg.lr, i)
    del params, first, snaps, batches, fn
    gc.collect()
    torch.cuda.empty_cache()

    arch = registry.get("whisper-large-v3")
    cfg = arch.cfg
    params = arch.module.init(cfg, torch.Generator(device=dev)
                              .manual_seed(17), device=dev)
    data = TokenPipeline(DataConfig(vocab=cfg.vocab_padded, batch=TRAIN_B,
                                    seq=TRAIN_S, seed=TRAIN_SEED))
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in data.batch_at(0).items()}
    batch["frames"] = torch.randn(
        (TRAIN_B, cfg.encoder.n_ctx, cfg.d_model),
        generator=torch.Generator(device=dev).manual_seed(0), device=dev
    ).to(torch.bfloat16)
    state = adamw.init_state(params)
    fn = steps.make_train_step(arch, adamw.AdamWConfig())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = []
    ev_ms, host_ms = timed_steps(
        lambda: losses.append(fn(params, state, batch)[2]["loss"]),
        STEPS_TIMED)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    assert all(np.isfinite(losses)), losses
    log(f"phase16/steps/b,arch={cfg.name},batch={TRAIN_B}x{TRAIN_S},frames="
        f"{cfg.encoder.n_ctx},losses={losses},step_ms={ev_ms:.3f},host_ms="
        f"{host_ms:.3f},peak_hbm_bytes={peak},dryrun_peak_per_device="
        f"{records['b']['memory']['peak_per_device']}")
    out["b"] = beside_roofline("b", records["b"], ev_ms)
    out["b"]["peak_hbm_bytes"] = peak
    return out


def steps_serving(records: dict, dev) -> dict:
    """(c) starcoder2-3b through ``make_serve_step`` over a bf16 cache of
    16 x 4096 filled to 3072 positions: 16 steps, counts from 0 around
    them (one ``decode_attention`` launch a layer a step), then a step
    against the same step with plain attention."""
    import torch
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.launch import steps
    from repro_torch.models import registry
    arch = registry.get("starcoder2-3b")
    cfg = arch.cfg
    params = arch.module.init(cfg, torch.Generator(device=dev)
                              .manual_seed(6), device=dev)
    cache = arch.module.init_cache(cfg, STEPS_SERVE_B, STEPS_SERVE_T,
                                   device=dev)
    g = torch.Generator(device=dev).manual_seed(16)
    for name in ("k", "v"):
        cache[name][:, :, :STEPS_SERVE_FILL].normal_(generator=g)
    cache["len"].fill_(STEPS_SERVE_FILL)
    serve = steps.make_serve_step(arch)
    tok = torch.randint(0, cfg.vocab, (STEPS_SERVE_B,), generator=g,
                        device=dev)
    state = {"cache": cache, "tok": tok}

    def step():
        logits, state["cache"] = serve(params, state["cache"], state["tok"])
        state["tok"] = torch.argmax(logits, dim=-1)

    step()  # untimed
    torch.cuda.synchronize()
    da_ops.LAUNCHES.reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(STEPS_SERVE_N):
        step()
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / STEPS_SERVE_N
    launches = da_ops.LAUNCHES.count
    ms = start.elapsed_time(end) / STEPS_SERVE_N
    want = cfg.n_layers * STEPS_SERVE_N
    assert launches == want, (launches, want)
    copy = {k: v.clone() for k, v in state["cache"].items()}
    got, _ = serve(params, state["cache"], state["tok"])
    plain, _ = arch.module.decode_step(cfg, params, copy, state["tok"],
                                       attend=_plain_attend)
    check = check_greedy(got, plain, "steps serve step", 0.5)
    log(f"phase16/steps/c,arch={cfg.name},batch={STEPS_SERVE_B},cache="
        f"{STEPS_SERVE_T},filled={STEPS_SERVE_FILL},steps={STEPS_SERVE_N},"
        f"step_ms={ms:.3f},host_ms={host_ms:.3f},tokens_per_s="
        f"{STEPS_SERVE_B / (ms * 1e-3):.1f},decode_attention_launches="
        f"{launches},want={want},vs_plain={check}")
    out = beside_roofline("c", records["c"], ms)
    out["launches"] = launches
    return out


def steps_prefill(records: dict, dev) -> dict:
    """(d) rwkv6-7b through ``make_prefill_step`` at 16 x 1024 without the
    chunked policy: one ``wkv6`` launch a layer, the logits against the
    forward with every layer's kernel call held to the plain recurrence
    (phase 8's check)."""
    import torch
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.launch import steps
    from repro_torch.models import registry
    arch = registry.get("rwkv6-7b")
    cfg = arch.cfg
    params = arch.module.init(cfg, torch.Generator(device=dev)
                              .manual_seed(8), device=dev)
    g = torch.Generator(device=dev).manual_seed(24)
    batch = {"tokens": torch.randint(0, cfg.vocab, (STEPS_PREFILL_B,
                                                    STEPS_PREFILL_T),
                                     generator=g, device=dev)}
    prefill = steps.make_prefill_step(arch)
    prefill(params, batch)  # untimed
    torch.cuda.synchronize()
    wkv_ops.LAUNCHES.reset()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    logits = prefill(params, batch)
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    launches = wkv_ops.LAUNCHES.count
    assert launches == cfg.n_layers, (launches, cfg.n_layers)
    errs: list = []
    with torch.no_grad():
        plain = arch.module.forward(cfg, params, batch["tokens"],
                                    last_only=True,
                                    wkv=checked_wkv(errs))[:, -1]
    check = check_greedy(logits, plain, "steps prefill")
    ms = start.elapsed_time(end)
    log(f"phase16/steps/d,arch={cfg.name},batch={STEPS_PREFILL_B}x"
        f"{STEPS_PREFILL_T},step_ms={ms:.3f},host_ms={host_ms:.3f},"
        f"tokens_per_s={STEPS_PREFILL_B * STEPS_PREFILL_T / (ms * 1e-3):.1f},"
        f"wkv6_launches={launches},layers={cfg.n_layers},"
        f"wkv6_max_rel_err={max(errs):.3e},vs_plain={check}")
    out = beside_roofline("d", records["d"], ms)
    out["launches"] = launches
    return out


def phase_steps() -> dict:
    """Phase 16: the dry run against the card's memory (its traces in
    parallel worker processes, before any card work), then the four timed
    steps of ``launch/steps.py`` at full size, each beside its roofline."""
    import concurrent.futures
    import multiprocessing
    import torch
    from repro_torch.launch import dryrun
    dev = torch.device(DEVICE)
    total = torch.cuda.get_device_properties(0).total_memory
    cells = steps_cells()
    t_phase = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=len(cells),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {label: pool.submit(dryrun.lower_cell, arch_id, shape,
                                      hbm_bytes=total, **kw)
                   for label, arch_id, shape, kw in cells}
        records = {label: f.result() for label, f in futures.items()}
    for label, rec in records.items():
        print_dry(label, rec, total)
        assert rec["hlo"]["flops_per_device"] > 0 and rec["fits_hbm"], label
    log(f"phase16/dryrun/seconds,{time.perf_counter() - t_phase:.2f}")
    out = {"train": steps_training(records, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    out["serve"] = steps_serving(records, dev)
    gc.collect()
    torch.cuda.empty_cache()
    out["prefill"] = steps_prefill(records, dev)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase16/done,seconds={time.perf_counter() - t_phase:.2f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--rows-log2", type=int, default=25,
                    help="table rows as a power of two (default 25: 8 GiB)")
    ap.add_argument("--profile", action="store_true",
                    help="after the serving walk and the rwkv run, profile "
                         "a few decode steps of each, two tiered "
                         "optimizer steps of the training phase, and "
                         "phase 14's decode steps, whisper's encode and "
                         "training step and the loss_and_grad cuts "
                         "(device time by kernel, host time by function)")
    ap.add_argument("--full-gates", action="store_true",
                    help="last, run bench_hotpaths and bench_serving at full "
                         "size with their gates")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_run = time.perf_counter()

    def timed(n, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"phase{n}/seconds,{time.perf_counter() - t0:.2f}")
        return out

    card = timed(1, phase_device)
    stats: dict = {}
    timed(2, phase_embedding_reduce, stats)
    timed(3, phase_stream_copy, stats)
    res = timed(4, phase_slice, stats, args.rows_log2)
    er, sc = res["er"], res["sc"]
    timed(5, phase_decode_attention, stats)
    serve = timed(6, phase_serving, stats, args.profile)
    timed(7, phase_wkv6, stats)
    rwkv = timed(8, phase_rwkv, stats, args.profile)
    timed(9, phase_figures)
    memo_res = timed(10, phase_memo, stats)
    sem = timed(11, phase_semantic, stats, args.rows_log2)
    moe = timed(12, phase_moe, stats)
    training = timed(13, phase_training, stats, args.profile)
    fam = timed(14, phase_families, stats, args.profile)
    elastic = timed(15, phase_elastic, stats)
    steps = timed(16, phase_steps)
    staged = timed(17, phase_staged)
    if args.full_gates:
        timed("_full_gates", phase_full_gates)
    log(f"run/seconds,{time.perf_counter() - t_run:.2f}")
    da, wkv = stats["da"], stats["wkv"]
    kernels = [
        {"name": "embedding_reduce", "route": "cuda",
         "source": "src/repro_torch/csrc/embedding_reduce.cu",
         "replaces": "src/repro/kernels/embedding_reduce/kernel.py:35",
         "launches": res["launches"]["embedding_reduce"],
         "max_abs_err": er["err"], "ms": er["ms"], "plain_ms": er["plain_ms"],
         "bound_ms": er["bound_ms"], "bound_by": "bytes",
         "library_ms": er["library_ms"],
         "launches_by_path": {
             "dlrm_walk": res["launches"]["embedding_reduce"],
             "semantic_dlrm": sem["launches"]["embedding_reduce"],
             "staged_cell_shape": staged["uniform"]["launches"]},
         "staged_path": staged,
         "table_form": {k: er[k] for k in ("table_ms", "table_bound_ms",
                                           "table_library_ms")},
         "slow_0.10": {"routed_ms": er["routed_f010_ms"],
                       "per_shard_ms": er["per_shard_f010_ms"]}},
        {"name": "stream_copy", "route": "cuda",
         "source": "src/repro_torch/csrc/stream_copy.cu",
         "replaces": "src/repro/kernels/stream_copy/kernel.py:102",
         "launches": res["launches"]["stream_copy"],
         "launches_by_path": {
             "dlrm_walk": res["launches"]["stream_copy"],
             "semantic_dlrm": sem["launches"]["stream_copy"],
             "moe_expert_retier": moe["retier_stream_copy_launches"],
             **training["launches"],
             "elastic_drain":
                 elastic["serving"]["launches"]["stream_copy"]},
         "max_abs_err": sc["err"], "ms": sc["ms"],
         "plain_ms": sc["plain_ms"],
         "bound_ms": sc["bound_ms"], "bound_by": "bytes",
         "library_ms": sc["library_ms"],
         "shape": "walk-shaped move, HBM -> pinned, 8192 x 256 KiB, "
                  "one launch; library: copy_ of the same bytes",
         "one_segment_launches_ms": sc["one_segment_launches_ms"],
         "slab_256KiB_hbm_to_pinned": sc["slab_256KiB"]},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention/kernel.py:65",
         "launches": serve["launches"]["decode_attention"],
         "launches_by_path": {
             "serving_walk": serve["launches"]["decode_attention"],
             "moe_decode": moe["launches"]["decode_attention"],
             "rglru_decode": fam["rglru"]["launches"]["decode_attention"],
             "whisper_decode":
                 fam["whisper"]["launches"]["decode_attention"],
             "elastic_serving":
                 elastic["serving"]["launches"]["decode_attention"],
             "steps_serve": steps["serve"]["launches"]},
         "max_abs_err": da["err"], "ms": da["ms"], "plain_ms": da["plain_ms"],
         "bound_ms": da["bound_ms"], "bound_by": "bytes",
         "library_ms": da["library_ms"]},
        {"name": "wkv6", "route": "cuda",
         "source": "src/repro_torch/csrc/wkv6.cu",
         "replaces": "src/repro/kernels/wkv6/kernel.py:55",
         "launches": rwkv["launches"]["wkv6"],
         "launches_by_path": {
             "rwkv_run": rwkv["launches"]["wkv6"],
             "rwkv_training_step":
                 fam["training"]["wkv6_training_launches"],
             "rwkv_tiny_driver":
                 fam["training"]["wkv6_tiny_driver_launches"],
             "steps_prefill": steps["prefill"]["launches"]},
         "max_abs_err": wkv["err"], "ms": wkv["ms"],
         "plain_ms": wkv["plain_ms"], "bound_ms": wkv["bound_ms"],
         "bound_by": wkv["bound_by"], "library_ms": None},
        {"name": "memo_probe", "route": "cuda",
         "source": "src/repro_torch/csrc/memo_probe.cu",
         "replaces": "src/repro/core/memo.py:70",
         "launches": memo_res["launches"], "max_abs_err": memo_res["err"],
         "ms": memo_res["ms"], "plain_ms": memo_res["plain_ms"],
         "bound_ms": memo_res["bound_ms"], "bound_by": "bytes",
         "library_ms": memo_res["plain_ms"],
         "shape": "seq_load, 528 lanes over 1 GiB of HBM; plain and "
                  "library: one torch.sum over the lanes"},
    ]
    print(card["card"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
