#!/usr/bin/env python3
"""Where the time of the two full-size gates' loops goes, on the card.

    python3 tools/gate_profile.py [--epochs N] [--runs N] [--no-profile]

Prints the card's name and power limit, then:

* ``actuation``: one epoch of ``bench_hotpaths.bench_actuation`` at full
  size (4096 pages: one repartition 0.35 <-> 0.3 and four writes of 248
  rows), copy-on-write and donated, each profiled the way
  ``chip_smoke.py --profile`` profiles a decode step (wall ms per
  epoch, device time by kernel and busy share, host time by function
  under cProfile), then the gate's ratio over ``--epochs`` epochs of
  each path in turns;
* ``serving``: one churn step of ``bench_serving``'s ``sync`` and
  ``overlap`` modes at full size (an engine step, then the re-tier of
  the batch population through the mover, fenced or not), profiled the
  same way, then ``--runs`` whole runs of each mode in turns (sync,
  overlap, overlap, sync, ...) with their goodput, stall and wall time.

``--no-profile`` prints the ratios alone (to set two trees side by side
in one call: run the script from each tree's root in turn).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def actuation(epochs: int, profile: bool = True) -> None:
    import numpy as np
    import torch
    from chip_smoke import log, profile_steps
    from repro_torch.benchmarks import bench_hotpaths as bh
    from repro_torch.core.telemetry import Telemetry

    device = torch.device("cuda", 0)
    n_pages = bh.N_PAGES
    rng = np.random.default_rng(3)
    idxs = [np.unique(rng.integers(0, n_pages * bh.PAGE_ROWS, size=256))[:248]
            for _ in range(4)]
    vals = [torch.as_tensor(rng.normal(size=(ix.size, bh.FEATURE))
                            .astype(np.float32), device=device)
            for ix in idxs]

    def path(donate: bool):
        state = {"it": bh._make(n_pages, device,
                                headroom=max(16, n_pages // 16))[0],
                 "f": 0}

        def epoch():
            it = state["it"].repartition_fraction(
                (0.35, 0.3)[state["f"] % 2], telemetry=Telemetry(),
                donate=donate)
            state["f"] += 1
            for ix, v in zip(idxs, vals):
                it = it.update_rows(ix, v, donate=donate)
            state["it"] = it
        for _ in range(2):
            epoch()
        return epoch

    epochs_of = {"cow": path(False), "donated": path(True)}
    for name, epoch in epochs_of.items():
        if profile:
            profile_steps(epoch, f"gate/actuation/{name}", n=8)
    times = {name: [] for name in epochs_of}
    for rep in range(3):
        for name in (("cow", "donated") if rep % 2 == 0
                     else ("donated", "cow")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(epochs):
                epochs_of[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / epochs * 1e3)
    for name, ms in times.items():
        log(f"gate/actuation/{name}/epoch_ms,"
            + ",".join(f"{m:.4f}" for m in ms))
    log(f"gate/actuation/speedup,"
        + ",".join(f"{c / d:.3f}" for c, d in zip(times["cow"],
                                                  times["donated"])))


def serving(runs: int, profile: bool = True) -> None:
    import torch
    from chip_smoke import log, profile_steps
    from repro_torch.benchmarks import bench_serving as bs
    from repro_torch.core.mover import BulkMover
    from repro_torch.core.policy import MemPolicy
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.core.tiers import paper_topology
    from repro_torch.models import registry
    from repro_torch.serving.engine import ServingEngine

    device = torch.device("cuda", 0)
    p = bs.FULL
    arch = registry.get(bs.ARCH).tiny()
    cfg = arch.cfg
    params = arch.module.init(cfg, 0, device=device)
    prompts, arrive = bs._workload(cfg, p)

    def churn_step(mode: str):
        topo = paper_topology()
        mover = BulkMover(topo, asynchronous=True, batch_size=16,
                          device=device)
        tel = Telemetry()
        eng = ServingEngine(
            cfg, params, max_batch=p["max_batch"], max_len=p["max_len"],
            policy=MemPolicy.from_slow_fraction(topo.fast.name,
                                                topo.slow.name, 0.5),
            page_t=bs.PAGE_T, topology=topo, mover=mover, telemetry=tel,
            prefix_pages=p["pool_pages"], overlap=(mode == "overlap"),
            device=device)
        state = {"n": 0, "next": 0}

        def step():
            if not eng.queue and not any(eng.slots):
                state["next"] = 0
            while state["next"] < len(prompts) and len(eng.queue) < 8:
                eng.submit(prompts[state["next"]],
                           max_new_tokens=p["new_tokens"])
                state["next"] += 1
            eng.step()
            eng._drain_migrations()
            state["n"] += 1
            eng.cache = eng.cache.repartition_fraction(
                (0.25, 0.5)[state["n"] % 2], pinned_slots=eng.pinned_slots,
                mover=mover, telemetry=tel, fast_tier=topo.fast.name,
                slow_tier=topo.slow.name, source=eng.buffer_name,
                donate=eng.donate_kv, wait=not eng.overlap)
        for _ in range(4):
            step()
        return step, mover

    for mode in ("sync", "overlap") if profile else ():
        step, mover = churn_step(mode)
        profile_steps(step, f"gate/serving/{mode}", n=8)
        mover.close()
    for rep in range(runs):
        for mode in (("sync", "overlap") if rep % 2 == 0
                     else ("overlap", "sync")):
            out, _ = bs._run_mode(mode, cfg, params, p, prompts, arrive,
                                  device)
            log(f"gate/serving/{mode}/run{rep},goodput_tok_s="
                f"{out['goodput_tok_s']:.1f},wall_s={out['wall_s']:.4f},"
                f"stall_s={out['migration_stall_s']:.6f},"
                f"hidden_s={out['migration_hidden_s']:.6f},"
                f"moved_bytes={out['moved_bytes']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--no-profile", action="store_true")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gate_profile: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    actuation(args.epochs, not args.no_profile)
    serving(args.runs, not args.no_profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
