#!/usr/bin/env python3
"""Host time of ``bench_hotpaths``' repartition section, by part.

    python3 tools/repartition_probe.py [--device cuda|cpu] [--shifts N]
                                       [--passes N]

The section times a capacity-padded ``InterleavedTensor`` (512 pages of
64 x 16 fp32, 0.3 slow, the smoke size) shifted 0.35 <-> 0.3 through an
asynchronous ``BulkMover``, copy-on-write (not donated), against the
per-page baseline (``bench_hotpaths._legacy_repartition_fraction``).
This probe prints, on the card by default (its name and power limit
first):

* the time of ``--passes`` passes of 4 shifts of each path, each pass
  through its own mover, the first untimed, as the section measures;
* over ``--shifts`` shifts of the new path, the host microseconds a shift
  spends in each part (planning, the mover's run, the gather's and the
  landing's ``stream_copy_segments``, the copy of the receiving shard,
  the page maps' upload), from wrappers around those functions (a part's
  time includes the parts it calls).
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def _wrap(owner, name: str, acc: dict, label: str) -> None:
    fn = getattr(owner, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            acc[label] = acc.get(label, 0.0) + time.perf_counter() - t0
    setattr(owner, name, timed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--shifts", type=int, default=200)
    ap.add_argument("--passes", type=int, default=6)
    args = ap.parse_args(argv)
    import torch
    from repro_torch.benchmarks import bench_hotpaths as hot
    from repro_torch.core import interleave as il
    from repro_torch.core.mover import BulkMover
    from repro_torch.core.telemetry import Telemetry
    from repro_torch.core.tiers import paper_three_device_topology
    from repro_torch.device import resolve_device
    from repro_torch.kernels.stream_copy import kernel as sc_kernel
    from repro_torch.kernels.stream_copy import ops as sc_ops
    device = resolve_device(args.device)
    if device.type == "cuda":
        from repro_torch.kernels import common
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0])
        common.build(["stream_copy", "embedding_reduce"])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    topo = paper_three_device_topology()
    fast, slow = topo.fast.name, topo.slows[0].name
    it, _ = hot._make(512, device)
    padded, _ = hot._make(512, device, headroom=32)
    shifts = [0.35, 0.3] * 2

    def new_pass(mover):
        out = padded
        for f in shifts:
            out = out.repartition_fraction(f, mover=mover, fast_tier=fast,
                                           slow_tier=slow)

    def legacy_pass(mover):
        out = it
        for f in shifts:
            out = hot._legacy_repartition_fraction(
                out, f, Telemetry(), mover=mover, names=(fast, slow))

    for name, one_pass in (("new", new_pass), ("legacy", legacy_pass)):
        ms = []
        for _ in range(args.passes):
            with BulkMover(topo, asynchronous=True, batch_size=16,
                           telemetry=Telemetry(), device=device) as mover:
                sync()
                t0 = time.perf_counter()
                one_pass(mover)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
        print(f"repartition/{name}_pass_ms,"
              + ";".join(f"{m:.2f}" for m in ms))

    acc: dict = {}
    for owner, name in ((il, "minimal_delta_weights"),
                        (il.InterleavedTensor, "_move_runs"),
                        (il.InterleavedTensor, "_ship_runs"),
                        (il.InterleavedTensor, "_issue_runs"),
                        (il.InterleavedTensor, "_reassign_stable"),
                        (il.InterleavedTensor, "_copy_shard"),
                        (il.InterleavedTensor, "_land"),
                        (il.InterleavedTensor, "_maps"),
                        (BulkMover, "run"),
                        (sc_ops, "stream_copy_segments"),
                        (sc_kernel, "launch_table")):
        _wrap(owner, name, acc, name)
    with BulkMover(topo, asynchronous=True, batch_size=16,
                   telemetry=Telemetry(), device=device) as mover:
        out = padded
        for f in [0.35, 0.3] * 10:  # warm
            out = out.repartition_fraction(f, mover=mover, fast_tier=fast,
                                           slow_tier=slow)
        sync()
        acc.clear()
        out = padded
        t0 = time.perf_counter()
        for f in [0.35, 0.3] * (args.shifts // 2):
            out = out.repartition_fraction(f, mover=mover, fast_tier=fast,
                                           slow_tier=slow)
        sync()
        total = time.perf_counter() - t0
    n = 2 * (args.shifts // 2)
    print(f"repartition/new_shift_us,total={total / n * 1e6:.1f},"
          + ",".join(f"{k}={v / n * 1e6:.1f}"
                     for k, v in sorted(acc.items(), key=lambda kv: -kv[1])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
