#!/usr/bin/env python3
"""The rates a tiered optimizer step's page runs move at, on the card.

    python3 tools/offload_probe.py [--gib N] [--reps N]

Prints the card's name and power limit, then for two kinds of page-locked
host memory — a block allocated with numpy and registered in place
(``cudaHostRegister``) and one from PyTorch's pinned allocator
(``repro_torch.device.host_block``, what ``TieredAdamW`` holds its state
in) — of ``--gib`` GiB each:
the ``stream_copy`` segment-list launch of one run of 8 pages (3 x 32 MiB,
pinned -> HBM and HBM -> pinned, as the step's loads and writebacks),
each direction alone over the whole block and both at once on two
streams, beside ``copy_`` of the same bytes; GB/s from CUDA events.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

RUN = 8 * (1 << 20) * 4 * 3  # a run of 8 pages of master, mu and nu


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--gib", type=int, default=4)
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("offload_probe: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.device import host_block
    from repro_torch.kernels.stream_copy import ops
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    nbytes = args.gib << 30
    third = RUN // 3
    arr = nbytes // 3 // third * third  # one array's bytes in the block
    runs = arr // third
    slots = torch.empty((2, RUN), dtype=torch.uint8, device=dev)
    side = torch.cuda.Stream(dev)

    def segs(r: int, to_host: bool) -> np.ndarray:
        rows = []
        for a in range(3):
            host_off, slot_off = a * arr + r * third, a * third
            src, dst = ((slot_off, host_off) if to_host
                        else (host_off, slot_off))
            rows.append([0, src, third, 0, dst, third, 1, third])
        return np.array(rows, np.int64)

    def timed(fn) -> float:
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 1e3

    for kind in ("registered", "allocator"):
        if kind == "registered":
            base = np.zeros(nbytes, np.uint8)
            cudart = torch.cuda.cudart()
            err = cudart.cudaHostRegister(base.ctypes.data, nbytes, 1 | 2)
            assert int(err) == 0, int(err)
            block = torch.from_numpy(base)
        else:
            block = host_block(nbytes, dev)

        def loads():
            for r in range(runs):
                ops.stream_copy_segments([block], [slots[r % 2]],
                                         segs(r, False))

        def stores():
            for r in range(runs):
                ops.stream_copy_segments([slots[r % 2]], [block],
                                         segs(r, True))

        def both():
            ready = torch.cuda.Event()
            ready.record()
            with torch.cuda.stream(side):
                side.wait_event(ready)
                stores()
            loads()
            torch.cuda.current_stream().wait_stream(side)

        dense = torch.empty(runs * RUN, dtype=torch.uint8, device=dev)
        host = block[:runs * RUN]
        moved = runs * RUN
        for rep in range(args.reps):
            out = {
                "load": moved / timed(loads),
                "store": moved / timed(stores),
                "both": 2 * moved / timed(both),
                "copy_load": moved / timed(lambda: dense.copy_(host,
                                                               non_blocking=True)),
                "copy_store": moved / timed(lambda: host.copy_(dense,
                                                               non_blocking=True)),
            }
            print(f"offload_probe/{kind},rep={rep},bytes={moved},"
                  + ",".join(f"{k}_GBps={v / 1e9:.2f}" for k, v in out.items()),
                  flush=True)
        del block, host, dense
        if kind == "registered":
            torch.cuda.synchronize()
            cudart.cudaHostUnregister(base.ctypes.data)
            del base
    return 0


if __name__ == "__main__":
    sys.exit(main())
