"""Quickstart: the paper's pipeline end-to-end on the port.

1. Characterize the tiers (MEMO), 2. classify a workload, 3. let the
planner place buffers, 4. run a tiered embedding reduction — the
CXL-paper loop: characterize -> classify -> place.  On the card the chase
runs the ``memo_probe`` kernel over HBM and the embedding-bag is one
routed ``embedding_reduce`` launch over an HBM and a pinned host shard.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
The modeled lines are the TPU v5e target's, as in the reference.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (AccessProfile, BufferClass, BufferReq,
                              InterleavedTensor, MemPolicy, memo, plan,
                              tpu_v5e_topology)
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    topo = tpu_v5e_topology()

    # 1) characterize (measured here + modeled for the target tiers)
    print("== MEMO (Fig. 2/3 analogue) ==")
    chase = memo.measure_pointer_chase(1 << 18, 1 << 13, device=device)
    print(" measured ptr-chase:", chase.row())
    for r in memo.simulate_latency(topo):
        print(" modeled:", r)

    # 2-3) plan placement for a training step's buffers
    reqs = [
        BufferReq("kv_cache", BufferClass.KV_CACHE, 6 << 30,
                  AccessProfile(6e9, 1e6, 1, 512, 1 << 16, 0.02)),
        BufferReq("opt_state", BufferClass.OPT_STATE, 24 << 30,
                  AccessProfile(24e9, 24e9, 1, 1024, 4 << 20, 0.02)),
        BufferReq("wkv_state", BufferClass.RECURRENT_STATE, 64 << 20,
                  AccessProfile(1e8, 1e8, 4096, 1, 4096, 0.02)),
    ]
    p = plan(reqs, topo, compute_seconds=0.02, reserve_fast_bytes=4 << 30)
    print("\n== placement plan ==\n" + p.report())

    # 4) tiered embedding-bag (exact across tiers)
    table = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1024, 64)).astype(np.float32))
    it = InterleavedTensor.from_array(
        table.to(device), MemPolicy.from_slow_fraction("fast", "slow", 0.25),
        page_rows=64, device=device)
    idx = torch.from_numpy(np.random.default_rng(1).integers(0, 1024, (8, 16)))
    w = torch.ones((8, 16), dtype=torch.float32)
    out = it.bag_reduce(idx.to(device), w.to(device))
    ref = torch.einsum("bkd,bk->bd", table[idx], w)
    err = float((out.cpu() - ref).abs().max())
    print(f"\ntiered embedding-bag max err vs dense: {err:.2e}")
    print("quickstart OK")
    return {"chase": chase, "plan": p, "max_abs_err": err}


if __name__ == "__main__":
    main()
