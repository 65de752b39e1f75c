"""Serve a small LM with the KV cache page-interleaved across memory
tiers (the paper's Redis experiment, §5.1, as a serving engine demo).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_tiered_kv \
          [--device cpu]
On the card the fast pool is HBM and the slow pool pinned host memory,
decoded through ``decode_attention``.  The runs pass ``--devices
tpu-v5e``, the reference's default topology, so that their modeled lines
read as the reference's (the port's driver defaults to ``h100``).
"""
from __future__ import annotations

import argparse

from repro_torch.launch import serve as serve_mod


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    runs = []
    for frac in (0.0, 0.5, 1.0):
        print(f"\n== slow-tier fraction {frac:.0%} ==")
        runs.append(serve_mod.main([
            "--arch", "internvl2-2b", "--tiny", "--requests", "8",
            "--max-batch", "4", "--max-len", "64", "--new-tokens", "8",
            "--slow-fraction", str(frac), "--page-t", "8",
            "--devices", "tpu-v5e", "--device", args.device,
        ]))

    # Shared-prefix batch: every request repeats the same 24-token system
    # prompt, so after the first request seeds the pool the rest attach the
    # prefix pages by reference and replay only their 4-token suffixes.
    print("\n== shared-prefix batch (prefix pool + cost admission) ==")
    runs.append(serve_mod.main([
        "--arch", "internvl2-2b", "--tiny", "--requests", "8",
        "--max-batch", "4", "--max-len", "64", "--new-tokens", "8",
        "--slow-fraction", "0.5", "--page-t", "8",
        "--shared-prefix", "24", "--prefix-pages", "16",
        "--admission", "cost", "--latency-every", "4",
        "--devices", "tpu-v5e", "--device", args.device,
    ]))
    return runs


if __name__ == "__main__":
    main()
