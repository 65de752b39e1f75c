"""Figure harness of the port: the paper figures whose modules are ported.

    python -m repro_torch.benchmarks.run [--only fig8|fig10|fig11]
                                         [--device cpu|cuda]

Prints ``name,us_per_call,derived`` CSV (us_per_call = 0 for purely
derived/simulated rows) and one ``figN/claims,0,ALL-VALIDATED`` or
``CLAIM-FAILED`` row per figure; exits 1 on any failure.  The device is
the card unless ``--device cpu`` is given: without a card the harness
raises rather than running on the CPU.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

from repro_torch.device import resolve_device

FIGURES = ("fig8", "fig10", "fig11")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", default=None, choices=FIGURES)
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from repro_torch.benchmarks import fig8_dlrm, fig10_dsb, fig11_caption
    figs = {
        "fig8": lambda: fig8_dlrm.run(device=device),
        "fig10": lambda: fig10_dsb.run(device=device),
        "fig11": lambda: fig11_caption.run(device=device),
    }
    print("name,us_per_call,derived")
    failures = 0
    for name, fn in figs.items():
        if args.only and args.only != name:
            continue
        t0 = time.time()
        try:
            for row in fn():
                print(row)
            print(f"{name}/claims,0,ALL-VALIDATED ({time.time()-t0:.1f}s)")
        except AssertionError as e:
            failures += 1
            print(f"{name}/claims,0,CLAIM-FAILED: {e}")
        except Exception:
            failures += 1
            traceback.print_exc()
            print(f"{name}/claims,0,ERROR")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
