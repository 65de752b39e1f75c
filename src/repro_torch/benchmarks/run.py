"""Figure harness of the port: the paper figures whose modules are ported,
the semantic-tiering benchmark, and the roofline rows of the dry run.

    python -m repro_torch.benchmarks.run [--only fig2|...|hotness|elastic]
                                         [--device cpu|cuda] [--skip-roofline]

Prints ``name,us_per_call,derived`` CSV (us_per_call = 0 for purely
derived/simulated rows) and one ``figN/claims,0,ALL-VALIDATED`` or
``CLAIM-FAILED`` row per figure; exits 1 on any failure.  The device is
the card unless ``--device cpu`` is given: without a card the harness
raises rather than running on the CPU.  Without ``--only`` the roofline
rows of ``python -m repro_torch.launch.dryrun``'s records follow (one H100's
peaks, :mod:`repro_torch.benchmarks.roofline`); ``--skip-roofline`` when
there are none yet.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

from repro_torch.device import resolve_device

FIGURES = ("fig2", "fig3", "fig4", "fig5", "fig6", "fig8", "fig10", "fig11",
           "hotness", "elastic")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", default=None, choices=FIGURES)
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"))
    ap.add_argument("--skip-roofline", action="store_true")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from repro_torch.benchmarks import (bench_hotness, fig2_latency,
                                        fig3_seq_bw, fig4_dsa, fig5_random,
                                        fig6_redis, fig8_dlrm, fig10_dsb,
                                        fig11_caption, fig_elastic)
    figs = {
        "fig2": lambda: fig2_latency.run(device=device),
        "fig3": lambda: fig3_seq_bw.run(device=device),
        "fig4": lambda: fig4_dsa.run(device=device),
        "fig5": lambda: fig5_random.run(device=device),
        "fig6": lambda: fig6_redis.run(device=device),
        "fig8": lambda: fig8_dlrm.run(device=device),
        "fig10": lambda: fig10_dsb.run(device=device),
        "fig11": lambda: fig11_caption.run(device=device),
        "hotness": lambda: bench_hotness.run(device=device)[0],
        "elastic": lambda: fig_elastic.run(device=device),
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
    if not args.skip_roofline and not args.only:
        try:
            from repro_torch.benchmarks import roofline
            recs = roofline.load_records()
            if recs:
                for row in roofline.csv_rows(recs):
                    print(row)
            else:
                print("roofline,0,NO-DRYRUN-ARTIFACTS "
                      "(run repro_torch.launch.dryrun)")
        except Exception:
            traceback.print_exc()
            failures += 1
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
