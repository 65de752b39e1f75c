"""Readings that a DeepSeek-V2 training cell's limits are set from, on the
card, many seeds in one process: the program's (sound runs), the fp8
control's and the planted faults' (``reference/mla_moe_decoder.FAULTS``),
each with the leaves that set it.

    python3 cxlbench/calibrate_moe.py --workload <cell> --seeds 11,12 \\
        [--program] [--control] [--faults [F,G]] [--seconds 2]

``--program`` runs the cell as the benchmark does (a short window) and
reports what its check compared; ``--control`` reads the reference in
fp8 (one step below the bf16 the configuration states) against the
sound reference, ``--faults`` each planted fault (or those named)
against it.  One JSON
line a reading; the benchmark's own runs never run this."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cxlbench import harness  # noqa: E402
from cxlbench.common import ROOT  # noqa: E402
from cxlbench.reference import dense_decoder  # noqa: E402
from cxlbench.reference import mla_moe_decoder as ref  # noqa: E402

#: leaves reported beside each number, worst first
WORST = 4


def show(**kw) -> None:
    print(json.dumps(kw), flush=True)


def worst_leaves(got: dict, want: dict) -> dict:
    """Each compared number's leaves, worst first, with their shares."""
    keep = dense_decoder.moved_leaves(want["grad_norms"])
    shares = {"grad_diff": want["grad_diffs"],
              "update_norm_gap": {k: abs(got["change_norms"][k]
                                         - want["change_norms"][k])
                                  for k in keep}}
    norms = {"grad_diff": want["grad_norms"],
             "update_norm_gap": want["change_norms"]}
    out = {}
    for name, vals in shares.items():
        median = sorted(norms[name][k] for k in keep)[len(keep) // 2]
        each = {k: vals[k] / max(norms[name][k], median, 1e-300)
                for k in keep}
        out[name] = sorted(each.items(), key=lambda kv: -kv[1])[:WORST]
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", nargs="?", default="",
                    const=",".join(ref.FAULTS))
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    unknown = set(faults) - set(ref.FAULTS)
    if unknown:
        raise SystemExit(f"no planted fault named {sorted(unknown)}")
    _, cell, config, traffic = harness.resolve(ROOT, args.workload)
    if traffic["driver"] != "moe_train_step":
        raise SystemExit("calibrate_moe.py reads moe_train_step cells; "
                         "calibrate.py reads the others")
    seen: list = []
    compare = dense_decoder.compare

    def recording(got, want):
        seen.append(worst_leaves(got, want))
        return compare(got, want)
    dense_decoder.compare = recording
    import torch
    dev = torch.device("cuda", 0)
    for seed in seeds:
        if args.program:
            res, checks = harness.run_cell(args.workload, seed, args.seconds,
                                           False, t_start=time.perf_counter())
            show(kind="program", workload=args.workload, seed=seed,
                 checks={n: v for n, v, _ in checks}, worst=seen.pop(),
                 peak=res["device"]["memory_peak_bytes"],
                 metrics={k: m["value"] for k, m in res["metrics"].items()})
        modes = ([("control", {"precision": "fp8"})] if args.control
                 else []) + [(f, {"fault": f}) for f in faults]
        if not modes:
            continue
        # the sound reference once a seed; a gradient's gap is symmetric
        want = ref.train_readings(config, traffic, seed, dev,
                                  keep_grads=True)
        sound = want.pop("first_grads")
        for kind, kw in modes:
            got = ref.train_readings(config, traffic, seed, dev,
                                     against=sound, **kw)
            want["grad_diffs"] = got.pop("grad_diffs")
            show(kind=kind, workload=args.workload, seed=seed,
                 checks=compare(got, want), worst=worst_leaves(got, want),
                 loss_gaps=dense_decoder.loss_gaps(got, want))
            del got
            torch.cuda.empty_cache()
        del want, sound
    show(kind="done", seconds=time.perf_counter() - T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
