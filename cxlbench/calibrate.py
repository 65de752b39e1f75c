"""Readings that a cell's limits are set from, on the card, many seeds in
one process: the program's (sound runs), the control's, and the planted
faults' of a training cell.

    python3 cxlbench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        [--program] [--control] [--faults] [--seconds 2]

``--program`` runs the cell as the benchmark does (a short window) and
reports what its check compared.  ``--control`` puts the control in the
program's place: for the DLRM cells the program's own bf16-table path
(one precision step below the float32 table), for the training cells the
reference in fp8 (one step below bf16).  ``--faults`` (training cells)
reads the reference run on half of each batch, and with its state
left unchanged by each step, against the sound reference.  One
JSON line a reading; the benchmark's own runs never run this."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from cxlbench import harness  # noqa: E402
from cxlbench.common import ROOT  # noqa: E402

#: the control of each driver: configuration keys replaced, or the
#: reference's precision
DLRM_CONTROL = {"dtype": "bfloat16"}


def show(**kw) -> None:
    print(json.dumps(kw), flush=True)


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    _, cell, config, traffic = harness.resolve(ROOT, args.workload)
    train = traffic["driver"] == "train_step"
    for seed in seeds:
        if args.program:
            res, checks = harness.run_cell(args.workload, seed, args.seconds,
                                           False, t_start=time.perf_counter())
            show(kind="program", workload=args.workload, seed=seed,
                 checks={n: v for n, v, _ in checks},
                 metrics={k: m["value"] for k, m in res["metrics"].items()})
        if args.control and not train:
            _, checks = harness.run_cell(args.workload, seed, args.seconds,
                                         False, t_start=time.perf_counter(),
                                         overrides=DLRM_CONTROL)
            show(kind="control", workload=args.workload, seed=seed,
                 checks={n: v for n, v, _ in checks})
        if train and (args.control or args.faults):
            import torch
            from cxlbench.reference import dense_decoder as ref
            dev = torch.device("cuda", 0)
            modes = ([("control", {"precision": "fp8"})] if args.control
                     else []) + ([(f, {"fault": f})
                                  for f in ("half_batch", "frozen")]
                                 if args.faults else [])
            for kind, kw in modes:
                got = ref.train_readings(config, traffic, seed, dev,
                                         keep_grads=True, **kw)
                want = ref.train_readings(config, traffic, seed, dev,
                                          against=got.pop("first_grads"))
                show(kind=kind, workload=args.workload, seed=seed,
                     checks=ref.compare(got, want),
                     loss_gaps=ref.loss_gaps(got, want))
    show(kind="done", seconds=time.perf_counter() - T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
