#!/usr/bin/env python3
"""One tier fit from several runs of phase 10, with each field's range.

    PYTHONPATH=src python3 tools/memo_medians.py LOG [LOG ...]

Each LOG is the output of ``chip_smoke.py`` (or of its phase 10 alone) on
the card, one machine each: its ``phase10/<memory>/record`` lines hold
the calibration's records, its ``phase10/<memory>/fitted`` line the
memory's capacity, and its first lines the card (name, power limit) and
the card's UUID.  For each memory the records of every run go through
one ``memo.fit_tier`` call: each measurement reads its median over the
runs, and a lane count falls short of a sweep's peak only where every
run reads it short.  Prints each sweep's lane counts (median and range
over the runs), the fitted fields, and beside each the least and the
greatest of the runs' own fits: what ``core/tiers.py``'s H100 values
cite.  Runs on the CPU and reads nothing but the logs.
"""
from __future__ import annotations

import re
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import memo  # noqa: E402

RECORD = re.compile(r"^phase10/(\w+)/record,([\w-]+),(\w+),lanes=(\d+),"
                    r"block_bytes=(\d+),bytes=(\d+),seconds=([\d.e+-]+),")
CAPACITY = re.compile(r"^phase10/(\w+)/fitted,.*capacity_bytes=(\d+)")
#: the fields a calibration fits, in the order printed
FIELDS = ("load_bw", "store_bw", "nt_store_bw", "load_latency_ns",
          "chase_latency_ns", "load_peak_streams", "store_peak_streams",
          "load_collapse_streams", "store_collapse_streams",
          "collapse_factor", "capacity_bytes")


def parse(path: str) -> tuple[list[str], dict, dict]:
    """(card lines, {memory: [Record]}, {memory: capacity}) of one log."""
    card, records, capacity = [], {}, {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.endswith(" W") or line.startswith("gpu_uuid="):
                card.append(line)
            m = RECORD.match(line)
            if m:
                mem, name, op, lanes, block, nbytes, sec = m.groups()
                records.setdefault(mem, []).append(memo.Record(
                    name, memo.MEMORIES[mem].name, op, int(lanes),
                    int(block), float(sec), int(nbytes)))
            m = CAPACITY.match(line)
            if m:
                capacity[m.group(1)] = int(m.group(2))
    return card, records, capacity


def _fmt(v) -> str:
    return str(v) if isinstance(v, int) else f"{v:.6g}"


def main(argv=None) -> int:
    paths = sys.argv[1:] if argv is None else argv
    if not paths:
        print(__doc__)
        return 2
    runs = [parse(p) for p in paths]
    for p, (card, records, _) in zip(paths, runs):
        print(f"run {p}: {'; '.join(card) or 'card line not found'}; "
              f"memories={sorted(records)}")
    for mem in sorted({m for _, records, _ in runs for m in records}):
        per_run = [(records[mem], capacity.get(mem))
                   for _, records, capacity in runs if mem in records]
        for op in ("load", "store"):
            rates = memo._rates([r for recs, _ in per_run for r in recs],
                                "seq", op)
            for lanes, vals in sorted(rates.items()):
                print(f"{mem},seq/{op}/lanes{lanes},GBps_median="
                      f"{statistics.median(vals) / 1e9:.6g},min="
                      f"{min(vals) / 1e9:.6g},max={max(vals) / 1e9:.6g}")
        base = memo.MEMORIES[mem]
        caps = [c for _, c in per_run if c is not None]
        cap = int(statistics.median(caps)) if caps else None
        fit = memo.fit_tier([r for recs, _ in per_run for r in recs], base,
                            capacity_bytes=cap)
        own = [memo.fit_tier(recs, base, capacity_bytes=c)
               for recs, c in per_run]
        for field in FIELDS:
            vals = [getattr(f, field) for f in own]
            print(f"{mem},{field},fit={_fmt(getattr(fit, field))},"
                  f"runs_min={_fmt(min(vals))},runs_max={_fmt(max(vals))},"
                  f"runs={[_fmt(v) for v in vals]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
