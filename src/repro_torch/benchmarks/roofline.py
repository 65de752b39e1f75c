"""Roofline of the dry-run records against one H100's own peaks.

Per (arch x shape) on one card (``repro_torch.launch.dryrun``):
  compute term    = FLOPs / 989 TFLOP/s (dense bf16, H100 SXM data sheet)
  memory term     = eager op bytes / the HBM load rate of
                    ``h100_topology()`` (fitted on the card by MEMO)
  collective term = 0 (one card)
  tier term       = host<->HBM staged bytes (paging + amortized Caption
                    repartition migration) / the pinned tier's fitted
                    load rate
plus MODEL_FLOPS = 6 N_active D (train) / 2 N_active D (inference), the
useful-compute ratio, the dominant term, and the roofline fraction
(model-flops time / dominant-term time).  Offload-micro cells aggregate
n_micro micro-programs and the paged update, as the reference's.

    python -m repro_torch.benchmarks.roofline [--dir experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.core.tiers import h100_topology
from repro_torch.launch.dryrun import DEFAULT_OUT, MESH_TAG

PEAK_FLOPS = 989e12  # dense bf16, H100 SXM data sheet (700 W)
HBM_BW = h100_topology().fast.load_bw
TIER_BW = h100_topology().slow.load_bw
ROOFLINE_JSON = "experiments/roofline_torch.json"


def load_records(dryrun_dir: str = DEFAULT_OUT, mesh: str = MESH_TAG):
    recs = []
    for f in sorted(glob.glob(os.path.join(dryrun_dir, f"*__{mesh}.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def terms(rec: dict) -> dict | None:
    if "error" in rec or "skipped" in rec or "hlo" not in rec:
        return None
    chips = rec["chips"]
    mult = rec.get("n_micro", 0) if rec.get("offload_micro_step") else 1
    mult = max(mult, 1)
    flops = rec["hlo"]["flops_per_device"] * mult
    hbm = rec["hlo"]["hbm_bytes_per_device"] * mult
    tier_bytes = rec.get("offload_traffic_bytes_per_step_per_chip", 0.0)
    # Caption repartition traffic (amortized page migration, recorded by
    # the dry run): migration shares the same PCIe path as paging.
    tier_bytes += rec.get("migration_bytes_per_step_per_chip", 0.0)
    if rec.get("offload_micro_step"):
        # bf16 grads stream host-ward every micro step
        tier_bytes += rec["params"] * 2 * mult / chips
    t = {
        "compute_s": flops / PEAK_FLOPS,
        "memory_s": hbm / HBM_BW,
        "collective_s": 0.0,
        "tier_s": tier_bytes / TIER_BW,
    }
    model_flops_dev = rec["model_flops_total"] / chips
    t["model_compute_s"] = model_flops_dev / PEAK_FLOPS
    t["useful_ratio"] = model_flops_dev / flops if flops else 0.0
    dom = max(("compute_s", "memory_s", "collective_s", "tier_s"),
              key=lambda k: t[k])
    t["dominant"] = dom.replace("_s", "")
    bound = max(t["compute_s"], t["memory_s"], t["collective_s"], t["tier_s"])
    t["roofline_fraction"] = t["model_compute_s"] / bound if bound else 0.0
    return t


def table(recs) -> str:
    rows = []
    header = ("| cell | dom | compute s | memory s | coll s | tier s | "
              "useful | roofline frac |")
    sep = "|" + "---|" * 8
    for rec in recs:
        name = f"{rec['arch']} x {rec['shape']}"
        if "skipped" in rec:
            rows.append(f"| {name} | SKIP ({rec['skipped'][:40]}...) "
                        f"| | | | | | |")
            continue
        t = terms(rec)
        if t is None:
            rows.append(f"| {name} | ERROR | | | | | | |")
            continue
        rows.append(
            f"| {name} | **{t['dominant']}** | {t['compute_s']:.4f} | "
            f"{t['memory_s']:.4f} | {t['collective_s']:.4f} | "
            f"{t['tier_s']:.4f} | {t['useful_ratio']:.2f} | "
            f"{t['roofline_fraction']:.2%} |")
    return "\n".join([header, sep] + rows)


def csv_rows(recs) -> list[str]:
    out = []
    for rec in recs:
        if "skipped" in rec or "error" in rec:
            continue
        t = terms(rec)
        step_s = max(t["compute_s"], t["memory_s"], t["collective_s"],
                     t["tier_s"])
        out.append(
            f"roofline/{rec['arch']}/{rec['shape']},{step_s*1e6:.1f},"
            f"dom={t['dominant']};frac={t['roofline_fraction']:.3f};"
            f"useful={t['useful_ratio']:.2f}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--dir", default=DEFAULT_OUT,
                    help="the dry run's records")
    args = ap.parse_args(argv)
    recs = load_records(args.dir)
    print(table(recs))
    print()
    for row in csv_rows(recs):
        print(row)
    out = []
    for rec in recs:
        e = {"arch": rec.get("arch"), "shape": rec.get("shape")}
        if "skipped" in rec:
            e["skipped"] = rec["skipped"]
        else:
            e.update(terms(rec) or {"error": rec.get("error", "?")})
        out.append(e)
    os.makedirs(os.path.dirname(ROOFLINE_JSON), exist_ok=True)
    with open(ROOFLINE_JSON, "w") as f:
        json.dump(out, f, indent=1, default=float)


if __name__ == "__main__":
    main()
