"""DLRM embedding table with hotness-driven semantic tiering.

A Zipf-skewed lookup stream hits an embedding table interleaved across a
fast tier and three CXL devices (the paper's Fig. 10 multi-device setup;
on the card an HBM shard and three pinned host shards).  The table starts
address-blind — an N:M interleave in address order, so the hot rows are
scattered across the slow devices — then the ledger the lookups feed
drives one :meth:`SemanticTensor.retier` that pins the hot rows fast and
deals the cold tail across the CXL devices in proportion to their
bandwidth.  The report shows the placement before and after, the
promoted and demoted pages, and the modeled throughput (the Fig. 8
model) at the same page budget; the bag sums (one routed
``embedding_reduce`` launch each on the card) stay the same bits.

Run:  PYTHONPATH=src python -m repro_torch.examples.dlrm_embedding
      [--device cpu] [--rows 4096] [--alpha 1.1] [--decay 0.5]
      [--budget 0.25] [--lookups 20000]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.benchmarks.fig8_dlrm import throughput_nd
from repro_torch.core.hotness import SemanticTensor
from repro_torch.core.tiers import paper_three_device_topology
from repro_torch.device import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rows", type=int, default=4096, help="table rows")
    ap.add_argument("--alpha", type=float, default=1.1, help="Zipf exponent")
    ap.add_argument("--decay", type=float, default=0.5,
                    help="ledger EWMA decay per epoch")
    ap.add_argument("--budget", type=float, default=0.25,
                    help="fraction of pages the fast tier can hold")
    ap.add_argument("--lookups", type=int, default=20000,
                    help="Zipf lookups per epoch")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    topo = paper_three_device_topology()
    names = (topo.fast.name,) + tuple(t.name for t in topo.slows)
    rng = np.random.default_rng(0)
    rows_per_key, page_rows = 8, 2
    n_keys = args.rows // rows_per_key

    # Zipf popularity over a random permutation: hot rows are scattered in
    # address space, exactly where a blind interleave loses.
    zipf = np.zeros(n_keys)
    zipf[rng.permutation(n_keys)] = 1.0 / (1.0 + np.arange(n_keys)) ** args.alpha
    row_p = np.repeat(zipf, rows_per_key)
    row_p /= row_p.sum()

    # integer-valued fp32 rows: bag sums are exact in any accumulation
    # order, so the before/after comparison below is bitwise
    table = rng.integers(-8, 9, size=(args.rows, 64)).astype(np.float32)
    weights = tuple((1.0 - args.budget) * b for b in topo.bandwidth_weights())
    st = SemanticTensor.from_array(
        table, rows_per_key=rows_per_key, weights=weights, device_names=names,
        page_rows=page_rows, decay=args.decay,
        headroom=args.rows // page_rows, placement="blind", device=device)

    def modeled(s: SemanticTensor) -> float:
        dev, sc = s.key_device(), s.ledger.scores()
        total = max(float(sc.sum()), 1e-12)
        shares = tuple(float(sc[dev == i + 1].sum()) / total
                       for i in range(len(topo.slows)))
        return throughput_nd(topo.fast, topo.slows, shares, 32)

    # one epoch of Zipf lookups; bag_reduce feeds the ledger
    idx = torch.as_tensor(rng.choice(args.rows, p=row_p,
                                     size=(args.lookups // 80, 80)),
                          device=device)
    w = torch.ones(idx.shape, dtype=torch.float32, device=device)
    out_before = st.bag_reduce(idx, w)
    st.ledger.tick()

    print("== hotness-blind placement (address-order N:M interleave) ==")
    print(st.placement_report())
    t_blind = modeled(st)
    print(f"hot-row traffic on fast: {st.hot_traffic_share():.1%}   "
          f"modeled: {t_blind:,.0f} inf/s\n")

    st = st.retier(weights)

    print("== after one hotness-driven re-tier (same page budget) ==")
    print(st.placement_report())
    t_hot = modeled(st)
    print(f"hot-row traffic on fast: {st.hot_traffic_share():.1%}   "
          f"modeled: {t_hot:,.0f} inf/s   (x{t_hot / t_blind:.2f})")
    r = st.last_retier
    print(f"moved: {r['moved_keys']} keys / {r['moved_pages']} pages "
          f"(promoted {r['promoted_pages']}, demoted {r['demoted_pages']})")

    out_after = st.bag_reduce(idx, w)
    drift = float((out_before - out_after).abs().max())
    print(f"bag-reduction max |before - after| = {drift:g}  (placement is "
          "invisible to the math)")
    assert t_hot > t_blind and drift == 0.0
    return {"blind_inf_s": t_blind, "hot_inf_s": t_hot, "drift": drift,
            "retier": r, "hot_traffic": st.hot_traffic_share()}


if __name__ == "__main__":
    main()
