"""DLRM lookups over a table paged between HBM and pinned host memory.

Set-up: the table is drawn on the device from the seed and paged by
``SemanticTensor.from_array`` with the configuration's placement, HBM
holding its share of the pages; the hotness ledger is fed a warm-up
stream of the cell's own traffic and one ``retier`` runs through
``BulkMover`` and ``stream_executor``; a pool of batches is drawn on the
device; two calls build and warm the kernel.

Window: a closed loop with one batch in flight, through the pool in
order: ``SemanticTensor.it.bag_reduce`` (routing and ``embedding_reduce``
over both tiers), then a wait for the sums.  The ledger's per-call
recording stays out of the window (a copy to the host and an
``np.add.at`` a call).  Each batch's time runs from a CUDA event recorded
before the call to one recorded after it.

Check: the last sums of a sample of the pool's batches, drawn from the
seed, against the reference's float64 sums over the table made again."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from cxlbench import weights
from cxlbench.common import generator, synchronize
from cxlbench.reference import dlrm as ref
from cxlbench.traffic import BagTraffic

#: the traffic parameters this driver implements
KEYS = ("driver", "distribution", "zipf_alpha", "bags", "pool_batches",
        "check_batches", "trace_seconds")
#: input stream of the checked sample (see ``common.generator``)
STREAM_SAMPLE = 3


def setup(run) -> None:
    from repro_torch.core import (BulkMover, HotnessLedger, SemanticTensor,
                                  h100_topology, stream_executor)
    cfg, tr, dev = run.config, run.traffic, run.device
    rows, rpk = int(cfg["rows"]), int(cfg["rows_per_key"])
    n_keys = rows // rpk
    slow = (1.0 - float(cfg["hbm_page_share"]),)
    topo = h100_topology()
    table = weights.dlrm_table(cfg, run.seed, dev,
                               weights.DTYPES[cfg["dtype"]])
    st = SemanticTensor.from_array(
        table, rows_per_key=rpk, weights=slow,
        device_names=(topo.fast.name, topo.slow.name),
        page_rows=int(cfg["page_rows"]),
        ledger=HotnessLedger(n_keys, decay=float(cfg["ledger_decay"])),
        headroom=int(cfg["headroom_pages"]), placement=cfg["placement"],
        device=dev)
    del table
    run.note("table paged")
    bags = BagTraffic(tr, n_keys=n_keys, rows_per_key=rpk,
                      lookups=int(cfg["lookups_per_bag"]), seed=run.seed,
                      device=dev)
    warm = bags.draw(int(cfg["retier_warmup_batches"]))
    st.ledger.record(torch.bincount(warm.reshape(-1).long() // rpk,
                                    minlength=n_keys))
    st.ledger.tick()
    del warm
    mover = BulkMover(topo, execute=stream_executor(), device=dev)
    try:
        st = st.retier(slow, mover=mover, donate=True)
        synchronize(dev)
    finally:
        mover.close()
    run.note("re-tiered")
    pool = bags.draw(int(tr["pool_batches"]))
    for i in range(2):
        st.it.bag_reduce(pool[i])
    synchronize(dev)
    g = generator(run.seed, STREAM_SAMPLE, torch.device("cpu"))
    order = torch.randperm(pool.shape[0], generator=g).tolist()
    run.state = {"st": st, "pool": pool, "sample_order": order,
                 "sample": set(order[:int(tr["check_batches"])]), "kept": {}}


def window(run, seconds: float) -> dict:
    """Lookups for ``seconds``: batches, seconds, each batch's ms (untraced
    runs) and how often each pool batch was issued."""
    it, pool = run.state["st"].it, run.state["pool"]
    sample, kept = run.state["sample"], run.state["kept"]
    dev, spans = run.device, run.spans
    card = dev.type == "cuda"
    n_pool = pool.shape[0]
    issued = np.zeros(n_pool, np.int64)
    ms = []
    if card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    n = 0
    synchronize(dev)
    t0 = time.perf_counter()
    while True:
        i = n % n_pool
        if spans.enabled:
            with spans.span("lookup"):
                with spans.span("bag_reduce"):
                    out = it.bag_reduce(pool[i])
                synchronize(dev)
        elif card:
            start.record()
            out = it.bag_reduce(pool[i])
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        else:
            t = time.perf_counter()
            out = it.bag_reduce(pool[i])
            ms.append((time.perf_counter() - t) * 1e3)
        if i in sample:
            kept[i] = out
        issued[i] += 1
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    return {"ops": n, "seconds": t1 - t0, "ms": ms, "issued": issued}


def end_to_end(run) -> dict:
    w = run.timed
    return {"bags_per_s": w["ops"] * int(run.traffic["bags"]) / w["seconds"],
            "lookup_p95_ms": float(np.percentile(w["ms"], 95))}


def facts(run) -> None:
    """What the readers count from, read before the program's state goes:
    each pool batch's lookups in HBM, and its distinct rows in HBM and in
    pinned memory, under the placement the window ran on and under the
    best placement of the configuration's HBM share for this pool."""
    it, pool = run.state["st"].it, run.state["pool"]
    pr = int(run.config["page_rows"])
    placed = it.page_device.to(torch.int8)
    n_pages = placed.shape[0]
    looked = torch.zeros(n_pages, dtype=torch.int64, device=pool.device)
    for b in pool:
        looked += torch.bincount(b.reshape(-1).long() // pr,
                                 minlength=n_pages)
    n_fast = int(round(float(run.config["hbm_page_share"]) * n_pages))
    best = torch.ones(n_pages, dtype=torch.int8, device=pool.device)
    best[torch.topk(looked, n_fast).indices] = 0
    out = {k: np.zeros(pool.shape[0], np.int64) for k in (
        "hbm_lookups", "hbm_rows", "pinned_rows", "best_hbm_rows",
        "best_pinned_rows")}
    for i, b in enumerate(pool):
        page = b.reshape(-1).long() // pr
        out["hbm_lookups"][i] = int((placed[page] == 0).sum())
        distinct = torch.unique(b.reshape(-1)).long() // pr
        for key, where in (("", placed), ("best_", best)):
            fast = int((where[distinct] == 0).sum())
            out[f"{key}hbm_rows"][i] = fast
            out[f"{key}pinned_rows"][i] = distinct.numel() - fast
    run.facts.update(out)


def release(run) -> None:
    run.state.pop("st")
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def check(run) -> list:
    """``(name, value, limit)``: the sampled batches' largest gap to the
    reference, over the reference sums' root mean square."""
    kept, pool = run.state["kept"], run.state["pool"]
    table = weights.dlrm_table(run.config, run.seed, run.device)
    got, want = [], []
    for i in run.state["sample_order"]:
        if i in kept:
            got.append(kept[i])
            want.append(ref.bag_sums(table, pool[i]))
    if not got:
        raise RuntimeError("no sampled batch was issued in the window")
    gap = ref.relative_gap(got, want)
    return [("bag_sum_err", gap, float(run.config["limits"]["bag_sum_err"]))]
