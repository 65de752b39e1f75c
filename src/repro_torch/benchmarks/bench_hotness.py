"""Hotness-driven semantic tiering benchmark.

The paper's DLRM experiments (Figs. 8/9) fix where pages live but not
which pages: placement is address-blind.  Under Zipf-skewed access the
same fast-tier page budget serves far more traffic when the hot keys
stay fast and only the cold tail interleaves across the slow devices.
Sections, as in the reference:

* ``placement`` — a Zipf-skewed row ledger over the three-CXL-device
  topology: the semantic placement must beat the blind N:M interleave
  on modeled throughput (the Fig. 8 model fed each placement's traffic
  shares), at the same page budget.
* ``dlrm`` — ``embedding_reduce`` through a :class:`SemanticTensor`: the
  blind and semantic placements give the same bag sums bit for bit, and
  both equal the dense sum.
* ``moe`` — a deepseek-moe-16b-style routed MLP with a skewed router:
  ``aux["expert_counts"]`` feeds the ledger, unit 0's expert stack
  re-tiers, and logits rebuilt from either layout are bit-equal.
* ``flip`` — a mid-run skew flip re-tiers in O(moved keys) descriptors
  (``descriptors <= moved_keys < moved_pages``), and a consumer sees one
  shard binding across it (``shard_bindings=1``, where the reference's
  row reads ``traces=1`` of a jitted consumer: the move is donated).
* ``caption`` — the hot-set size as a walked coordinate: the walk
  converges onto the budget floor, a flip re-opens it through membership
  drift, and it converges again with the new hot set fast.

On the card the tables live in HBM and pinned host memory (the
three-device preset: an HBM shard and three pinned shards), bag sums are
one routed ``embedding_reduce`` launch and moves ``stream_copy``; the
modeled rows are the reference's numbers.  ``--smoke`` runs the CI-sized
lane; ``main`` writes ``BENCH_hotness_torch.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import stopwatch, synchronize
from repro_torch.benchmarks.fig8_dlrm import throughput_nd
from repro_torch.core.caption import (CaptionConfig, CaptionController,
                                      EpochMetrics)
from repro_torch.core.hotness import (HotnessLedger, HotSetCoordinator,
                                      SemanticTensor)
from repro_torch.core.mover import BulkMover
from repro_torch.core.telemetry import Telemetry
from repro_torch.core.tiers import paper_three_device_topology
from repro_torch.device import DeviceLike, resolve_device

THREADS = 32
#: fast tier holds this fraction of the table; the rest must live on CXL.
FAST_BUDGET = 0.25

SMOKE = dict(n_keys=64, rows_per_key=8, page_rows=2, dim=8, alpha=1.1,
             n_experts=16, walk_epochs=40, flip_epochs=10)
FULL = dict(n_keys=512, rows_per_key=8, page_rows=2, dim=32, alpha=1.1,
            n_experts=32, walk_epochs=64, flip_epochs=16)


def _zipf_scores(n_keys: int, alpha: float, rng) -> np.ndarray:
    """Zipf popularity over a random key permutation: hot keys scattered
    in address space, where a blind interleave cannot pin them fast."""
    s = np.zeros(n_keys)
    s[rng.permutation(n_keys)] = 1.0 / (1.0 + np.arange(n_keys)) ** alpha
    return s / s.sum()


def _traffic_weights(st: SemanticTensor, topo) -> tuple[float, ...]:
    """Per-slow-device share of the observed traffic under the current
    placement."""
    dev = st.key_device()
    s = st.ledger.scores()
    total = max(float(s.sum()), 1e-12)
    return tuple(float(s[dev == i + 1].sum()) / total
                 for i in range(len(topo.slows)))


def _modeled(st: SemanticTensor, topo) -> float:
    return throughput_nd(topo.fast, topo.slows, _traffic_weights(st, topo),
                         THREADS)


def _budget_weights(topo, budget: float = FAST_BUDGET) -> tuple[float, ...]:
    """Slow-share vector for a fixed fast-tier page budget, split in
    proportion to the CXL devices' bandwidth (Fig. 10's prior)."""
    return tuple((1.0 - budget) * b for b in topo.bandwidth_weights())


def _section_placement(p, topo, names, payload, device
                       ) -> tuple[list[str], SemanticTensor]:
    """Same page budget, data and traffic: placement is the only
    variable.  Returns the semantic tensor for the flip section."""
    rng = np.random.default_rng(0)
    arr = rng.normal(size=(p["n_keys"] * p["rows_per_key"], p["dim"])) \
        .astype(np.float32)
    led = HotnessLedger(p["n_keys"], decay=0.5)
    led.record(_zipf_scores(p["n_keys"], p["alpha"], rng) * 1e6)
    weights = _budget_weights(topo)
    st = SemanticTensor.from_array(
        arr, rows_per_key=p["rows_per_key"], weights=weights,
        device_names=names, page_rows=p["page_rows"], ledger=led,
        headroom=p["n_keys"] * p["rows_per_key"] // p["page_rows"],
        placement="blind", device=device)
    blind_share, t_blind = st.hot_traffic_share(), _modeled(st, topo)

    mover = BulkMover(topo, device=device)
    telem = Telemetry()
    try:
        st = st.retier(weights, mover=mover, telemetry=telem)
    finally:
        mover.close()
    sem_share, t_sem = st.hot_traffic_share(), _modeled(st, topo)

    assert np.array_equal(arr, st.to_array().cpu().numpy()), \
        "re-tier corrupted the table"
    assert sem_share > blind_share, (sem_share, blind_share)
    assert t_sem > t_blind, \
        f"hotness-aware {t_sem:.0f} <= blind {t_blind:.0f} inf/s"
    counters = telem.snapshot()["counters"]
    payload["placement"] = {
        "fast_budget": FAST_BUDGET,
        "blind": {"hot_traffic": blind_share, "modeled_inf_s": t_blind},
        "semantic": {"hot_traffic": sem_share, "modeled_inf_s": t_sem},
        "speedup": t_sem / t_blind,
        "promoted_pages": counters.get("semantic_promoted_pages", 0),
        "demoted_pages": counters.get("semantic_demoted_pages", 0),
        "retier": st.last_retier,
    }
    rows = [
        f"hotness/placement/win,0,blind={t_blind:.0f};sem={t_sem:.0f}"
        f";x{t_sem / t_blind:.2f};hot_traffic={blind_share:.2f}"
        f"->{sem_share:.2f}",
    ]
    return rows, st


def _section_dlrm(p, topo, names, payload, device) -> list[str]:
    """``embedding_reduce`` through both placements: the same bits."""
    rng = np.random.default_rng(1)
    rows_total = p["n_keys"] * p["rows_per_key"]
    # integer-valued fp32: bag sums are exact in any accumulation order,
    # so equality across placements is bitwise
    table = rng.integers(-8, 9, size=(rows_total, 64)).astype(np.float32)
    row_p = np.repeat(_zipf_scores(p["n_keys"], p["alpha"], rng),
                      p["rows_per_key"])
    idx_np = rng.choice(rows_total, p=row_p / row_p.sum(), size=(32, 16))
    idx = torch.as_tensor(idx_np, device=device)
    w = torch.ones((32, 16), dtype=torch.float32, device=device)
    weights = _budget_weights(topo)
    st = SemanticTensor.from_array(
        table, rows_per_key=p["rows_per_key"], weights=weights,
        device_names=names, page_rows=p["page_rows"],
        headroom=rows_total // p["page_rows"], placement="blind",
        device=device)
    # bag_reduce records the touched rows into the ledger
    out_blind = st.bag_reduce(idx, w)
    st.ledger.tick()
    synchronize(device)
    stop = stopwatch(device)
    st = st.retier(weights)
    dt = stop()
    out_sem = st.bag_reduce(idx, w)
    dense = (torch.as_tensor(table, device=device)[idx]
             * w[..., None]).sum(dim=1)
    assert torch.equal(out_blind, out_sem), \
        "DLRM bag reduction drifted across placements"
    assert torch.equal(out_sem, dense)
    payload["dlrm"] = {
        "hot_traffic": st.hot_traffic_share(),
        "retier": st.last_retier,
        "retier_s": dt,
        "bitexact": True,
    }
    return [
        f"hotness/dlrm/bitexact,{dt * 1e6:.0f},"
        f"hot_traffic={st.hot_traffic_share():.2f}"
        f";moved_keys={st.last_retier.get('moved_keys', 0)}",
    ]


def moe_config(p):
    """deepseek-moe-16b ``.tiny()`` with the section's expert count, top-2."""
    from repro_torch.models import registry
    cfg = registry.get("deepseek-moe-16b").tiny().cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=p["n_experts"], top_k=2))


def _section_moe(p, topo, names, payload, device, params=None
                 ) -> list[str]:
    """Router dispatch counts -> ledger -> per-expert re-tier; logits
    bit-equal with the expert stack rebuilt from either layout.
    ``params`` defaults to ``moe.init(cfg, 0)`` on ``device``."""
    from repro_torch.models import moe
    cfg = moe_config(p)
    if params is None:
        params = moe.init(cfg, 0, device=device)
    rng = np.random.default_rng(2)
    # unit 0's stacked expert up-projection: (E, d, f) -> E keys of d rows
    w_up_all = params.units["moe"]["experts"]["w_up"]
    w_up = w_up_all[0].clone()
    E, d, f = w_up.shape
    led = HotnessLedger(p["n_experts"], decay=0.5)
    weights = _budget_weights(topo)
    st = SemanticTensor.from_array(
        w_up.reshape(E * d, f), rows_per_key=d, weights=weights,
        device_names=names, page_rows=d // 4, ledger=led,
        headroom=E * 4, placement="blind", device=device)
    # skew the routing mix toward a hot subset drawn from the experts the
    # blind interleave put on slow devices (the adversarial case)
    cold_placed = np.nonzero(st.key_device() != 0)[0]
    hot = rng.choice(cold_placed, size=max(2, p["n_experts"] // 8),
                     replace=False)
    bias = np.zeros(p["n_experts"], np.float32)
    bias[hot] = 4.0
    router = params.units["moe"]["router"]
    router0 = router.clone()
    router.add_(torch.as_tensor(bias, device=router.device))
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_padded, size=(2, 16)), device=device)
    try:
        logits0, aux = moe.forward_with_aux(cfg, params, tokens)
        counts = aux["expert_counts"].cpu().numpy()
        assert counts.sum() > 0
        led.record(counts)

        def with_stack(stack):
            w_up_all[0].copy_(stack.reshape(E, d, f))
            return moe.forward(cfg, params, tokens)

        lb = with_stack(st.to_array())
        st = st.retier(weights)
        ls = with_stack(st.to_array())
    finally:
        w_up_all[0].copy_(w_up)
        router.copy_(router0)
    assert torch.equal(lb, logits0)
    assert torch.equal(ls, logits0), \
        "MoE logits drifted across expert placements"
    assert st.last_retier.get("promoted_pages", 0) > 0, \
        "hot experts were never promoted off the CXL devices"
    hot_share = st.hot_traffic_share()
    # the skewed routing concentrates on few experts; pinning them fast
    # captures well above the page budget's worth of dispatches
    assert hot_share > FAST_BUDGET + 0.1, hot_share
    payload["moe"] = {
        "n_experts": E,
        "hot_router_experts": sorted(int(x) for x in hot),
        "dispatch_top4": np.argsort(-counts)[:4].tolist(),
        "hot_traffic": hot_share,
        "retier": st.last_retier,
        "bitexact": True,
    }
    return [
        f"hotness/moe/bitexact,0,E={E};hot_traffic={hot_share:.2f}"
        f";promoted={st.last_retier.get('promoted_pages', 0)}",
    ]


def _section_flip(p, topo, names, st: SemanticTensor, payload, device
                  ) -> list[str]:
    """Mid-run skew flip: O(moved-keys) descriptors, one shard binding."""
    rng = np.random.default_rng(3)
    bindings = set()

    def step(t, i):
        bindings.add(tuple((q.data_ptr(), tuple(q.shape)) for q in t.parts))
        return t.gather_rows(i)

    idx = np.arange(min(64, st.logical_rows))
    before = step(st.it, idx).cpu()
    # flip the skew: a fresh permutation, fed until the EWMA crosses
    flipped = _zipf_scores(p["n_keys"], p["alpha"], rng) * 1e6
    for _ in range(p["flip_epochs"]):
        st.ledger.record(flipped)
        st.ledger.tick()
    drift = st.drift()
    mover = BulkMover(topo, device=device)
    try:
        d0 = mover.descriptors_submitted
        # donated: the consumer keeps its binding of the shards
        st = st.retier(_budget_weights(topo), mover=mover, donate=True)
        descs = mover.descriptors_submitted - d0
    finally:
        mover.close()
    after = step(st.it, idx).cpu()

    r = st.last_retier
    assert r["moved_pages"] > 0, "flip moved nothing"
    assert descs <= r["moved_keys"], (descs, r)
    assert descs < r["moved_pages"], (descs, r)
    assert torch.equal(before, after), "flip corrupted the table"
    assert len(bindings) == 1, f"{len(bindings)} shard bindings"
    payload["flip"] = {"drift": drift, "descriptors": int(descs),
                       "shard_bindings": len(bindings), **r}
    return [
        f"hotness/flip/odelta,0,drift={drift:.2f};descs={descs}"
        f"<=keys={r['moved_keys']}<pages={r['moved_pages']}"
        f";shard_bindings={len(bindings)}",
    ]


def _section_caption(p, topo, names, payload, device) -> list[str]:
    """The hot-set size as a walked coordinate with drift re-opening."""
    rng = np.random.default_rng(4)
    arr = rng.normal(size=(p["n_keys"] * p["rows_per_key"], p["dim"])) \
        .astype(np.float32)
    led = HotnessLedger(p["n_keys"], decay=0.5)
    skew = _zipf_scores(p["n_keys"], p["alpha"], rng) * 1e6
    led.record(skew)
    cfg = CaptionConfig(epoch_steps=1, probe_epochs=1, step=0.1,
                        min_step=0.02, hysteresis=0.005, drift_threshold=0.0,
                        write_damp=False)
    # the fast tier holds FAST_BUDGET of the pages: the walk may not
    # shrink the slow share below the capacity floor
    ctl = CaptionController(topo, cfg, initial_fraction=0.9,
                            min_fraction=1.0 - FAST_BUDGET)
    st = SemanticTensor.from_array(
        arr, rows_per_key=p["rows_per_key"], weights=ctl.weights,
        device_names=names, page_rows=p["page_rows"], ledger=led,
        headroom=p["n_keys"] * p["rows_per_key"] // p["page_rows"],
        placement="semantic", device=device)
    coord = HotSetCoordinator(st, ctl, drift_threshold=0.5)
    trail, flip_at = [], None
    for e in range(p["walk_epochs"]):
        if ctl.converged and flip_at is None:
            # workload shift mid-run: a brand-new hot set
            skew = _zipf_scores(p["n_keys"], p["alpha"], rng) * 1e6
            flip_at = e
        coord.st.ledger.record(skew)
        t = _modeled(coord.st, topo)
        coord.epoch(EpochMetrics(throughput=t))
        trail.append((round(ctl.fraction, 3), round(t)))
    assert flip_at is not None, "walk never converged before the flip"
    assert coord.reopens >= 1, "hot-set drift did not re-open the walk"
    assert ctl.converged, "walk did not re-converge after the flip"
    final_share = coord.st.hot_traffic_share()
    assert final_share > FAST_BUDGET, final_share
    assert np.array_equal(arr, coord.st.to_array().cpu().numpy())
    payload["caption"] = {
        "flip_epoch": flip_at, "reopens": coord.reopens,
        "final_fraction": ctl.fraction, "final_hot_traffic": final_share,
        "trail": trail,
    }
    return [
        f"hotness/caption/walk,0,flip@{flip_at};reopens={coord.reopens}"
        f";frac={ctl.fraction:.2f};hot_traffic={final_share:.2f}",
    ]


def run(smoke: bool = False, device: DeviceLike = None,
        moe_params=None) -> tuple[list[str], dict]:
    """Every section with its assertions; ``moe_params`` (a
    :class:`~repro_torch.models.moe.MoEParams` of :func:`moe_config`)
    replaces the moe section's random init."""
    device = resolve_device(device)
    p = SMOKE if smoke else FULL
    topo = paper_three_device_topology()
    names = (topo.fast.name,) + tuple(t.name for t in topo.slows)
    payload = {"config": {"smoke": smoke, **p, "threads": THREADS,
                          "devices": list(names)}}
    rows, st = _section_placement(p, topo, names, payload, device)
    rows += _section_dlrm(p, topo, names, payload, device)
    rows += _section_moe(p, topo, names, payload, device, moe_params)
    rows += _section_flip(p, topo, names, st, payload, device)
    rows += _section_caption(p, topo, names, payload, device)
    return rows, payload


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true", help="CI-sized lane")
    ap.add_argument("--out", default="BENCH_hotness_torch.json")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    rows, payload = run(smoke=args.smoke, device=args.device)
    payload["timestamp"] = time.time()
    for r in rows:
        print(r)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2, default=float)
    print(f"hotness/json,0,wrote={args.out}")


if __name__ == "__main__":
    main()
