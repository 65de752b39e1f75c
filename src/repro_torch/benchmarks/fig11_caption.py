"""Fig. 11 — Caption: dynamic page allocation converging from cold start.

The paper's §7 result: a counter-sampling controller that tunes the
slow-tier page fraction online converges to (within a few points of)
the best *static* weighted-interleave split — without knowing the
workload in advance — and never ends below the membind-fast default.

Scenario A reproduces the positive regime on the paper's testbed with
the SNC-clipped fast tier (the Fig. 9 setup where ~20% CXL RAISES DLRM
throughput ~11%): the controller starts at 0% slow and climbs the
measured-throughput hill to the static optimum.

Scenario B runs the same loop on the reference's modeled TPU v5e preset,
where the fast tier has bandwidth headroom: the correct answer is "stay
fast", and Caption's guardrails keep it there (Fig. 7 discipline:
interleaving never helps an unsaturated fast tier).

Finally the actuation path is audited end-to-end: re-tiering a real
``InterleavedTensor`` (on the card an HBM shard and a pinned host shard,
moved by ``stream_copy`` through the default ``BulkMover``) moves ONLY
the delta pages (byte-for-byte checked against BulkMover telemetry) and
is numerically a no-op; and a Caption walk over a capacity-padded tensor
keeps one binding of its shards (storage and shape) across every epoch,
the port's counterpart of the reference's single jit trace.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from repro_torch.benchmarks.common import launch_bound, synchronize
from repro_torch.benchmarks.fig8_dlrm import (BYTES_PER_INFER, throughput,
                                             throughput_nd)
from repro_torch.core.arbiter import ArbiterConfig, CaptionArbiter
from repro_torch.core.caption import (CaptionConfig, CaptionController,
                                      EpochMetrics)
from repro_torch.core.interleave import InterleavedTensor
from repro_torch.core.mover import BulkMover
from repro_torch.core.policy import MemPolicy
from repro_torch.core.telemetry import EpochWindow, Telemetry
from repro_torch.core.tiers import (CXL_A, CXL_B, DDR5_L8, TierTopology,
                                    paper_topology, tpu_v5e_topology)
from repro_torch.core.warmstart import WarmStartMemo
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.stream_copy import ops as sc_ops

THREADS = 32
EPOCHS = 64

# -- multi-buffer mode: three tiered buffers share one slow tier ------------
#: per-buffer thread counts (weights-, KV- and opt-state-shaped demand).
MB_BUFFERS = {"weights": 32, "kv": 24, "opt": 16}
#: shared slow-tier byte budget (< the CXL 20 GB/s peak: link headroom).
MB_BUDGET = 12e9
#: §3 contention: an oversubscribed far-memory controller serves *less*
#: than its budget (Fig. 3 collapse), so blowing it hurts everyone.
MB_COLLAPSE = 0.65


def snc_topology() -> TierTopology:
    """Paper testbed with the fast tier clipped to 2 channels (Fig. 9)."""
    snc = dataclasses.replace(DDR5_L8, name="snc-2ch", load_bw=55e9,
                              load_peak_streams=12)
    return TierTopology(fast=snc, slow=paper_topology().slow)


def three_device_topology() -> TierTopology:
    """The SNC fast node + two of the paper's CXL devices (Table 1 mix)."""
    snc = dataclasses.replace(DDR5_L8, name="snc-2ch", load_bw=55e9,
                              load_peak_streams=12)
    return TierTopology(fast=snc, slows=(CXL_A, CXL_B))


def run_three_device() -> list[str]:
    """Caption on a 3-device topology: the controller walks a WEIGHT
    VECTOR on the simplex (coordinate descent per device) and must land
    within 5pp per device of the best static sweep point — the N-device
    generalization of the paper's Fig. 11 convergence claim."""
    rows = []
    topo = three_device_topology()

    def tput(w) -> float:
        return throughput_nd(topo.fast, topo.slows, tuple(w), THREADS)

    # Exhaustive static sweep over the weight simplex (the Fig. 10 grid).
    grid = np.linspace(0.0, 0.5, 51)
    best_w, best_t = (0.0, 0.0), 0.0
    for a in grid:
        for b in grid:
            if a + b > 0.8:
                continue
            t = tput((float(a), float(b)))
            if t > best_t:
                best_w, best_t = (float(a), float(b)), t
    membind = tput((0.0, 0.0))

    ctl = CaptionController(
        topo, CaptionConfig(probe_epochs=2, step=0.05, min_step=0.01,
                            hysteresis=0.01))
    trace = []
    for epoch in range(256):
        t = tput(ctl.weights)
        trace.append((epoch, tuple(ctl.weights), t))
        ctl.observe(EpochMetrics(throughput=t))
        if ctl.converged:
            break
    for epoch, w, t in trace[:: max(1, len(trace) // 8)]:
        rows.append(f"fig11/3dev/epoch{epoch:03d},0,"
                    f"w=({w[0]:.3f},{w[1]:.3f});inf_s={t:.0f}")
    final_t = tput(ctl.weights)
    rows.append(
        f"fig11/3dev/converged,0,"
        f"w=({ctl.weights[0]:.3f},{ctl.weights[1]:.3f})"
        f";best=({best_w[0]:.3f},{best_w[1]:.3f})"
        f";tput={final_t:.0f};static_best={best_t:.0f};membind={membind:.0f}")
    # Acceptance: converged; each device's weight within 5pp of the best
    # static sweep point; throughput at least membind-fast and within 5%
    # of the best static split.
    assert ctl.converged, ctl.phase
    for w, b in zip(ctl.weights, best_w):
        assert abs(w - b) <= 0.05, (tuple(ctl.weights), best_w)
    assert final_t >= membind, (final_t, membind)
    assert final_t >= 0.95 * best_t, (final_t, best_t)
    return rows


def _static_sweep(topo: TierTopology) -> tuple[float, float]:
    """Best static weighted-interleave split by exhaustive sweep."""
    best_f, best_t = 0.0, throughput(topo.fast, topo.slow, 0.0, THREADS)
    for f in np.linspace(0.0, 0.6, 121):
        t = throughput(topo.fast, topo.slow, float(f), THREADS)
        if t > best_t:
            best_f, best_t = float(f), t
    return best_f, best_t


def _run_loop(topo: TierTopology, cfg: CaptionConfig
              ) -> tuple[CaptionController, list[tuple[int, float, float]]]:
    """Cold start (0% slow) closed loop: modeled epoch -> counters -> adjust."""
    ctl = CaptionController(topo, cfg, initial_fraction=0.0)
    trace = []
    for epoch in range(EPOCHS):
        t = throughput(topo.fast, topo.slow, ctl.fraction, THREADS)
        trace.append((epoch, ctl.fraction, t))
        ctl.observe(EpochMetrics(throughput=t))  # DLRM inference: read-only
    return ctl, trace


def _shared_throughput(topo: TierTopology, fracs: dict[str, float]
                       ) -> tuple[dict[str, float], float]:
    """Per-buffer inference rates when all buffers share the slow tier.

    Each buffer runs the Fig. 8 closed-loop model in isolation; if their
    combined slow-tier traffic oversubscribes MB_BUDGET, the controller
    collapses (Fig. 3) and every buffer slows in proportion to its slow
    dependence.  Returns (rates, achieved slow-tier bytes/s)."""
    fast, slow = topo.fast, topo.slow
    xs = {n: throughput(fast, slow, fracs[n], th)
          for n, th in MB_BUFFERS.items()}
    offered = sum(xs[n] * fracs[n] * BYTES_PER_INFER for n in xs)
    if offered <= MB_BUDGET:
        return xs, offered
    eff = MB_BUDGET * MB_COLLAPSE
    xs = {n: xs[n] / (1 + fracs[n] * (offered / eff - 1)) for n in xs}
    return xs, sum(xs[n] * fracs[n] * BYTES_PER_INFER for n in xs)


def run_multibuffer(topo: TierTopology) -> list[str]:
    """Three buffers under one CaptionArbiter vs uncoordinated greed.

    The uncoordinated baseline gives each buffer its per-buffer greedy
    optimum (the best static split computed as if it owned the whole slow
    tier — exactly what N independent Caption loops converge to); their
    summed traffic blows the budget and the controller collapse drags
    aggregate throughput below even membind-fast.  The arbiter gates and
    clips growth against the shared budget, so the fleet lands under it
    and beats the greedy configuration."""
    rows = []
    fast, slow = topo.fast, topo.slow

    # Uncoordinated greedy: per-buffer static sweep assuming sole ownership.
    greedy = {}
    for n, th in MB_BUFFERS.items():
        grid = np.linspace(0.0, 0.6, 121)
        greedy[n] = float(grid[int(np.argmax(
            [throughput(fast, slow, float(f), th) for f in grid]))])
    xs_greedy, off_greedy = _shared_throughput(topo, greedy)
    agg_greedy = sum(xs_greedy.values())
    membind = sum(throughput(fast, slow, 0.0, th)
                  for th in MB_BUFFERS.values())

    # Coordinated: one arbiter, three registered controllers, telemetry
    # source attribution billing each buffer's slow traffic.
    tel = Telemetry()
    arb = CaptionArbiter(topo, ArbiterConfig(slow_bw_budget=MB_BUDGET,
                                             starvation_floor=0.1))
    ccfg = CaptionConfig(probe_epochs=2, step=0.05, min_step=0.01,
                         hysteresis=0.01)
    ctls = {n: arb.register(n, CaptionController(topo, ccfg))
            for n in MB_BUFFERS}
    wins = {n: EpochWindow(tel) for n in MB_BUFFERS}
    for epoch in range(96):
        fracs = {n: c.fraction for n, c in ctls.items()}
        xs, _ = _shared_throughput(topo, fracs)
        for n in MB_BUFFERS:
            tel.record_move("engine", slow.name,
                            int(xs[n] * fracs[n] * BYTES_PER_INFER), 0.0,
                            source=n)
            arb.observe_window(n, wins[n], xs[n], slow_name=slow.name,
                               seconds=1.0)

    fracs = {n: c.fraction for n, c in ctls.items()}
    xs_arb, off_arb = _shared_throughput(topo, fracs)
    agg_arb = sum(xs_arb.values())
    for n in MB_BUFFERS:
        rows.append(f"fig11/multibuffer/{n},0,f={fracs[n]:.3f}"
                    f";tput={xs_arb[n]:.0f};grant={arb.grants()[n]:.3g}")
    rows.append(
        f"fig11/multibuffer/aggregate,0,arb={agg_arb:.0f}"
        f";greedy={agg_greedy:.0f};membind={membind:.0f}"
        f";slow_bw={off_arb:.3g};budget={MB_BUDGET:.3g}")
    # Acceptance: combined slow traffic within budget; aggregate throughput
    # at least the best uncoordinated (per-buffer greedy) configuration;
    # nobody starved below the floor share.
    assert off_arb <= MB_BUDGET * 1.05, (off_arb, MB_BUDGET)
    assert agg_arb >= agg_greedy, (agg_arb, agg_greedy)
    assert agg_arb >= membind, (agg_arb, membind)
    floor = arb.cfg.starvation_floor * MB_BUDGET
    assert all(g >= floor * 0.99 for g in arb.grants().values()), arb.grants()
    return rows


def _audit(topo: TierTopology, fraction: float, rng, device: torch.device,
           payload: dict) -> str:
    """Repartition moves ONLY the delta pages, through the default mover
    (``stream_copy`` on the card, within its launch bound)."""
    table = rng.normal(size=(4096, 64)).astype(np.float32)
    page_rows = 64
    it = InterleavedTensor.from_array(table, MemPolicy.membind("fast"),
                                      page_rows=page_rows, device=device)
    ref = it.to_array().cpu().numpy()
    page_bytes = page_rows * it.row_bytes
    tel = Telemetry()
    launches = []
    with BulkMover(topo, asynchronous=True, batch_size=16, telemetry=tel,
                   device=device) as mover:
        pol1 = MemPolicy.from_slow_fraction("fast", "slow", fraction)
        expect1 = int(pol1.page_is_slow(it.n_pages).sum())  # 0 -> f: delta =
        n0 = sc_ops.LAUNCHES.count
        it = it.repartition(pol1, mover=mover, fast_tier=topo.fast.name,
                            slow_tier=topo.slow.name)
        descs1 = mover.descriptors_submitted
        launches.append((sc_ops.LAUNCHES.count - n0, descs1))
        moved1 = tel.route(topo.fast.name, topo.slow.name).bytes_moved
        assert moved1 == expect1 * page_bytes, (moved1, expect1 * page_bytes)
        # a small controller adjustment flips only the page-count delta
        f2 = fraction + 0.05
        cur_slow = int(it.page_tier.sum())
        delta12 = abs(round(f2 * it.n_pages) - cur_slow)
        descs_before = mover.descriptors_submitted
        n0 = sc_ops.LAUNCHES.count
        it = it.repartition_fraction(f2, mover=mover,
                                     fast_tier=topo.fast.name,
                                     slow_tier=topo.slow.name)
        descs12 = mover.descriptors_submitted - descs_before
        launches.append((sc_ops.LAUNCHES.count - n0, descs12))
        moved2 = (tel.route(topo.fast.name, topo.slow.name).bytes_moved
                  + tel.route(topo.slow.name, topo.fast.name).bytes_moved
                  - moved1)
        assert moved2 == delta12 * page_bytes, (moved2, delta12 * page_bytes)
        assert delta12 < it.n_pages  # strictly less than a rebuild
        # run-coalesced movement: O(delta-runs) descriptors, not one per
        # page — the billed bytes above stayed exact regardless
        assert descs12 < delta12, (descs12, delta12)
    # each move is one route on the rebuild path (no headroom): one gather
    # launch per batch of 16 descriptors, one landing launch
    for n, descs in launches:
        assert n <= launch_bound([descs]), (n, descs)
        if device.type == "cuda":
            assert n > 0, "the audit's moves did not launch stream_copy"
    assert np.allclose(it.to_array().cpu().numpy(), ref)  # numerical no-op
    payload["audit"] = {"pages": it.n_pages, "delta1": expect1,
                        "delta2": delta12, "descs2": descs12,
                        "stream_copy_launches": [n for n, _ in launches],
                        "descriptors": [d for _, d in launches]}
    return (f"fig11/repartition/audit,0,pages={it.n_pages}"
            f";delta1={expect1};delta2={delta12};descs2={descs12}"
            f";bytes_ok=1")


def _binding_walk(topo: TierTopology, rng, device: torch.device) -> str:
    """Probe epochs keep the consumer's bindings: a step reads the walk
    tensor across a 16-epoch Caption walk on capacity-padded shards, and
    sees one (storage, shape) binding of its shards throughout — what one
    jit trace certifies in the reference, and what a CUDA-graph capture
    of the step needs."""
    ctl_w = CaptionController(
        snc_topology(), CaptionConfig(probe_epochs=1, step=0.05,
                                      min_step=0.01, hysteresis=0.01))
    n_pages = 256
    walk_it = InterleavedTensor.from_array(
        rng.normal(size=(n_pages * 16, 8)).astype(np.float32),
        MemPolicy.membind("fast"), page_rows=16,
        headroom=ctl_w.headroom_pages(n_pages), device=device)
    bindings = set()

    def _step(t, i):
        bindings.add(tuple((p.data_ptr(), tuple(p.shape)) for p in t.parts))
        return t.gather_rows(i)

    idx = torch.as_tensor(rng.integers(0, n_pages * 16, size=32),
                          device=device)
    epochs = 0
    for _ in range(16):
        _step(walk_it, idx)
        synchronize(device)
        tput = throughput(topo.fast, topo.slow, ctl_w.fraction, THREADS)
        d = ctl_w.observe(EpochMetrics(throughput=tput))
        # the Caption actuation pattern drops the parent: donated, so the
        # receiving shards are written in place
        walk_it = walk_it.repartition_fraction(d.fraction,
                                               telemetry=Telemetry(),
                                               donate=True)
        ctl_w.actuated(walk_it.slow_fraction())
        epochs += 1
    assert epochs >= 10 and len(bindings) == 1, (epochs, len(bindings))
    return (f"fig11/repartition/retrace_free,0,epochs={epochs}"
            f";shard_bindings={len(bindings)}")


def run(device: DeviceLike = None, payload: Optional[dict] = None
        ) -> list[str]:
    device = resolve_device(device)
    payload = payload if payload is not None else {}
    rows = []
    cfg = CaptionConfig(probe_epochs=2, step=0.05, min_step=0.01,
                        hysteresis=0.01)

    # --- Scenario A: bandwidth-bound fast tier (paper SNC, Fig. 9/11) ------
    topo = snc_topology()
    best_f, best_t = _static_sweep(topo)
    baseline = throughput(topo.fast, topo.slow, 0.0, THREADS)  # membind fast
    ctl, trace = _run_loop(topo, cfg)
    for epoch, f, t in trace[:: max(1, EPOCHS // 16)]:
        rows.append(f"fig11/snc/epoch{epoch:02d},0,f={f:.3f};inf_s={t:.0f}")
    final_t = throughput(topo.fast, topo.slow, ctl.fraction, THREADS)
    rows.append(
        f"fig11/snc/converged,0,f={ctl.fraction:.3f};best_static={best_f:.3f}"
        f";tput={final_t:.0f};static_best={best_t:.0f};membind={baseline:.0f}")
    # Acceptance: within 5 points of the best static split, and at least as
    # good as the static default (membind fast).
    assert abs(ctl.fraction - best_f) <= 0.05, (ctl.fraction, best_f)
    assert final_t >= baseline, (final_t, baseline)
    assert final_t >= 0.95 * best_t, (final_t, best_t)

    # --- Scenario B: fast tier has headroom (modeled TPU v5e preset) -------
    tpu = tpu_v5e_topology()
    tbest_f, _ = _static_sweep(tpu)
    tctl, ttrace = _run_loop(tpu, cfg)
    tfinal = throughput(tpu.fast, tpu.slow, tctl.fraction, THREADS)
    tbase = throughput(tpu.fast, tpu.slow, 0.0, THREADS)
    rows.append(f"fig11/tpu/converged,0,f={tctl.fraction:.3f}"
                f";best_static={tbest_f:.3f};tput={tfinal:.0f}")
    assert abs(tctl.fraction - tbest_f) <= 0.05, (tctl.fraction, tbest_f)
    assert tfinal >= 0.95 * tbase

    # --- Actuation audit: repartition moves ONLY the delta pages ------------
    rng = np.random.default_rng(0)
    rows.append(_audit(topo, ctl.fraction, rng, device, payload))

    # --- One binding across the walk: probe epochs never rebind -------------
    rows.append(_binding_walk(topo, rng, device))

    # --- N-device: weight-vector convergence on a 3-device pool -------------
    rows.extend(run_three_device())

    # --- Multi-buffer: one arbiter, one shared slow-tier budget -------------
    rows.extend(run_multibuffer(topo))
    payload["rows"] = list(rows)
    return rows


# -- control plane: dueling probes, warm-start memo, joint moves -------------
#: injected relative telemetry noise (std) for the regret comparison.
NOISE_STD = 0.06
#: paired duels per candidate point in the noise-robust configuration.
DUEL_COUNT = 3
#: seeds averaged by the regret gate (smoke uses the first 3).
REGRET_SEEDS = (0, 1, 2, 3, 4)
REGRET_EPOCHS = 280


def _control_cfg(duels: int = 0) -> CaptionConfig:
    return CaptionConfig(probe_epochs=2, step=0.05, min_step=0.01,
                         hysteresis=0.01, duel_count=duels)


def _sweep_threads(topo: TierTopology, threads: int) -> tuple[float, float]:
    best_f, best_t = 0.0, throughput(topo.fast, topo.slow, 0.0, threads)
    for f in np.linspace(0.0, 0.6, 121):
        t = throughput(topo.fast, topo.slow, float(f), threads)
        if t > best_t:
            best_f, best_t = float(f), t
    return best_f, best_t


def _noisy_regret(topo: TierTopology, best_t: float, seed: int,
                  duels: int, epochs: int) -> tuple[float, float]:
    """Closed loop on the SNC hill with multiplicative telemetry noise;
    returns (final fraction, cumulative relative regret vs the best
    static split).  Regret is charged on the TRUE throughput at each
    operating point — the controller only ever sees the noisy signal."""
    rng = np.random.default_rng(seed)
    ctl = CaptionController(topo, _control_cfg(duels), initial_fraction=0.0)
    regret = 0.0
    for _ in range(epochs):
        t_true = throughput(topo.fast, topo.slow, ctl.fraction, THREADS)
        regret += (best_t - t_true) / best_t
        ctl.observe(EpochMetrics(
            throughput=t_true * (1.0 + rng.normal(0.0, NOISE_STD))))
    return ctl.fraction, regret


def _regret_section(topo: TierTopology, smoke: bool,
                    rows: list[str]) -> dict:
    """Dueling probes vs single-sample hill-climb under injected noise.

    The single-sample climb is bimodal under noise: one unlucky window
    at cold start rejects the first (real) gradient and parks the walk
    at f=0 for the whole run.  Paired duels average the noise down and
    retry before shrinking, so every seed converges near the optimum —
    the seed-averaged cumulative regret must be strictly lower."""
    seeds = REGRET_SEEDS[:3] if smoke else REGRET_SEEDS
    epochs = 200 if smoke else REGRET_EPOCHS
    best_f, best_t = _static_sweep(topo)
    single, duel = {}, {}
    for seed in seeds:
        sf, sr = _noisy_regret(topo, best_t, seed, 0, epochs)
        df, dr = _noisy_regret(topo, best_t, seed, DUEL_COUNT, epochs)
        single[seed] = {"final_f": sf, "regret": sr}
        duel[seed] = {"final_f": df, "regret": dr}
        rows.append(f"fig11/control/regret/seed{seed},0,"
                    f"single_f={sf:.3f};single_regret={sr:.1f}"
                    f";duel_f={df:.3f};duel_regret={dr:.1f}")
    s_mean = sum(v["regret"] for v in single.values()) / len(seeds)
    d_mean = sum(v["regret"] for v in duel.values()) / len(seeds)
    rows.append(f"fig11/control/regret/mean,0,single={s_mean:.1f}"
                f";duel={d_mean:.1f};noise={NOISE_STD};epochs={epochs}")
    # Acceptance: dueling cumulative regret strictly below the
    # single-sample baseline in the same run, and the dueling walk lands
    # near the true optimum on EVERY seed (no stuck-at-zero runs).
    assert d_mean < s_mean, (d_mean, s_mean)
    for seed, v in duel.items():
        assert abs(v["final_f"] - best_f) <= 0.05, (seed, v, best_f)
    return {"noise": NOISE_STD, "epochs": epochs, "best_f": best_f,
            "seeds": list(seeds), "duel_count": DUEL_COUNT,
            "single": single, "duel": duel,
            "single_mean_regret": s_mean, "duel_mean_regret": d_mean}


def _warmstart_section(topo: TierTopology, rows: list[str]) -> dict:
    """Cold walk records its converged weights under the workload
    fingerprint; a rerun of the same workload must warm-start from the
    memo — at the remembered optimum from the first decision, converged
    within one confirmation stint instead of re-walking the hill."""
    cfg = _control_cfg()
    memo = WarmStartMemo()
    cold = CaptionController(topo, cfg, initial_fraction=0.0)
    cold.attach_memo(memo)
    cold_epochs = None
    for epoch in range(4 * REGRET_EPOCHS):
        t = throughput(topo.fast, topo.slow, cold.fraction, THREADS)
        cold.observe(EpochMetrics(throughput=t))
        if cold.converged:
            cold_epochs = epoch + 1
            break
    assert cold.converged and len(memo) == 1, (cold.phase, len(memo))

    # The rerun loads the memo through a JSON roundtrip (what --memo-path
    # persists to disk between runs).
    memo2 = WarmStartMemo.from_json(memo.to_json())
    warm = CaptionController(topo, cfg, initial_fraction=0.0)
    warm.attach_memo(memo2)
    reach_epoch = None
    warm_epochs = None
    for epoch in range(cold_epochs):
        t = throughput(topo.fast, topo.slow, warm.fraction, THREADS)
        warm.observe(EpochMetrics(throughput=t))
        gap = max(abs(a - b) for a, b in zip(warm.weights, cold.weights))
        if reach_epoch is None and gap <= 0.02:
            reach_epoch = epoch + 1
        if warm.converged:
            warm_epochs = epoch + 1
            break
    gap_pp = 100 * max(abs(a - b)
                       for a, b in zip(warm.weights, cold.weights))
    rows.append(f"fig11/control/warmstart,0,cold_epochs={cold_epochs}"
                f";warm_epochs={warm_epochs};reach_epoch={reach_epoch}"
                f";gap_pp={gap_pp:.2f};hits={memo2.hits}")
    # Acceptance: the warm-started rerun is within 2pp per device of the
    # cold walk's converged weights within 2 probe epochs (it lands
    # there on the memo-hit decision), holds converged after one
    # confirmation stint, and beats the cold walk outright.
    assert warm.converged, warm.phase
    assert memo2.hits == 1, (memo2.hits, memo2.misses)
    assert reach_epoch is not None and reach_epoch <= 2, reach_epoch
    assert gap_pp <= 2.0, gap_pp
    assert warm_epochs <= 2 * cfg.probe_epochs, (warm_epochs, cold_epochs)
    assert warm_epochs < cold_epochs, (warm_epochs, cold_epochs)
    return {"cold_epochs": cold_epochs, "warm_epochs": warm_epochs,
            "reach_epoch": reach_epoch, "gap_pp": gap_pp,
            "memo_hits": memo2.hits}


def _drift_section(topo: TierTopology, smoke: bool,
                   rows: list[str]) -> dict:
    """Drifting workload: after the dueling walk converges on workload A
    (32 threads), the app shifts to a write-heavier, lower-parallelism
    phase (B).  The slow-route bandwidth at the held point shifts with
    it, the drift detector re-opens the walk, and the controller
    re-converges near B's own static optimum."""
    threads_b = 16  # B's static optimum is ~0.09: nonzero AND != A's
    demand_scale_b = 3.0  # B pushes 3x the slow-tier bytes per inference
    best_f_a, _ = _sweep_threads(topo, THREADS)
    best_f_b, _ = _sweep_threads(topo, threads_b)
    ctl = CaptionController(topo, _control_cfg(DUEL_COUNT),
                            initial_fraction=0.0)
    reopen_epoch = None
    switch_epoch = None
    epochs = 360 if smoke else 600
    for epoch in range(epochs):
        if switch_epoch is None and ctl.converged:
            switch_epoch = epoch + 8  # hold a few epochs, then drift
        on_b = switch_epoch is not None and epoch >= switch_epoch
        threads = threads_b if on_b else THREADS
        scale = demand_scale_b if on_b else 1.0
        t = throughput(topo.fast, topo.slow, ctl.fraction, threads)
        d = ctl.observe(EpochMetrics(
            throughput=t,
            slow_bw=scale * t * ctl.fraction * BYTES_PER_INFER))
        if on_b and reopen_epoch is None and "drift" in d.reason:
            reopen_epoch = epoch
    rows.append(f"fig11/control/drift,0,switch={switch_epoch}"
                f";reopen={reopen_epoch};final_f={ctl.fraction:.3f}"
                f";best_a={best_f_a:.3f};best_b={best_f_b:.3f}")
    # Acceptance: converged on A near A's optimum, re-opened after the
    # shift, re-converged near B's optimum (which must actually differ).
    assert switch_epoch is not None  # converged on A at all
    assert abs(best_f_a - best_f_b) > 0.02, (best_f_a, best_f_b)
    assert reopen_epoch is not None and reopen_epoch >= switch_epoch
    assert ctl.converged, ctl.phase
    assert abs(ctl.fraction - best_f_b) <= 0.05, (ctl.fraction, best_f_b)
    return {"switch_epoch": switch_epoch, "reopen_epoch": reopen_epoch,
            "final_f": ctl.fraction, "best_f_a": best_f_a,
            "best_f_b": best_f_b}


def _joint_section(topo: TierTopology, smoke: bool,
                   rows: list[str]) -> dict:
    """Arbiter joint moves: growth is frozen locally and granted through
    utility-per-cost-ordered propose/commit rounds against the shared
    budget — coordination by allocation instead of clip-the-greedy."""
    fast, slow = topo.fast, topo.slow
    greedy = {}
    for n, th in MB_BUFFERS.items():
        grid = np.linspace(0.0, 0.6, 121)
        greedy[n] = float(grid[int(np.argmax(
            [throughput(fast, slow, float(f), th) for f in grid]))])
    xs_greedy, _ = _shared_throughput(topo, greedy)
    agg_greedy = sum(xs_greedy.values())
    membind = sum(throughput(fast, slow, 0.0, th)
                  for th in MB_BUFFERS.values())

    tel = Telemetry()
    arb = CaptionArbiter(topo, ArbiterConfig(slow_bw_budget=MB_BUDGET,
                                             starvation_floor=0.1,
                                             joint_moves=True))
    ctls = {n: arb.register(n, CaptionController(topo, _control_cfg()))
            for n in MB_BUFFERS}
    wins = {n: EpochWindow(tel) for n in MB_BUFFERS}
    rounds = 0
    granted_total = 0.0
    epochs = 64 if smoke else 96
    for epoch in range(epochs):
        fracs = {n: c.fraction for n, c in ctls.items()}
        xs, _ = _shared_throughput(topo, fracs)
        for n in MB_BUFFERS:
            tel.record_move("engine", slow.name,
                            int(xs[n] * fracs[n] * BYTES_PER_INFER), 0.0,
                            source=n)
            arb.observe_window(n, wins[n], xs[n], slow_name=slow.name,
                               seconds=1.0)
        grants = arb.joint_move()
        if grants:
            rounds += 1
            granted_total += sum(grants.values())

    fracs = {n: c.fraction for n, c in ctls.items()}
    xs_arb, off_arb = _shared_throughput(topo, fracs)
    agg_arb = sum(xs_arb.values())
    for n in MB_BUFFERS:
        rows.append(f"fig11/control/joint/{n},0,f={fracs[n]:.3f}"
                    f";tput={xs_arb[n]:.0f}")
    rows.append(f"fig11/control/joint/aggregate,0,arb={agg_arb:.0f}"
                f";greedy={agg_greedy:.0f};membind={membind:.0f}"
                f";slow_bw={off_arb:.3g};budget={MB_BUDGET:.3g}"
                f";rounds={rounds};granted={granted_total:.3f}")
    # Acceptance: growth happened ONLY through committed joint grants,
    # the fleet lands under budget, and coordinated allocation does at
    # least as well as uncoordinated greed (and membind-fast).
    assert rounds > 0 and granted_total > 0
    assert abs(sum(fracs.values()) - granted_total) <= granted_total + 1e-9
    assert off_arb <= MB_BUDGET * 1.05, (off_arb, MB_BUDGET)
    assert agg_arb >= membind, (agg_arb, membind)
    assert agg_arb >= agg_greedy, (agg_arb, agg_greedy)
    return {"fractions": fracs, "aggregate": agg_arb, "greedy": agg_greedy,
            "membind": membind, "slow_bw": off_arb, "budget": MB_BUDGET,
            "rounds": rounds, "granted_total": granted_total}


def run_control(smoke: bool = False) -> tuple[list[str], dict]:
    """Convergence-time + cumulative-regret gate for the control plane
    (noisy and drifting workloads), emitted as BENCH_control.json."""
    rows: list[str] = []
    topo = snc_topology()
    bench = {
        "bench": "control",
        "smoke": smoke,
        "regret": _regret_section(topo, smoke, rows),
        "warmstart": _warmstart_section(topo, rows),
        "drift": _drift_section(topo, smoke, rows),
        "joint": _joint_section(topo, smoke, rows),
    }
    return rows, bench


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--control", action="store_true",
                    help="run the control-plane gate (dueling regret, "
                         "warm-start, drift re-probe, joint moves) instead "
                         "of the legacy Fig. 11 sections")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized control-plane gate (implies --control)")
    ap.add_argument("--out", default=None,
                    help="write the control-plane results as JSON "
                         "(BENCH_control_torch.json)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.control or args.smoke:
        rows, bench = run_control(smoke=args.smoke)
        print("\n".join(rows))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(bench, f, indent=2, sort_keys=True)
            print(f"wrote {args.out}")
        return
    print("\n".join(run(device=args.device)))


if __name__ == "__main__":
    main()
