"""Differential tests for the port's Caption controller: the same
EpochMetrics sequences fed to both packages' controllers give the same
Decision sequences (fig11 scenarios A and B, the 3-device walk, duels
under noise, drift re-open, hot remove/add), and a warm-start memo
written by either package loads in the other."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks.fig8_dlrm import BYTES_PER_INFER, throughput, throughput_nd  # noqa: E402
from repro.core import caption as r_cap  # noqa: E402
from repro.core import tiers as r_tiers  # noqa: E402
from repro.core import warmstart as r_ws  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import caption as t_cap  # noqa: E402
from repro_torch.core import tiers as t_tiers  # noqa: E402
from repro_torch.core import warmstart as t_ws  # noqa: E402

THREADS = 32


def _snc(tiers):
    snc = dataclasses.replace(tiers.DDR5_L8, name="snc-2ch", load_bw=55e9,
                              load_peak_streams=12)
    return tiers.TierTopology(fast=snc, slow=tiers.CXL_AGILEX)


def _three(tiers):
    snc = dataclasses.replace(tiers.DDR5_L8, name="snc-2ch", load_bw=55e9,
                              load_peak_streams=12)
    return tiers.TierTopology(fast=snc, slows=(tiers.CXL_A, tiers.CXL_B))


def _cfg(mod, **kw):
    base = dict(probe_epochs=2, step=0.05, min_step=0.01, hysteresis=0.01)
    base.update(kw)
    return mod.CaptionConfig(**base)


def _decision(d):
    return (d.fraction, d.changed, d.phase.value, d.reason, tuple(d.weights))


def _pair(topo_fn, **kw):
    cfg_kw = kw.pop("cfg", {})
    r = r_cap.CaptionController(topo_fn(r_tiers), _cfg(r_cap, **cfg_kw), **kw)
    t = t_cap.CaptionController(topo_fn(t_tiers), _cfg(t_cap, **cfg_kw), **kw)
    return r, t


def _step(r, t, **metrics):
    dr = r.observe(r_cap.EpochMetrics(**metrics))
    dt = t.observe(t_cap.EpochMetrics(**metrics))
    assert _decision(dt) == _decision(dr)
    assert (t.phase.value, t.weights, t.converged) == (
        r.phase.value, r.weights, r.converged)
    return dr


@pytest.mark.parametrize("scenario", ["snc", "tpu-v5e"])
def test_fig11_scenarios_same_decisions(scenario):
    """Scenario A climbs the SNC hill; scenario B stays fast on v5e."""
    topo_fn = _snc if scenario == "snc" else (
        lambda tiers: tiers.tpu_v5e_topology())
    r, t = _pair(topo_fn, initial_fraction=0.0)
    topo = topo_fn(r_tiers)
    for _ in range(64):
        _step(r, t, throughput=throughput(topo.fast, topo.slow, r.fraction,
                                          THREADS))
    assert t.history and len(t.history) == len(r.history)
    if scenario == "tpu-v5e":
        assert t.fraction <= 0.05


def test_three_device_walk_same_decisions():
    r, t = _pair(_three)
    topo = _three(r_tiers)
    for _ in range(256):
        _step(r, t, throughput=throughput_nd(topo.fast, topo.slows,
                                             tuple(r.weights), THREADS))
        if r.converged:
            break
    assert t.converged


@pytest.mark.parametrize("seed", [0, 1])
def test_duels_under_noise_same_decisions(seed):
    rng = np.random.default_rng(seed)
    r, t = _pair(_snc, cfg={"duel_count": 3}, initial_fraction=0.0)
    topo = _snc(r_tiers)
    for _ in range(220):
        tput = throughput(topo.fast, topo.slow, r.fraction, THREADS)
        _step(r, t, throughput=tput * (1.0 + rng.normal(0.0, 0.06)))


def test_drift_reopen_same_decisions():
    r, t = _pair(_snc, cfg={"duel_count": 3}, initial_fraction=0.0)
    topo = _snc(r_tiers)
    switch, reopened = None, False
    for epoch in range(360):
        if switch is None and r.converged:
            switch = epoch + 8
        on_b = switch is not None and epoch >= switch
        threads, scale = (16, 3.0) if on_b else (THREADS, 1.0)
        tput = throughput(topo.fast, topo.slow, r.fraction, threads)
        d = _step(r, t, throughput=tput,
                  slow_bw=scale * tput * r.fraction * BYTES_PER_INFER)
        reopened = reopened or (on_b and "drift" in d.reason)
    assert switch is not None and reopened


def test_guardrails_same_decisions():
    """Writer limit, fast pressure and write damping read the same
    metrics fields in both controllers."""
    r, t = _pair(lambda tiers: tiers.tpu_v5e_topology(),
                 initial_fraction=0.2)
    rng = np.random.default_rng(3)
    for i in range(40):
        _step(r, t, throughput=float(100 + rng.normal(0, 5)),
              write_ratio=float(rng.uniform(0, 0.6)),
              writer_concurrency=int(rng.integers(0, 5)),
              fast_pressure=float(rng.uniform(0.5, 1.0)),
              slow_bw=float(rng.uniform(1e9, 3e9)))
    lat_r = r_cap.CaptionController(r_tiers.tpu_v5e_topology(),
                                    boundedness=r_cap.Boundedness.LATENCY_BOUND,
                                    initial_fraction=0.3)
    lat_t = t_cap.CaptionController(t_tiers.tpu_v5e_topology(),
                                    boundedness=t_cap.Boundedness.LATENCY_BOUND,
                                    initial_fraction=0.3)
    for i in range(20):
        _step(lat_r, lat_t, throughput=100.0 - i)


def test_remove_and_add_device_same_decisions():
    r, t = _pair(lambda tiers: tiers.paper_three_device_topology(),
                 cfg={"probe_epochs": 1}, initial_weights=(0.1, 0.2, 0.3))
    for _ in range(64):
        _step(r, t, throughput=100.0)
        if r.converged:
            break
    r.remove_device("cxl-b")
    t.remove_device("cxl-b")
    assert t.weights == r.weights and t.topology.slow_names == ("cxl-a",
                                                                "cxl-c")
    for _ in range(64):
        _step(r, t, throughput=100.0 - abs(sum(r.weights) - 0.3) * 100.0)
        if r.converged:
            break
    r.add_device("cxl-b")
    t.add_device("cxl-b")
    assert t.weights == r.weights and t.active_slow_device == "cxl-b"
    for _ in range(16):
        _step(r, t, throughput=100.0 - abs(sum(r.weights) - 0.3) * 100.0)


def test_from_plan_and_headroom_same():
    from repro.core import classifier as r_cls, planner as r_pl, policy as r_po
    from repro_torch.core import classifier as t_cls, planner as t_pl, policy as t_po
    plans = []
    for cls, pl, po, tiers in ((r_cls, r_pl, r_po, r_tiers),
                               (t_cls, t_pl, t_po, t_tiers)):
        prof = cls.AccessProfile(30e9, 30e9, 1, 1024, 2 << 20, 0.05)
        req = pl.BufferReq("opt", po.BufferClass.OPT_STATE, 30 << 30, prof)
        topo = tiers.tpu_v5e_topology()
        plans.append(pl.plan([req], topo, compute_seconds=0.05))
    r = r_cap.CaptionController.from_plan(plans[0], "opt",
                                          r_tiers.tpu_v5e_topology())
    t = t_cap.CaptionController.from_plan(plans[1], "opt",
                                          t_tiers.tpu_v5e_topology())
    assert (t.weights, t.min_fraction) == (r.weights, r.min_fraction)
    for n in (0, 1, 7, 1 << 19):
        assert t.headroom_pages(n) == r.headroom_pages(n)
    for i in range(30):
        _step(r, t, throughput=100.0 + i % 3)


@pytest.mark.parametrize("writer", ["r", "t"])
def test_warm_start_memo_crosses_packages(writer):
    """A memo written by one package warm-starts the other's controller
    at the same remembered optimum, with the same decisions."""
    topo = {"r": _snc(r_tiers), "t": _snc(t_tiers)}
    mods = {"r": (r_cap, r_ws), "t": (t_cap, t_ws)}
    cap, ws = mods[writer]
    memo = ws.WarmStartMemo()
    cold = cap.CaptionController(topo[writer], _cfg(cap),
                                 initial_fraction=0.0)
    cold.attach_memo(memo)
    for _ in range(1200):
        cold.observe(cap.EpochMetrics(throughput=throughput(
            topo["r"].fast, topo["r"].slow, cold.fraction, THREADS)))
        if cold.converged:
            break
    assert cold.converged and len(memo) == 1
    text = memo.to_json()
    memo_r = r_ws.WarmStartMemo.from_json(text)
    memo_t = convert.memo_from_json(text)
    assert memo_t.to_json() == memo_r.to_json()
    assert t_ws.topology_signature(topo["t"]) == r_ws.topology_signature(
        topo["r"])
    r, t = _pair(_snc, initial_fraction=0.0)
    r.attach_memo(memo_r)
    t.attach_memo(memo_t)
    for _ in range(8):
        _step(r, t, throughput=throughput(topo["r"].fast, topo["r"].slow,
                                          r.fraction, THREADS))
    assert memo_t.hits == memo_r.hits == 1
    assert max(abs(a - b) for a, b in zip(t.weights, cold.weights)) <= 0.02
