"""Differential tests for the CaptionArbiter: the scenarios of
tests/test_arbiter.py run against both packages must make the same
decisions and grant the same budgets."""
import types

import pytest

pytest.importorskip("torch")

import repro.core.arbiter as r_arbiter  # noqa: E402
import repro.core.caption as r_caption  # noqa: E402
import repro.core.classifier as r_classifier  # noqa: E402
import repro.core.telemetry as r_telemetry  # noqa: E402
import repro.core.tiers as r_tiers  # noqa: E402
import repro_torch.core as t_core  # noqa: E402
import repro_torch.core.arbiter as t_arbiter  # noqa: E402
import repro_torch.core.caption as t_caption  # noqa: E402
import repro_torch.core.classifier as t_classifier  # noqa: E402
import repro_torch.core.telemetry as t_telemetry  # noqa: E402
import repro_torch.core.tiers as t_tiers  # noqa: E402

PKGS = {
    "ref": types.SimpleNamespace(arb=r_arbiter, cap=r_caption,
                                 cls=r_classifier, tel=r_telemetry,
                                 tiers=r_tiers),
    "port": types.SimpleNamespace(arb=t_arbiter, cap=t_caption,
                                  cls=t_classifier, tel=t_telemetry,
                                  tiers=t_tiers),
}


def _decision(d):
    return (round(d.fraction, 12), d.phase.value, d.reason,
            tuple(round(w, 12) for w in d.weights))


def _both(scenario):
    out = {side: scenario(p) for side, p in PKGS.items()}
    assert out["port"] == out["ref"]
    return out["port"]


def _greedy(p, ctl):
    return p.cap.EpochMetrics(throughput=1.0 + ctl.fraction)


def test_budget_walk_identical():
    def run(p):
        topo = p.tiers.tpu_v5e_topology()
        arb = p.arb.CaptionArbiter(topo, p.arb.ArbiterConfig(slow_bw_budget=10e9))
        ctls = [arb.register(f"buf{i}", p.cap.CaptionController(
            topo, p.cap.CaptionConfig(probe_epochs=1, step=0.1)))
            for i in range(3)]
        decisions = []
        for _ in range(24):
            for i, c in enumerate(ctls):
                decisions.append(_decision(arb.observe(
                    f"buf{i}", _greedy(p, c), slow_bw=c.fraction * 40e9)))
        return (decisions, arb.grants(), arb.demands(),
                arb.aggregate_demand_bw())

    decisions, grants, _, demand = _both(run)
    assert demand <= 10e9 * 1.05 and sum(grants.values()) <= 10e9 * 1.001


def test_latency_priority_and_floor_identical():
    def run(p):
        topo = p.tiers.tpu_v5e_topology()
        arb = p.arb.CaptionArbiter(topo, p.arb.ArbiterConfig(
            slow_bw_budget=10e9, starvation_floor=0.1))
        arb.register("lat", p.cap.CaptionController(
            topo, p.cap.CaptionConfig(probe_epochs=1), initial_fraction=0.2,
            min_fraction=0.2, boundedness=p.cls.Boundedness.LATENCY_BOUND))
        arb.register("loud", p.cap.CaptionController(
            topo, p.cap.CaptionConfig(probe_epochs=1)))
        arb.register("quiet", p.cap.CaptionController(
            topo, p.cap.CaptionConfig(probe_epochs=1)))
        out = [_decision(arb.observe(n, p.cap.EpochMetrics(throughput=1.0),
                                     slow_bw=bw))
               for n, bw in (("lat", 2e9), ("loud", 50e9), ("quiet", 0.1e9))]
        return out, arb.grants()

    _, g = _both(run)
    assert g["lat"] == pytest.approx(2e9) and g["loud"] > g["quiet"]


def test_clip_at_capacity_floor_identical():
    def run(p):
        topo = p.tiers.tpu_v5e_topology()
        arb = p.arb.CaptionArbiter(topo, p.arb.ArbiterConfig(
            slow_bw_budget=1e9, starvation_floor=0.0))
        ctl = arb.register("opt", p.cap.CaptionController(
            topo, p.cap.CaptionConfig(probe_epochs=1), initial_fraction=0.5,
            min_fraction=0.4))
        arb.register("other", p.cap.CaptionController(
            topo, p.cap.CaptionConfig(probe_epochs=1)))
        arb.observe("other", p.cap.EpochMetrics(throughput=1.0), slow_bw=0.9e9)
        out = [_decision(arb.observe("opt", p.cap.EpochMetrics(throughput=1.0),
                                     slow_bw=20e9)) for _ in range(8)]
        return out, ctl.fraction

    _, fraction = _both(run)
    assert 0.4 - 1e-9 <= fraction < 0.5


def test_source_billing_from_window_identical():
    def run(p):
        topo = p.tiers.tpu_v5e_topology()
        tel = p.tel.Telemetry()
        arb = p.arb.CaptionArbiter(topo, p.arb.ArbiterConfig(slow_bw_budget=10e9))
        wins = {}
        for name in ("a", "b", "quiet"):
            arb.register(name, p.cap.CaptionController(
                topo, p.cap.CaptionConfig(probe_epochs=1)))
            wins[name] = p.tel.EpochWindow(tel)
        tel.record_move("engine", "host", 3_000, 0.0, source="a")
        tel.record_move("engine", "host", 1_000, 0.0, source="b")
        out = [_decision(arb.observe_window(n, wins[n], throughput=1.0,
                                            slow_name="host", seconds=1.0))
               for n in ("a", "b", "quiet")]
        return out, arb.demands()

    _, d = _both(run)
    assert d == pytest.approx({"a": 3_000.0, "b": 1_000.0, "quiet": 0.0})


def test_legacy_fallback_identical():
    def run(p):
        topo = p.tiers.tpu_v5e_topology()
        tel = p.tel.Telemetry()
        arb = p.arb.CaptionArbiter(topo, p.arb.ArbiterConfig(slow_bw_budget=10e9))
        arb.register("legacy", p.cap.CaptionController(
            topo, p.cap.CaptionConfig(probe_epochs=1)))
        win = p.tel.EpochWindow(tel)
        tel.record_move("engine", "host", 500, 0.0, source="other")
        win.tick(seconds=1.0)
        tel.record_move("engine", "host", 2_000, 0.0)
        d = arb.observe_window("legacy", win, throughput=1.0, slow_name="host",
                               seconds=1.0)
        return _decision(d), arb.demands()

    assert _both(run)[1]["legacy"] == pytest.approx(2_000.0)


def test_elastic_budgets_identical():
    """Three-device budgets through a remove/add, then a walk."""
    def run(p):
        topo = p.tiers.paper_three_device_topology()
        arb = p.arb.CaptionArbiter(topo, p.arb.budgeted_config(topo, 0.0))
        ctls = {f"buf{i}": arb.register(f"buf{i}", p.cap.CaptionController(
            topo, p.cap.CaptionConfig(probe_epochs=1, step=0.1)))
            for i in range(2)}
        before = dict(arb.cfg.device_budgets)
        arb.remove_device("cxl-c")
        mid = (arb.topology.slow_names, dict(arb.cfg.device_budgets))
        arb.add_device("cxl-c")
        after = dict(arb.cfg.device_budgets)
        out = []
        for _ in range(6):
            for name, ctl in ctls.items():
                out.append(_decision(arb.observe(
                    name, _greedy(p, ctl), slow_bw=ctl.fraction * 20e9)))
        return before, mid, after, out, arb.grants()

    _both(run)


def test_register_rejects_duplicates_and_is_exported():
    assert t_core.CaptionArbiter is t_arbiter.CaptionArbiter
    topo = t_tiers.tpu_v5e_topology()
    arb = t_arbiter.CaptionArbiter(topo)
    arb.register("kv", t_caption.CaptionController(topo))
    with pytest.raises(ValueError, match="registered"):
        arb.register("kv", t_caption.CaptionController(topo))
