"""Differential tests: the port's framework-free modules (tiers, perfmodel,
policy, classifier, planner, ledger) give exactly the reference's answers."""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import classifier as r_classifier  # noqa: E402
from repro.core import perfmodel as r_perfmodel  # noqa: E402
from repro.core import planner as r_planner  # noqa: E402
from repro.core import policy as r_policy  # noqa: E402
from repro.core import tiers as r_tiers  # noqa: E402
from repro.core.ledger import TierLedger as RLedger  # noqa: E402
from repro_torch.core import classifier as t_classifier  # noqa: E402
from repro_torch.core import perfmodel as t_perfmodel  # noqa: E402
from repro_torch.core import planner as t_planner  # noqa: E402
from repro_torch.core import policy as t_policy  # noqa: E402
from repro_torch.core import tiers as t_tiers  # noqa: E402
from repro_torch.core.ledger import CapacityError, TierLedger as TLedger  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PRESETS = ("tpu-v5e", "paper", "paper3")


def _spec(t):
    return dataclasses.asdict(t)


def _topo(t):
    return ([_spec(x) for x in t.devices], [_spec(x) for x in t.extra])


# -- presets ---------------------------------------------------------------------
def test_every_reference_preset_is_unchanged():
    for name, spec in r_tiers.DEVICE_REGISTRY.items():
        assert _spec(t_tiers.DEVICE_REGISTRY[name]) == _spec(spec), name
    for name in PRESETS:
        assert _topo(t_tiers.topology_from_spec(name)) == _topo(
            r_tiers.topology_from_spec(name)), name
    spec = "ddr5-l8+cxl-a+cxl-b"
    assert _topo(t_tiers.topology_from_spec(spec)) == _topo(
        r_tiers.topology_from_spec(spec))


#: every field phase 10 calibrates, as ``core/tiers.py`` commits it: one
#: ``memo.fit_tier`` over three machines' runs (chip_smoke.py phase 10)
H100_CALIBRATED = {
    "h100-hbm": dict(
        load_bw=3.10658e12, store_bw=2.7634e12, nt_store_bw=1.38884e12,
        load_latency_ns=1008.57, chase_latency_ns=331.793,
        load_peak_streams=132, store_peak_streams=132,
        load_collapse_streams=1 << 20, store_collapse_streams=1 << 20,
        collapse_factor=1.0, capacity_bytes=85_017_493_504),
    "h100-host-pinned": dict(
        load_bw=3.12764e10, store_bw=5.26243e10, nt_store_bw=3.34241e10,
        load_latency_ns=3552.88, chase_latency_ns=1245.46,
        load_peak_streams=2, store_peak_streams=2,
        load_collapse_streams=1 << 20, store_collapse_streams=1 << 20,
        collapse_factor=1.0, capacity_bytes=108_447_924_224),
}


def test_h100_preset_is_its_own():
    topo = t_tiers.topology_from_spec("h100")
    assert topo.fast.name == "h100-hbm" and topo.slow.name == "h100-host-pinned"
    # calibrated by MEMO on the card, not the data sheet's 3.35 TB/s and 80 GB
    assert topo.fast.load_bw < 3.35e12
    for tier in (topo.fast, topo.slow):
        got = {k: getattr(tier, k) for k in H100_CALIBRATED[tier.name]}
        assert got == H100_CALIBRATED[tier.name], tier.name
    assert topo.slow.link_bw == 64e9
    # no field is carried over from the TPU v5e tiers.  A stream count is
    # a point of MEMO's lane grid, where a measured count may equal
    # HOST_V5E's (the pinned stores' 2): only the counts pinned above to
    # their calibrated values are exempt.
    for ours, theirs in ((topo.fast, r_tiers.HBM_V5E),
                         (topo.slow, r_tiers.HOST_V5E)):
        a, b = _spec(ours), _spec(theirs)
        pinned = {k for k in H100_CALIBRATED[ours.name]
                  if k.endswith("_streams")}
        same = [k for k in a if k not in ("name", "kind", *pinned)
                and a[k] == b[k] and a[k] not in (None, 1.0)]
        assert not same, same
    assert "h100-hbm" in t_tiers.DEVICE_REGISTRY
    assert "h100-hbm" not in r_tiers.DEVICE_REGISTRY


# -- perfmodel -------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(r_tiers.DEVICE_REGISTRY))
def test_perfmodel_curves_equal_on_a_grid(name):
    r, t = r_tiers.DEVICE_REGISTRY[name], t_tiers.DEVICE_REGISTRY[name]
    for rop, top in zip(r_tiers.OpClass, t_tiers.OpClass):
        assert rop.value == top.value
        for n in (1, 2, 3, 4, 8, 12, 16, 24, 32, 64):
            assert (t_perfmodel.stream_bandwidth(t, top, n)
                    == r_perfmodel.stream_bandwidth(r, rop, n))
            for block in (64, 256, 2048, 16384, 1 << 20):
                assert (t_perfmodel.random_block_bandwidth(t, top, block, n)
                        == r_perfmodel.random_block_bandwidth(r, rop, block, n))
        assert (t_perfmodel.store_traffic_bytes(t, 4096, top)
                == r_perfmodel.store_traffic_bytes(r, 4096, rop))
    topo_r, topo_t = r_tiers.paper_topology(), t_tiers.paper_topology()
    for nbytes in (4096, 1 << 20, 1 << 30):
        for n_desc, batch, asyn in ((1, 1, False), (64, 16, True),
                                    (128, 128, False)):
            kw = dict(n_descriptors=n_desc, batch_size=batch,
                      asynchronous=asyn)
            a = t_perfmodel.bulk_move_cost(topo_t.fast, t, nbytes, **kw)
            b = r_perfmodel.bulk_move_cost(topo_r.fast, r, nbytes, **kw)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            a = t_perfmodel.pipelined_move_cost(t, topo_t.fast, nbytes, **kw)
            b = r_perfmodel.pipelined_move_cost(r, topo_r.fast, nbytes, **kw)
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert t_perfmodel.chase_seconds(t, 7) == r_perfmodel.chase_seconds(r, 7)


# -- policy ----------------------------------------------------------------------
def _policies(mod):
    P = mod.MemPolicy
    return [
        P.membind("fast"), P.membind("slow"), P.preferred("hbm", "host"),
        P.interleave(("fast", "slow")), P.weighted(("dram", "cxl"), (30, 1)),
        P.weighted(("fast", "a", "b"), (5, 2, 1)),
        P.from_slow_fraction("fast", "slow", 0.3),
        P.from_slow_fraction("fast", "slow", 0.07, round_up=True),
        P.from_tier_fractions("fast", ("a", "b", "c"), (0.1, 0.25, 0.05)),
    ]


@pytest.mark.parametrize("i", range(9))
def test_policy_page_maps_equal(i):
    r, t = _policies(r_policy)[i], _policies(t_policy)[i]
    assert (t.kind.value, t.tiers, t.weights) == (r.kind.value, r.tiers,
                                                  r.weights)
    for n in (1, 7, 64, 129, 1000):
        assert np.array_equal(t.assign_pages(n), r.assign_pages(n))
        assert np.array_equal(t.page_is_slow(n), r.page_is_slow(n))
    assert t.slow_fraction(t.tiers[0]) == r.slow_fraction(r.tiers[0])


def test_largest_remainder_split_equal():
    rng = np.random.default_rng(0)
    for _ in range(50):
        q = list(rng.uniform(0, 20, size=int(rng.integers(1, 6))))
        units = int(rng.integers(0, 80))
        caps = [int(c) for c in rng.integers(0, 30, size=len(q))]
        assert (t_policy.largest_remainder_split(q, units)
                == r_policy.largest_remainder_split(q, units))
        assert (t_policy.largest_remainder_split(q, units, caps)
                == r_policy.largest_remainder_split(q, units, caps))


# -- classifier ------------------------------------------------------------------
def test_classifier_equal():
    rng = np.random.default_rng(1)
    for _ in range(40):
        args = (float(rng.uniform(1e3, 1e10)), float(rng.uniform(0, 1e9)),
                int(rng.integers(1, 64)), int(rng.integers(1, 2048)),
                int(rng.choice([64, 256, 4096, 2 << 20])),
                float(rng.uniform(0, 0.05)),
                None if rng.uniform() < 0.5 else float(rng.uniform(1e-6, 1e-2)))
        rp, tp = r_classifier.AccessProfile(*args), t_classifier.AccessProfile(*args)
        for name in r_tiers.DEVICE_REGISTRY:
            assert (t_classifier.classify(tp, t_tiers.DEVICE_REGISTRY[name]).value
                    == r_classifier.classify(rp, r_tiers.DEVICE_REGISTRY[name]).value)
        for name in PRESETS:
            assert (t_classifier.classify_pool(
                tp, t_tiers.topology_from_spec(name)).value
                    == r_classifier.classify_pool(
                        rp, r_tiers.topology_from_spec(name)).value)


# -- planner + ledger ------------------------------------------------------------
def _plan(mod_planner, mod_policy, mod_classifier, topo, seed):
    rng = np.random.default_rng(seed)
    classes = list(mod_policy.BufferClass)
    reqs = []
    for i in range(int(rng.integers(1, 6))):
        prof = mod_classifier.AccessProfile(
            float(rng.uniform(1e8, 1e11)), float(rng.uniform(0, 1e10)),
            int(rng.choice([1, 64])), int(rng.choice([1, 1024])), 2 << 20,
            0.05)
        reqs.append(mod_planner.BufferReq(
            f"b{i}", classes[int(rng.integers(0, len(classes)))],
            int(rng.uniform(0.1, 12) * 2**30), prof))
    try:
        return mod_planner.plan(reqs, topo, compute_seconds=0.05)
    except MemoryError as e:
        return str(e)


@pytest.mark.parametrize("preset", PRESETS)
def test_planner_decisions_equal(preset):
    for seed in range(8):
        r = _plan(r_planner, r_policy, r_classifier,
                  r_tiers.topology_from_spec(preset), seed)
        t = _plan(t_planner, t_policy, t_classifier,
                  t_tiers.topology_from_spec(preset), seed)
        if isinstance(r, str):
            assert t == r
            continue
        assert list(t.decisions) == list(r.decisions)
        for name, rd in r.decisions.items():
            td = t.decisions[name]
            assert (td.slow_fraction, td.min_slow_fraction, td.reason,
                    td.boundedness.value, td.device_fractions,
                    td.policy.tiers, td.policy.weights) == (
                rd.slow_fraction, rd.min_slow_fraction, rd.reason,
                rd.boundedness.value, rd.device_fractions,
                rd.policy.tiers, rd.policy.weights)
        assert (t.est_fast_seconds, t.est_slow_seconds, t.est_step_seconds,
                t.notes) == (r.est_fast_seconds, r.est_slow_seconds,
                             r.est_step_seconds, r.notes)
        for tier in r_tiers.topology_from_spec(preset).tiers:
            assert t.ledger.used(tier.name) == r.ledger.used(tier.name)


def test_ledger_equal():
    r, t = (RLedger(r_tiers.tpu_v5e_topology()),
            TLedger(t_tiers.tpu_v5e_topology()))
    for led in (r, t):
        led.register("a", "hbm", 10 << 30)
        led.register("b", "host", 3 << 30)
    assert (t.used("hbm"), t.free("hbm"), t.used("host")) == (
        r.used("hbm"), r.free("hbm"), r.used("host"))
    with pytest.raises(CapacityError):
        t.register("c", "hbm", 10 << 30)
    t.release("a")
    r.release("a")
    assert t.free("hbm") == r.free("hbm")


# -- the package boundary --------------------------------------------------------
def test_import_loads_neither_jax_nor_the_reference():
    code = (
        "import json, sys\n"
        "import repro_torch, repro_torch.core, repro_torch.convert\n"
        "import repro_torch.kernels.embedding_reduce.ops\n"
        "import repro_torch.kernels.stream_copy.ops\n"
        "import repro_torch.kernels.decode_attention.ops\n"
        "import repro_torch.kernels.wkv6.ops, repro_torch.models.rwkv\n"
        "import repro_torch.serving.engine, repro_torch.launch.serve\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.steps\n"
        "import repro_torch.launch.hlo_analysis, repro_torch.launch.mesh\n"
        "import repro_torch.benchmarks.roofline, repro_torch.models.moe\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, check=True, timeout=120)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    # and no source of the port names either
    for path in list((ROOT / "src" / "repro_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "from repro." not in text and "import repro." not in text, path
