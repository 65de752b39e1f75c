"""Differential tests for the port's hotness layer: the same numpy inputs
through ``repro.core.hotness`` and ``repro_torch.core.hotness`` give the
same bits — ledger scores, ranks, splits and drift; page maps from
``semantic_assignment``; a ``SemanticTensor``'s maps, ``to_array``, bag
sums, re-tier summaries, descriptor counts and telemetry; and the
``HotSetCoordinator``'s walk, re-open and landing."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from benchmarks.fig8_dlrm import throughput_nd as r_throughput_nd  # noqa: E402
from repro.core import caption as r_cap  # noqa: E402
from repro.core import hotness as r_hot  # noqa: E402
from repro.core import mover as r_mover  # noqa: E402
from repro.core import telemetry as r_tel  # noqa: E402
from repro.core import tiers as r_tiers  # noqa: E402
from repro_torch.benchmarks.fig8_dlrm import throughput_nd as t_throughput_nd  # noqa: E402
from repro_torch.core import caption as t_cap  # noqa: E402
from repro_torch.core import hotness as t_hot  # noqa: E402
from repro_torch.core import mover as t_mover  # noqa: E402
from repro_torch.core import telemetry as t_tel  # noqa: E402
from repro_torch.core import tiers as t_tiers  # noqa: E402

R_TOPO = r_tiers.paper_three_device_topology()
T_TOPO = t_tiers.paper_three_device_topology()
NAMES = (R_TOPO.fast.name,) + tuple(t.name for t in R_TOPO.slows)
W3 = (0.25, 0.25, 0.25)


def _zipf(n, rng, alpha=1.1, scale=1e4):
    s = np.zeros(n)
    s[rng.permutation(n)] = 1.0 / (1.0 + np.arange(n)) ** alpha
    return s * scale


def _same_ledger(a, b):
    assert np.array_equal(a.scores(), b.scores())
    assert np.array_equal(a.rank(), b.rank())
    assert a.epochs == b.epochs and a.total_observed == b.total_observed
    assert a.drift() == b.drift()


# -- HotnessLedger -----------------------------------------------------------
def test_ledger_ewma_topk_and_drift_match_reference():
    """A random sequence of records, ticks, marks and splits."""
    rng = np.random.default_rng(0)
    n = 40
    led_r, led_t = r_hot.HotnessLedger(n, decay=0.7), \
        t_hot.HotnessLedger(n, decay=0.7)
    for step in range(30):
        op = step % 5
        if op == 0:
            c = _zipf(n, rng, scale=rng.uniform(1, 1e3))
            led_r.record(c)
            led_t.record(torch.from_numpy(c))
        elif op == 1:
            k = rng.integers(0, n, size=50)
            w = rng.uniform(0, 3, size=50)
            led_r.record_keys(k, weights=w)
            led_t.record_keys(k, weights=w)
        elif op == 2:
            rows = rng.integers(0, n * 8, size=64)
            led_r.record_rows(rows, 8)
            led_t.record_rows(torch.from_numpy(rows), 8)
        elif op == 3:
            assert led_r.tick() == led_t.tick()
        else:
            led_r.mark(step % 7 + 1)
            led_t.mark(step % 7 + 1)
        _same_ledger(led_r, led_t)
        for k in (0, 5, 17, 99):
            hr, cr = led_r.topk_split(k)
            ht, ct = led_t.topk_split(k)
            assert np.array_equal(hr, ht) and np.array_equal(cr, ct)
            assert led_r.traffic_share(hr) == led_t.traffic_share(ht)


def test_ledger_validation():
    led = t_hot.HotnessLedger(4, decay=0.5)
    with pytest.raises(ValueError):
        led.record_keys([4])
    with pytest.raises(ValueError):
        led.record([1, 2])
    with pytest.raises(ValueError):
        t_hot.HotnessLedger(0)
    with pytest.raises(ValueError):
        t_hot.HotnessLedger(4, decay=1.0)


# -- semantic_assignment -----------------------------------------------------
@pytest.mark.parametrize("n_keys,ppk,n_hot,weights", [
    (8, 4, 2, (0.5, 0.5)), (64, 4, 16, (0.2, 0.5, 0.3)),
    (33, 2, 0, (1.0,)), (20, 1, 20, (0.3, 0.3)), (50, 3, 7, (0.0, 0.0)),
    (17, 2, 5, (0.0, 1.0, 2.0))])
def test_semantic_assignment_matches_reference(n_keys, ppk, n_hot, weights):
    rng = np.random.default_rng(n_keys)
    order = rng.permutation(n_keys)
    hot, cold = order[:n_hot], order[n_hot:]
    want = r_hot.semantic_assignment(n_keys, ppk, hot, cold, weights)
    got = t_hot.semantic_assignment(n_keys, ppk, hot, cold, weights)
    assert got.dtype == want.dtype and np.array_equal(got, want)


# -- SemanticTensor ----------------------------------------------------------
def _pair(n_keys=64, rpk=8, page_rows=2, dim=4, seed=0, placement="blind",
          weights=W3, integer=False):
    rng = np.random.default_rng(seed)
    arr = (rng.integers(-8, 9, size=(n_keys * rpk, dim)) if integer
           else rng.normal(size=(n_keys * rpk, dim))).astype(np.float32)
    skew = _zipf(n_keys, rng)
    out = []
    for mod, table in ((r_hot, jnp.asarray(arr)),
                       (t_hot, torch.from_numpy(arr))):
        led = mod.HotnessLedger(n_keys, decay=0.5)
        led.record(skew)
        kw = {} if mod is r_hot else {"device": "cpu"}
        out.append(mod.SemanticTensor.from_array(
            table, rows_per_key=rpk, weights=weights, device_names=NAMES,
            page_rows=page_rows, ledger=led,
            headroom=n_keys * rpk // page_rows, placement=placement, **kw))
    return out[0], out[1], arr


def _same_tensor(sr, st):
    assert np.array_equal(np.asarray(sr.it.page_device),
                          st.it.page_device.numpy())
    assert np.array_equal(np.asarray(sr.it.page_local),
                          st.it.page_local.numpy())
    assert np.array_equal(np.asarray(sr.to_array()), st.to_array().numpy())
    assert np.array_equal(sr.key_device(), st.key_device())
    assert sr.hot_keys() == st.hot_keys()
    assert sr.hot_traffic_share() == st.hot_traffic_share()
    assert sr.it.device_names == st.it.device_names
    assert sr.last_retier == st.last_retier
    _same_ledger(sr.ledger, st.ledger)


@pytest.mark.parametrize("placement", ["blind", "semantic"])
@pytest.mark.parametrize("weights", [W3, (0.5, 0.2, 0.1), (0.1, 0.0, 0.6)])
def test_semantic_tensor_round_trip_and_retier_match(placement, weights):
    sr, st, arr = _pair(placement=placement, weights=weights)
    _same_tensor(sr, st)
    assert np.array_equal(st.to_array().numpy(), arr)
    assert st.placement_report() == sr.placement_report()
    for w in (W3, (0.6, 0.1, 0.05), weights):
        sr = sr.retier(w, telemetry=r_tel.Telemetry())
        st = st.retier(w, telemetry=t_tel.Telemetry())
        _same_tensor(sr, st)
        assert np.array_equal(st.to_array().numpy(), arr)
        assert np.array_equal(st.plan_assignment(w), sr.plan_assignment(w))


def test_blind_to_semantic_raises_the_hot_share():
    _, st, arr = _pair()
    st2 = st.retier(W3, telemetry=t_tel.Telemetry())
    assert st2.last_retier["moved_pages"] > 0
    assert st2.hot_traffic_share() > st.hot_traffic_share()
    assert np.array_equal(st2.to_array().numpy(), arr)


def test_noop_retier_returns_self():
    sr, st, _ = _pair(placement="semantic")
    assert sr.retier(W3, telemetry=r_tel.Telemetry()) is sr
    assert st.retier(W3, telemetry=t_tel.Telemetry()) is st


def test_retier_descriptors_below_moved_keys_below_moved_pages():
    sr, st, arr = _pair(placement="semantic")
    rng = np.random.default_rng(9)
    for _ in range(8):
        s = _zipf(st.n_keys, rng)
        for t in (sr, st):
            t.ledger.record(s)
            t.ledger.tick()
    descs = []
    for mod, mv, t in ((r_hot, r_mover.BulkMover(R_TOPO), sr),
                       (t_hot, t_mover.BulkMover(T_TOPO, device="cpu"), st)):
        tel = (r_tel if mod is r_hot else t_tel).Telemetry()
        try:
            d0 = mv.descriptors_submitted
            out = t.retier(W3, mover=mv, telemetry=tel)
            descs.append(mv.descriptors_submitted - d0)
        finally:
            mv.close()
        if mod is r_hot:
            sr2 = out
        else:
            st2 = out
    _same_tensor(sr2, st2)
    r = st2.last_retier
    assert descs[0] == descs[1] <= r["moved_keys"] < r["moved_pages"]
    assert np.array_equal(st2.to_array().numpy(), arr)


def test_access_feeds_the_ledger_and_telemetry_matches():
    sr, st, _ = _pair(integer=True)
    rng = np.random.default_rng(3)
    idx = rng.integers(0, st.logical_rows, size=(6, 10))
    w = rng.integers(0, 3, size=(6, 10)).astype(np.float32)
    got = st.bag_reduce(torch.from_numpy(idx), torch.from_numpy(w))
    want = sr.bag_reduce(jnp.asarray(idx), jnp.asarray(w))
    assert np.array_equal(got.numpy(), np.asarray(want))
    st.gather_rows(np.arange(20))
    sr.gather_rows(jnp.arange(20))
    st = st.update_rows(np.array([3, 9]), torch.ones(2, 4), donate=True)
    sr = sr.update_rows(jnp.asarray([3, 9]), jnp.ones((2, 4)))
    _same_ledger(sr.ledger, st.ledger)
    tr, tt = r_tel.Telemetry(), t_tel.Telemetry()
    sr = sr.retier(W3, telemetry=tr, source="t")
    st = st.retier(W3, telemetry=tt, source="t")
    _same_tensor(sr, st)
    cr, ct = tr.snapshot()["counters"], tt.snapshot()["counters"]
    for k in ("semantic_promoted_pages", "semantic_demoted_pages",
              "semantic_promoted_pages|t", "semantic_demoted_pages|t"):
        assert ct[k] == cr[k], k
    assert ct["semantic_promoted_pages"] > 0
    # the sums of either placement are the same bits
    got2 = st.bag_reduce(torch.from_numpy(idx), torch.from_numpy(w))
    assert np.array_equal(got2.numpy(), got.numpy())


def test_padding_and_validation():
    arr = np.arange(30, dtype=np.float32).reshape(10, 3)
    sr = r_hot.SemanticTensor.from_array(jnp.asarray(arr), rows_per_key=4,
                                         weights=(0.5,),
                                         device_names=("fast", "slow"))
    st = t_hot.SemanticTensor.from_array(arr, rows_per_key=4,
                                         weights=(0.5,),
                                         device_names=("fast", "slow"),
                                         device="cpu")
    assert st.n_keys == sr.n_keys == 3  # 10 rows pad to 12
    assert np.array_equal(st.to_array().numpy(), arr)
    assert np.array_equal(st.key_device(), sr.key_device())
    with pytest.raises(ValueError):
        t_hot.SemanticTensor.from_array(arr, rows_per_key=4, page_rows=3,
                                        weights=(0.5,), device="cpu")
    with pytest.raises(ValueError):
        t_hot.SemanticTensor.from_array(arr, rows_per_key=4, weights=(0.5,),
                                        placement="nope", device="cpu")
    with pytest.raises(ValueError, match="ledger"):
        t_hot.SemanticTensor.from_array(
            arr, rows_per_key=4, weights=(0.5,), device="cpu",
            ledger=t_hot.HotnessLedger(5))


def test_shard_storage_is_kept_across_a_flip():
    """A hotness flip under headroom keeps every shard's storage: one
    binding for a consumer across it (the port's "zero retraces")."""
    _, st, arr = _pair(placement="semantic")
    ptrs = [p.data_ptr() for p in st.it.parts]
    rng = np.random.default_rng(11)
    for _ in range(8):
        st.ledger.record(_zipf(st.n_keys, rng))
        st.ledger.tick()
    st = st.retier(W3, telemetry=t_tel.Telemetry(), donate=True)
    assert st.last_retier["moved_pages"] > 0
    assert [p.data_ptr() for p in st.it.parts] == ptrs
    assert np.array_equal(st.to_array().numpy(), arr)


# -- HotSetCoordinator -------------------------------------------------------
def _walk(mod, coord, skew, epochs, topo, throughput_nd, trail):
    for _ in range(epochs):
        coord.st.ledger.record(skew)
        dev, sc = coord.st.key_device(), coord.st.ledger.scores()
        total = max(float(sc.sum()), 1e-12)
        shares = tuple(float(sc[dev == i + 1].sum()) / total
                       for i in range(len(topo.slows)))
        d = coord.epoch(mod.EpochMetrics(
            throughput=throughput_nd(topo.fast, topo.slows, shares, 32)))
        trail.append((tuple(d.weights), coord.reopens, coord.drift()))


def test_coordinator_walk_reopens_on_drift_like_the_reference():
    rng = np.random.default_rng(5)
    n_keys, rpk = 64, 8
    arr = rng.normal(size=(n_keys * rpk, 4)).astype(np.float32)
    skew = _zipf(n_keys, rng, scale=1e6)
    flipped = _zipf(n_keys, rng, scale=1e6)
    coords, trails = [], []
    for cap, hot, topo, tnd, table, kw in (
            (r_cap, r_hot, R_TOPO, r_throughput_nd, jnp.asarray(arr), {}),
            (t_cap, t_hot, T_TOPO, t_throughput_nd, torch.from_numpy(arr),
             {"device": "cpu"})):
        led = hot.HotnessLedger(n_keys, decay=0.5)
        led.record(skew)
        cfg = cap.CaptionConfig(epoch_steps=1, probe_epochs=1, step=0.1,
                                min_step=0.02, hysteresis=0.005,
                                drift_threshold=0.0, write_damp=False)
        ctl = cap.CaptionController(topo, cfg, initial_fraction=0.9,
                                    min_fraction=0.75)
        st = hot.SemanticTensor.from_array(
            table, rows_per_key=rpk, weights=ctl.weights,
            device_names=NAMES, page_rows=2, ledger=led,
            headroom=n_keys * rpk // 2, placement="semantic", **kw)
        coord = hot.HotSetCoordinator(st, ctl, drift_threshold=0.5)
        trail = []
        _walk(cap, coord, skew, 20, topo, tnd, trail)
        assert ctl.converged and coord.reopens == 0
        _walk(cap, coord, flipped, 20, topo, tnd, trail)
        coords.append(coord)
        trails.append(trail)
    assert trails[0] == trails[1]
    cr, ct = coords
    assert ct.reopens == cr.reopens >= 1
    assert ct.controller.converged
    assert ct.st.hot_traffic_share() == cr.st.hot_traffic_share() > 0.5
    _same_tensor(cr.st, ct.st)
    assert np.array_equal(ct.st.to_array().numpy(), arr)
