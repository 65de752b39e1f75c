"""Differential tests for the port's InterleavedTensor: the reference's
tiering, hot-path and actuation scenarios replayed against both packages
on the same numpy inputs.  Page maps, capacities, descriptor counts,
telemetry route bytes and full-shard copy counts must be bit-equal,
``to_array`` equal, and on the stable path every shard's ``data_ptr()``
must stay put (the port's counterpart of the reference's single trace)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import donation as r_donation  # noqa: E402
from repro.core import interleave as r_il  # noqa: E402
from repro.core.caption import (CaptionConfig as RConfig,  # noqa: E402
                                CaptionController as RController,
                                EpochMetrics as RMetrics)
from repro.core.mover import BulkMover as RMover  # noqa: E402
from repro.core.policy import MemPolicy as RPolicy  # noqa: E402
from repro.core.telemetry import Telemetry as RTel  # noqa: E402
from repro.core.tiers import (paper_three_device_topology as r_paper3,  # noqa: E402
                              tpu_v5e_topology as r_v5e)
from repro.kernels.embedding_reduce import ops as r_er  # noqa: E402
from repro_torch.core import donation as t_donation  # noqa: E402
from repro_torch.core import interleave as t_il  # noqa: E402
from repro_torch.core.caption import (CaptionConfig as TConfig,  # noqa: E402
                                      CaptionController as TController,
                                      EpochMetrics as TMetrics)
from repro_torch.core.mover import BulkMover as TMover  # noqa: E402
from repro_torch.core.policy import MemPolicy as TPolicy  # noqa: E402
from repro_torch.core.telemetry import Telemetry as TTel  # noqa: E402
from repro_torch.core.tiers import (paper_three_device_topology as t_paper3,  # noqa: E402
                                    tpu_v5e_topology as t_v5e)
from repro_torch.kernels.embedding_reduce import ops as t_er  # noqa: E402

RIT, TIT = r_il.InterleavedTensor, t_il.InterleavedTensor


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _build(x, policy_args, page_rows, headroom=0, kind="weighted"):
    make_r = getattr(RPolicy, kind)
    make_t = getattr(TPolicy, kind)
    r = RIT.from_array(jnp.asarray(x), make_r(*policy_args), page_rows,
                       headroom=headroom)
    t = TIT.from_array(torch.from_numpy(np.array(x)), make_t(*policy_args),
                       page_rows, headroom=headroom, device="cpu")
    return r, t


def _same(r, t, x=None):
    """Bit-equal state: maps, capacities, names, shards, logical array."""
    assert np.array_equal(_np(t.page_device), _np(r.page_device))
    assert np.array_equal(_np(t.page_local), _np(r.page_local))
    assert t.capacity_pages == r.capacity_pages
    assert t.valid_page_counts() == r.valid_page_counts()
    assert t.device_names == r.device_names
    assert t.weights() == r.weights()
    for pr, pt in zip(r.parts, t.parts):
        assert np.array_equal(_np(pt), _np(pr))
    assert np.array_equal(_np(t.to_array()), _np(r.to_array()))
    if x is not None:
        assert np.array_equal(_np(t.to_array()), x)


def _routes(tel):
    return {k: (v.bytes_moved, v.descriptors, v.batches)
            for k, v in tel.routes.items()}


# -- construction, routed access, bag reduction ---------------------------------
@pytest.mark.parametrize("wf,ws,page_rows,seed", [
    (1, 1, 2, 0), (3, 1, 4, 1), (1, 7, 16, 2), (5, 2, 3, 3), (7, 7, 8, 4),
    (2, 5, 11, 5)])
def test_gather_update_roundtrip(wf, ws, page_rows, seed):
    rng = np.random.default_rng(seed)
    rows = int(rng.integers(page_rows, 6 * page_rows))
    x = rng.normal(size=(rows, 4)).astype(np.float32)
    r, t = _build(x, (("fast", "slow"), (wf, ws)), page_rows)
    _same(r, t, x)
    idx = rng.integers(0, rows, size=8)
    assert np.array_equal(_np(t.gather_rows(torch.from_numpy(idx))), x[idx])
    vals = np.full((8, 4), 7.0, np.float32)
    r2 = r.update_rows(jnp.asarray(idx), jnp.asarray(vals))
    t2 = t.update_rows(torch.from_numpy(idx), torch.from_numpy(vals))
    _same(r2, t2)
    assert np.array_equal(_np(t2.gather_rows(idx)), vals)
    _same(r, t, x)  # the parent is untouched without donation


@pytest.mark.parametrize("seed", range(5))
def test_bag_reduce_equals_untiered(seed):
    rng = np.random.default_rng(seed)
    V, D, B, K = 64, 8, 4, 6
    table = rng.normal(size=(V, D)).astype(np.float32)
    idx = rng.integers(0, V, size=(B, K))
    w = rng.uniform(size=(B, K)).astype(np.float32)
    want = np.einsum("bkd,bk->bd", table[idx], w)
    for weights in [(1, 1), (3, 1), (1, 3)]:
        r, t = _build(table, (("fast", "slow"), weights), 4)
        got = t.bag_reduce(torch.from_numpy(idx), torch.from_numpy(w))
        np.testing.assert_allclose(_np(got), want, atol=1e-5)
        np.testing.assert_allclose(
            _np(got), _np(r.bag_reduce(jnp.asarray(idx), jnp.asarray(w))),
            atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bag_reduce_integer_table_bit_exact_with_kernels(dtype):
    """The reference with its Pallas kernel vs the port with its kernel
    wrapper (the plain version on the CPU): integer tables give the same
    bits, zero weights and duplicate lookups included."""
    rng = np.random.default_rng(11)
    V, D, B, K = 256, 64, 8, 80
    table = rng.integers(-8, 9, size=(V, D)).astype(np.float32)
    idx = rng.integers(0, V, size=(B, K))
    idx[:, 1] = idx[:, 0]
    w = rng.integers(0, 3, size=(B, K)).astype(np.float32)
    r, t = _build(table, (("fast", "slow"), (3, 1)), 8, headroom=4)
    if dtype == "bfloat16":
        r = RIT.from_array(jnp.asarray(table, jnp.bfloat16),
                           RPolicy.weighted(("fast", "slow"), (3, 1)), 8,
                           headroom=4)
        t = TIT.from_array(torch.from_numpy(table).to(torch.bfloat16),
                           TPolicy.weighted(("fast", "slow"), (3, 1)), 8,
                           headroom=4, device="cpu")
    ref = r.bag_reduce(jnp.asarray(idx), jnp.asarray(w),
                       reduce_fn=r_er.embedding_reduce)
    got = t.bag_reduce(torch.from_numpy(idx), torch.from_numpy(w))
    assert np.array_equal(_np(got.float()),
                          np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [True, False])
def test_bag_reduce_is_one_routed_call_equal_to_the_per_shard_path(
        monkeypatch, dtype, weighted):
    """``bag_reduce`` makes one routed call, whose result equals the
    per-shard path (the port's and the reference's with its Pallas
    kernel) over the three-device drain map, bit for bit on an integer
    table, negative and out-of-range rows included."""
    rng = np.random.default_rng(13)
    x = rng.integers(-8, 9, size=(64 * 4, 4)).astype(np.float32)
    names = ("fast", "cxl-a", "cxl-b")
    r, t = _build(x, (names, (4, 2, 2)), 4, headroom=16)
    if dtype == "bfloat16":
        r = RIT.from_array(jnp.asarray(x, jnp.bfloat16),
                           RPolicy.weighted(names, (4, 2, 2)), 4, headroom=16)
        t = TIT.from_array(torch.from_numpy(x).to(torch.bfloat16),
                           TPolicy.weighted(names, (4, 2, 2)), 4, headroom=16,
                           device="cpu")
    r = r.drain_device("cxl-a", telemetry=RTel())
    t = t.drain_device("cxl-a", telemetry=TTel())
    idx = rng.integers(-9, 64 * 4 + 9, size=(5, 16))
    w = rng.integers(0, 3, size=idx.shape).astype(np.float32)
    w_t = torch.from_numpy(w) if weighted else None
    calls = []
    routed = t_er.bag_reduce_routed
    monkeypatch.setattr(t_er, "bag_reduce_routed",
                        lambda *a: calls.append(a) or routed(*a))
    got = t.bag_reduce(torch.from_numpy(idx), w_t)
    assert len(calls) == 1
    per_shard = t.bag_reduce(torch.from_numpy(idx), w_t,
                             reduce_fn=t_er.embedding_reduce)
    assert len(calls) == 1
    ref = r.bag_reduce(jnp.asarray(idx), jnp.asarray(w) if weighted else None,
                       reduce_fn=r_er.embedding_reduce)
    assert torch.equal(got, per_shard)
    assert np.array_equal(_np(got.float()),
                          np.asarray(ref.astype(jnp.float32)))


def test_migrate_pages():
    x = np.arange(80.0, dtype=np.float32).reshape(20, 4)
    r, t = _build(x, ("fast",), 4, kind="membind")
    r2 = r.migrate_pages(np.array([1, 3]), to_slow=True)
    t2 = t.migrate_pages(np.array([1, 3]), to_slow=True)
    _same(r2, t2, x)
    assert 0.3 < t2.slow_fraction() < 0.5


@pytest.mark.parametrize("seed,headroom", [(0, 0), (1, 3), (2, 20), (3, 7),
                                           (4, 0), (5, 12)])
def test_gather_bucketed_equals_masked(seed, headroom):
    rng = np.random.default_rng(seed)
    rows = int(rng.integers(8, 120))
    x = rng.normal(size=(rows, 4)).astype(np.float32)
    w = (int(rng.integers(1, 6)), int(rng.integers(1, 6)))
    r, t = _build(x, (("fast", "slow"), w), 8, headroom=headroom)
    if headroom:  # the free-slot (non-rank) local layout too
        f = float(rng.uniform(0, 1))
        r = r.repartition_fraction(f, telemetry=RTel())
        t = t.repartition_fraction(f, telemetry=TTel())
        _same(r, t, x)
    idx = rng.integers(0, rows, size=(2, 7))
    got = t._gather_rows_bucketed(idx)
    assert torch.equal(got, t._gather_rows_masked(torch.from_numpy(idx)))
    assert np.array_equal(_np(got), _np(r._gather_rows_bucketed(idx)))
    assert np.array_equal(_np(t.gather_rows(idx)), x[idx])
    for n in (1, 64, 4096, 100000):
        assert t.choose_gather_path(n) == r.choose_gather_path(n)


@pytest.mark.parametrize("seed", range(6))
def test_scatter_bucketed_masked_donated_equal(seed):
    rng = np.random.default_rng(seed)
    rows = int(rng.integers(16, 120))
    x = rng.normal(size=(rows, 4)).astype(np.float32)
    r, t = _build(x, (("fast", "slow"), (3, 1)), 8, headroom=4)
    idx_set = rng.permutation(rows)[:8]
    vals = rng.normal(size=(8, 4)).astype(np.float32)
    ref = x.copy()
    ref[idx_set] = vals
    a = t._scatter_bucketed(idx_set, torch.from_numpy(vals), "set")
    b = t._scatter_masked(torch.from_numpy(idx_set), torch.from_numpy(vals),
                          "set")
    assert np.array_equal(_np(a.to_array()), ref)
    assert np.array_equal(_np(b.to_array()), ref)
    _same(r._scatter_bucketed(idx_set, jnp.asarray(vals), "set"), a)
    idx_add = rng.integers(0, rows, size=8)  # duplicates likely
    add_ref = x.copy()
    np.add.at(add_ref, idx_add, vals)
    c = t._scatter_bucketed(idx_add, torch.from_numpy(vals), "add")
    d = t._scatter_masked(torch.from_numpy(idx_add), torch.from_numpy(vals),
                          "add")
    np.testing.assert_allclose(_np(c.to_array()), add_ref, atol=1e-6)
    np.testing.assert_allclose(_np(d.to_array()), add_ref, atol=1e-6)
    # donated: same values, written into the parent's own storage
    ptrs = [p.data_ptr() for p in t.parts]
    e = t.add_rows(idx_add, torch.from_numpy(vals), donate=True)
    np.testing.assert_allclose(_np(e.to_array()), add_ref, atol=1e-6)
    assert [p.data_ptr() for p in e.parts] == ptrs


def test_scatter_copy_counts_equal():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(256, 4)).astype(np.float32)
    r, t = _build(x, (("fast", "slow"), (3, 1)), 8, headroom=4)
    idx = np.arange(0, 256, 3)
    vals = np.ones((idx.size, 4), np.float32)
    r_donation.FULL_SHARD_COPIES.reset()
    t_donation.FULL_SHARD_COPIES.reset()
    r2 = r.update_rows(idx, jnp.asarray(vals))
    t2 = t.update_rows(idx, torch.from_numpy(vals))
    assert (t_donation.FULL_SHARD_COPIES.reset()
            == r_donation.FULL_SHARD_COPIES.reset() == 2)
    _same(r2, t2)


# -- vectorized bookkeeping ------------------------------------------------------
@pytest.mark.parametrize("seed", range(8))
def test_bookkeeping_helpers_equal(seed):
    rng = np.random.default_rng(seed)
    n_devices = int(rng.integers(2, 5))
    n = int(rng.integers(8, 200))
    cur = rng.integers(0, n_devices, size=n).astype(np.int8)
    for a, b in zip(t_il.device_page_map(cur, n_devices),
                    r_il.device_page_map(cur, n_devices)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    w = tuple(float(v) for v in rng.dirichlet(np.ones(n_devices))[1:])
    for run_pages in (1, 4, 16):
        a = t_il.minimal_delta_weights(cur, w, n_devices, run_pages=run_pages)
        b = r_il.minimal_delta_weights(cur, w, n_devices, run_pages=run_pages)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b)
            delta = np.nonzero(a != cur)[0]
            for x, y in zip(t_il.route_pure_runs(cur[delta], a[delta], delta),
                            r_il.route_pure_runs(cur[delta], b[delta], delta)):
                assert np.array_equal(x, y)
    f = float(rng.uniform())
    assert np.array_equal(t_il.minimal_delta_assignment(cur, f),
                          r_il.minimal_delta_assignment(cur, f))
    v = np.sort(rng.choice(64, size=12, replace=False))
    assert t_il.contiguous_runs(v) == r_il.contiguous_runs(v)


# -- repartition: coalescing + billed bytes --------------------------------------
def test_one_point_shift_coalesced_descriptors_equal():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4096 * 4, 8)).astype(np.float32)
    r, t = _build(x, ("fast", "slow", 0.3), 4, headroom=512,
                  kind="from_slow_fraction")
    out = {}
    for name, it, Mover, Tel, topo in (
            ("r", r, RMover, RTel, r_paper3()),
            ("t", t, TMover, TTel, t_paper3())):
        tel = Tel()
        kw = {} if name == "r" else {"device": "cpu"}
        with Mover(topo, asynchronous=True, batch_size=16, telemetry=tel,
                   **kw) as mover:
            it2 = it.repartition_fraction(0.31, mover=mover,
                                          fast_tier=topo.fast.name,
                                          slow_tier=topo.slows[0].name)
            out[name] = (it2, mover.descriptors_submitted,
                         mover.bytes_submitted, _routes(tel))
    (r2, rd, rb, rr), (t2, td, tb, tr) = out["r"], out["t"]
    assert (td, tb, tr) == (rd, rb, rr)
    delta = abs(round(0.31 * t.n_pages) - int(t.page_tier.sum()))
    assert tb == delta * 4 * t.row_bytes and td < delta / 2
    _same(r2, t2, x)


def test_telemetry_path_billed_bytes_equal():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(512, 4)).astype(np.float32)
    r, t = _build(x, (("fast", "slow"), (3, 1)), 4)
    rt, tt = RTel(), TTel()
    r2 = r.repartition_fraction(0.5, telemetry=rt)
    t2 = t.repartition_fraction(0.5, telemetry=tt)
    assert _routes(tt) == _routes(rt)
    _same(r2, t2, x)


# -- capacity-padded shards ------------------------------------------------------
def test_headroom_walk_keeps_storage_until_exhausted():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(256, 4)).astype(np.float32)
    r, t = _build(x, (("fast", "slow"), (1, 0)), 8, headroom=8)
    ptrs = [p.data_ptr() for p in t.parts]
    r_donation.FULL_SHARD_COPIES.reset()
    t_donation.FULL_SHARD_COPIES.reset()
    for f in (0.1, 0.25, 0.05, 0.2):  # all fit 8 pages of headroom
        r = r.repartition_fraction(f, telemetry=RTel())
        t = t.repartition_fraction(f, telemetry=TTel(), donate=True)
        _same(r, t, x)
        assert [p.data_ptr() for p in t.parts] == ptrs
    assert t_donation.FULL_SHARD_COPIES.reset() == 0
    r_donation.FULL_SHARD_COPIES.reset()
    r = r.repartition_fraction(0.9, telemetry=RTel())  # grows: rebuild
    t = t.repartition_fraction(0.9, telemetry=TTel())
    _same(r, t, x)
    assert (t_donation.FULL_SHARD_COPIES.reset()
            == r_donation.FULL_SHARD_COPIES.reset() == 2)
    assert t.capacity_pages[1] >= round(0.9 * t.n_pages) + 8


def test_headroom_zero_keeps_exact_legacy_shapes():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(128, 4)).astype(np.float32)
    r, t = _build(x, (("fast", "slow"), (3, 1)), 4)
    r2 = r.repartition_fraction(0.4, telemetry=RTel())
    t2 = t.repartition_fraction(0.4, telemetry=TTel())
    _same(r2, t2, x)
    for i, part in enumerate(t2.parts):
        assert part.shape[0] == int((t2.page_device == i).sum()) * 4


def test_caption_walk_same_maps_and_stable_storage():
    """Twelve Caption probe epochs: both packages' controllers drive the
    same page maps, and the port's shards never move (the reference's
    single-trace bar)."""
    rng = np.random.default_rng(4)
    n_pages = 128
    x = rng.normal(size=(n_pages * 8, 4)).astype(np.float32)
    rc = RController(r_v5e(), RConfig(probe_epochs=1, step=0.05),
                     initial_fraction=0.1)
    tc = TController(t_v5e(), TConfig(probe_epochs=1, step=0.05),
                     initial_fraction=0.1)
    assert tc.headroom_pages(n_pages) == rc.headroom_pages(n_pages)
    r, t = _build(x, ("fast", "slow", 0.1), 8,
                  headroom=tc.headroom_pages(n_pages),
                  kind="from_slow_fraction")
    ptrs = [p.data_ptr() for p in t.parts]
    for _ in range(12):
        rd = rc.observe(RMetrics(throughput=1.0 + rc.fraction))
        td = tc.observe(TMetrics(throughput=1.0 + tc.fraction))
        assert td.weights == rd.weights
        r = r.repartition_weights(rd.weights, telemetry=RTel())
        t = t.repartition_weights(td.weights, telemetry=TTel(), donate=True)
        rc.actuated(r.slow_fraction())
        tc.actuated(t.slow_fraction())
        assert [p.data_ptr() for p in t.parts] == ptrs
        assert np.array_equal(_np(t.page_device), _np(r.page_device))
        assert np.array_equal(_np(t.page_local), _np(r.page_local))
    _same(r, t, x)


# -- donation --------------------------------------------------------------------
def test_donated_repartition_zero_copies_same_storage():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(512, 4)).astype(np.float32)
    r, t = _build(x, (("fast", "slow"), (3, 1)), 8, headroom=8)
    ptrs = [p.data_ptr() for p in t.parts]
    r_donation.FULL_SHARD_COPIES.reset()
    t_donation.FULL_SHARD_COPIES.reset()
    for f in (0.375, 0.25, 0.3125, 0.125, 0.25):
        r = r.repartition_fraction(f, telemetry=RTel(), donate=True)
        t = t.repartition_fraction(f, telemetry=TTel(), donate=True)
        _same(r, t, x)
    assert (t_donation.FULL_SHARD_COPIES.reset()
            == r_donation.FULL_SHARD_COPIES.reset() == 0)
    assert [p.data_ptr() for p in t.parts] == ptrs


def test_donated_vs_copy_on_write_bit_exact():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(512, 4)).astype(np.float32)
    r, t = _build(x, (("fast", "slow"), (3, 1)), 8, headroom=8)
    r_donation.FULL_SHARD_COPIES.reset()
    t_donation.FULL_SHARD_COPIES.reset()
    rc = r.repartition_fraction(0.375, telemetry=RTel())
    tc = t.repartition_fraction(0.375, telemetry=TTel())
    assert (t_donation.FULL_SHARD_COPIES.reset()
            == r_donation.FULL_SHARD_COPIES.reset())
    _same(rc, tc, x)
    _same(r, t, x)  # copy-on-write left the parent intact
    td = t.repartition_fraction(0.375, telemetry=TTel(), donate=True)
    assert t_donation.FULL_SHARD_COPIES.reset() == 0
    for a, b in zip(tc.parts, td.parts):
        assert torch.equal(a, b)
    # the donated child writes the parent's storage in place
    assert [p.data_ptr() for p in td.parts] == [p.data_ptr() for p in t.parts]


def test_three_device_drain_and_reassign_equal():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64 * 4, 4)).astype(np.float32)
    names = ("fast", "cxl-a", "cxl-b")
    r, t = _build(x, (names, (4, 2, 2)), 4, headroom=16)
    r2, t2 = r.drain_device("cxl-a", telemetry=RTel()), t.drain_device(
        "cxl-a", telemetry=TTel())
    _same(r2, t2, x)
    assert t2.weights()[0] == 0.0
    new = rng.integers(0, 3, size=t.n_pages).astype(np.int8)
    rt, tt = RTel(), TTel()
    _same(r.reassign_pages(new, telemetry=rt),
          t.reassign_pages(new, telemetry=tt), x)
    assert _routes(tt) == _routes(rt)
    assert t.reassign_pages(t._host_map()[0]) is t


# -- devices and backends --------------------------------------------------------
def test_backend_follows_device():
    from repro_torch.device import resolve_backend, resolve_device
    cpu = resolve_device("cpu")
    assert resolve_backend(None, cpu) == "modeled"
    assert resolve_backend("modeled", cpu) == "modeled"
    with pytest.raises(RuntimeError):
        resolve_backend("pinned", cpu)  # no quiet fallback to modeled
    with pytest.raises(ValueError):
        resolve_backend("nope", cpu)


def test_from_array_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    x = torch.zeros((16, 4))
    with pytest.raises(RuntimeError, match="CUDA"):
        TIT.from_array(x, TPolicy.membind("fast"), 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        TIT.from_array(x, TPolicy.membind("fast"), 4, device="cpu",
                       backend="pinned")
    with pytest.raises(RuntimeError, match="CUDA"):
        TMover(t_v5e())


@pytest.mark.cuda
def test_card_moves_launch_stream_copy_with_or_without_mover():
    """On the card every page move is the stream_copy kernel's output:
    without a mover (HBM->pinned, pinned->pinned) one gather launch and
    one landing launch a move; through a mover's default executor
    (pinned->HBM) at most one gather launch per batch of descriptors and
    one landing launch; the maps match the reference's and every shard
    keeps its storage."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (pinned backend)")
    from repro_torch.kernels.stream_copy import ops as sc
    rng = np.random.default_rng(7)
    x = rng.integers(-8, 9, size=(64 * 8, 4)).astype(np.float32)
    names = ("ddr5-l8", "cxl-a", "cxl-b")
    r, _ = _build(x, (names, (4, 2, 2)), 8, headroom=20)
    t = TIT.from_array(torch.from_numpy(x), TPolicy.weighted(names, (4, 2, 2)),
                       8, headroom=20, device="cuda")
    assert t.backend == "pinned"
    for n in (64, 512, 4096, 1 << 20):  # the reference's crossover, on the card too
        assert t.choose_gather_path(n) == r.choose_gather_path(n)
    ptrs = [p.data_ptr() for p in t.parts]
    steps = [lambda it, **kw: it.repartition_weights((0.3125, 0.25), **kw),
             lambda it, **kw: it.drain_device("cxl-b", **kw)]
    for step in steps:
        sc.LAUNCHES.reset()
        r = step(r, telemetry=RTel(), donate=True)
        t = step(t, telemetry=TTel(), donate=True)
        assert sc.LAUNCHES.count == 2  # the gather, then the landing
        assert np.array_equal(_np(t.page_device), _np(r.page_device))
        assert np.array_equal(_np(t.to_array()), x)
    with TMover(t_paper3(), telemetry=TTel(), device="cuda") as mover:
        assert mover.pipelined  # the card's default executor is the kernel
        sc.LAUNCHES.reset()
        t = t.repartition_weights((0.25, 0.0), mover=mover, donate=True)
        descs = mover.descriptors_submitted
        assert 0 < sc.LAUNCHES.count <= -(-descs // mover.batch_size) + 1
    assert np.array_equal(_np(t.to_array()), x)
    assert [p.data_ptr() for p in t.parts] == ptrs


def test_bf16_scatter_add_takes_the_bucketed_path():
    """Known divergence: the reference's numpy scatter cannot add
    bfloat16, so its non-donated ``add_rows`` on a bf16 tensor falls back
    to the masked formulation and counts no full-shard copy; the port adds
    bf16 natively on the bucketed path and counts one copy per touched
    shard.  The values agree."""
    rng = np.random.default_rng(12)
    x = rng.integers(-4, 5, size=(64, 4)).astype(np.float32)
    r = RIT.from_array(jnp.asarray(x, jnp.bfloat16),
                       RPolicy.weighted(("fast", "slow"), (1, 1)), 4)
    t = TIT.from_array(torch.from_numpy(x).to(torch.bfloat16),
                       TPolicy.weighted(("fast", "slow"), (1, 1)), 4,
                       device="cpu")
    idx = np.array([0, 1, 4, 5, 4])  # both shards, one duplicate
    vals = np.ones((5, 4), np.float32)
    r_donation.FULL_SHARD_COPIES.reset()
    t_donation.FULL_SHARD_COPIES.reset()
    r2 = r.add_rows(idx, jnp.asarray(vals, jnp.bfloat16))
    t2 = t.add_rows(idx, torch.from_numpy(vals).to(torch.bfloat16))
    assert r_donation.FULL_SHARD_COPIES.reset() == 0
    assert t_donation.FULL_SHARD_COPIES.reset() == 2
    assert np.array_equal(t2.to_array().float().numpy(),
                          np.asarray(r2.to_array().astype(jnp.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("weights", [(3, 1), (4, 2, 2, 1)])
def test_card_bucketed_gather_equals_masked(weights):
    """On the card the bucketed gather (HBM rows gathered on the card,
    pinned rows on the host into one page-locked buffer, one permutation
    back) gives the masked gather's rows and the reference's, with
    duplicate, negative and out-of-range rows, after a move into free
    slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (pinned backend)")
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64 * 8, 4)).astype(np.float32)
    names = ("ddr5-l8", "cxl-a", "cxl-b", "cxl-c")[:len(weights)]
    r, _ = _build(x, (names, weights), 8, headroom=8)
    t = TIT.from_array(torch.from_numpy(x), TPolicy.weighted(names, weights),
                       8, headroom=8, device="cuda")
    r = r.repartition_fraction(0.4, telemetry=RTel())
    t = t.repartition_fraction(0.4, telemetry=TTel(), donate=True)
    idx = rng.integers(-20, x.shape[0] + 20, size=(3, 300))
    idx[0, :50] = idx[0, 50]  # duplicates
    got = t._gather_rows_bucketed(idx)
    assert got.is_cuda and got.shape == (3, 300, 4)
    assert torch.equal(got, t._gather_rows_masked(torch.from_numpy(idx)))
    assert np.array_equal(_np(got), _np(r._gather_rows_bucketed(idx)))
