"""Differential tests for the tiered KV cache: the scenarios of
test_hotpaths.py, test_actuation.py and test_prefix.py replayed against
both packages from the same state.  Page maps, positions, pools, billed
bytes, descriptor counts and full-copy counts must be bit-equal; decode
logits agree at fp32 1e-4."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import donation as r_donation  # noqa: E402
from repro.core.mover import BulkMover as RMover  # noqa: E402
from repro.core.policy import MemPolicy as RPolicy  # noqa: E402
from repro.core.telemetry import Telemetry as RTelemetry  # noqa: E402
from repro.core.tiers import paper_three_device_topology as r_paper3  # noqa: E402
from repro.core.tiers import TierTopology as RTopo  # noqa: E402
from repro.models import registry as r_registry  # noqa: E402
from repro.serving.kv_cache import TieredKVCache as RCache  # noqa: E402
from repro.serving.kv_cache import tiered_decode_step as r_step  # noqa: E402
from repro_torch.convert import kv_cache_from_jax, params_from_jax  # noqa: E402
from repro_torch.core import donation as t_donation  # noqa: E402
from repro_torch.core.mover import BulkMover as TMover  # noqa: E402
from repro_torch.core.policy import MemPolicy as TPolicy  # noqa: E402
from repro_torch.core.telemetry import Telemetry as TTelemetry  # noqa: E402
from repro_torch.core.tiers import paper_three_device_topology as t_paper3  # noqa: E402
from repro_torch.core.tiers import TierTopology as TTopo  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402
from repro_torch.serving.kv_cache import TieredKVCache as TCache  # noqa: E402
from repro_torch.serving.kv_cache import tiered_decode_step as t_step  # noqa: E402

ARCH = "internvl2-2b"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x)


@pytest.fixture(scope="module")
def model():
    r_arch = r_registry.get(ARCH).tiny()
    params = r_arch.module.init(r_arch.cfg, jax.random.PRNGKey(0))
    t_cfg = t_registry.get(ARCH).tiny().cfg
    t_params = params_from_jax(
        t_cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return r_arch.cfg, params, t_cfg, t_params


def _policies(kind):
    if kind == "fast":
        return RPolicy.membind("fast"), TPolicy.membind("fast")
    if kind == "half":
        return (RPolicy.from_slow_fraction("fast", "slow", 0.5),
                TPolicy.from_slow_fraction("fast", "slow", 0.5))
    if kind == "quarter":
        return (RPolicy.from_slow_fraction("fast", "slow", 0.25),
                TPolicy.from_slow_fraction("fast", "slow", 0.25))
    if kind == "three":
        return (RPolicy.from_tier_fractions("fast", ("cxl-a", "cxl-b"),
                                            (0.25, 0.25)),
                TPolicy.from_tier_fractions("fast", ("cxl-a", "cxl-b"),
                                            (0.25, 0.25)))
    raise KeyError(kind)


def _pair(model, kind, *, batch=3, max_len=32, page_t=4, headroom=0,
          seed=0, lengths=None):
    """The same cache in both packages: the reference's, with its pools
    filled from a numpy seed, carried across by kv_cache_from_jax."""
    cfg = model[0]
    r_pol, _ = _policies(kind)
    rc = RCache.create(cfg, batch, max_len, r_pol, page_t=page_t,
                       slow_headroom=headroom)
    rng = np.random.default_rng(seed)
    fill = [jnp.asarray(rng.normal(size=p.shape), p.dtype) for p in rc.k_parts]
    fill_v = [jnp.asarray(rng.normal(size=p.shape), p.dtype)
              for p in rc.v_parts]
    if lengths is None:
        lengths = rng.integers(1, max_len // 2, size=batch)
    rc = dataclasses.replace(rc, k_parts=tuple(fill), v_parts=tuple(fill_v),
                             lengths=jnp.asarray(lengths, jnp.int32))
    return rc, kv_cache_from_jax(rc, device="cpu")


def _same(rc, tc):
    assert len(rc.k_parts) == len(tc.k_parts)
    for a, b in zip(rc.k_parts + rc.v_parts, tc.k_parts + tc.v_parts):
        assert a.shape == tuple(b.shape)
        assert np.array_equal(_np(a), _np(b))
    for a, b in zip(rc.pos_parts, tc.pos_parts):
        assert np.array_equal(_np(a), _np(b))
    assert np.array_equal(_np(rc.page_local), _np(tc.page_local))
    assert np.array_equal(_np(rc.page_device), _np(tc.page_device))
    assert np.array_equal(_np(rc.lengths), _np(tc.lengths))
    assert tuple(rc.device_names) == tuple(tc.device_names)
    assert rc.capacity_pages() == tc.capacity_pages()
    assert rc.read_bytes_per_step() == tc.read_bytes_per_step()
    assert rc.read_bytes_per_device() == tc.read_bytes_per_device()
    assert rc.storage_bytes_per_device() == tc.storage_bytes_per_device()
    assert rc.pool_bytes_per_device() == tc.pool_bytes_per_device()
    assert rc.weights() == tc.weights()
    assert rc.slow_fraction() == tc.slow_fraction()
    if rc.prefix is not None:
        for f in ("k", "v", "slot_pages", "slot_shared", "page_device"):
            assert np.array_equal(_np(getattr(rc.prefix, f)),
                                  _np(getattr(tc.prefix, f))), f


def _routes(tel):
    return tel.snapshot()["routes"]


# -- construction and addressing ----------------------------------------------------
@pytest.mark.parametrize("kind,headroom", [("fast", 0), ("half", 0),
                                           ("quarter", 2), ("three", 2),
                                           ("three", 8)])
def test_create_matches_reference(model, kind, headroom):
    r_cfg, _, t_cfg, _ = model
    r_pol, t_pol = _policies(kind)
    rc = RCache.create(r_cfg, 3, 32, r_pol, page_t=4, slow_headroom=headroom)
    tc = TCache.create(t_cfg, 3, 32, t_pol, page_t=4, slow_headroom=headroom,
                       device="cpu")
    assert tc.backend == "modeled"
    _same(rc, tc)


def test_append_layer_and_partitions_match(model):
    rc, tc = _pair(model, "three", headroom=2, lengths=[0, 5, 13])
    K, hd = rc.k_parts[0].shape[3:]
    rng = np.random.default_rng(9)
    for layer in range(rc.k_parts[0].shape[0]):
        k = rng.normal(size=(3, K, hd)).astype(np.float32)
        v = rng.normal(size=(3, K, hd)).astype(np.float32)
        rc = rc.append_layer(layer, jnp.asarray(k), jnp.asarray(v))
        assert tc.append_layer(layer, torch.from_numpy(k),
                               torch.from_numpy(v)) is tc
        _same(rc, tc)
        r_parts = rc.partitions(layer)
        t_parts = tc.partitions(layer)
        assert len(r_parts) == len(t_parts)
        for a, b in zip(r_parts, t_parts):
            for x, y in zip(a, b):
                assert np.array_equal(_np(x), _np(y))


# -- retiles: stable, rebuild, pins, drains -----------------------------------------
@pytest.mark.parametrize("donate", [False, True])
def test_stable_walk_bit_equal(model, donate):
    """test_hotpaths' three-device walk over a headroom-8 cache."""
    rc, tc = _pair(model, "three", batch=2, headroom=8)
    ptrs = [p.data_ptr() for p in tc.k_parts + tc.v_parts]
    fracs = [(0.125, 0.125), (0.25, 0.25), (0.125, 0.0), (0.25, 0.125),
             (0.0, 0.25), (0.375, 0.125), (0.125, 0.375), (0.25, 0.0),
             (0.0, 0.0), (0.375, 0.375)]
    for w in fracs:
        rt, tt = RTelemetry(), TTelemetry()
        r_donation.FULL_SHARD_COPIES.reset()
        t_donation.FULL_SHARD_COPIES.reset()
        rc = rc.repartition_weights(w, telemetry=rt, donate=donate)
        tc = tc.repartition_weights(w, telemetry=tt, donate=donate)
        _same(rc, tc)
        assert _routes(rt) == _routes(tt)
        assert (r_donation.FULL_SHARD_COPIES.count
                == t_donation.FULL_SHARD_COPIES.count)
    if donate:
        assert [p.data_ptr() for p in tc.k_parts + tc.v_parts] == ptrs


def test_rebuild_roundtrip_bit_equal(model):
    rc, tc = _pair(model, "fast", batch=2)
    for f in (0.5, 0.25, 0.0):
        r_donation.FULL_SHARD_COPIES.reset()
        t_donation.FULL_SHARD_COPIES.reset()
        rc = rc.repartition_fraction(f, telemetry=RTelemetry())
        tc = tc.repartition_fraction(f, telemetry=TTelemetry())
        _same(rc, tc)
        assert (r_donation.FULL_SHARD_COPIES.count
                == t_donation.FULL_SHARD_COPIES.count > 0)


def test_pin_slot_and_repartition_bit_equal(model):
    """test_arbiter's pin scenario: pinning rewrites maps, never the fast
    pool's shape; pinned slots stay out of repartitions."""
    rc, tc = _pair(model, "fast", batch=4, page_t=8)
    shape = tuple(tc.k_fast.shape)
    rc = rc.pin_slot(1, telemetry=RTelemetry())
    tc = tc.pin_slot(1, telemetry=TTelemetry())
    assert tuple(tc.k_fast.shape) == shape
    _same(rc, tc)
    rc = rc.repartition_fraction(0.5, pinned_slots={1}, telemetry=RTelemetry())
    tc = tc.repartition_fraction(0.5, pinned_slots={1}, telemetry=TTelemetry())
    _same(rc, tc)
    assert tc.slow_fraction(pinned_slots={1}) == pytest.approx(0.5)
    rc = rc.repartition_fraction(0.5, telemetry=RTelemetry())
    tc = tc.repartition_fraction(0.5, telemetry=TTelemetry())
    _same(rc, tc)


@pytest.mark.parametrize("donate", [False, True])
def test_three_device_drain_bit_equal(model, donate):
    rc, tc = _pair(model, "three", batch=2, headroom=8)
    rt, tt = RTelemetry(), TTelemetry()
    rc = rc.drain_device("cxl-a", telemetry=rt, donate=donate)
    tc = tc.drain_device("cxl-a", telemetry=tt, donate=donate)
    _same(rc, tc)
    assert _routes(rt) == _routes(tt)
    assert tc.weights()[0] == 0.0
    assert tc.storage_bytes_per_device()["cxl-a"] == 0
    with pytest.raises(ValueError, match="keeps weight"):
        tc.drain_device("cxl-b", weights=(0.5, 0.5))


@pytest.mark.parametrize("donate", [False, True])
def test_three_device_drain_through_the_mover_bit_equal(model, donate):
    """The drain's runs gathered through each package's mover (the port's
    as one segment list a run): pools, maps, descriptors, billed bytes
    and routes equal."""
    rc, tc = _pair(model, "three", batch=3, headroom=8)
    topo_r, topo_t = r_paper3(), t_paper3()
    rt, tt = RTelemetry(), TTelemetry()
    with RMover(topo_r, asynchronous=False, telemetry=rt) as rm, \
            TMover(topo_t, asynchronous=False, telemetry=tt,
                   device="cpu") as tm:
        for name in ("cxl-a", "cxl-b"):
            rc = rc.drain_device(name, mover=rm, telemetry=rt,
                                 fast_tier=topo_r.fast.name, donate=donate)
            tc = tc.drain_device(name, mover=tm, telemetry=tt,
                                 fast_tier=topo_t.fast.name, donate=donate)
            _same(rc, tc)
        assert (tm.descriptors_submitted, tm.bytes_submitted) == (
            rm.descriptors_submitted, rm.bytes_submitted)
    def bills(tel):
        return {k: (v["bytes_moved"], v["descriptors"], v["batches"])
                for k, v in _routes(tel).items()}
    assert bills(rt) == bills(tt)
    assert tm.descriptors_submitted > 0


def test_mover_descriptors_and_bytes_match(model):
    """One slot group, consecutive locals: one coalesced descriptor per
    run in both packages, the same billed bytes."""
    topo_r = RTopo(fast=r_paper3().fast, slow=r_paper3().slows[0])
    topo_t = TTopo(fast=t_paper3().fast, slow=t_paper3().slows[0])
    rc, tc = _pair(model, "fast", batch=3, max_len=64, headroom=8)
    with RMover(topo_r, asynchronous=True, batch_size=16,
                telemetry=RTelemetry()) as rm, \
            TMover(topo_t, asynchronous=True, batch_size=16,
                   telemetry=TTelemetry(), device="cpu") as tm:
        for f in (0.5, 0.25):
            rc = rc.repartition_fraction(f, mover=rm, fast_tier=topo_r.fast.name,
                                         slow_tier=topo_r.slow.name)
            tc = tc.repartition_fraction(f, mover=tm, fast_tier=topo_t.fast.name,
                                         slow_tier=topo_t.slow.name,
                                         donate=True)
            _same(rc, tc)
            assert tm.descriptors_submitted == rm.descriptors_submitted
            assert tm.bytes_submitted == rm.bytes_submitted
    assert 1 <= tm.descriptors_submitted <= 4


# -- the shared-prefix pool -----------------------------------------------------------
def test_prefix_ops_bit_equal(model):
    rc, tc = _pair(model, "half", batch=3, max_len=64, page_t=8, headroom=4,
                   lengths=[20, 30, 3])
    rc, tc = rc.with_prefix(4), tc.with_prefix(4)
    _same(rc, tc)
    # promotion: slot 0's first two pages into pool pages 2 and 0
    rk, rv = zip(*(rc.gather_token_rows(0, p * 8, 8) for p in range(2)))
    tk, tv = zip(*(tc.gather_token_rows(0, p * 8, 8) for p in range(2)))
    for a, b in zip(rk + rv, tk + tv):
        assert np.array_equal(_np(a), _np(b))
    rc = rc.write_prefix_pages([2, 0], np.stack(rk, 1), np.stack(rv, 1))
    tc = tc.write_prefix_pages([2, 0], torch.stack(tk, 1), torch.stack(tv, 1))
    _same(rc, tc)
    # attach by reference, then copy-on-write a partial page
    rc, tc = rc.attach_prefix(1, [2, 0]), tc.attach_prefix(1, [2, 0])
    _same(rc, tc)
    k_rows = np.asarray(rc.prefix.k)[:, 2, :5]
    v_rows = np.asarray(rc.prefix.v)[:, 2, :5]
    rc = rc.write_token_rows(1, 16, k_rows, v_rows)
    tc = tc.write_token_rows(1, 16, tc.prefix.k[:, 2, :5], tc.prefix.v[:, 2, :5])
    _same(rc, tc)
    for li in range(rc.k_parts[0].shape[0]):
        for a, b in zip(rc.partitions(li), tc.partitions(li)):
            for x, y in zip(a, b):
                assert np.array_equal(_np(x), _np(y))
    # a retile keeps the shared boundary sentineled
    rc = rc.repartition_fraction(0.75, telemetry=RTelemetry())
    tc = tc.repartition_fraction(0.75, telemetry=TTelemetry(), donate=True)
    _same(rc, tc)
    # labels: billed once per page, on real routes
    rt, tt = RTelemetry(), TTelemetry()
    rc = rc.retile_prefix([1, -1, 1, -1], telemetry=rt)
    tc = tc.retile_prefix([1, -1, 1, -1], telemetry=tt)
    _same(rc, tc)
    assert _routes(rt) == _routes(tt)
    rc, tc = rc.detach_prefix(1), tc.detach_prefix(1)
    _same(rc, tc)


# -- the decode step ------------------------------------------------------------------
def test_decode_step_logits_match(model):
    """tiered_decode_step on the same state and parameters: logits at
    1e-4 and the same greedy tokens, across a mid-sequence retile and an
    SLO pin."""
    r_cfg, r_params, t_cfg, t_params = model
    rc = RCache.create(r_cfg, 2, 32, _policies("quarter")[0], page_t=4,
                       slow_headroom=4)
    tc = kv_cache_from_jax(rc, device="cpu")
    toks = np.array([3, 9], np.int32)
    for t in range(8):
        lr, rc = r_step(r_cfg, r_params, rc, jnp.asarray(toks))
        lt, tc = t_step(t_cfg, t_params, tc, torch.from_numpy(toks))
        np.testing.assert_allclose(_np(lt), _np(lr), atol=1e-4, rtol=1e-4)
        toks = np.asarray(jnp.argmax(lr, -1)).astype(np.int32)
        assert np.array_equal(t_sample(lt), toks)
        if t == 2:
            rc = rc.repartition_fraction(0.5, telemetry=RTelemetry())
            tc = tc.repartition_fraction(0.5, telemetry=TTelemetry(),
                                         donate=True)
        if t == 5:
            rc = rc.pin_slot(1, telemetry=RTelemetry())
            tc = tc.pin_slot(1, telemetry=TTelemetry(), donate=True)
    assert np.array_equal(_np(rc.page_device), _np(tc.page_device))


def test_retiles_reuse_one_staging_buffer_a_pool(model):
    """Every cache evolved from one stages its moved runs in one buffer a
    destination pool, grown on demand: a walk repeated allocates none,
    and the pools stay the reference's."""
    rc, tc = _pair(model, "half", batch=3, headroom=8)
    stages = ptrs = None
    for _ in range(2):
        for f in (0.25, 0.75, 0.5):
            rc = rc.repartition_fraction(f, telemetry=RTelemetry())
            tc = tc.repartition_fraction(f, telemetry=TTelemetry())
            _same(rc, tc)
            stages = stages or tc.__dict__["_stages"]
            assert tc.__dict__["_stages"] is stages
        now = {k: b.data_ptr() for k, b in stages.items()}
        assert now and (ptrs is None or now == ptrs), (now, ptrs)
        ptrs = now


def t_sample(logits):
    return torch.argmax(logits, -1).numpy().astype(np.int32)


def test_cache_on_a_card_needs_one():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = t_registry.get(ARCH).tiny().cfg
    with pytest.raises(RuntimeError, match="CUDA"):
        TCache.create(cfg, 2, 32, TPolicy.membind("fast"))


@pytest.mark.cuda
@pytest.mark.parametrize("with_mover", [True, False])
def test_card_drain_gathers_a_batch_in_one_launch(with_mover):
    """On the card, HBM and three pinned pools: a drain through the mover
    launches ``stream_copy`` at most once a route-pure batch of 16
    descriptors plus one landing, without one once a run plus one
    landing, and every slot reads back what it held."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.benchmarks.common import launch_bound
    from repro_torch.core.mover import stream_executor
    from repro_torch.kernels.stream_copy import ops as sc_ops
    cfg = t_registry.get(ARCH).tiny().cfg
    topo = t_paper3()
    names = (topo.fast.name,) + topo.slow_names
    cache = TCache.create(cfg, 4, 64, TPolicy.weighted(names, (5, 1, 1, 1)),
                          page_t=4, slow_headroom=8, device="cuda")
    L, K, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [[torch.randn((L, 48, K, hd), generator=gen, device="cuda")
             for _ in range(2)] for _ in range(4)]
    for i, (k, v) in enumerate(rows):
        cache = cache.write_token_rows(i, 0, k, v)
    tel = TTelemetry()
    with TMover(topo, asynchronous=False, execute=stream_executor(),
                telemetry=tel, device="cuda") as mover:
        sc_ops.LAUNCHES.reset()
        cache = cache.drain_device("cxl-c", mover=mover if with_mover
                                   else None, telemetry=tel, donate=True)
        torch.cuda.synchronize()
        launches = sc_ops.LAUNCHES.reset()
    descs = [r["descriptors"] for route, r in
             tel.snapshot()["routes"].items() if route.startswith("cxl-c->")]
    bound = launch_bound(descs) if with_mover else sum(descs) + 1
    assert 0 < launches <= bound, (launches, descs)
    assert not (cache.page_device.cpu().numpy() == 3).any()
    for i, (k, v) in enumerate(rows):
        k_got, v_got = cache.gather_token_rows(i, 0, 48)
        assert torch.equal(k_got, k) and torch.equal(v_got, v), i
