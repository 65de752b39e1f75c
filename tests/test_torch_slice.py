"""The slice end to end at a small size, in both packages: the reference's
InterleavedTensor is carried across with ``repro_torch.convert``, then a
Caption walk actuates through ``BulkMover(execute=stream_executor())`` in
each.  Every epoch gives the same decisions, fractions, billed bytes and
descriptor counts, and bag outputs bit-equal on an integer table."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from benchmarks.fig8_dlrm import throughput  # noqa: E402
from repro.core import donation as r_donation  # noqa: E402
from repro.core import interleave as r_il  # noqa: E402
from repro.core import mover as r_mv  # noqa: E402
from repro.core.caption import (CaptionConfig as RConfig,  # noqa: E402
                                CaptionController as RController,
                                EpochMetrics as RMetrics)
from repro.core.policy import MemPolicy as RPolicy  # noqa: E402
from repro.core.telemetry import Telemetry as RTel  # noqa: E402
from repro.core import tiers as r_tiers  # noqa: E402
from repro.kernels.embedding_reduce import ops as r_er  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import donation as t_donation  # noqa: E402
from repro_torch.core import mover as t_mv  # noqa: E402
from repro_torch.core.caption import (CaptionConfig as TConfig,  # noqa: E402
                                      CaptionController as TController,
                                      EpochMetrics as TMetrics)
from repro_torch.core.telemetry import Telemetry as TTel  # noqa: E402
from repro_torch.core import tiers as t_tiers  # noqa: E402

PAGE_ROWS, DIM, BAG, LOOKUPS = 8, 64, 16, 80


def _snc(tiers):
    snc = dataclasses.replace(tiers.DDR5_L8, name="snc-2ch", load_bw=55e9,
                              load_peak_streams=12)
    return tiers.TierTopology(fast=snc, slow=tiers.CXL_AGILEX)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _state_equal(r, t):
    assert np.array_equal(t.page_device.numpy(), np.asarray(r.page_device))
    assert np.array_equal(t.page_local.numpy(), np.asarray(r.page_local))
    assert t.capacity_pages == r.capacity_pages
    assert t.device_names == r.device_names


def _routes(tel):
    return {k: (v.bytes_moved, v.descriptors, v.batches)
            for k, v in tel.routes.items()}


def test_convert_carries_state_bit_exact():
    rng = np.random.default_rng(0)
    for dtype in (jnp.float32, jnp.bfloat16):
        x = jnp.asarray(rng.normal(size=(100, 8)), jnp.float32).astype(dtype)
        pol = RPolicy.from_tier_fractions("fast", ("cxl-a", "cxl-b"),
                                          (0.25, 0.125))
        r = r_il.InterleavedTensor.from_array(x, pol, 4, headroom=3)
        r = r.repartition_fraction(0.4, telemetry=RTel())  # free-slot layout
        t = convert.interleaved_from_reference(r, device="cpu")
        _state_equal(r, t)
        for pr, pt in zip(r.parts, t.parts):
            assert np.array_equal(_np(pt), _np(pr))
        assert np.array_equal(_np(t.to_array()), _np(r.to_array()))
        assert t.backend == "modeled" and t.headroom == 3
        # the same table and policy, paged afresh by both packages
        t2 = convert.table_from_numpy(np.asarray(x), convert.policy_from_reference(pol),
                                      4, headroom=3, device="cpu")
        r2 = r_il.InterleavedTensor.from_array(x, pol, 4, headroom=3)
        _state_equal(r2, t2)
        assert np.array_equal(convert.tensor_to_numpy(t2.to_array()),
                              _np(r2.to_array()))


def test_slice_walk_in_both_packages():
    rng = np.random.default_rng(1)
    rows = 256 * PAGE_ROWS
    table = rng.integers(-8, 9, size=(rows, DIM)).astype(np.float32)
    topo_r, topo_t = _snc(r_tiers), _snc(t_tiers)
    fast, slow = topo_r.fast.name, topo_r.slow.name
    r_ctl = RController(topo_r, RConfig(max_fraction=0.5, probe_epochs=2,
                                        step=0.05, min_step=0.01,
                                        hysteresis=0.01))
    t_ctl = TController(topo_t, TConfig(max_fraction=0.5, probe_epochs=2,
                                        step=0.05, min_step=0.01,
                                        hysteresis=0.01))
    n_pages = rows // PAGE_ROWS
    headroom = r_ctl.headroom_pages(n_pages)
    assert t_ctl.headroom_pages(n_pages) == headroom
    r_it = r_il.InterleavedTensor.from_array(
        jnp.asarray(table), RPolicy.weighted((fast, slow), (1, 0)),
        PAGE_ROWS, headroom=headroom)
    t_it = convert.interleaved_from_reference(r_it, device="cpu")
    _state_equal(r_it, t_it)
    ptrs = [p.data_ptr() for p in t_it.parts]
    batches = [rng.integers(0, rows, size=(BAG, LOOKUPS)) for _ in range(2)]
    want = [np.einsum("bkd->bd", table[b]) for b in batches]
    r_tel, t_tel = RTel(), TTel()
    r_donation.FULL_SHARD_COPIES.reset()
    t_donation.FULL_SHARD_COPIES.reset()
    moved = 0
    with r_mv.BulkMover(topo_r, batch_size=16, telemetry=r_tel,
                        execute=r_mv.stream_executor()) as r_mover, \
            t_mv.BulkMover(topo_t, batch_size=16, telemetry=t_tel,
                           execute=t_mv.stream_executor(),
                           device="cpu") as t_mover:
        for epoch in range(40):
            tput = throughput(topo_r.fast, topo_r.slow, r_ctl.fraction, 32)
            dr = r_ctl.observe(RMetrics(throughput=tput))
            dt = t_ctl.observe(TMetrics(throughput=tput))
            assert (dt.fraction, dt.reason, dt.phase.value) == (
                dr.fraction, dr.reason, dr.phase.value)
            r_it = r_it.repartition_fraction(
                dr.fraction, mover=r_mover, fast_tier=fast, slow_tier=slow,
                donate=True)
            t_it = t_it.repartition_fraction(
                dt.fraction, mover=t_mover, fast_tier=fast, slow_tier=slow,
                donate=True)
            r_ctl.actuated(r_it.slow_fraction())
            t_ctl.actuated(t_it.slow_fraction())
            assert t_it.slow_fraction() == r_it.slow_fraction()
            assert (t_mover.descriptors_submitted, t_mover.bytes_submitted) \
                == (r_mover.descriptors_submitted, r_mover.bytes_submitted)
            assert _routes(t_tel) == _routes(r_tel)
            _state_equal(r_it, t_it)
            for b, w in zip(batches, want):
                got = _np(t_it.bag_reduce(torch.from_numpy(b)))
                assert np.array_equal(got, w)
                assert np.array_equal(got, _np(r_it.bag_reduce(jnp.asarray(b))))
            assert [p.data_ptr() for p in t_it.parts] == ptrs
            moved = t_mover.bytes_submitted
            if r_ctl.converged:
                break
    assert moved > 0 and t_ctl.converged == r_ctl.converged
    assert t_it.slow_fraction() > 0.05  # the SNC hill pays for slow pages
    assert (t_donation.FULL_SHARD_COPIES.reset()
            == r_donation.FULL_SHARD_COPIES.reset() == 0)
    # the reference's Pallas kernel on the final placement, bit-equal
    small = batches[0][:2, :8]
    ref = r_it.bag_reduce(jnp.asarray(small), reduce_fn=r_er.embedding_reduce)
    assert np.array_equal(_np(t_it.bag_reduce(torch.from_numpy(small))),
                          _np(ref))
    assert np.array_equal(_np(t_it.to_array()), table)
