"""Differential tests for the port's BulkMover: route-pure batching, lanes,
per-device writer watermarks, post-cast billing and modeled costs equal to
the reference's on the same descriptors, plus the executors on the CPU."""
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import mover as r_mv  # noqa: E402
from repro.core.telemetry import Telemetry as RTel  # noqa: E402
from repro.core.tiers import (paper_three_device_topology as r_paper3,  # noqa: E402
                              paper_topology as r_paper)
from repro_torch.core import mover as t_mv  # noqa: E402
from repro_torch.core.telemetry import Telemetry as TTel  # noqa: E402
from repro_torch.core.tiers import (paper_three_device_topology as t_paper3,  # noqa: E402
                                    paper_topology as t_paper)

SIDES = {
    "r": (r_mv, RTel, r_paper3, r_paper, lambda a: jnp.asarray(a), {}),
    "t": (t_mv, TTel, t_paper3, t_paper, lambda a: torch.from_numpy(a),
          {"device": "cpu"}),
}


def _routes(tel):
    return {k: (v.bytes_moved, v.descriptors, v.batches)
            for k, v in tel.routes.items()}


@pytest.mark.parametrize("batch_size", [1, 4, 16])
def test_route_pure_batching_three_devices(batch_size):
    out = {}
    for side, (mv, Tel, paper3, _, arr, kw) in SIDES.items():
        tel = Tel()
        with mv.BulkMover(paper3(), asynchronous=True, batch_size=batch_size,
                          max_writers=2, drain_workers=3, telemetry=tel,
                          **kw) as mover:
            descs = []
            for dst in ("cxl-a", "cxl-b", "cxl-c"):
                descs += [mv.Descriptor("ddr5-l8", dst,
                                        arr(np.zeros(32, np.float32)))
                          for _ in range(6)]
            mover.submit(descs)
            mover.wait_all()
            peaks = {dst: mover.take_peak_writers(dst) >= 1
                     for dst in ("cxl-a", "cxl-b", "cxl-c")}
            out[side] = (_routes(tel), mover.descriptors_submitted,
                         mover.bytes_submitted, peaks,
                         mover.take_peak_writers("cxl-a"))
    assert out["t"] == out["r"]
    routes = out["t"][0]
    assert routes[("ddr5-l8", "cxl-a")][2] == -(-6 // batch_size)


def test_writer_limit_is_per_device():
    out = {}
    for side, (mv, Tel, paper3, _, arr, kw) in SIDES.items():
        barrier = threading.Barrier(3)

        def rendezvous(payload):
            barrier.wait(timeout=10)
            return payload

        with mv.BulkMover(paper3(), asynchronous=True, batch_size=1,
                          max_writers=1, drain_workers=3, telemetry=Tel(),
                          execute=rendezvous, **kw) as mover:
            mover.submit([mv.Descriptor("ddr5-l8", dst,
                                        arr(np.zeros(8, np.float32)))
                          for dst in ("cxl-a", "cxl-b", "cxl-c")])
            mover.wait_all()
            out[side] = (mover.take_peak_writers(), dict(mover.peak_by_dev))
    assert out["t"] == out["r"] == (3, {"cxl-a": 1, "cxl-b": 1, "cxl-c": 1})


def test_latency_lane_drains_first():
    out = {}
    for side, (mv, Tel, paper3, _, arr, kw) in SIDES.items():
        order = []
        with mv.BulkMover(paper3(), asynchronous=False, batch_size=2,
                          telemetry=Tel(), **kw) as mover:
            descs = [mv.Descriptor(
                "ddr5-l8", "cxl-a", arr(np.full(4, i, np.float32)),
                lane=(mv.LANE_LATENCY if i % 3 == 0 else mv.LANE_BULK),
                on_done=lambda res, i=i: order.append(i))
                for i in range(9)]
            comps = mover.submit(descs)
            assert [float(np.asarray(c.result)[0]) for c in comps] == list(
                map(float, range(9)))  # returned in submission order
        out[side] = order
    assert out["t"] == out["r"]
    assert out["t"][:3] == [0, 3, 6]


def test_post_cast_billing():
    out = {}
    for side, (mv, Tel, paper3, _, arr, kw) in SIDES.items():
        topo = paper3()
        if side == "r":
            payload, f32 = jnp.ones((64, 16), jnp.bfloat16), jnp.float32
        else:
            payload, f32 = torch.ones((64, 16), dtype=torch.bfloat16), \
                torch.float32
        d = mv.Descriptor(topo.fast.name, topo.slows[0].name, payload,
                          out_dtype=f32)
        plain = mv.Descriptor(topo.fast.name, topo.slows[0].name, payload)
        tel = Tel()
        with mv.BulkMover(topo, telemetry=tel, **kw) as mover:
            comps = mover.submit([d])
            mover.wait_all()
            out[side] = (d.nbytes, plain.nbytes, mover.bytes_submitted,
                         _routes(tel))
            del comps
    assert out["t"] == out["r"]
    assert out["t"][:3] == (64 * 16 * 4, 64 * 16 * 2, 64 * 16 * 4)


@pytest.mark.parametrize("pipelined", [False, True])
def test_modeled_cost_equal(pipelined):
    costs = {}
    for side, (mv, Tel, paper3, paper, arr, kw) in SIDES.items():
        execute = mv.stream_executor() if pipelined else mv._execute_copy
        descs = [mv.Descriptor("cxl-agilex", "ddr5-l8",
                               arr(np.zeros(1024 * (1 + i % 3), np.float32)))
                 for i in range(64)]
        row = []
        for batch, asyn in ((1, False), (128, False), (128, True)):
            m = mv.BulkMover(paper(), asynchronous=asyn, batch_size=batch,
                             telemetry=Tel(), execute=execute, **kw)
            assert m.pipelined == pipelined
            row.append(m.modeled_cost(descs))
            m.close()
        costs[side] = row
    assert costs["t"] == costs["r"]


def test_stream_executor_on_host_payloads():
    """Pageable host tensors (the ``modeled`` backend) take the plain copy:
    a new tensor, the fused cast applied, nothing launched."""
    from repro_torch.kernels.stream_copy import ops
    topo = t_paper3()
    src = torch.from_numpy(
        np.random.default_rng(6).normal(size=(100, 8)).astype(np.float32))
    got = {}
    ops.LAUNCHES.reset()
    with t_mv.BulkMover(topo, execute=t_mv.stream_executor(),
                        telemetry=TTel(), device="cpu") as mover:
        assert mover.pipelined
        d = t_mv.Descriptor(topo.fast.name, topo.slows[0].name, src,
                            out_dtype=torch.bfloat16,
                            on_done=lambda r: got.setdefault("x", r))
        fut = mover.issue([d])[0]
        mover.wait_all()
        assert fut.done() and fut.result().result is got["x"]
    assert got["x"].dtype == torch.bfloat16
    assert torch.equal(got["x"], src.to(torch.bfloat16))
    assert got["x"].data_ptr() != src.data_ptr()
    assert d.done is None and ops.LAUNCHES.count == 0
    with pytest.raises(RuntimeError):
        mover.submit([d])  # closed


def test_cpu_mover_copies_host_memory_only():
    """A mover on the CPU takes the plain host copy by default and refuses
    a move into card memory: on the card every move is the kernel's."""
    topo = t_paper3()
    src = torch.ones((8, 4))
    with t_mv.BulkMover(topo, asynchronous=False, telemetry=TTel(),
                        device="cpu") as m:
        assert m._execute is t_mv._execute_copy and not m.pipelined
        got = m.submit([t_mv.Descriptor("ddr5-l8", "cxl-a", src)])[0].result
        assert torch.equal(got, src) and got.data_ptr() != src.data_ptr()
        with pytest.raises(ValueError, match="stream_executor"):
            m.submit([t_mv.Descriptor("ddr5-l8", "cxl-a", src,
                                      dst=t_mv.PINNED)])


def test_sync_async_equivalence_and_double_buffer():
    topo = t_paper3()
    payloads = [torch.full((128,), float(i)) for i in range(12)]
    with t_mv.BulkMover(topo, asynchronous=False, batch_size=4,
                        telemetry=TTel(), device="cpu") as m:
        sync_res = [c.result for c in m.submit(
            [t_mv.Descriptor("ddr5-l8", "cxl-a", p) for p in payloads])]
    with t_mv.BulkMover(topo, asynchronous=True, batch_size=4,
                        telemetry=TTel(), device="cpu") as m:
        m.submit([t_mv.Descriptor("ddr5-l8", "cxl-a", p) for p in payloads])
        comps = m.wait_all()
    assert len(comps) == 12
    for p, r in zip(payloads, sync_res):
        assert torch.equal(p, r)
    assert (list(t_mv.double_buffer(range(7), lambda i: i * i))
            == list(r_mv.double_buffer(range(7), lambda i: i * i)))
