"""The segment-list ``stream_copy`` and the page-move plan built on it.

On the CPU: ``move_plan``'s gather and landing, run through the plain
segment-list version, leave every shard bit-equal to the reference's
``_reassign`` (one-direction moves, a three-device move in which a shard
both loses and receives pages, the rebuild path, ragged runs, a bf16
table; without a mover, through a mover's default executor and through
``stream_executor``'s batch entry); the plain segment-list version equals
the reference's Pallas ``stream_copy`` (interpret mode) on each segment;
the kernel wrapper's launch layout for a walk-shaped plan; the hold that
keeps a launch's pinned operands alive until it has run.  On a CUDA card
only: the kernel against the plain version, and a move's old pinned shard
dropped and its memory pinned again while the move is still queued."""
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import donation as r_donation  # noqa: E402
from repro.core import interleave as r_il  # noqa: E402
from repro.core.mover import BulkMover as RMover  # noqa: E402
from repro.core.mover import Descriptor as RDescriptor  # noqa: E402
from repro.core.policy import MemPolicy as RPolicy  # noqa: E402
from repro.core.telemetry import Telemetry as RTel  # noqa: E402
from repro.core.tiers import paper_three_device_topology as r_paper3  # noqa: E402
from repro.kernels.stream_copy import ops as r_sc  # noqa: E402
from repro_torch.core import donation as t_donation  # noqa: E402
from repro_torch.core import interleave as t_il  # noqa: E402
from repro_torch.core import mover as t_mv  # noqa: E402
from repro_torch.core.policy import MemPolicy as TPolicy  # noqa: E402
from repro_torch.core.telemetry import Telemetry as TTel  # noqa: E402
from repro_torch.core.tiers import paper_three_device_topology as t_paper3  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.stream_copy import kernel as sc_kernel  # noqa: E402
from repro_torch.kernels.stream_copy import ops as t_sc, ref as t_sc_ref  # noqa: E402

RIT, TIT = r_il.InterleavedTensor, t_il.InterleavedTensor
NAMES2, NAMES3 = ("ddr5-l8", "cxl-a"), ("ddr5-l8", "cxl-a", "cxl-b")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _build(x, names, weights, page_rows, headroom, dtype):
    r = RIT.from_array(jnp.asarray(x, dtype), RPolicy.weighted(names, weights),
                       page_rows, headroom=headroom)
    t = TIT.from_array(torch.from_numpy(np.asarray(x)).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32),
        TPolicy.weighted(names, weights), page_rows, headroom=headroom,
        device="cpu")
    return r, t


def _same(r, t):
    """Maps, capacities and every shard (headroom included) bit-equal."""
    assert np.array_equal(_np(t.page_device), _np(r.page_device))
    assert np.array_equal(_np(t.page_local), _np(r.page_local))
    assert t.capacity_pages == r.capacity_pages
    for pr, pt in zip(r.parts, t.parts):
        assert pt.dtype == (torch.bfloat16 if pr.dtype == jnp.bfloat16
                            else torch.float32)
        assert np.array_equal(_np(pt), _np(pr))
    assert np.array_equal(_np(t.to_array()), _np(r.to_array()))


def _hazard_map(dev: np.ndarray) -> np.ndarray:
    """Device 1 sends 6 pages to device 2 and takes 8 of device 2's: both
    shards lose and receive, and freed slots are refilled."""
    new = dev.copy()
    on1, on2 = np.nonzero(dev == 1)[0], np.nonzero(dev == 2)[0]
    new[on1[1:13:2]] = 2
    new[on2[::2][:8]] = 1
    return new


#: name -> (rows, page_rows, names, weights, headroom, dtype, steps); each
#: step maps a tensor to keyword arguments -> the next tensor
CASES = {
    "to_slow": (512, 8, NAMES2, (1, 0), 32, jnp.float32,
                [lambda it, **kw: it.repartition_fraction(0.25, **kw)]),
    "to_slow_and_back": (512, 8, NAMES2, (1, 0), 32, jnp.float32,
                         [lambda it, **kw: it.repartition_fraction(0.375, **kw),
                          lambda it, **kw: it.repartition_fraction(0.125, **kw)]),
    "three_device_hazard": (64 * 4, 4, NAMES3, (4, 2, 2), 4, jnp.float32,
                            [lambda it, **kw: it.reassign_pages(
                                _hazard_map(it._host_map()[0]), **kw)]),
    "rebuild_exact": (256, 4, NAMES2, (3, 1), 0, jnp.float32,
                      [lambda it, **kw: it.repartition_fraction(0.5, **kw)]),
    "rebuild_grow": (256, 8, NAMES2, (1, 0), 4, jnp.float32,
                     [lambda it, **kw: it.repartition_fraction(0.1, **kw),
                      lambda it, **kw: it.repartition_fraction(0.75, **kw)]),
    "ragged_runs": (250, 8, NAMES3, (5, 2, 1), 12, jnp.float32,
                    [lambda it, **kw: it.repartition_weights(
                        (0.1, 0.4), run_pages=3, **kw),
                     lambda it, **kw: it.drain_device("cxl-b", **kw)]),
    "bf16": (512, 16, NAMES2, (3, 1), 8, jnp.bfloat16,
             [lambda it, **kw: it.repartition_fraction(0.0625, **kw),
              lambda it, **kw: it.repartition_fraction(0.5, **kw)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("how", ["direct", "mover", "mover_stream"])
@pytest.mark.parametrize("donate", [False, True])
def test_move_plan_lands_like_the_reference(case, how, donate, monkeypatch):
    rows, page_rows, names, weights, headroom, dtype, steps = CASES[case]
    rng = np.random.default_rng(len(case) + rows)
    x = rng.integers(-64, 65, size=(rows, 4)).astype(np.float32)
    r, t = _build(x, names, weights, page_rows, headroom, dtype)
    calls = []
    real = t_sc.stream_copy_segments
    monkeypatch.setattr(t_sc, "stream_copy_segments",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    for step in steps:
        r_tel, t_tel = RTel(), TTel()
        r_donation.FULL_SHARD_COPIES.reset()
        t_donation.FULL_SHARD_COPIES.reset()
        calls.clear()
        if how == "direct":
            r = step(r, telemetry=r_tel, donate=donate)
            t = step(t, telemetry=t_tel, donate=donate)
        else:
            execute = t_mv.stream_executor() if how == "mover_stream" else None
            with RMover(r_paper3(), telemetry=r_tel, batch_size=4) as rm, \
                    t_mv.BulkMover(t_paper3(), telemetry=t_tel, batch_size=4,
                                   execute=execute, device="cpu") as tm:
                r = step(r, mover=rm, donate=donate)
                t = step(t, mover=tm, donate=donate)
                assert (tm.descriptors_submitted, tm.bytes_submitted) == (
                    rm.descriptors_submitted, rm.bytes_submitted)
        _same(r, t)
        assert np.array_equal(_np(t.to_array()), _np(jnp.asarray(x, dtype)))
        routes = {k: (v.bytes_moved, v.descriptors, v.batches)
                  for k, v in t_tel.routes.items()}
        assert routes == {k: (v.bytes_moved, v.descriptors, v.batches)
                          for k, v in r_tel.routes.items()}
        assert (t_donation.FULL_SHARD_COPIES.reset()
                == r_donation.FULL_SHARD_COPIES.reset())
        # the gather: one call, one per route-pure mover batch through
        # the batch entry, none through per-descriptor copies; then one
        # landing call
        gathers = {"direct": 1, "mover": 0,
                   "mover_stream": sum(b for _, _, b in routes.values())}
        assert len(calls) == gathers[how] + 1, (calls, routes)


def test_page_segments_coalesce_consecutive_pairs():
    segs = t_il.page_segments([0, 0, 0, 0, 1, 1], [4, 5, 6, 9, 0, 1],
                              [2, 2, 3, 3, 3, 3], [0, 1, 2, 3, 4, 6])
    assert segs.tolist() == [[0, 4, 2, 0, 2], [0, 6, 3, 2, 1],
                             [0, 9, 3, 3, 1], [1, 0, 3, 4, 1],
                             [1, 1, 3, 6, 1]]
    assert t_il.page_segments([], [], [], []).shape == (0, 5)


def test_move_plan_stages_runs_in_order_and_coalesces_slots():
    """Gather: one segment per run, staged back to back; landing: the
    staged pages in order, consecutive destination slots merged."""
    runs = [(0, 1, np.array([3, 4, 5]), 10), (0, 2, np.array([7]), 20),
            (1, 0, np.array([8, 9]), 2)]
    new_dev = np.zeros(12, np.int8)
    new_local = np.zeros(12, np.int32)
    new_dev[[3, 4, 5, 7, 8, 9]] = [1, 1, 1, 2, 0, 0]
    new_local[[3, 4, 5, 7, 8, 9]] = [0, 1, 5, 3, 6, 7]
    gather, landing = t_il.move_plan(runs, new_dev, new_local)
    assert gather.tolist() == [[0, 10, 0, 0, 3], [0, 20, 0, 3, 1],
                               [1, 2, 0, 4, 2]]
    assert landing.tolist() == [[0, 0, 1, 0, 2], [0, 2, 1, 5, 1],
                                [0, 3, 2, 3, 1], [0, 4, 0, 6, 2]]
    el = t_il.element_segments(gather, 32)
    assert el[:, [0, 1, 3, 4, 6, 7]].tolist() == [
        [0, 320, 0, 0, 1, 96], [0, 640, 0, 96, 1, 32],
        [1, 64, 0, 128, 1, 64]]


# -- the plain segment-list version against the reference kernel ------------------
#: (src base length, dst base length, segments): ragged, unaligned,
#: row-strided, a repeated row (source stride 0), one element, 16 bytes
SEGMENT_SETS = [
    (4096, 4096, [(0, 0, 1024, 0, 0, 1024, 1, 1024),
                  (0, 1024, 1, 0, 2048, 1, 1, 1),
                  (0, 1027, 300, 0, 2051, 310, 4, 253),
                  (0, 3000, 0, 0, 3300, 8, 5, 4)]),
    (1000, 1200, [(0, 1, 37, 0, 3, 41, 7, 29),
                  (0, 500, 500, 0, 700, 500, 1, 500)]),
]


@pytest.mark.parametrize("sdt,odt", [("float32", None),
                                     ("float32", "bfloat16"),
                                     ("bfloat16", "float32"),
                                     ("bfloat16", None)])
@pytest.mark.parametrize("which", range(len(SEGMENT_SETS)))
def test_plain_segments_equal_the_reference_kernel(sdt, odt, which):
    n_src, n_dst, segs = SEGMENT_SETS[which]
    rng = np.random.default_rng(which)
    x = rng.normal(size=n_src).astype(np.float32)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    src_j = jnp.asarray(x).astype(jdt[sdt])
    src_t = torch.from_numpy(np.array(src_j.astype(jnp.float32))).to(tdt[sdt])
    out_t = tdt[odt or sdt]
    dst = torch.full((n_dst,), -7.0, dtype=out_t)
    t_sc.stream_copy_segments([src_t], [dst], np.array(segs, np.int64))
    covered = np.zeros(n_dst, bool)
    for _, so, ss, _, do, ds, rows, cols in segs:
        win = np.stack([np.asarray(src_j[so + r * ss: so + r * ss + cols])
                        for r in range(rows)])
        want = r_sc.stream_copy(jnp.asarray(win),
                                out_dtype=jdt[odt] if odt else None)
        got = torch.stack([dst[do + r * ds: do + r * ds + cols]
                           for r in range(rows)])
        assert np.array_equal(_np(got), _np(want))
        for r in range(rows):
            covered[do + r * ds: do + r * ds + cols] = True
    assert (dst.float().numpy()[~covered] == -7.0).all()


def test_plain_segments_refuse_segments_outside_their_bases():
    src, dst = torch.zeros(64), torch.zeros(64)
    for bad in ((0, 60, 8, 0, 0, 8, 1, 8), (0, 0, 8, 0, 60, 8, 1, 8),
                (0, 0, 8, 0, 0, 4, 2, 8), (1, 0, 8, 0, 0, 8, 1, 8)):
        with pytest.raises(ValueError):
            sc_kernel.launch_table([src], [dst], np.array([bad], np.int64))
    with pytest.raises(ValueError, match="dtype"):
        sc_kernel.launch_table([src, src.to(torch.bfloat16)], [dst],
                               np.zeros((0, 8), np.int64))


@pytest.mark.parametrize("cast", [False, True])
def test_short_and_long_launch_tables_agree(monkeypatch, cast):
    """Short lists take the per-row table path: on random lists (empty
    segments, negative offsets and strides, bases out of range, segments
    past their bases) it gives the vectorised path's table, prefix and
    dtype codes, or the same refusal."""
    rng = np.random.default_rng(11)
    srcs = [torch.zeros(1000, dtype=torch.bfloat16 if cast else torch.float32),
            torch.zeros(500, dtype=torch.bfloat16 if cast else torch.float32)]
    dsts = [torch.zeros(800), torch.zeros(900)]
    outcomes = set()
    for _ in range(600):
        segs = []
        for _ in range(int(rng.integers(1, 10))):
            rows, cols = int(rng.integers(0, 4)), int(rng.integers(0, 50))
            segs.append((int(rng.choice([0, 1, 1, 2])), int(rng.integers(-2, 300)),
                         int(rng.integers(-3, 80)), int(rng.choice([0, 1, -1])),
                         int(rng.integers(-2, 300)),
                         int(rng.integers(cols - 3, cols + 80)), rows, cols))
        segs = np.array(segs, np.int64)
        got = []
        for small in (sc_kernel.SMALL_TABLE, 0):
            monkeypatch.setattr(sc_kernel, "SMALL_TABLE", small)
            try:
                got.append(sc_kernel.launch_table(srcs, dsts, segs))
            except ValueError as e:
                got.append(str(e))
        short, long = got
        if isinstance(short, str):
            assert short == long
            outcomes.add(short)
        else:
            assert np.array_equal(short[0], long[0])
            assert np.array_equal(short[1], long[1]) and short[2:] == long[2:]
            outcomes.add("table")
    assert len(outcomes) == 3  # tables and both refusals were drawn


# -- the launch the wrapper makes -------------------------------------------------
def _seg_launches(monkeypatch, srcs, dsts, segs):
    """The kernel launches (table, prefix, n_seg, total, dtype codes) that
    ``kernel.stream_copy_segments`` makes, the library replaced."""
    import ctypes
    calls = []

    def fake(table, prefix, n_seg, total, s_code, d_code, stream):
        read = lambda p, n: np.ctypeslib.as_array(  # noqa: E731
            ctypes.cast(p, ctypes.POINTER(ctypes.c_int64)), (n,)).copy()
        calls.append((read(table, 8 * n_seg).reshape(n_seg, 8),
                      read(prefix, n_seg + 1), n_seg, total, s_code, d_code))
        return 0

    monkeypatch.setattr(sc_kernel, "_seg_lib", lambda: fake)
    monkeypatch.setattr(common, "stream_handle", lambda device: None)
    sc_kernel.stream_copy_segments(srcs, dsts, segs, torch.device("cpu"))
    return calls


def test_walk_shaped_plan_is_one_launch(monkeypatch):
    """A walk-shaped gather: 48 runs of 16 pages of 64 x 64 fp32 (256 KiB
    each) from two shards into one staging buffer is one launch whose
    prefix sum counts 16-byte units; every run is aligned (vector body)
    and the host flags name each side's memory."""
    pr, dim, run = 64, 64, 16
    fast = torch.zeros(256 * pr * dim)
    slow = torch.zeros(256 * pr * dim)
    runs = [(i % 2, 1 - i % 2, np.arange(run) + 3 * run * (i // 2), i * 4)
            for i in range(48)]
    gather, _ = t_il.move_plan(runs)
    stage = torch.empty(48 * run * pr * dim)
    segs = t_il.element_segments(gather, pr * dim)
    (call,) = _seg_launches(monkeypatch, [fast, slow], [stage], segs)
    table, prefix, n_seg, total, s_code, d_code = call
    units = run * pr * dim * 4 // 16
    assert n_seg == 48 and (s_code, d_code) == (0, 0)
    assert prefix.tolist() == [units * i for i in range(49)]
    assert total == 48 * units
    assert (table[:, 3] == run * pr * dim * 4).all()  # bytes a row
    assert (table[:, 2] == 1).all()
    base = np.where(np.arange(48) % 2 == 0, fast.data_ptr(), slow.data_ptr())
    assert (table[:, 0] == base + gather[:, 1] * pr * dim * 4).all()
    assert (table[:, 1] == stage.data_ptr()
            + gather[:, 3] * pr * dim * 4).all()
    flags = sc_kernel.SRC_HOST | sc_kernel.DST_HOST  # CPU tensors: host
    assert (table[:, 6] == sc_kernel.VEC | flags).all()
    # a source one element off 16 bytes: the element-wise body
    (call,) = _seg_launches(monkeypatch, [fast[1:]], [stage], segs[:1])
    assert call[0][0, 6] == flags


def test_cast_launch_counts_source_units(monkeypatch):
    """A cast counts 16 bytes of source a unit (4 fp32 or 8 bf16) and
    keeps elements in the table; a ragged row rounds its units up."""
    src = torch.zeros(1000)
    dst = torch.zeros(1000, dtype=torch.bfloat16)
    segs = np.array([(0, 0, 10, 0, 0, 12, 3, 10),
                     (0, 100, 0, 0, 100, 0, 0, 5)], np.int64)
    (call,) = _seg_launches(monkeypatch, [src], [dst], segs)
    table, prefix, n_seg, total, s_code, d_code = call
    assert (s_code, d_code) == (0, 1)
    assert prefix.tolist() == [0, 9, 9] and total == 9
    assert table[0, 2:6].tolist() == [3, 10, 10, 12]
    assert table[1, 2:4].tolist() == [0, 0]  # an empty segment moves nothing
    assert _seg_launches(monkeypatch, [src], [dst], segs[1:]) == []


def test_mover_batch_writes_the_named_views():
    """Intended divergence, pinned: a descriptor's ``dst`` may be a view
    of the caller's staging buffer, which the executor writes in place
    (the reference's executors always return a new array).  The batch
    entry takes a whole batch at once; descriptors, bytes and route
    telemetry stay per descriptor, equal to the reference's."""
    rng = np.random.default_rng(3)
    payloads = [torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))
                for _ in range(6)]
    stage = torch.zeros((96, 4))
    views = [stage[16 * i: 16 * (i + 1)] for i in range(6)]
    for execute in (None, t_mv.stream_executor()):
        stage.zero_()
        t_sc.LAUNCHES.reset()
        tel, r_tel = TTel(), RTel()
        with t_mv.BulkMover(t_paper3(), telemetry=tel, batch_size=4,
                            execute=execute, device="cpu") as m, \
                RMover(r_paper3(), telemetry=r_tel, batch_size=4) as rm:
            descs = [t_mv.Descriptor("ddr5-l8", "cxl-a", p, dst=v)
                     for p, v in zip(payloads, views)]
            futs = m.issue(descs)
            m.wait_all()
            rm.issue([RDescriptor("ddr5-l8", "cxl-a", jnp.asarray(p.numpy()))
                      for p in payloads])
            rm.wait_all()
            assert all(f.result().result is v for f, v in zip(futs, views))
            assert (m.descriptors_submitted, m.bytes_submitted) == (
                rm.descriptors_submitted, rm.bytes_submitted)
        assert torch.equal(stage, torch.cat(payloads))
        assert ({k: (v.bytes_moved, v.descriptors, v.batches)
                 for k, v in tel.routes.items()}
                == {k: (v.bytes_moved, v.descriptors, v.batches)
                    for k, v in r_tel.routes.items()})
        assert t_sc.LAUNCHES.count == 0  # host memory: the plain version
    bad = t_mv.stream_executor().batch([t_mv.Descriptor(
        "ddr5-l8", "cxl-a", (payloads[0],), dst=views[0])])
    assert bad is None  # a tuple payload takes the per-descriptor path


class _Event:
    """A stand-in for a CUDA event: complete once ``done`` is set."""

    def __init__(self) -> None:
        self.done = False

    def query(self) -> bool:
        return self.done


def test_host_hold_releases_oldest_first_once_launches_ran():
    hold = common.HostHold()
    a, b, c = torch.zeros(4), torch.ones(4), torch.full((4,), 2.0)
    gone = weakref.ref(a)
    events = [_Event() for _ in range(3)]
    for t, ev in zip((a, b, c), events):
        hold.keep([t], ev)
    del a
    assert gone() is not None and len(hold) == 3
    events[1].done = True
    hold.release()
    assert len(hold) == 3  # the oldest launch is still queued
    events[0].done = True
    hold.release()
    assert gone() is None and len(hold) == 1
    events[2].done = True
    hold.keep([], _Event())  # a keep releases too; nothing new to hold
    assert len(hold) == 0


def test_plain_version_holds_nothing():
    held = len(t_sc.HELD)
    src, dst = torch.arange(64.0), torch.zeros(64)
    t_sc.stream_copy_segments([src], [dst], np.array(
        [(0, 0, 0, 0, 0, 0, 1, 64)], np.int64))
    t_sc.stream_copy(src, out=dst)
    assert torch.equal(dst, src) and len(t_sc.HELD) == held


# -- on the card ------------------------------------------------------------------
@pytest.fixture
def cuda():
    """The card, or a skip: the kernel runs only on CUDA."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel vs plain version)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["hbm->hbm", "pinned->hbm", "hbm->pinned",
                                   "pinned->pinned"])
def test_segments_kernel_matches_plain(cuda, route):
    """Every segment set above and a walk-shaped list, both casts and the
    byte copy, on each route: bit-equal to the plain version, one launch
    a call, nothing outside the segments written."""
    src_mem, dst_mem = route.split("->")

    def place(t, mem):
        return t.to(cuda) if mem == "hbm" else t.pin_memory()

    sets = SEGMENT_SETS + [(64 * 4096, 64 * 4096, [
        (0, 4096 * i, 4096, 0, 4096 * (63 - i), 4096, 1, 4096 - 8 * (i % 3))
        for i in range(64)])]
    for n_src, n_dst, segs in sets:
        segs = np.array(segs, np.int64)
        for sdt, odt in ((torch.float32, torch.float32),
                         (torch.float32, torch.bfloat16),
                         (torch.bfloat16, torch.float32),
                         (torch.bfloat16, torch.bfloat16)):
            host = torch.randn(n_src).to(sdt)
            want = torch.full((n_dst,), -7.0, dtype=odt)
            t_sc_ref.stream_copy_segments([host], [want], segs)
            dst = place(torch.full((n_dst,), -7.0, dtype=odt), dst_mem)
            before = t_sc.LAUNCHES.count
            t_sc.stream_copy_segments([place(host, src_mem)], [dst], segs)
            torch.cuda.synchronize()
            assert t_sc.LAUNCHES.count == before + 1
            assert torch.equal(dst.cpu(), want), (route, sdt, odt, n_src)


@pytest.mark.cuda
def test_card_move_has_no_host_wait_and_lands_in_place(cuda, monkeypatch):
    """A donated move on the card: gather and landing are two launches,
    the host never waits on the stream, the pinned shard keeps its
    storage, and the values are the plain path's."""
    x = torch.arange(64 * 8 * 4, dtype=torch.float32).reshape(-1, 4)
    t = TIT.from_array(x, TPolicy.weighted(("fast", "slow"), (1, 0)), 8,
                       headroom=32, device=cuda)
    ptrs = [p.data_ptr() for p in t.parts]
    waits = []
    monkeypatch.setattr(torch.cuda.Stream, "synchronize",
                        lambda self: waits.append(self))
    t_sc.LAUNCHES.reset()
    t = t.repartition_fraction(0.375, telemetry=TTel(), donate=True)
    assert t_sc.LAUNCHES.count == 2 and waits == []
    monkeypatch.undo()
    assert [p.data_ptr() for p in t.parts] == ptrs
    assert torch.equal(t.to_array().cpu(), x)


@pytest.mark.cuda
@pytest.mark.parametrize("headroom", [0, 32])
def test_dropped_pinned_shard_outlives_the_queued_move(cuda, headroom):
    """The card is held busy, then a move that reads the old pinned shard
    is queued (headroom 0: the rebuild's landing; 32: the copy of the
    receiving shard, not donated).  The caller drops the old tensor at
    once and pins host memory of the shard's size and overwrites it: the
    moved values are still the old shard's."""
    x = torch.arange(64 * 8 * 4, dtype=torch.float32).reshape(-1, 4)
    t = TIT.from_array(x, TPolicy.weighted(("fast", "slow"), (1, 1)), 8,
                       headroom=headroom, device=cuda)
    n = t.parts[1].numel()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of work queued ahead
    t = t.repartition_fraction(0.75, telemetry=TTel(), donate=False)
    grabbed = [torch.empty(n, pin_memory=True).fill_(-1.0) for _ in range(4)]
    torch.cuda.synchronize()
    assert all(torch.equal(g, torch.full_like(g, -1.0)) for g in grabbed)
    assert torch.equal(t.to_array().cpu(), x)
