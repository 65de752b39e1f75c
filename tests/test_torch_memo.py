"""MEMO in both packages: the port's ``repro_torch.core.memo`` and its
``memo_probe`` kernel against the reference's ``repro.core.memo``.

On the CPU: each probe's plain version bit-equal to the reference's
jitted program on the same numpy-seeded inputs (sizes where every fp32 sum
is exact); the three ``measure_*`` calls' records equal field for field
but ``seconds``; the simulate tables equal on the three reference
topologies; ``fit_tier`` recovering a tier from records the perfmodel
generates; the calibration's scaled passes and single-cycle chase.  On a
CUDA card only: each probe kernel on HBM and on pinned host memory
against its plain version."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import memo as r_memo  # noqa: E402
from repro.core import tiers as r_tiers  # noqa: E402
from repro_torch.core import memo as t_memo  # noqa: E402
from repro_torch.core import perfmodel as t_perfmodel  # noqa: E402
from repro_torch.core import tiers as t_tiers  # noqa: E402
from repro_torch.kernels.memo_probe import ops as t_probe  # noqa: E402
from repro_torch.kernels.memo_probe import ref as t_ref  # noqa: E402

NBYTES = 4096  # 1024 fp32 elements: arange sums stay below 2^24
LANES = (1, 2, 4, 8)


def _x():
    return np.arange(NBYTES // 4, dtype=np.float32)


# -- each probe's plain version against the reference's program ---------------
def _seq_load():
    for lanes in LANES:
        want = np.asarray(r_memo._seq_load(jnp.asarray(_x()), lanes))
        got = t_probe.seq_load(torch.from_numpy(_x()), lanes)
        yield want, got.numpy()


def _seq_store():
    for lanes in LANES:
        v = np.random.default_rng(lanes).integers(-8, 9, lanes).astype(
            np.float32)
        want = np.asarray(r_memo._seq_store(jnp.asarray(_x()), lanes,
                                            jnp.asarray(v)))
        x = torch.from_numpy(_x())
        got = t_probe.seq_store(x, lanes, torch.from_numpy(v))
        assert got.data_ptr() == x.data_ptr()  # in place
        yield want, got.numpy()


def _random_block_load():
    rng = np.random.default_rng(0)
    n = NBYTES // 4
    for be in (1, 16, 37, 256):
        starts = rng.integers(0, n - be, size=64).astype(np.int32)
        want = np.asarray(r_memo._random_block_load(
            jnp.asarray(_x()), jnp.asarray(starts), be))
        got = t_probe.random_block_load(torch.from_numpy(_x()),
                                        torch.from_numpy(starts), be)
        yield want, got.numpy()


def _pointer_chase():
    perm = np.random.default_rng(0).permutation(NBYTES // 4).astype(np.int32)
    for steps in (0, 1, 1000):
        want = np.asarray(r_memo._pointer_chase(jnp.asarray(perm),
                                                jnp.int32(steps)))
        got = t_probe.pointer_chase(torch.from_numpy(perm), steps)
        yield want, got.numpy()


@pytest.mark.parametrize("probe", [_seq_load, _seq_store, _random_block_load,
                                   _pointer_chase])
def test_plain_probes_bit_equal_to_the_reference(probe):
    before = t_probe.LAUNCHES.count
    for want, got in probe():
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want)
    assert t_probe.LAUNCHES.count == before  # the CPU launches nothing


def test_random_block_starts_clamp_like_dynamic_slice():
    """Starts outside the table are placed as ``lax.dynamic_slice``
    places them (a negative start counts from the end, then each is
    clamped); two lanes of starts give one sum a lane."""
    x = torch.arange(100, dtype=torch.float32)
    starts = torch.tensor([[-5, 98], [0, 200], [-300, 50]],
                          dtype=torch.int32)
    got = t_probe.random_block_load(x, starts, 4)
    want = [float(x[95:99].sum() + x[96:100].sum()),
            float(x[0:4].sum() + x[96:100].sum()),
            float(x[0:4].sum() + x[50:54].sum())]
    assert got.tolist() == want
    for row, w in zip(starts.numpy(), want):
        ref = r_memo._random_block_load(jnp.arange(100, dtype=jnp.float32),
                                        jnp.asarray(row), 4)
        assert float(ref) == w


# -- measure mode: the reference's records ------------------------------------
MEASURES = {
    "sequential": (dict(nbytes=NBYTES), r_memo.measure_sequential,
                   t_memo.measure_sequential),
    "random_block": (dict(table_bytes=1 << 16,
                          block_bytes_list=(1024, 4096), n_blocks=16),
                     r_memo.measure_random_block,
                     t_memo.measure_random_block),
    "pointer_chase": (dict(n_elems=1 << 12, steps=1 << 8),
                      r_memo.measure_pointer_chase,
                      t_memo.measure_pointer_chase),
}


@pytest.mark.parametrize("name", sorted(MEASURES))
def test_measure_records_equal_but_seconds(name):
    kwargs, ref_fn, port_fn = MEASURES[name]
    want, got = ref_fn(**kwargs), port_fn(**kwargs, device="cpu")
    if name == "pointer_chase":
        want, got = [want], [got]
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g.seconds > 0
        assert (dataclasses.replace(g, seconds=0.0)
                == t_memo.Record(**{**dataclasses.asdict(w), "seconds": 0.0}))
        assert g.tier == "local"  # the default call, as in the reference


def test_memory_names_the_cards_memory():
    """Intended divergence: ``memory=`` picks HBM or pinned host memory on
    the card (records then name the tier); the CPU measures the host's
    only, and the default device is the card."""
    assert {k: v.name for k, v in t_memo.MEMORIES.items()} == {
        "hbm": "h100-hbm", "pinned": "h100-host-pinned"}
    for memory in ("hbm", "pinned"):
        with pytest.raises(ValueError, match="card"):
            t_memo.measure_pointer_chase(1 << 10, 4, device="cpu",
                                         memory=memory)
    with pytest.raises(ValueError, match="memory is one of"):
        t_memo.measure_sequential(NBYTES, device="cpu", memory="ddr")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_memo.measure_sequential(NBYTES)


def test_scaled_passes_read_whole_windows():
    """The calibration's form on the CPU: every launch reads whole lane
    windows on 16-byte boundaries within the buffer; random blocks and
    the chase grow from their first run; ``calibrate`` needs the card."""
    nbytes = 1 << 18
    recs = t_memo.measure_sequential(nbytes, (1, 3, 8), device="cpu",
                                     pass_seconds=1e-3)
    assert [(r.op, r.lanes) for r in recs] == [
        ("load", 1), ("store", 1), ("load", 3), ("store", 3), ("load", 8),
        ("store", 8), ("copy", 1)]
    for r in recs:
        per = r.bytes_moved // (2 if r.op == "copy" else 1)
        assert 0 < per <= nbytes and per % (16 * r.lanes) == 0, r
        assert r.seconds > 0 and r.block_bytes == nbytes
    (rand,) = t_memo.measure_random_block(1 << 16, (1024,), 8, device="cpu",
                                          pass_seconds=1e-3)
    assert rand.bytes_moved >= 8 * 1024 and rand.bytes_moved % 1024 == 0
    chase = t_memo.measure_pointer_chase(1 << 12, 16, device="cpu",
                                         cycle=True, pass_seconds=1e-3)
    assert chase.bytes_moved >= 16 * 4
    with pytest.raises(ValueError, match="card"):
        t_memo.calibrate("hbm", device="cpu")


@pytest.mark.parametrize("n", [1, 2, 1000, 4097])
def test_single_cycle_visits_every_element(n):
    perm = t_memo.single_cycle(n, seed=n)
    assert perm.dtype == np.int32 and sorted(perm.tolist()) == list(range(n))
    p, seen = 0, set()
    for _ in range(n):
        seen.add(p)
        p = int(perm[p])
    assert p == 0 and len(seen) == n
    assert np.array_equal(perm, t_memo.single_cycle(n, seed=n))


# -- simulate mode: identical tables ------------------------------------------
TOPOLOGIES = ("paper_topology", "tpu_v5e_topology",
              "paper_three_device_topology")
SIMULATE = ("simulate_latency", "simulate_seq_bw", "simulate_random_bw",
            "simulate_movement")


@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("fn", SIMULATE)
def test_simulate_rows_equal_reference(topo, fn):
    want = getattr(r_memo, fn)(getattr(r_tiers, topo)())
    got = getattr(t_memo, fn)(getattr(t_tiers, topo)())
    assert got == want


# -- fit_tier: a tier back from the perfmodel's own curves --------------------
GRID = (1, 2, 4, 8, 12, 16, 24, 26, 32, 48, 64, 96, 128)


def _model_records(tier):
    """The records a perfect measurement of ``tier`` would give: each
    rate as the bytes of one second (so the peak reads back exactly)."""
    recs = []
    for op in (t_tiers.OpClass.LOAD, t_tiers.OpClass.STORE):
        for n in GRID:
            bw = t_perfmodel.stream_bandwidth(tier, op, n)
            recs.append(t_memo.Record("seq", tier.name, op.value, n, 1 << 30,
                                      1.0, int(bw)))
    recs.append(t_memo.Record("seq", tier.name, "copy", 1, 1 << 30, 1.0,
                              int(2 * tier.nt_store_bw)))
    rand = t_perfmodel.random_block_bandwidth(tier, t_tiers.OpClass.LOAD,
                                              1024, 1)
    recs.append(t_memo.Record("rand", tier.name, "load", 1, 1024, 1.0,
                              int(rand)))
    steps = 1 << 14
    recs.append(t_memo.Record("ptr-chase", tier.name, "load", 1, 4,
                              steps * tier.chase_latency_ns * 1e-9,
                              steps * 4))
    return recs


def _on_grid(streams):
    """The smallest grid point at or above a model stream count."""
    return min(n for n in GRID if n >= streams)


@pytest.mark.parametrize("name", ["cxl-agilex", "ddr5-l8"])
def test_fit_tier_round_trip(name):
    tier = t_tiers.DEVICE_REGISTRY[name]
    blank = dataclasses.replace(tier, load_bw=1.0, store_bw=1.0,
                                nt_store_bw=1.0, load_latency_ns=1.0,
                                chase_latency_ns=1.0, load_peak_streams=1,
                                store_peak_streams=1,
                                load_collapse_streams=1,
                                store_collapse_streams=1,
                                collapse_factor=0.5)
    fit = t_memo.fit_tier(_model_records(tier), blank,
                          capacity_bytes=12345)
    assert fit.load_bw == tier.load_bw and fit.store_bw == tier.store_bw
    assert fit.nt_store_bw == tier.nt_store_bw
    assert fit.load_peak_streams == _on_grid(tier.load_peak_streams)
    assert fit.store_peak_streams == _on_grid(tier.store_peak_streams)
    assert fit.load_latency_ns == pytest.approx(tier.load_latency_ns,
                                                rel=0.01)
    assert fit.chase_latency_ns == pytest.approx(tier.chase_latency_ns,
                                                 rel=1e-9)
    assert fit.capacity_bytes == 12345
    assert (fit.name, fit.kind, fit.link_bw) == (tier.name, tier.kind,
                                                 tier.link_bw)
    if name == "cxl-agilex":  # collapses past 12 (loads) and 4 (stores)
        assert fit.load_collapse_streams == tier.load_collapse_streams
        assert fit.store_collapse_streams == tier.store_collapse_streams
        assert fit.collapse_factor == pytest.approx(tier.collapse_factor,
                                                    abs=1e-3)
    else:  # falls to 0.95 of peak at most: within the share, no collapse
        assert fit.load_collapse_streams == t_memo.NO_COLLAPSE
        assert fit.store_collapse_streams == t_memo.NO_COLLAPSE
        assert fit.collapse_factor == 1.0


def test_fit_sweep_reads_peak_and_collapse():
    assert t_memo.fit_sweep({1: [10.0], 2: [19.0], 4: [20.0], 8: [20.0]}) == (
        20.0, 2, t_memo.NO_COLLAPSE, 1.0)
    assert t_memo.fit_sweep({1: [10.0], 2: [20.0], 4: [19.5], 8: [12.0],
                             16: [10.0]}) == (20.0, 2, 4, 0.5)


def test_fit_sweep_over_runs_reads_no_threshold_from_noise():
    """Several runs: the peak is the median curve's; a lane count falls
    short of it only where every run reads it short."""
    # one run of three reads 8+ lanes at the peak: no collapse, and 2
    # lanes reach it in one run, so they count as peak streams
    noisy = {1: [10.0, 11.0, 9.0], 2: [14.0, 20.0, 15.0],
             4: [15.0, 16.0, 20.0], 8: [20.0, 12.0, 14.0],
             16: [13.0, 12.0, 19.5]}
    assert t_memo.fit_sweep(noisy) == (16.0, 2, t_memo.NO_COLLAPSE, 1.0)
    # every run falls past 4 lanes: the collapse stands
    falls = {1: [10.0, 9.0, 11.0], 2: [20.0, 19.5, 19.8],
             4: [19.9, 20.1, 20.0], 8: [12.0, 13.0, 11.0],
             16: [10.0, 9.0, 10.5]}
    assert t_memo.fit_sweep(falls) == (20.0, 2, 4, 0.5)


def test_fit_tier_over_runs_takes_medians():
    """Records of three runs fit as one: every field is the median run's,
    and one run alone fits the same fields as the three together where
    they agree."""
    tier = t_tiers.DEVICE_REGISTRY["cxl-agilex"]
    base = _model_records(tier)

    def scaled(k):
        return [dataclasses.replace(r, seconds=r.seconds * k) for r in base]
    runs = scaled(1.0) + scaled(1.01) + scaled(0.995)
    one = t_memo.fit_tier(base, tier)
    three = t_memo.fit_tier(runs, tier)
    assert dataclasses.asdict(three) == dataclasses.asdict(one)
    with pytest.raises(ValueError, match="one-lane"):
        t_memo.fit_tier([t_memo.Record("seq", "t", "load", 2, 1, 1.0, 8),
                         t_memo.Record("rand", "t", "load", 1, 1024, 1.0, 4)],
                        t_tiers.H100_HBM)


def test_memo_probe_is_one_of_the_built_kernels():
    """The probe's source builds with the other kernels (one ``nvcc``
    each, from the checkout) and names the programs it replaces."""
    from repro_torch.kernels import common
    assert "memo_probe" in common.KERNELS
    src = (common.CSRC / "memo_probe.cu").read_text()
    for program in ("_seq_load", "_seq_store", "_random_block_load",
                    "_pointer_chase"):
        assert program in src
    for entry in ("repro_memo_seq_load", "repro_memo_seq_store",
                  "repro_memo_random_block_load", "repro_memo_pointer_chase"):
        assert f'extern "C" int {entry}(' in src
    assert common.library_path("memo_probe").parent == common.BUILD_DIR


def test_kernel_wrappers_refuse_before_any_build():
    """What the kernels do not take is refused in Python, before a
    library is built or loaded."""
    from repro_torch.kernels.memo_probe import kernel as t_kernel
    cpu = torch.device("cpu")
    bad = [
        lambda: t_kernel.seq_load(torch.zeros(10), 3, cpu),
        lambda: t_kernel.seq_load(torch.zeros(12, dtype=torch.bfloat16), 3,
                                  cpu),
        lambda: t_kernel.seq_store(torch.zeros(12), 3, torch.zeros(3), cpu),
        lambda: t_kernel.random_block_load(
            torch.zeros(64), torch.zeros(4, dtype=torch.int64), 8, cpu),
        lambda: t_kernel.random_block_load(
            torch.zeros(64), torch.zeros(4, dtype=torch.int32), 65, cpu),
        lambda: t_kernel.pointer_chase(torch.zeros(8, dtype=torch.int32), 4,
                                       8, cpu),
        lambda: t_kernel.pointer_chase(torch.zeros(8, dtype=torch.int64), 4,
                                       0, cpu),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    assert not t_kernel._fns


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def cuda():
    """The card, or a skip: the probe kernels run only on CUDA."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel vs plain version)")
    return torch.device("cuda")


def _placed(t, memory, cuda):
    return t.to(cuda) if memory == "hbm" else t.pin_memory()


@pytest.mark.cuda
@pytest.mark.parametrize("memory", ["hbm", "pinned"])
def test_probe_kernels_match_plain(cuda, memory):
    """Each entry point on the card, bit-equal to its plain version (exact
    integer sums), one launch a call; views off a 16-byte boundary and
    ragged lane slices take the scalar head and tail."""
    g = torch.Generator().manual_seed(0)
    t_probe.LAUNCHES.reset()
    calls = 0
    for n, lanes, off in ((1024, 1, 0), (4096, 8, 0), (65536, 132, 1),
                          (10007, 7, 3)):
        nn = n - n % lanes
        host = torch.randint(-8, 9, (nn + off,), generator=g).float()
        x = _placed(host, memory, cuda)[off:]
        assert torch.equal(t_probe.seq_load(x, lanes).cpu(),
                           t_ref.seq_load(host[off:], lanes))
        v = torch.randint(-8, 9, (lanes,), generator=g).float()
        t_probe.seq_store(x, lanes, v)
        torch.cuda.synchronize()
        assert torch.equal(x.cpu(), t_ref.seq_store(host[off:].clone(),
                                                    lanes, v))
        calls += 2
    host = torch.randint(-8, 9, (1 << 16,), generator=g).float()
    x = _placed(host, memory, cuda)
    for be, shape in ((256, (128,)), (37, (3, 50)), (4096, (2, 8))):
        starts = torch.randint(-64, (1 << 16) + 64, shape, generator=g,
                               dtype=torch.int32)
        got = t_probe.random_block_load(x, starts, be)
        assert got.is_cuda and torch.equal(
            got.cpu(), t_ref.random_block_load(host, starts, be))
        calls += 1
    perm = torch.from_numpy(t_memo.single_cycle(1 << 12, 0))
    got = t_probe.pointer_chase(_placed(perm, memory, cuda), 5000)
    assert int(got) == int(t_ref.pointer_chase(perm, 5000))
    assert t_probe.LAUNCHES.count == calls + 1
