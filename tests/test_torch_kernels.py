"""Differential tests for the port's kernels: each plain PyTorch version
against the reference's Pallas ops (interpret mode on the CPU), the CPU
dispatch of each wrapper, and — on a CUDA card only — each hand-written
kernel against its plain version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import interleave as r_il  # noqa: E402
from repro.core.policy import MemPolicy as RPolicy  # noqa: E402
from repro.core.telemetry import Telemetry as RTel  # noqa: E402
from repro.kernels.embedding_reduce import ops as r_er  # noqa: E402
from repro.kernels.stream_copy import ops as r_sc  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.embedding_reduce import kernel as t_er_kernel  # noqa: E402
from repro_torch.kernels.embedding_reduce import ops as t_er, ref as t_er_ref  # noqa: E402
from repro_torch.kernels.stream_copy import ops as t_sc, ref as t_sc_ref  # noqa: E402

BF16_TOL = dict(atol=0.3, rtol=0.05)


def _bf16(x: np.ndarray):
    """The same bf16 values in both frameworks (rounded once, by jax)."""
    j = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)
    return j, t


def _pair(x: np.ndarray, dtype: str):
    if dtype == "bfloat16":
        return _bf16(x)
    return jnp.asarray(x, jnp.float32), torch.from_numpy(
        np.ascontiguousarray(x, np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture
def cuda():
    """The card, or a skip: the kernels themselves run only on CUDA."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel vs plain version)")
    return torch.device("cuda")


# -- embedding_reduce: plain version vs the Pallas ops ---------------------------
@pytest.mark.parametrize("V,D,B,K", [(32, 64, 2, 4), (128, 128, 8, 16),
                                     (256, 256, 4, 32), (64, 512, 1, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_reduce_sweep(V, D, B, K, dtype):
    rng = np.random.default_rng(V + D + B + K)
    table_j, table_t = _pair(rng.normal(size=(V, D)), dtype)
    idx = rng.integers(0, V, size=(B, K))
    w = rng.uniform(size=(B, K)).astype(np.float32)
    ref = r_er.embedding_reduce(table_j, jnp.asarray(idx), jnp.asarray(w))
    got = t_er.embedding_reduce(table_t, torch.from_numpy(idx),
                                torch.from_numpy(w))
    assert got.dtype == table_t.dtype and got.shape == (B, D)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(ref), atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(_np(got), _np(ref), **BF16_TOL)


@pytest.mark.parametrize("seed", range(10))
def test_embedding_reduce_property(seed):
    """Plain == Pallas for arbitrary index multisets incl. duplicates."""
    rng = np.random.default_rng(seed)
    V, D = 64, 128
    B, K = int(rng.integers(1, 6)), int(rng.integers(1, 12))
    table = rng.normal(size=(V, D)).astype(np.float32)
    idx = rng.integers(0, V, size=(B, K))
    w = rng.uniform(size=(B, K)).astype(np.float32)
    ref = r_er.embedding_reduce(jnp.asarray(table), jnp.asarray(idx),
                                jnp.asarray(w))
    got = t_er.embedding_reduce(torch.from_numpy(table), torch.from_numpy(idx),
                                torch.from_numpy(w))
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embedding_reduce_integer_tables_bit_exact(dtype):
    """Integer-valued tables and weights: every sum is exact in any order,
    so the plain version equals the Pallas kernel bit for bit, zero
    weights and duplicates included."""
    rng = np.random.default_rng(7)
    V, D, B, K = 96, 64, 16, 80
    table_j, table_t = _pair(rng.integers(-8, 9, size=(V, D)), dtype)
    idx = rng.integers(0, V, size=(B, K))
    idx[:, 1] = idx[:, 0]
    w = rng.integers(0, 3, size=(B, K)).astype(np.float32)
    w_j, w_t = _pair(w, dtype)
    ref = r_er.embedding_reduce(table_j, jnp.asarray(idx), w_j)
    got = t_er.embedding_reduce(table_t, torch.from_numpy(idx), w_t)
    assert np.array_equal(_np(got), _np(ref))


def test_embedding_reduce_plain_sums_in_k_order():
    """The plain version adds lookup by lookup (not a tree sum): a
    cancellation that depends on the order comes out as in-order fp32."""
    table = torch.tensor([[1e8], [1.0], [-1e8]], dtype=torch.float32)
    idx = torch.tensor([[0, 1, 2]])
    w = torch.ones((1, 3))
    assert t_er_ref.embedding_reduce(table, idx, w).item() == 0.0
    assert t_er_ref.embedding_reduce(table, torch.tensor([[0, 2, 1]]),
                                     w).item() == 1.0


# -- embedding_reduce, routed form: plain version vs the reference -----------------
THREE = ("fast", "cxl-a", "cxl-b")
#: (device names, weights, page_rows, headroom, drained device): two shards;
#: the three-device drain map of test_three_device_drain_and_reassign_equal
#: (cxl-a keeps its capacity, no pages); a shard of 0 rows
ROUTED_CASES = {
    "two": (("fast", "slow"), (3, 1), 8, 4, None),
    "three_drained": (THREE, (4, 2, 2), 4, 16, "cxl-a"),
    "empty_shard": (THREE, (3, 0, 1), 4, 0, None),
}


def _sharded(table: np.ndarray, case: str, dtype: str):
    """A reference InterleavedTensor over ``table`` and its shards and page
    maps as torch tensors (the same values)."""
    names, weights, page_rows, headroom, drained = ROUTED_CASES[case]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    r = r_il.InterleavedTensor.from_array(
        jnp.asarray(table, jnp.float32).astype(jdt),
        RPolicy.weighted(names, weights), page_rows, headroom=headroom)
    if drained is not None:
        r = r.drain_device(drained, telemetry=RTel())
    parts = [torch.from_numpy(np.array(p.astype(jnp.float32))).to(
        getattr(torch, dtype)) for p in r.parts]
    maps = (torch.from_numpy(np.asarray(r.page_device).astype(np.int8)),
            torch.from_numpy(np.asarray(r.page_local).astype(np.int64)))
    return r, parts, maps, page_rows


def _bags(rng, rows: int, page_rows: int, B: int, K: int) -> np.ndarray:
    """Random bags with duplicates and negative and out-of-range rows."""
    idx = rng.integers(0, rows, size=(B, K))
    idx[:, 1] = idx[:, 0]
    idx[0, 2:8] = [-1, -page_rows - 3, -10 ** 6, rows, rows + 5, 10 ** 6]
    return idx


@pytest.mark.parametrize("case", sorted(ROUTED_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [True, False])
def test_bag_reduce_routed_plain_bit_exact_with_pallas(case, dtype, weighted):
    """Integer tables: the routed plain version equals the reference's
    per-shard path with its Pallas kernel bit for bit (zero weights,
    duplicates, negative and out-of-range rows, empty shards)."""
    rng = np.random.default_rng(len(case) + 3 * weighted)
    rows = 61
    table = rng.integers(-8, 9, size=(rows, 16)).astype(np.float32)
    r, parts, (pd, pl), page_rows = _sharded(table, case, dtype)
    idx = _bags(rng, rows, page_rows, 3, 12)
    w = rng.integers(0, 3, size=idx.shape).astype(np.float32)
    ref = r.bag_reduce(jnp.asarray(idx), jnp.asarray(w) if weighted else None,
                       reduce_fn=r_er.embedding_reduce)
    got = t_er.bag_reduce_routed(parts, pd, pl, page_rows,
                                 torch.from_numpy(idx),
                                 torch.from_numpy(w) if weighted else None)
    assert got.dtype == parts[0].dtype and got.shape == (3, 16)
    assert np.array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("case", sorted(ROUTED_CASES))
def test_bag_reduce_routed_plain_random_tables(case):
    rng = np.random.default_rng(21)
    rows = 61
    table = rng.normal(size=(rows, 8)).astype(np.float32)
    r, parts, (pd, pl), page_rows = _sharded(table, case, "float32")
    idx = _bags(rng, rows, page_rows, 4, 10)
    w = rng.uniform(size=idx.shape).astype(np.float32)
    ref = r.bag_reduce(jnp.asarray(idx), jnp.asarray(w),
                       reduce_fn=r_er.embedding_reduce)
    got = t_er.bag_reduce_routed(parts, pd, pl, page_rows,
                                 torch.from_numpy(idx), torch.from_numpy(w))
    np.testing.assert_allclose(_np(got), _np(ref), atol=1e-5)


def test_bag_reduce_routed_route_floors_negative_rows():
    """Pages are floors (not truncations) and offsets come from the
    unclamped page: row -1 is page -1's last row, clipped to page 0."""
    pd = torch.tensor([0, 1], dtype=torch.int8)
    pl = torch.tensor([0, 0], dtype=torch.int64)
    dev, local = t_er_ref.route(torch.tensor([-1, -4, -5, 3, 4, 9, 100]), pd,
                                pl, 4)
    assert dev.tolist() == [0, 0, 0, 0, 1, 1, 1]
    assert local.tolist() == [3, 0, 3, 3, 0, 1, 0]


class _CudaStandIn:
    """Stands for a CUDA tensor in the wrappers' dispatch checks."""
    is_cuda = True
    device = torch.device("cuda", 0)

    def is_pinned(self) -> bool:
        return False


def test_bag_reduce_routed_refusals():
    """More than four shards raise on any device (no loop of per-shard
    launches); pageable host memory beside a CUDA tensor raises instead of
    taking the plain version."""
    part = torch.zeros((8, 4))
    pd = torch.zeros(2, dtype=torch.int8)
    pl = torch.tensor([0, 1])
    idx = torch.zeros((2, 3), dtype=torch.int64)
    t_er.LAUNCHES.reset()
    with pytest.raises(ValueError, match="1 to 4 shards"):
        t_er.bag_reduce_routed([part] * 5, pd, pl, 4, idx)
    with pytest.raises(ValueError, match="1 to 4 shards"):
        t_er.bag_reduce_routed([], pd, pl, 4, idx)
    with pytest.raises(ValueError, match="pinned"):
        t_er.bag_reduce_routed([_CudaStandIn(), part], pd, pl, 4, idx)
    with pytest.raises(ValueError, match="pinned"):
        t_er.embedding_reduce(part, _CudaStandIn(), torch.ones((2, 3)))
    assert t_er.LAUNCHES.count == 0
    assert t_er.bag_reduce_routed([part] * 4, pd, pl, 4, idx).shape == (2, 4)
    assert t_er.LAUNCHES.count == 0  # the plain version counts nothing


def test_bag_reduce_staged_path_engages_by_input():
    """The staged path: a shard with rows in pinned memory, at least
    ``STAGE_MIN_LOOKUPS`` lookups and 16-byte rows; its workspace is a
    counter a 2^REGION_LOG2-byte region of the pinned shards (here host
    tensors, as pinned ones are not CUDA tensors) and 16 + 4 + a row's
    bytes a lookup."""
    n = t_er_kernel.STAGE_MIN_LOOKUPS
    assert t_er_kernel.stages([False, True], n, 4)
    assert t_er_kernel.stages([True, True, True], n + 1, 8)
    assert not t_er_kernel.stages([False, True], n - 1, 4)
    assert not t_er_kernel.stages([False, False], n, 4)
    assert not t_er_kernel.stages([False, True], n, 1)
    region_rows = (1 << t_er_kernel.REGION_LOG2) // 256
    parts = [torch.empty((3 * region_rows + 1, 64)), torch.empty((0, 64)),
             torch.empty((region_rows, 64))]
    regions = 4 + 1
    assert t_er_kernel.staged_bytes(parts, 1000, 256) == (
        -(-4 * (regions + 1) // 16) * 16 + 16 * 1000 + 4000 + 1000 * 256)


# -- stream_copy: plain version vs the Pallas ops --------------------------------
@pytest.mark.parametrize("shape,block", [((256, 64), 64), ((512, 128), 256),
                                         ((128, 32), 128)])
@pytest.mark.parametrize("dtype,out_dtype", [
    ("float32", None), ("float32", "bfloat16"), ("bfloat16", None)])
def test_stream_copy_sweep(shape, block, dtype, out_dtype):
    rng = np.random.default_rng(shape[0] + block)
    x_j, x_t = _pair(rng.normal(size=shape), dtype)
    odt_j = {None: None, "bfloat16": jnp.bfloat16}[out_dtype]
    odt_t = {None: None, "bfloat16": torch.bfloat16}[out_dtype]
    ref = r_sc.stream_copy(x_j, out_dtype=odt_j, block_rows=block)
    got = t_sc.stream_copy(x_t, out_dtype=odt_t)
    assert str(got.dtype).split(".")[-1] == str(ref.dtype)
    assert got.data_ptr() != x_t.data_ptr()
    assert np.array_equal(_np(got), _np(ref))


@pytest.mark.parametrize("shape", [(1, 8), (7, 16), (100, 16), (300, 8),
                                   (513, 4), (5, 1), (64, 3), (1024, 128)])
@pytest.mark.parametrize("block", [4, 64, 256])
def test_stream_copy_ragged_sweep(shape, block):
    """Any row count, fused casts both ways: bit-exact against the
    reference kernel's ragged pipeline."""
    rng = np.random.default_rng(shape[0] * shape[1] + block)
    x = rng.normal(size=shape).astype(np.float32)
    x_j, x_t = jnp.asarray(x), torch.from_numpy(x)
    assert np.array_equal(_np(t_sc.stream_copy(x_t)),
                          _np(r_sc.stream_copy(x_j, block_rows=block)))
    down_j = r_sc.stream_copy(x_j, out_dtype=jnp.bfloat16, block_rows=block)
    down_t = t_sc.stream_copy(x_t, out_dtype=torch.bfloat16)
    assert np.array_equal(_np(down_t), _np(down_j))
    up_j = r_sc.stream_copy(x_j.astype(jnp.bfloat16), out_dtype=jnp.float32,
                            block_rows=block)
    up_t = t_sc.stream_copy(x_t.to(torch.bfloat16), out_dtype=torch.float32)
    assert up_t.dtype == torch.float32
    assert np.array_equal(_np(up_t), _np(up_j))


def test_stream_copy_into_given_out():
    x = torch.arange(12.0).reshape(3, 4)
    out = torch.empty((3, 4), dtype=torch.bfloat16)
    assert t_sc.stream_copy(x, out=out) is out
    assert torch.equal(out, x.to(torch.bfloat16))
    assert torch.equal(t_sc_ref.stream_copy(x), x)


def test_stream_copy_row_strided_windows_take_the_plain_version():
    """A column window of a wider buffer on each side (a KV run slab's
    layout): on the CPU the plain copy fills exactly the window."""
    x = torch.arange(60.0).reshape(5, 12)
    dst = torch.zeros((5, 10), dtype=torch.bfloat16)
    t_sc.stream_copy(x[:, 2:9], out=dst[:, 1:8])
    assert torch.equal(dst[:, 1:8], x[:, 2:9].to(torch.bfloat16))
    dst[:, 1:8] = 0
    assert not dst.any()


def _launch_args(monkeypatch, src, out):
    """The arguments ``stream_copy``'s wrapper would pass to the kernel."""
    from repro_torch.kernels.stream_copy import kernel as sc_kernel
    calls = []
    monkeypatch.setattr(sc_kernel, "_lib",
                        lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(common, "stream_handle", lambda device: None)
    sc_kernel.stream_copy(src, out, torch.device("cpu"))
    (args,) = calls
    return args[2:10]  # rows, cols, ss, ds, dtype codes, itemsize, vec


@pytest.mark.parametrize("d_off,vec", [(0, 1), (1, 0)])
def test_stream_copy_launch_layout_of_a_pool_run_slab(monkeypatch, d_off,
                                                      vec):
    """A KV run slab ``pool[:, b, rows].flatten(1)`` is one row per layer,
    rows the pool's layer stride apart; the 16-byte vector body runs only
    when every row starts aligned on both sides."""
    L, B, T, K, hd = 3, 4, 16, 2, 8
    pool = torch.zeros((L, B, T, K, hd), dtype=torch.bfloat16)
    slab = pool[:, 1, 8:16].flatten(1)
    buf = torch.empty((L, slab.shape[1] + 8), dtype=torch.float32)
    out = buf[:, d_off:d_off + slab.shape[1]]
    assert _launch_args(monkeypatch, slab, out) == (
        L, 8 * K * hd, B * T * K * hd, slab.shape[1] + 8, 1, 0, 2, vec)


def test_stream_copy_launch_layout_of_a_contiguous_slab(monkeypatch):
    """A contiguous slab of any shape is one row of all its elements."""
    x = torch.zeros((5, 12))
    assert _launch_args(monkeypatch, x, torch.empty((5, 12))) == (
        1, 60, 60, 60, 0, 0, 4, 1)
    assert _launch_args(monkeypatch, x.view(-1)[1:],
                        torch.empty(59))[-1] == 0


# -- wrappers: CPU dispatch, counters, build --------------------------------------
def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    t_er.LAUNCHES.reset()
    t_sc.LAUNCHES.reset()
    table = torch.randn(16, 8)
    t_er.embedding_reduce(table, torch.zeros((2, 3), dtype=torch.int64),
                          torch.ones(2, 3))
    t_sc.stream_copy(table)
    assert (t_er.LAUNCHES.count, t_sc.LAUNCHES.count) == (0, 0)
    assert common.card_device(table) is None


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No compiler, no kernel: the build raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        common.build(["stream_copy"])
    lib = common.library_path("embedding_reduce")
    assert lib.name.startswith("libembedding_reduce-") and lib.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in common.NVCC_FLAGS
    assert "--fmad=false" in common.NVCC_FLAGS


# -- the hand-written kernels, on the card ---------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("memory", ["hbm", "pinned"])
def test_embedding_reduce_kernel_matches_plain(cuda, dtype, memory):
    g = torch.Generator().manual_seed(0)
    table = torch.randn((4096, 64), generator=g).to(dtype)
    idx = torch.randint(0, 4096, (256, 80), generator=g)
    idx[:, 1] = idx[:, 0]
    w = torch.rand((256, 80), generator=g).to(dtype)
    w[:, ::7] = 0
    tab = table.to(cuda) if memory == "hbm" else table.pin_memory()
    before = t_er.LAUNCHES.count
    got = t_er.embedding_reduce(tab, idx.to(cuda), w.to(cuda))
    want = t_er_ref.embedding_reduce(table.to(cuda), idx.to(cuda), w.to(cuda))
    torch.cuda.synchronize()
    assert t_er.LAUNCHES.count == before + 1
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(), **BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_embedding_reduce_kernel_reads_indices_as_given(cuda, index_dtype):
    """fp32, bit for bit, through int32 and int64 indices (no cast launch):
    the vector path, the scalar path (D = 24), column tiles (D = 512) and
    bags longer than the staging area (K = 600)."""
    g = torch.Generator().manual_seed(4)
    for V, D, B, K in ((4096, 64, 256, 80), (300, 24, 17, 5),
                       (64, 512, 3, 33), (1000, 64, 9, 600)):
        table = torch.randn((V, D), generator=g)
        idx = torch.randint(0, V, (B, K), generator=g)
        w = torch.rand((B, K), generator=g)
        w[:, ::5] = 0
        got = t_er.embedding_reduce(table.to(cuda), idx.to(cuda, index_dtype),
                                    w.to(cuda))
        want = t_er_ref.embedding_reduce(table, idx, w)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), (V, D, B, K)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slow", [0.0, 0.10, 0.5])
def test_bag_reduce_routed_kernel_equals_per_shard_kernels(cuda, dtype, slow):
    """An HBM shard and a pinned shard: one routed launch per bag_reduce
    call, equal bit for bit to the table-form kernel per shard summed in
    shard order; int32 and int64 indices, negative and out-of-range rows,
    given weights (also fp32 over a bf16 table) or none."""
    from repro_torch.core.interleave import InterleavedTensor
    from repro_torch.core.policy import MemPolicy
    from repro_torch.core.telemetry import Telemetry
    g = torch.Generator().manual_seed(5)
    rows, page_rows = 64 * 300, 64
    table = torch.randn((rows, 64), generator=g).to(dtype)
    it = InterleavedTensor.from_array(
        table, MemPolicy.weighted(("fast", "slow"), (1, 0)), page_rows,
        headroom=160, device=cuda)
    it = it.repartition_fraction(slow, telemetry=Telemetry(), donate=True)
    assert it.parts[0].is_cuda and it.parts[1].is_pinned()
    idx = torch.randint(-100, rows + 100, (256, 80), generator=g)
    idx[:, 1] = idx[:, 0]
    w = torch.rand((256, 80), generator=g)
    w[:, ::7] = 0
    for weights in (w.to(cuda, dtype), w.to(cuda), None):
        for ix in (idx.to(cuda), idx.to(cuda, torch.int32)):
            before = t_er.LAUNCHES.count
            got = it.bag_reduce(ix, weights)
            assert t_er.LAUNCHES.count == before + 1
            want = it.bag_reduce(ix, weights, reduce_fn=t_er.embedding_reduce)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (slow, weights is None, ix.dtype)


def _staged_shards(cuda, layout: str, dtype, page_rows: int, g):
    """Shards after ``layout`` ("H": HBM, "P": pinned), 20-40 pages each,
    their pages interleaved at random over the global rows; the page maps
    on the card."""
    parts, dev, local = [], [], []
    for i, kind in enumerate(layout):
        pages = int(torch.randint(20, 41, (1,), generator=g))
        rows = torch.randn((pages * page_rows, 64), generator=g).to(dtype)
        parts.append(rows.to(cuda) if kind == "H" else rows.pin_memory())
        dev += [i] * pages
        local += list(range(pages))
    order = torch.randperm(len(dev), generator=g)
    pd = torch.tensor(dev, dtype=torch.int8)[order].to(cuda)
    pl = torch.tensor(local, dtype=torch.int64)[order].to(cuda)
    return parts, pd, pl


#: (layout, table dtype, index dtype, weights, page_rows, B, K, indices):
#: weights "w" (some 0), "none", "zero" (every one 0); indices "uniform",
#: "dup" (8 rows in all), "out" (beyond both ends, clamped); B = -1 or -2
#: (with K = 1): one lookup below or above STAGE_MIN_LOOKUPS, with the
#: threshold as it is
STAGED_CASES = [
    ("HP", torch.float32, torch.int64, "w", 64, 256, 80, "uniform"),
    ("HP", torch.bfloat16, torch.int64, "w", 64, 256, 80, "uniform"),
    ("HP", torch.float32, torch.int32, "none", 64, 256, 80, "uniform"),
    ("HP", torch.bfloat16, torch.int32, "w", 64, 256, 80, "uniform"),
    ("HPP", torch.float32, torch.int64, "w", 64, 200, 80, "uniform"),
    ("HPP", torch.bfloat16, torch.int32, "none", 64, 200, 80, "uniform"),
    ("HPPP", torch.float32, torch.int32, "w", 64, 128, 80, "uniform"),
    ("HPPP", torch.bfloat16, torch.int64, "w", 64, 128, 80, "out"),
    ("PHP", torch.float32, torch.int64, "w", 64, 256, 80, "uniform"),
    ("HHP", torch.float32, torch.int64, "w", 64, 256, 80, "dup"),
    ("HP", torch.float32, torch.int64, "zero", 64, 256, 80, "uniform"),
    ("HP", torch.float32, torch.int64, "w", 64, 256, 80, "out"),
    ("HPP", torch.float32, torch.int64, "none", 48, 256, 80, "uniform"),
    ("HPP", torch.bfloat16, torch.int64, "w", 48, 256, 80, "dup"),
    ("HP", torch.float32, torch.int32, "w", 64, 9, 600, "uniform"),
    ("HPP", torch.bfloat16, torch.int64, "w", 64, 17, 600, "out"),
    ("HP", torch.float32, torch.int64, "w", 64, -1, 1, "uniform"),
    ("HP", torch.float32, torch.int64, "w", 64, -2, 1, "uniform"),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "layout,dtype,index_dtype,weights,page_rows,B,K,indices", STAGED_CASES,
    ids=[f"{c[0]}-{str(c[1])[6:]}-{str(c[2])[6:]}-{c[3]}-pr{c[4]}-B{c[5]}-"
         f"K{c[6]}-{c[7]}" for c in STAGED_CASES])
def test_bag_reduce_staged_equals_one_launch(cuda, monkeypatch, layout, dtype,
                                             index_dtype, weights, page_rows,
                                             B, K, indices):
    """The staged path (rows of the pinned shards gathered in address
    order into HBM, then the bag kernel) against the one-launch routed
    kernel, bit for bit, and against the plain version; 2-4 shards with
    1-3 pinned, duplicate and clamped rows, zero and absent weights, a
    page size that is not a power of two, bags longer than the bag
    kernel's staging area, and the threshold's two sides."""
    g = torch.Generator().manual_seed(len(layout) * 1000 + page_rows + K)
    parts, pd, pl = _staged_shards(cuda, layout, dtype, page_rows, g)
    rows = pd.numel() * page_rows
    threshold = t_er_kernel.STAGE_MIN_LOOKUPS
    forced = B > 0
    if not forced:
        B = threshold - 1 if B == -1 else threshold + 1
    if indices == "dup":
        idx = torch.randint(0, 8, (B, K), generator=g) * (rows // 8)
    elif indices == "out":
        idx = torch.randint(-3 * page_rows, rows + 3 * page_rows, (B, K),
                            generator=g)
    else:
        idx = torch.randint(0, rows, (B, K), generator=g)
    w = torch.rand((B, K), generator=g)
    w[:, ::7] = 0
    if weights == "zero":
        w.zero_()
    wt = None if weights == "none" else w.to(cuda)
    ix = idx.to(cuda, index_dtype)
    if forced:
        monkeypatch.setattr(t_er_kernel, "STAGE_MIN_LOOKUPS", 1)
    staged = t_er_kernel.stages([not p.is_cuda for p in parts], B * K, 4)
    assert staged == (forced or B * K >= threshold)
    t_er.STAGED.reset()
    before = t_er.LAUNCHES.count
    got = t_er.bag_reduce_routed(parts, pd, pl, page_rows, ix, wt)
    assert t_er.STAGED.count == int(staged)
    assert t_er.LAUNCHES.count - before == (
        t_er_kernel.STAGED_KERNELS if staged else 1)
    monkeypatch.setattr(t_er_kernel, "STAGE_MIN_LOOKUPS", t_er_kernel.MAX_ROWS)
    one = t_er.bag_reduce_routed(parts, pd, pl, page_rows, ix, wt)
    torch.cuda.synchronize()
    assert torch.equal(got, one)
    want = t_er_ref.bag_reduce_routed(
        [p.cpu() for p in parts], pd.cpu(), pl.cpu(), page_rows, idx,
        None if wt is None else w.to(dtype))
    if dtype == torch.float32:
        assert torch.equal(got.cpu(), want)
    else:
        torch.testing.assert_close(got.cpu().float(), want.float(), **BF16_TOL)


#: (layout, table dtype, index dtype, region log2): regions so small that
#: the pinned shards hold more of them than one tile of the staged path's
#: scan (csrc SCAN_THREADS x SCAN_ITEMS = 8,192), so the scan's carry from
#: tile to tile and each pinned shard's first region are read
SMALL_REGION_CASES = [
    ("HP", torch.float32, torch.int64, 4),
    ("HPP", torch.bfloat16, torch.int32, 4),
    ("HPPP", torch.float32, torch.int32, 6),
    ("PHP", torch.bfloat16, torch.int64, 5),
]


@pytest.mark.cuda
@pytest.mark.parametrize(
    "layout,dtype,index_dtype,region_log2", SMALL_REGION_CASES,
    ids=[f"{c[0]}-{str(c[1])[6:]}-{str(c[2])[6:]}-r{c[3]}"
         for c in SMALL_REGION_CASES])
def test_bag_reduce_staged_small_regions(cuda, monkeypatch, layout, dtype,
                                         index_dtype, region_log2):
    """The staged path over 10k-40k regions of 16-64 bytes, bit for bit
    against the one-launch routed kernel."""
    g = torch.Generator().manual_seed(100 + region_log2 + len(layout))
    parts, pd, pl = _staged_shards(cuda, layout, dtype, 64, g)
    row_bytes = 64 * parts[0].element_size()
    regions = sum(-(-p.shape[0] * row_bytes >> region_log2) for p in parts
                  if not p.is_cuda)
    assert regions > 8192, regions
    idx = torch.randint(0, pd.numel() * 64, (256, 80), generator=g)
    w = torch.rand((256, 80), generator=g)
    w[:, ::7] = 0
    ix, wt = idx.to(cuda, index_dtype), w.to(cuda)
    monkeypatch.setattr(t_er_kernel, "REGION_LOG2", region_log2)
    monkeypatch.setattr(t_er_kernel, "STAGE_MIN_LOOKUPS", 1)
    t_er.STAGED.reset()
    got = t_er.bag_reduce_routed(parts, pd, pl, 64, ix, wt)
    assert t_er.STAGED.count == 1
    monkeypatch.setattr(t_er_kernel, "STAGE_MIN_LOOKUPS", t_er_kernel.MAX_ROWS)
    one = t_er.bag_reduce_routed(parts, pd, pl, 64, ix, wt)
    torch.cuda.synchronize()
    assert torch.equal(got, one)


@pytest.mark.cuda
def test_bag_reduce_staged_counter(cuda):
    """``STAGED`` counts a call at the threshold with a pinned shard, and
    neither a call one lookup below it nor an all-HBM call at it."""
    g = torch.Generator().manual_seed(9)
    n = t_er_kernel.STAGE_MIN_LOOKUPS
    parts, pd, pl = _staged_shards(cuda, "HP", torch.float32, 64, g)
    hbm = [p.to(cuda) for p in parts]
    idx = torch.randint(0, pd.numel() * 64, (n, 1), generator=g).to(cuda)
    t_er.STAGED.reset()
    t_er.bag_reduce_routed(parts, pd, pl, 64, idx[:n - 1])
    assert t_er.STAGED.count == 0
    t_er.bag_reduce_routed(hbm, pd, pl, 64, idx)
    assert t_er.STAGED.count == 0
    t_er.bag_reduce_routed(parts, pd, pl, 64, idx)
    torch.cuda.synchronize()
    assert t_er.STAGED.count == 1


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["hbm->hbm", "pinned->hbm", "hbm->pinned"])
def test_stream_copy_kernel_matches_plain(cuda, route):
    src_mem, dst_mem = route.split("->")
    for shape in ((1, 8), (513, 4), (1024, 128)):
        for sdt, odt in ((torch.float32, torch.float32),
                         (torch.float32, torch.bfloat16),
                         (torch.bfloat16, torch.float32)):
            host = torch.randn(shape).to(sdt)
            src = host.to(cuda) if src_mem == "hbm" else host.pin_memory()
            out = (torch.empty(shape, dtype=odt, device=cuda)
                   if dst_mem == "hbm"
                   else torch.empty(shape, dtype=odt, pin_memory=True))
            t_sc.stream_copy(src, out=out)
            torch.cuda.synchronize()
            assert torch.equal(out.cpu(), host.to(odt))
    # row-strided: column windows of wider buffers, rows aligned to 16
    # bytes (vector body) and not (scalar body)
    for off in (0, 1):
        for sdt, odt in ((torch.bfloat16, torch.bfloat16),
                         (torch.float32, torch.bfloat16),
                         (torch.bfloat16, torch.float32)):
            host = torch.randn((30, 1032)).to(sdt)
            src = host.to(cuda) if src_mem == "hbm" else host.pin_memory()
            dst = (torch.zeros((30, 1040), dtype=odt, device=cuda)
                   if dst_mem == "hbm"
                   else torch.zeros((30, 1040), dtype=odt, pin_memory=True))
            t_sc.stream_copy(src[:, off:off + 1000],
                             out=dst[:, off:off + 1000])
            torch.cuda.synchronize()
            got = dst.cpu()
            assert torch.equal(got[:, off:off + 1000],
                               host[:, off:off + 1000].to(odt))
            got[:, off:off + 1000] = 0
            assert not got.any()


@pytest.mark.cuda
def test_embedding_reduce_kernel_skips_zero_weight_rows(cuda):
    """Known divergence, pinned: a zero-weight lookup issues no row load,
    so a non-finite row contributes nothing in the kernel, while the plain
    version (and the Pallas kernel) compute 0 * inf = nan."""
    table = torch.ones((4, 8))
    table[2] = float("inf")
    idx = torch.tensor([[0, 2, 1]])
    w = torch.tensor([[1.0, 0.0, 1.0]])
    got = t_er.embedding_reduce(table.to(cuda), idx.to(cuda), w.to(cuda))
    plain = t_er_ref.embedding_reduce(table, idx, w)
    assert torch.equal(got.cpu(), torch.full((1, 8), 2.0))
    assert torch.isnan(plain).all()

