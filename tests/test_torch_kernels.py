"""Differential tests for the port's kernels: each plain PyTorch version
against the reference's Pallas ops (interpret mode on the CPU), the CPU
dispatch of each wrapper, and — on a CUDA card only — each hand-written
kernel against its plain version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.embedding_reduce import ops as r_er  # noqa: E402
from repro.kernels.stream_copy import ops as r_sc  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
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

