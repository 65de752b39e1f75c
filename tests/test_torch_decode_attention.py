"""Differential tests for flash-decode attention: the port's plain versions
of both forms against the reference (``attend_partial``/``merge_partials``
of ``repro.models.attention``, the Pallas kernel in interpret mode and its
oracle), the append scatter against the reference's drop-mode scatter,
the wrappers' CPU dispatch — and, on a CUDA card only, the hand-written
kernels against their plain versions."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import ops as r_da  # noqa: E402
from repro.kernels.decode_attention import ref as r_da_ref  # noqa: E402
from repro.models import attention as r_attn  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as t_da  # noqa: E402
from repro_torch.kernels.decode_attention import ref as t_ref  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SWEEP = [(2, 8, 2, 32, 128, 32), (1, 4, 4, 64, 256, 64),
         (3, 8, 1, 16, 64, 64), (2, 16, 16, 32, 128, 128)]
#: recurrentgemma-9b's heads: 16 query heads on 1 KV head of 256
RG_256 = (2, 16, 1, 256, 128, 64)


def _pair(x: np.ndarray, dtype: str):
    """The same values in both frameworks (bf16 rounded once, by jax)."""
    j = jnp.asarray(x, jnp.float32)
    if dtype == "bfloat16":
        j = j.astype(jnp.bfloat16)
        return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
            torch.bfloat16)
    return j, torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _inputs(B, H, K, hd, T, dtype, seed):
    rng = np.random.default_rng(seed)
    q = _pair(rng.normal(size=(B, H, hd)), dtype)
    k = _pair(rng.normal(size=(B, T, K, hd)), dtype)
    v = _pair(rng.normal(size=(B, T, K, hd)), dtype)
    valid = rng.uniform(size=(B, T)) < 0.6
    valid[0] = False  # a fully masked partition row
    return q, k, v, valid


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol * 10)


@pytest.fixture
def cuda():
    """The card, or a skip: the kernels themselves run only on CUDA."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel vs plain version)")
    return torch.device("cuda")


# -- partial form: plain version vs the reference's attend_partial --------------
@pytest.mark.parametrize("B,H,K,hd,T,_block",
                         SWEEP + [(16, 24, 2, 128, 64, 64), RG_256,
                                  (2, 16, 16, 128, 64, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_partial_matches_reference(B, H, K, hd, T, _block, dtype):
    (qj, qt), (kj, kt), (vj, vt), valid = _inputs(B, H, K, hd, T, dtype,
                                                  B * T + hd)
    ra, rm, rl = r_attn.attend_partial(qj, kj, vj, jnp.asarray(valid))
    ta, tm, tl = t_attn.attend_partial(qt, kt, vt, torch.from_numpy(valid))
    assert ta.dtype == tm.dtype == tl.dtype == torch.float32
    # every row, the fully masked one included (m = -1e30, l = T, acc = sum v)
    _close(ta, ra, dtype)
    _close(tl, rl, dtype)
    assert np.array_equal(_np(tm)[0], _np(rm)[0])
    np.testing.assert_allclose(_np(tm), _np(rm), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("n_parts", [1, 2, 3])
def test_merge_partials_matches_reference(n_parts):
    """Partitions of one cache (a device split plus a masked-out one)
    merge to the reference's result, and to unsplit attention."""
    B, H, K, hd, T = 3, 8, 2, 16, 48
    (qj, qt), (kj, kt), (vj, vt), _ = _inputs(B, H, K, hd, T, "float32", 5)
    rng = np.random.default_rng(n_parts)
    owner = rng.integers(0, n_parts, size=(B, T))
    r_parts, t_parts = [], []
    for p in range(n_parts + 1):  # the extra one is fully masked
        valid = owner == p
        r_parts.append(r_attn.attend_partial(qj, kj, vj, jnp.asarray(valid)))
        t_parts.append(t_attn.attend_partial(qt, kt, vt,
                                             torch.from_numpy(valid)))
    got = t_attn.merge_partials(t_parts)
    _close(got, r_attn.merge_partials(r_parts), "float32")
    whole = t_ref.decode_attention(qt, kt, vt, torch.full((B,), T))
    _close(got, whole, "float32")


# -- normalised form: plain version vs the Pallas kernel and its oracle --------
@pytest.mark.parametrize("B,H,K,hd,T,block", SWEEP + [RG_256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_sweep(B, H, K, hd, T, block, dtype):
    (qj, qt), (kj, kt), (vj, vt), _ = _inputs(B, H, K, hd, T, dtype, T + hd)
    lengths = np.random.default_rng(0).integers(1, T + 1, size=B)
    pallas = r_da.decode_attention(qj, kj, vj, jnp.asarray(lengths),
                                   block_t=block)
    oracle = r_da_ref.decode_attention(qj, kj, vj, jnp.asarray(lengths))
    got = t_da.decode_attention(qt, kt, vt, torch.from_numpy(lengths))
    assert got.dtype == torch.float32 and got.shape == (B, H, hd)
    _close(got, pallas, dtype)
    _close(got, oracle, dtype)


def test_decode_attention_ragged_lengths():
    B, H, K, hd, T = 4, 4, 2, 16, 256
    (qj, qt), (kj, kt), (vj, vt), _ = _inputs(B, H, K, hd, T, "float32", 1)
    lengths = np.array([1, 17, 100, 256])
    pallas = r_da.decode_attention(qj, kj, vj, jnp.asarray(lengths),
                                   block_t=64)
    got = t_da.decode_attention(qt, kt, vt, torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(got), _np(pallas), atol=1e-5)


def test_decode_attention_zero_length_is_zero():
    """The port's choice at lengths == 0: 0, as the Pallas kernel gives
    (its oracle gives NaN there)."""
    B, H, K, hd, T = 2, 4, 2, 16, 64
    (qj, qt), (kj, kt), (vj, vt), _ = _inputs(B, H, K, hd, T, "float32", 2)
    lengths = np.array([0, 9])
    pallas = np.asarray(r_da.decode_attention(qj, kj, vj, jnp.asarray(lengths),
                                              block_t=32))
    oracle = np.asarray(r_da_ref.decode_attention(qj, kj, vj,
                                                  jnp.asarray(lengths)))
    got = _np(t_da.decode_attention(qt, kt, vt, torch.from_numpy(lengths)))
    assert np.all(pallas[0] == 0) and np.isnan(oracle[0]).all()
    assert np.all(got[0] == 0)
    np.testing.assert_allclose(got[1], pallas[1], atol=1e-5)


# -- the append scatter ----------------------------------------------------------
@pytest.mark.parametrize("pool_dtype", ["float32", "bfloat16"])
def test_kv_append_drops_out_of_range_rows_as_reference(pool_dtype):
    rng = np.random.default_rng(3)
    B, T, K, hd = 5, 10, 2, 16
    pool_j, pool_t = _pair(rng.normal(size=(3, B, T, K, hd)), pool_dtype)
    k_new = rng.normal(size=(B, K, hd)).astype(np.float32)
    v_new = rng.normal(size=(B, K, hd)).astype(np.float32)
    rows = np.array([0, 9, 10, 12, 3])  # 10 and 12: another pool's rows
    want = pool_j.at[1, jnp.arange(B), jnp.asarray(rows)].set(
        jnp.asarray(k_new).astype(pool_j.dtype), mode="drop")
    k_pool, v_pool = pool_t.clone(), pool_t.clone()
    t_da.kv_append(k_pool[1], v_pool[1], torch.from_numpy(rows),
                   torch.from_numpy(k_new), torch.from_numpy(v_new))
    assert np.array_equal(_np(k_pool), _np(want))
    assert np.array_equal(_np(v_pool)[1, 1, 9],
                          _np(torch.from_numpy(v_new[1]).to(pool_t.dtype)))


# -- wrappers: CPU dispatch, counters, limits -------------------------------------
def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    t_da.LAUNCHES.reset()
    t_da.APPEND_LAUNCHES.reset()
    q = torch.randn(2, 4, 16)
    k = torch.randn(2, 8, 2, 16)
    t_da.attend_partial(q, k, k, torch.ones(2, 8, dtype=torch.bool))
    t_da.decode_attention(q, k, k, torch.tensor([3, 8]))
    t_da.kv_append(k, k.clone(), torch.tensor([0, 1]), k[:, 0], k[:, 0])
    assert (t_da.LAUNCHES.count, t_da.APPEND_LAUNCHES.count) == (0, 0)
    assert "decode_attention" in common.KERNELS


def test_kernel_checks_shapes_before_launch():
    """What the kernel does not take is refused in Python, before any
    library is built or loaded."""
    q = torch.randn(2, 4, 48)
    k = torch.randn(2, 8, 2, 48)
    with pytest.raises(ValueError, match="head dim"):
        t_kernel._check_kv(q, k, k)
    q = torch.randn(2, 34, 16)
    k = torch.randn(2, 8, 2, 16)
    with pytest.raises(ValueError, match="at most"):
        t_kernel._check_kv(q, k, k)
    assert t_kernel.splits_for(16, 2, 4096) == 3
    assert t_kernel.splits_for(2, 2, 64) == 1


def test_splits_fit_one_cluster_and_keep_two_tiles_a_block():
    """The splits of one (sequence, KV head) form one thread-block cluster
    (at most ``MAX_SPLITS``), and no split is shorter than two tiles."""
    for B, K, T in [(1, 1, 1 << 20), (1, 1, 4096), (16, 2, 4096),
                    (2, 1, 128), (64, 8, 100_000), (1, 1, 1)]:
        s = t_kernel.splits_for(B, K, T)
        assert 1 <= s <= t_kernel.MAX_SPLITS
        assert s == 1 or T // s >= 2 * t_kernel.TILE


def test_fp32_body_keeps_four_blocks_per_sm():
    """The fp32 CUDA-core body merges its splits in a second kernel, so it
    keeps its own rule (about four blocks per SM, pieces of at least 128
    positions), apart from the bf16 body's cluster rule."""
    assert t_kernel.f32_splits_for(16, 2, 4096) == 17
    assert t_kernel.f32_splits_for(2, 2, 64) == 1
    k32 = torch.zeros(16, 4096, 2, 128)
    assert t_kernel._splits(k32, 16, 2, 4096) == 17
    assert t_kernel._splits(k32.bfloat16(), 16, 2, 4096) == 3


def test_kernel_checks_positions_against_the_tile_bits():
    """The bf16 body keeps one bit per 64-position tile in shared memory,
    so it takes at most ``MAX_POSITIONS``; the fp32 body has no limit."""
    q = torch.randn(1, 16, 256).bfloat16()
    for T, ok in ((t_kernel.MAX_POSITIONS, True),
                  (t_kernel.MAX_POSITIONS + 1, False)):
        k = torch.zeros(1, 1, 1, 256, dtype=torch.bfloat16).expand(1, T, 1,
                                                                   256)
        if ok:
            t_kernel._check_kv(q, k, k)
        else:
            with pytest.raises(ValueError, match="positions"):
                t_kernel._check_kv(q, k, k)
    k = torch.zeros(1, 1, 1, 256).expand(1, t_kernel.MAX_POSITIONS + 1, 1,
                                         256)
    t_kernel._check_kv(q.float(), k, k)


def test_kernel_takes_q_in_its_own_dtype():
    """q in fp32 or bf16 goes to the kernel as it is (no cast launch);
    other dtypes are refused before launch."""
    k = torch.randn(2, 8, 2, 64).to(torch.bfloat16)
    for dtype in (torch.float32, torch.bfloat16):
        t_kernel._check_kv(torch.randn(2, 4, 64).to(dtype), k, k)
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        t_kernel._check_kv(torch.randn(2, 4, 64).half(), k, k)


def test_kernel_shape_check_takes_head_dim_160():
    """stablelm-12b's head dim (160, 32 query heads over 8 KV heads) is
    built; a head dim that is not, such as 96, is still refused."""
    assert 160 in t_kernel.HEAD_DIMS
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(2, 32, 160).to(dtype)
        k = torch.randn(2, 8, 8, 160).to(dtype)
        t_kernel._check_kv(q, k, k)
    q = torch.randn(2, 32, 96)
    k = torch.randn(2, 8, 8, 96)
    with pytest.raises(ValueError, match="head dim"):
        t_kernel._check_kv(q, k, k)


def test_kernel_shape_check_takes_head_dim_256():
    """recurrentgemma-9b's head dim (256, 16 query heads over 1 KV head)
    is built; a head dim that is not, such as 96, is still refused."""
    assert 256 in t_kernel.HEAD_DIMS
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(2, 16, 256).to(dtype)
        k = torch.randn(2, 8, 1, 256).to(dtype)
        t_kernel._check_kv(q, k, k)
    q = torch.randn(2, 16, 96)
    k = torch.randn(2, 8, 1, 96)
    with pytest.raises(ValueError, match="head dim"):
        t_kernel._check_kv(q, k, k)


# -- the hand-written kernels, on the card ---------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("memory", ["hbm", "pinned"])
def test_decode_attention_kernel_matches_plain(cuda, dtype, memory):
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    g = torch.Generator().manual_seed(0)
    for B, H, K, hd, T, _ in SWEEP + [(16, 24, 2, 128, 512, 0)]:
        q = torch.randn((B, H, hd), generator=g).to(dtype)
        k = torch.randn((B, T, K, hd), generator=g).to(dtype)
        v = torch.randn((B, T, K, hd), generator=g).to(dtype)
        lengths = torch.randint(1, T + 1, (B,), generator=g)
        lengths[0], lengths[-1] = 1, T
        valid = torch.rand((B, T), generator=g) < 0.6
        valid[0] = False
        kk = k.to(cuda) if memory == "hbm" else k.pin_memory()
        vv = v.to(cuda) if memory == "hbm" else v.pin_memory()
        before = t_da.LAUNCHES.count
        got = t_da.decode_attention(q.to(cuda), kk, vv, lengths.to(cuda))
        acc, m, l = t_da.attend_partial(q.to(cuda), kk, vv, valid.to(cuda))
        want = t_ref.decode_attention(q, k, v, lengths)
        ra, rm, rl = t_ref.attend_partial(q, k, v, valid)
        torch.cuda.synchronize()
        assert t_da.LAUNCHES.count == before + 2
        torch.testing.assert_close(got.cpu(), want, atol=tol, rtol=tol * 10)
        rows = valid.any(1)
        torch.testing.assert_close(acc.cpu()[rows], ra[rows], atol=tol,
                                   rtol=tol * 10)
        torch.testing.assert_close(m.cpu()[rows], rm[rows], atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(l.cpu()[rows], rl[rows], rtol=tol * 10,
                                   atol=tol)
        # the fully masked row: no load, (acc, l) = 0, merged weight 0
        assert bool((m[0] == t_ref.NEG_INF).all()) and not l[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("memory", ["hbm", "pinned"])
def test_decode_attention_kernel_head_dim_160(cuda, dtype, memory):
    """stablelm-12b's heads (hd 160, G = 4): both forms against the plain
    versions, ragged lengths and a fully masked row."""
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    g = torch.Generator().manual_seed(1)
    B, H, K, hd, T = 3, 32, 8, 160, 200
    q = torch.randn((B, H, hd), generator=g).to(dtype)
    k = torch.randn((B, T, K, hd), generator=g).to(dtype)
    v = torch.randn((B, T, K, hd), generator=g).to(dtype)
    lengths = torch.tensor([1, 77, T])
    valid = torch.rand((B, T), generator=g) < 0.6
    valid[0] = False
    kk = k.to(cuda) if memory == "hbm" else k.pin_memory()
    vv = v.to(cuda) if memory == "hbm" else v.pin_memory()
    before = t_da.LAUNCHES.count
    got = t_da.decode_attention(q.to(cuda), kk, vv, lengths.to(cuda))
    acc, m, l = t_da.attend_partial(q.to(cuda), kk, vv, valid.to(cuda))
    want = t_ref.decode_attention(q, k, v, lengths)
    ra, rm, rl = t_ref.attend_partial(q, k, v, valid)
    torch.cuda.synchronize()
    assert t_da.LAUNCHES.count == before + 2
    torch.testing.assert_close(got.cpu(), want, atol=tol, rtol=tol * 10)
    rows = valid.any(1)
    torch.testing.assert_close(acc.cpu()[rows], ra[rows], atol=tol,
                               rtol=tol * 10)
    torch.testing.assert_close(m.cpu()[rows], rm[rows], atol=tol, rtol=tol)
    torch.testing.assert_close(l.cpu()[rows], rl[rows], atol=tol,
                               rtol=tol * 10)
    assert bool((m[0] == t_ref.NEG_INF).all()) and not l[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("memory", ["hbm", "pinned"])
def test_decode_attention_kernel_one_query_head_a_kv_head(cuda, dtype,
                                                          memory):
    """deepseek-moe-16b's heads (16 query heads on 16 KV heads of 128,
    G = 1: rows 1-15 of the bf16 body's 16-row tile are zero), as its
    decode step calls the partial form (valid prefix of a 1024-position
    cache), and the normalised form; ragged lengths, a masked row."""
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    g = torch.Generator().manual_seed(2)
    B, H, K, hd, T = 8, 16, 16, 128, 1024
    q = torch.randn((B, H, hd), generator=g).to(dtype)
    k = torch.randn((B, T, K, hd), generator=g).to(dtype)
    v = torch.randn((B, T, K, hd), generator=g).to(dtype)
    lengths = torch.tensor([1, 2, 31, 32, 64, 500, 1023, T])
    valid = torch.arange(T)[None, :] < lengths[:, None]
    valid[0] = False
    kk = k.to(cuda) if memory == "hbm" else k.pin_memory()
    vv = v.to(cuda) if memory == "hbm" else v.pin_memory()
    before = t_da.LAUNCHES.count
    got = t_da.decode_attention(q.to(cuda), kk, vv, lengths.to(cuda))
    acc, m, l = t_da.attend_partial(q.to(cuda), kk, vv, valid.to(cuda))
    want = t_ref.decode_attention(q, k, v, lengths)
    ra, rm, rl = t_ref.attend_partial(q, k, v, valid)
    torch.cuda.synchronize()
    assert t_da.LAUNCHES.count == before + 2
    torch.testing.assert_close(got.cpu(), want, atol=tol, rtol=tol * 10)
    rows = valid.any(1)
    torch.testing.assert_close(acc.cpu()[rows], ra[rows], atol=tol,
                               rtol=tol * 10)
    torch.testing.assert_close(m.cpu()[rows], rm[rows], atol=tol, rtol=tol)
    torch.testing.assert_close(l.cpu()[rows], rl[rows], atol=tol,
                               rtol=tol * 10)
    assert bool((m[0] == t_ref.NEG_INF).all()) and not l[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("memory", ["hbm", "pinned"])
def test_kv_append_kernel_matches_plain(cuda, memory):
    for dtype in (torch.float32, torch.bfloat16):
        pool = torch.randn((3, 5, 10, 2, 16)).to(dtype)
        k_pool = pool.to(cuda) if memory == "hbm" else pool.clone().pin_memory()
        v_pool = pool.to(cuda) if memory == "hbm" else pool.clone().pin_memory()
        k_new = torch.randn((5, 2, 16), device=cuda)
        v_new = torch.randn((5, 2, 16), device=cuda)
        rows = torch.tensor([0, 9, 10, -1, 3], device=cuda)
        before = t_da.APPEND_LAUNCHES.count
        t_da.kv_append(k_pool[1], v_pool[1], rows, k_new, v_new)
        want_k, want_v = pool.clone(), pool.clone()
        t_ref.kv_append(want_k[1], want_v[1], rows.cpu(), k_new.cpu(),
                        v_new.cpu())
        torch.cuda.synchronize()
        assert t_da.APPEND_LAUNCHES.count == before + 1
        assert torch.equal(k_pool.cpu(), want_k)
        assert torch.equal(v_pool.cpu(), want_v)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("memory", ["hbm", "pinned"])
def test_decode_attention_kernel_head_dim_256(cuda, dtype, memory):
    """recurrentgemma-9b's heads (hd 256, 16 query heads on 1 KV head):
    both forms against the plain versions, ragged lengths, a fully masked
    row, and the local 2048-position window as the partial form's mask."""
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    g = torch.Generator().manual_seed(2)
    B, H, K, hd, T = 4, 16, 1, 256, 3000
    q = torch.randn((B, H, hd), generator=g).to(dtype)
    k = torch.randn((B, T, K, hd), generator=g).to(dtype)
    v = torch.randn((B, T, K, hd), generator=g).to(dtype)
    lengths = torch.tensor([1, 700, 2500, T])
    t = torch.arange(T)[None]
    window = (t < lengths[:, None]) & (t >= lengths[:, None] - 2048)
    kk = k.to(cuda) if memory == "hbm" else k.pin_memory()
    vv = v.to(cuda) if memory == "hbm" else v.pin_memory()
    got = t_da.decode_attention(q.to(cuda), kk, vv, lengths.to(cuda))
    torch.testing.assert_close(got.cpu(), t_ref.decode_attention(
        q, k, v, lengths), atol=tol, rtol=tol * 10)
    for valid in (torch.rand((B, T), generator=g) < 0.6, window):
        valid[0] = False
        acc, m, l = t_da.attend_partial(q.to(cuda), kk, vv, valid.to(cuda))
        ra, rm, rl = t_ref.attend_partial(q, k, v, valid)
        torch.cuda.synchronize()
        rows = valid.any(1)
        torch.testing.assert_close(acc.cpu()[rows], ra[rows], atol=tol,
                                   rtol=tol * 10)
        torch.testing.assert_close(m.cpu()[rows], rm[rows], atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(l.cpu()[rows], rl[rows], atol=tol,
                                   rtol=tol * 10)
        assert bool((m[0] == t_ref.NEG_INF).all()) and not l[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [128, 256])
def test_fp32_q_over_bf16_kv_keeps_fp32_accuracy(cuda, hd):
    """An fp32 q that bf16 cannot hold, over bf16 K/V: the kernel splits q
    and P into bf16 high and low halves, so it lands within 2e-5 of the
    fp32 plain version, where the same q rounded to bf16 does not."""
    g = torch.Generator().manual_seed(3)
    B, H, K, T = 4, 16, 1 if hd == 256 else 2, 700
    q = torch.randn((B, H, hd), generator=g)
    assert not torch.equal(q, q.bfloat16().float())
    k = torch.randn((B, T, K, hd), generator=g).to(torch.bfloat16)
    v = torch.randn((B, T, K, hd), generator=g).to(torch.bfloat16)
    lengths = torch.tensor([5, 300, 699, T])
    got = t_da.decode_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                                lengths.to(cuda)).cpu()
    want = t_ref.decode_attention(q, k, v, lengths)
    rounded = t_ref.decode_attention(q.bfloat16(), k, v, lengths)
    assert float((got - want).abs().max()) <= 2e-5
    assert float((rounded - want).abs().max()) > 2e-5


@pytest.mark.cuda
def test_bf16_body_takes_long_rows(cuda):
    """hd 256 with an fp32 q (the body's largest shared memory) and one
    split a row: 100,000 positions, past where a per-tile list would no
    longer fit beside the ring, with every fifth tile wholly masked.  K/V
    are shared by every sequence (stride 0), so a few rows are held
    against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(6)
    B, H, K, hd, T = 50, 16, 1, 256, 100_000
    assert t_kernel.splits_for(B, K, T) == 1
    q = torch.randn((B, H, hd), generator=g, device=cuda)
    k1, v1 = (torch.randn((1, T, K, hd), generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    k, v = k1.expand(B, T, K, hd), v1.expand(B, T, K, hd)
    lengths = torch.randint(1, T + 1, (B,), generator=g, device=cuda)
    lengths[0] = T
    valid = torch.rand((B, T), generator=g, device=cuda) < 0.6
    valid &= torch.arange(T, device=cuda) // t_kernel.TILE % 5 != 2
    got = t_da.decode_attention(q, k, v, lengths)
    acc, m, l = t_da.attend_partial(q, k, v, valid)
    for b in (0, 1, B - 1):
        want = t_ref.decode_attention(q[b:b + 1], k1, v1, lengths[b:b + 1])
        torch.testing.assert_close(got[b:b + 1], want, atol=2e-5, rtol=2e-4)
        ra, rm, rl = t_ref.attend_partial(q[b:b + 1], k1, v1, valid[b:b + 1])
        torch.testing.assert_close(acc[b:b + 1], ra, atol=2e-2, rtol=0.2)
        torch.testing.assert_close(m[b:b + 1], rm, atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(l[b:b + 1], rl, atol=2e-2, rtol=0.2)


@pytest.mark.cuda
@pytest.mark.parametrize("memory", ["hbm", "pinned"])
def test_splits_over_valid_tiles_only_at_the_end_of_t(cuda, memory):
    """Valid positions only in the last tiles of T: the splits share those
    few tiles (none of them idles on the masked stretch), and the merge
    gives the plain result."""
    g = torch.Generator().manual_seed(4)
    B, H, K, hd, T = 16, 24, 2, 128, 4096
    assert t_kernel.splits_for(B, K, T) > 1  # several splits share 4 tiles
    q = torch.randn((B, H, hd), generator=g).to(torch.bfloat16)
    k = torch.randn((B, T, K, hd), generator=g).to(torch.bfloat16)
    v = torch.randn((B, T, K, hd), generator=g).to(torch.bfloat16)
    valid = torch.zeros((B, T), dtype=torch.bool)
    valid[:, T - 200:] = torch.rand((B, 200), generator=g) < 0.7
    valid[1] = False
    kk = k.to(cuda) if memory == "hbm" else k.pin_memory()
    vv = v.to(cuda) if memory == "hbm" else v.pin_memory()
    acc, m, l = t_da.attend_partial(q.to(cuda), kk, vv, valid.to(cuda))
    ra, rm, rl = t_ref.attend_partial(q, k, v, valid)
    torch.cuda.synchronize()
    rows = valid.any(1)
    torch.testing.assert_close(acc.cpu()[rows], ra[rows], atol=2e-2,
                               rtol=0.2)
    torch.testing.assert_close(m.cpu()[rows], rm[rows], atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(l.cpu()[rows], rl[rows], atol=2e-2, rtol=0.2)
    assert bool((m[1] == t_ref.NEG_INF).all()) and not l[1].any()
