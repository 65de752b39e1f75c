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
@pytest.mark.parametrize("B,H,K,hd,T,_block", SWEEP + [(16, 24, 2, 128, 64, 64)])
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
@pytest.mark.parametrize("B,H,K,hd,T,block", SWEEP)
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
    assert t_kernel.splits_for(16, 2, 4096) == 17
    assert t_kernel.splits_for(2, 2, 64) == 1


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
