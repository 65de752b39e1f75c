"""Differential tests for the RWKV6 WKV recurrence: the port's plain
version against the reference's oracle (``repro.kernels.wkv6.ref``) and
its Pallas kernel in interpret mode (``repro.kernels.wkv6.ops``) on the
shapes of the reference's own kernel tests, the state carry, T = 1 and an
odd T, bf16 r/k/v with fp32 w, the wrapper's CPU dispatch — and, on a
CUDA card only, the hand-written kernel against its plain version."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.wkv6 import ops as r_ops  # noqa: E402
from repro.kernels.wkv6 import ref as r_ref  # noqa: E402
from repro_torch.kernels import common  # noqa: E402
from repro_torch.kernels.wkv6 import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.wkv6 import ops as t_ops  # noqa: E402
from repro_torch.kernels.wkv6 import ref as t_ref  # noqa: E402

#: the reference's kernel tests hold the recurrence to 1e-4 (fp32)
ATOL = 1e-4
#: (B, T, H, hd, block_t) of tests/test_kernels.py:106-108
SWEEP = [(2, 64, 2, 16, 16), (1, 128, 4, 32, 64), (2, 32, 1, 64, 32)]


def _inputs(B, T, H, hd, seed, *, state=False, rkv_dtype="float32",
            decay="reference"):
    """r, k, v, w, u, state as numpy, drawn as the reference's tests draw
    them (w in (0.5, 1)); bf16 r/k/v are rounded once, by jax, so both
    packages see the same values.  ``decay="model"`` draws w as the model
    makes it, exp(-exp(x)) with x uniform in [-6, 3]: from ~2e-9, which
    all but wipes the state in one step, to ~0.9975."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(B, T, H, hd)).astype(np.float32) * 0.5
    k = rng.normal(size=(B, T, H, hd)).astype(np.float32) * 0.5
    v = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    if decay == "model":
        x = rng.uniform(-6.0, 3.0, size=(B, T, H, hd))
        w = np.exp(-np.exp(x)).astype(np.float32)
    else:
        w = (1 / (1 + np.exp(-rng.normal(size=(B, T, H, hd))))).astype(
            np.float32) * 0.5 + 0.5
    u = rng.normal(size=(H, hd)).astype(np.float32) * 0.1
    s0 = (rng.normal(size=(B, H, hd, hd)).astype(np.float32) * 0.1 if state
          else np.zeros((B, H, hd, hd), np.float32))
    if rkv_dtype == "bfloat16":
        r, k, v = (np.asarray(jnp.asarray(a).astype(jnp.bfloat16))
                   for a in (r, k, v))
    return r, k, v, w, u, s0


def _t(a):
    """A torch tensor of the same values (bf16 bit-exact)."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol)


@pytest.fixture
def cuda():
    """The card, or a skip: the kernel itself runs only on CUDA."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel vs plain version)")
    return torch.device("cuda")


# -- plain version vs the reference's oracle and Pallas kernel -------------------
@pytest.mark.parametrize("B,T,H,hd,block", SWEEP)
def test_wkv6_plain_matches_reference_sweep(B, T, H, hd, block):
    r, k, v, w, u, s0 = _inputs(B, T, H, hd, B * T + hd)
    y_o, s_o = r_ref.wkv6(*map(_j, (r, k, v, w, u, s0)))
    y_p, s_p = r_ops.wkv6(*map(_j, (r, k, v, w, u, s0)), block_t=block)
    y, s = t_ops.wkv6(*map(_t, (r, k, v, w, u, s0)))
    assert y.dtype == s.dtype == torch.float32
    assert y.shape == (B, T, H, hd) and s.shape == (B, H, hd, hd)
    for want_y, want_s in ((y_o, s_o), (y_p, s_p)):
        _close(y.numpy(), want_y)
        _close(s.numpy(), want_s)


def test_wkv6_state_carry():
    """Two calls of T/2 with the state carried == one call over T (the
    reference's tests/test_kernels.py:122-138, on the port's wrapper)."""
    B, T, H, hd = 1, 64, 2, 16
    r, k, v, w, u, s0 = _inputs(B, T, H, hd, 7)
    y_a, s_a = t_ops.wkv6(*(_t(a[:, :32]) for a in (r, k, v, w)), _t(u),
                          _t(s0))
    y_b, s_b = t_ops.wkv6(*(_t(a[:, 32:]) for a in (r, k, v, w)), _t(u), s_a)
    y_full, s_full = r_ref.wkv6(*map(_j, (r, k, v, w, u, s0)))
    _close(torch.cat([y_a, y_b], 1).numpy(), y_full)
    _close(s_b.numpy(), s_full)


@pytest.mark.parametrize("T", [1, 37])
def test_wkv6_any_t_with_a_starting_state(T):
    """T = 1 (a decode step) and a T that tiles by nothing; the Pallas
    wrapper takes its oracle there, the port's wrapper does not care."""
    r, k, v, w, u, s0 = _inputs(2, T, 4, 16, T, state=True)
    y, s = t_ops.wkv6(*map(_t, (r, k, v, w, u, s0)))
    y_o, s_o = r_ref.wkv6(*map(_j, (r, k, v, w, u, s0)))
    _close(y.numpy(), y_o)
    _close(s.numpy(), s_o)


def test_wkv6_bf16_rkv_fp32_w():
    """The model's mix: bf16 r/k/v, fp32 w, fp32 state and y.  Both sides
    see the same bf16 values and compute in fp32, so the difference is
    summation order only and the fp32 tolerance holds."""
    r, k, v, w, u, s0 = _inputs(2, 48, 4, 16, 3, state=True,
                                rkv_dtype="bfloat16")
    y, s = t_ops.wkv6(*map(_t, (r, k, v, w, u, s0)))
    y_o, s_o = r_ref.wkv6(*map(_j, (r, k, v, w, u, s0)))
    assert _t(r).dtype == torch.bfloat16
    assert y.dtype == s.dtype == torch.float32
    _close(y.numpy(), y_o)
    _close(s.numpy(), s_o)


@pytest.mark.parametrize("hd", [16, 64])
def test_wkv6_plain_matches_reference_on_the_model_decay(hd):
    """The model's own decay distribution, w = exp(-exp(x)): some channels
    keep the state, others wipe it in one step (fp32, T = 37)."""
    r, k, v, w, u, s0 = _inputs(2, 37, 2, hd, 37 + hd, state=True,
                                decay="model")
    assert w.min() < 1e-8 and w.max() > 0.99
    y, s = t_ops.wkv6(*map(_t, (r, k, v, w, u, s0)))
    y_o, s_o = r_ref.wkv6(*map(_j, (r, k, v, w, u, s0)))
    _close(y.numpy(), y_o)
    _close(s.numpy(), s_o)


def test_wkv6_state_out_may_alias_state():
    r, k, v, w, u, s0 = _inputs(2, 9, 2, 16, 4, state=True)
    want_y, want_s = t_ops.wkv6(*map(_t, (r, k, v, w, u, s0)))
    state = _t(s0).clone()
    y, out = t_ops.wkv6(*map(_t, (r, k, v, w, u)), state, state_out=state)
    assert out is state
    assert torch.equal(y, want_y) and torch.equal(state, want_s)


# -- the wrapper: CPU dispatch, counter, limits ------------------------------------
def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    t_ops.LAUNCHES.reset()
    r, k, v, w, u, s0 = map(_t, _inputs(1, 5, 2, 16, 0))
    t_ops.wkv6(r, k, v, w, u, s0)
    t_ops.wkv6(r, k, v, w, u, s0, state_out=s0.clone())
    assert t_ops.LAUNCHES.count == 0
    assert "wkv6" in common.KERNELS


def test_kernel_checks_shapes_before_launch():
    """What the kernel does not take is refused in Python, before any
    library is built or loaded."""
    r, k, v, w, u, s0 = map(_t, _inputs(1, 4, 2, 16, 0))
    t_kernel.check(r, k, v, w, u, s0, None)  # accepted
    r48, k48, v48, w48, u48, s48 = map(_t, _inputs(1, 4, 2, 48, 0))
    with pytest.raises(ValueError, match="head dim"):
        t_kernel.check(r48, k48, v48, w48, u48, s48, None)
    with pytest.raises(ValueError, match="share a dtype"):
        t_kernel.check(r, k.to(torch.bfloat16), v, w, u, s0, None)
    with pytest.raises(ValueError, match="state"):
        t_kernel.check(r, k, v, w, u, s0.double(), None)
    with pytest.raises(ValueError, match="u "):
        t_kernel.check(r, k, v, w, u[:1], s0, None)
    with pytest.raises(TypeError, match="float32 and bfloat16"):
        t_kernel.check(r, k, v, w.half(), u, s0, None)
    assert t_kernel.HEAD_DIMS == (16, 32, 64)


def test_occupancy_query_refuses_other_head_dims():
    """The residency query names the head dims the kernel is built for,
    before any library is built or loaded."""
    with pytest.raises(ValueError, match="head dim"):
        t_kernel.blocks_per_sm(torch.bfloat16, torch.float32, 48)


# -- the hand-written kernel, on the card ------------------------------------------
def _kernel_vs_plain(cuda, r, k, v, w, u, s0, *, alias=False):
    dev = [a.to(cuda) for a in (r, k, v, w, u, s0)]
    before = t_ops.LAUNCHES.count
    out = dev[5] if alias else None
    y, s = t_ops.wkv6(*dev, state_out=out)
    y_p, s_p = t_ref.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    assert t_ops.LAUNCHES.count == before + 1
    if alias:
        assert s is dev[5]
    torch.testing.assert_close(y.cpu(), y_p, atol=ATOL, rtol=1e-5)
    torch.testing.assert_close(s.cpu(), s_p, atol=ATOL, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,hd,_block", SWEEP + [(2, 1, 4, 64, 0),
                                                     (2, 1000, 4, 64, 0)])
@pytest.mark.parametrize("rkv_dtype", ["float32", "bfloat16"])
def test_wkv6_kernel_matches_plain(cuda, B, T, H, hd, _block, rkv_dtype):
    arrays = _inputs(B, T, H, hd, T + hd, state=True, rkv_dtype=rkv_dtype)
    _kernel_vs_plain(cuda, *map(_t, arrays))


@pytest.mark.cuda
def test_wkv6_kernel_state_carry_and_alias(cuda):
    B, T, H, hd = 1, 64, 2, 16
    r, k, v, w, u, s0 = map(_t, _inputs(B, T, H, hd, 8, state=True))
    dev = [a.to(cuda) for a in (r, k, v, w)]
    uc, state = u.to(cuda), s0.to(cuda)
    y_a, _ = t_ops.wkv6(*(a[:, :32] for a in dev), uc, state, state_out=state)
    y_b, _ = t_ops.wkv6(*(a[:, 32:] for a in dev), uc, state, state_out=state)
    y_p, s_p = t_ref.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([y_a, y_b], 1).cpu(), y_p,
                               atol=ATOL, rtol=1e-5)
    torch.testing.assert_close(state.cpu(), s_p, atol=ATOL, rtol=1e-5)
    _kernel_vs_plain(cuda, r, k, v, w, u, s0, alias=True)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("rkv_dtype", ["float32", "bfloat16"])
def test_wkv6_kernel_on_the_model_decay(cuda, hd, rkv_dtype):
    arrays = _inputs(2, 37, 2, hd, 5 + hd, state=True, rkv_dtype=rkv_dtype,
                     decay="model")
    _kernel_vs_plain(cuda, *map(_t, arrays))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [15, 17, 33])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_wkv6_kernel_ragged_last_chunk(cuda, T, hd):
    """T that ends inside a chunk of the ring, after one or two whole ones."""
    arrays = _inputs(2, T, 2, hd, T * hd, state=True, rkv_dtype="bfloat16",
                     decay="model")
    _kernel_vs_plain(cuda, *map(_t, arrays))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 33])
def test_wkv6_kernel_state_out_aliases_state(cuda, T):
    arrays = _inputs(2, T, 4, 64, T + 3, state=True, rkv_dtype="bfloat16",
                     decay="model")
    _kernel_vs_plain(cuda, *map(_t, arrays), alias=True)


@pytest.mark.cuda
@pytest.mark.parametrize("rkv_dtype", ["float32", "bfloat16"])
def test_wkv6_kernel_takes_unaligned_views(cuda, rkv_dtype):
    """r, k, v, w one element into a wider buffer: not 16-byte aligned,
    so the ring copies them element by element."""
    r, k, v, w, u, s0 = map(_t, _inputs(2, 33, 2, 64, 9, state=True,
                                        rkv_dtype=rkv_dtype, decay="model"))
    views = []
    for a in (r, k, v, w):
        wide = torch.zeros((2, 33, 2, 66), dtype=a.dtype, device=cuda)
        wide[..., 1:65] = a.to(cuda)
        views.append(wide[..., 1:65])
    assert views[0].data_ptr() % 16 != 0
    y, s = t_ops.wkv6(*views, u.to(cuda), s0.to(cuda))
    y_p, s_p = t_ref.wkv6(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.cpu(), y_p, atol=ATOL, rtol=1e-5)
    torch.testing.assert_close(s.cpu(), s_p, atol=ATOL, rtol=1e-5)


@pytest.mark.cuda
def test_wkv6_kernel_fills_the_card_in_one_wave(cuda):
    """At the rwkv slice's shapes every (batch, head) pair's block is
    resident at once: 16 x 64 blocks over the card's SMs."""
    blocks = t_kernel.blocks_per_sm(torch.bfloat16, torch.float32, 64)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert blocks * sms >= 16 * 64
