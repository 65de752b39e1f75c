"""Differential tests for the port's rwkv6 model (``repro_torch.models.rwkv``)
against the reference's (``repro.models.rwkv``): the parameter tree and its
carry-over, ``forward`` with and without states, ``decode_step`` replays
against the reference's and against the port's own ``forward``, the
in-place cache update, dtypes, and the ``wkv=`` seam.

Every model test runs on ``cfg.tiny()`` (d_model 64: one head of 64) and
on the same config with ``rwkv_head_dim=16`` (four heads), where a mix-up
of the head and time axes would show."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as r_registry  # noqa: E402
from repro.models import rwkv as r_rwkv  # noqa: E402
from repro_torch.convert import params_from_jax, rwkv_cache_from_jax  # noqa: E402
from repro_torch.kernels.wkv6 import ref as t_wkv_ref  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402
from repro_torch.models import rwkv as t_rwkv  # noqa: E402

ARCH = "rwkv6-7b"
TINY = r_registry.get_config(ARCH).tiny()
CFGS = {"tiny": TINY, "tiny_hd16": dataclasses.replace(TINY, rwkv_head_dim=16)}
#: fp32 forward and decode against the reference (summation order only)
ATOL = 1e-5
#: decode replay against forward (tests/test_arch_smoke.py:91)
REPLAY_TOL = 5e-3


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, name + "."))
        else:
            out[name] = v
    return out


def _tree(cfg, seed=0):
    """The reference's parameters as numpy, with u, the mixes and w0 drawn
    at random (its init leaves u at 0 and every mix at 0.5, which would
    hide the bonus term and the direction of the token shift)."""
    tree = jax.tree_util.tree_map(
        np.asarray, r_rwkv.init(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    tm, cm = tree["layers"]["tm"], tree["layers"]["cm"]
    for group, name, lo, hi in ((tm, "u", -0.5, 0.5), (tm, "w0", -7.0, -1.0),
                                (tm, "mu_r", 0, 1), (tm, "mu_k", 0, 1),
                                (tm, "mu_v", 0, 1), (tm, "mu_w", 0, 1),
                                (tm, "mu_g", 0, 1), (cm, "mu_k", 0, 1),
                                (cm, "mu_r", 0, 1)):
        a = group[name]
        group[name] = rng.uniform(lo, hi, size=a.shape).astype(a.dtype)
    return tree


def _pair(cfg, seed=0):
    tree = _tree(cfg, seed)
    return tree, params_from_jax(cfg, tree, device="cpu")


def _tokens(cfg, B, T, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(B, T))


# -- registry and parameters ---------------------------------------------------------
def test_registry_ports_rwkv():
    arch = t_registry.get(ARCH)
    assert arch.module is t_rwkv
    assert arch.cfg.family == "ssm"
    assert dataclasses.asdict(arch.tiny().cfg) == dataclasses.asdict(TINY)


@pytest.mark.parametrize("name,cfg", list(CFGS.items()) + [
    ("tiny_bf16", dataclasses.replace(TINY, param_dtype="bfloat16"))])
def test_init_tree_matches_reference_shapes(name, cfg):
    r_params = r_rwkv.init(cfg, jax.random.PRNGKey(0))
    t_params = t_rwkv.init(cfg, 0, device="cpu")
    assert isinstance(t_params, t_rwkv.RwkvParams)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in _flat(r_params).items()}
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in t_params.named_parameters()}
    assert got == want
    assert not any(p.requires_grad for p in t_params.parameters())
    # the constant leaves are the reference's constants
    for k in ("tm.mu_r", "tm.w0", "tm.u", "tm.gn_scale", "cm.mu_k", "ln1.bias"):
        np.testing.assert_array_equal(_np(dict(t_params.named_parameters())[
            "layers." + k]), _np(_flat(r_params)["layers." + k]))


@pytest.mark.parametrize("cfg", CFGS.values(), ids=CFGS.keys())
def test_params_from_jax_round_trips_exactly(cfg):
    tree, params = _pair(cfg)
    assert isinstance(params, t_rwkv.RwkvParams)
    got = dict(params.named_parameters())
    want = _flat(tree)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert np.array_equal(_np(got[name]), np.asarray(value, np.float32)), name
    bf = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)), tree)
    pb = params_from_jax(cfg, bf, device="cpu")
    assert pb.layers["tm"]["Wr"].dtype == torch.bfloat16
    assert np.array_equal(_np(pb.layers["tm"]["Wr"]),
                          np.asarray(bf["layers"]["tm"]["Wr"]).astype(np.float32))


# -- forward -------------------------------------------------------------------------
@pytest.mark.parametrize("cfg", CFGS.values(), ids=CFGS.keys())
def test_forward_matches_reference(cfg):
    tree, params = _pair(cfg)
    toks = _tokens(cfg, 2, 12)
    want, want_states = r_rwkv.forward(cfg, tree, jnp.asarray(toks),
                                       return_states=True)
    got, got_states = t_rwkv.forward(cfg, params, torch.from_numpy(toks),
                                     return_states=True)
    assert got.shape == (2, 12, cfg.vocab_padded)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=ATOL)
    for g, w in zip(got_states, want_states):
        assert g.shape == w.shape
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL, rtol=ATOL)
    last = t_rwkv.forward(cfg, params, torch.from_numpy(toks), last_only=True)
    np.testing.assert_allclose(_np(last), _np(want)[:, -1:], atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("cfg", CFGS.values(), ids=CFGS.keys())
def test_forward_from_states_matches_reference(cfg):
    """A prefill continued from carried states, in both packages, and
    equal to one forward over the whole sequence."""
    tree, params = _pair(cfg)
    toks = _tokens(cfg, 2, 10)
    _, r_states = r_rwkv.forward(cfg, tree, jnp.asarray(toks[:, :6]),
                                 return_states=True)
    _, t_states = t_rwkv.forward(cfg, params, torch.from_numpy(toks[:, :6]),
                                 return_states=True)
    kept = [s.clone() for s in t_states]
    want = r_rwkv.forward(cfg, tree, jnp.asarray(toks[:, 6:]), states=r_states)
    got = t_rwkv.forward(cfg, params, torch.from_numpy(toks[:, 6:]),
                         states=t_states)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=ATOL)
    whole = t_rwkv.forward(cfg, params, torch.from_numpy(toks))
    np.testing.assert_allclose(_np(got), _np(whole)[:, 6:], atol=ATOL,
                               rtol=ATOL)
    assert all(torch.equal(a, b) for a, b in zip(kept, t_states))


def test_bf16_dtypes_follow_reference():
    """r/k/v and the token shifts in bf16, w and the WKV state in fp32,
    logits in bf16 — as the reference returns them; values agree to bf16
    rounding (the two frameworks round bf16 at other places)."""
    cfg = dataclasses.replace(CFGS["tiny_hd16"], param_dtype="bfloat16")
    tree = _tree(cfg)
    params = params_from_jax(cfg, tree, device="cpu")
    toks = _tokens(cfg, 2, 8)
    want, want_states = r_rwkv.forward(cfg, tree, jnp.asarray(toks),
                                       return_states=True)
    got, got_states = t_rwkv.forward(cfg, params, torch.from_numpy(toks),
                                     return_states=True)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    assert [str(s.dtype).split(".")[-1] for s in got_states] == [
        str(s.dtype) for s in want_states] == ["bfloat16", "bfloat16", "float32"]
    np.testing.assert_allclose(_np(got), _np(want), atol=0.05, rtol=0.05)


# -- decode ----------------------------------------------------------------------------
@pytest.mark.parametrize("cfg", CFGS.values(), ids=CFGS.keys())
def test_decode_steps_match_reference_and_forward(cfg):
    tree, params = _pair(cfg)
    B, S = 2, 8
    toks = _tokens(cfg, B, S)
    full = _np(t_rwkv.forward(cfg, params, torch.from_numpy(toks)))
    r_cache = r_rwkv.init_cache(cfg, B, S)
    t_cache = t_rwkv.init_cache(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        want, r_cache = r_rwkv.decode_step(cfg, tree, r_cache,
                                           jnp.asarray(toks[:, t]))
        got, t_cache = t_rwkv.decode_step(cfg, params, t_cache,
                                          torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=ATOL)
        outs.append(_np(got))
    err = float(np.max(np.abs(np.stack(outs, 1) - full)))
    assert err < REPLAY_TOL, err
    for name in ("tm", "cm", "wkv"):
        np.testing.assert_allclose(_np(t_cache[name]), _np(r_cache[name]),
                                   atol=ATOL, rtol=ATOL)
    assert np.array_equal(_np(t_cache["len"]), _np(r_cache["len"]))


@pytest.mark.parametrize("cfg", CFGS.values(), ids=CFGS.keys())
def test_decode_continues_a_reference_cache(cfg):
    """A reference cache taken mid-sequence carries across
    (``rwkv_cache_from_jax``, bf16 token shifts included) and both
    packages decode on from it alike; so does a cache made of the port's
    prefill states."""
    tree, params = _pair(cfg)
    toks = _tokens(cfg, 2, 7)
    r_cache = r_rwkv.init_cache(cfg, 2)
    for t in range(4):
        _, r_cache = r_rwkv.decode_step(cfg, tree, r_cache,
                                        jnp.asarray(toks[:, t]))
    t_cache = rwkv_cache_from_jax(
        jax.tree_util.tree_map(np.asarray, r_cache), device="cpu")
    assert t_cache["len"].dtype == torch.int32
    _, states = t_rwkv.forward(cfg, params, torch.from_numpy(toks[:, :4]),
                               return_states=True, last_only=True)
    prefilled = dict(zip(("tm", "cm", "wkv"), states),
                     len=torch.full((2,), 4, dtype=torch.int32))
    for t in range(4, 7):
        want, r_cache = r_rwkv.decode_step(cfg, tree, r_cache,
                                           jnp.asarray(toks[:, t]))
        got, t_cache = t_rwkv.decode_step(cfg, params, t_cache,
                                          torch.from_numpy(toks[:, t]))
        again, prefilled = t_rwkv.decode_step(cfg, params, prefilled,
                                              torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=ATOL)
        np.testing.assert_allclose(_np(again), _np(want), atol=ATOL,
                                   rtol=ATOL)


def test_decode_step_updates_the_cache_in_place():
    """The port's divergence: the reference returns new state arrays; the
    port writes the new states into the cache's own tensors (the WKV
    state through ``state_out`` aliasing ``state``) and returns them."""
    cfg = CFGS["tiny_hd16"]
    _, params = _pair(cfg)
    cache = t_rwkv.init_cache(cfg, 2, device="cpu")
    tensors = {k: cache[k] for k in ("tm", "cm", "wkv")}
    ptrs = {k: t.data_ptr() for k, t in tensors.items()}
    _, out = t_rwkv.decode_step(cfg, params, cache, torch.tensor([3, 5]))
    for k, t in tensors.items():
        assert out[k] is t and t.data_ptr() == ptrs[k]
        assert t.abs().sum() > 0, k  # written, no longer the zero state
    assert out["len"].tolist() == [1, 1] and cache["len"].tolist() == [0, 0]


def test_wkv_seam_runs_once_per_layer():
    """Every layer's recurrence goes through the ``wkv`` function the
    caller names (the kernel's wrapper by default): L calls per forward
    over all T, and per decode step with T = 1, the state written in
    place."""
    cfg = CFGS["tiny_hd16"]
    _, params = _pair(cfg)
    calls = []

    def wkv(r, k, v, w, u, state, *, state_out=None):
        calls.append((tuple(r.shape), r.dtype, w.dtype,
                      state_out is not None and
                      state_out.data_ptr() == state.data_ptr()))
        return t_wkv_ref.wkv6(r, k, v, w, u, state, state_out=state_out)

    toks = torch.from_numpy(_tokens(cfg, 2, 5))
    want = t_rwkv.forward(cfg, params, toks)
    got = t_rwkv.forward(cfg, params, toks, wkv=wkv)
    assert torch.equal(got, want)
    assert calls == [((2, 5, 4, 16), torch.float32, torch.float32, False)] * 2
    calls.clear()
    cache = t_rwkv.init_cache(cfg, 2, device="cpu")
    t_rwkv.decode_step(cfg, params, cache, toks[:, 0], wkv=wkv)
    assert calls == [((2, 1, 4, 16), torch.float32, torch.float32, True)] * 2


def test_init_without_a_card_raises_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_rwkv.init(TINY, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_rwkv.init_cache(TINY, 2)
