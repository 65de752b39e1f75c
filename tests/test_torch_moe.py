"""Differential tests for the port's MoE family and the attention it
needs: ``moe_mlp``, ``forward_with_aux`` and ``decode_step`` against
``repro.models.moe`` at deepseek-moe-16b ``.tiny()`` in fp32, through
``params_from_jax``; the full-sequence ``attention`` and the model-level
``decode_attention`` against ``repro.models.attention``; the decode
replay against ``forward``; the registry and the serve CLI's refusal.

Tolerances: fp32 on the CPU, the same inputs; the port's matmuls and
softmaxes differ from XLA's in rounding only, so outputs agree to 1e-4
(absolute and relative) and routing (expert counts, drops) exactly."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as r_attn  # noqa: E402
from repro.models import moe as r_moe  # noqa: E402
from repro.models import registry as r_registry  # noqa: E402
from repro.models import transformer as r_dense  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402
from repro_torch.models import transformer as t_dense  # noqa: E402

ARCH = "deepseek-moe-16b"
TOL = dict(atol=1e-4, rtol=1e-4)
REPLAY_TOL = 5e-3  # the reference's test_decode_matches_forward


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _tiny(**moe):
    cfg = r_registry.get(ARCH).tiny().cfg
    tcfg = t_registry.get(ARCH).tiny().cfg
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
        tcfg = dataclasses.replace(tcfg,
                                   moe=dataclasses.replace(tcfg.moe, **moe))
    return cfg, tcfg


def _params(cfg, tcfg, seed=0):
    tree = jax.tree_util.tree_map(
        np.asarray, r_moe.init(cfg, jax.random.PRNGKey(seed)))
    return tree, params_from_jax(tcfg, tree, device="cpu")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


# -- the parameter tree --------------------------------------------------------------
def test_init_tree_matches_reference_shapes():
    cfg, tcfg = _tiny()
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in
            _flat(r_moe.init(cfg, jax.random.PRNGKey(0))).items()}
    params = t_moe.init(tcfg, 0, device="cpu")
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in params.named_parameters()}
    assert got == want
    assert not any(p.requires_grad for p in params.parameters())
    assert "units.moe.router" in got and got["units.moe.router"][1] == \
        "float32"


def test_params_from_jax_round_trips_exactly():
    cfg, tcfg = _tiny()
    tree, params = _params(cfg, tcfg, 1)
    got = dict(params.named_parameters())
    want = _flat(tree)
    assert sorted(got) == sorted(want)
    for name, value in want.items():
        assert np.array_equal(_np(got[name]), np.asarray(value)), name
    assert params.unit(1)["moe"]["experts"]["w_up"].data_ptr() == (
        got["units.moe.experts.w_up"][1].data_ptr())


def test_init_follows_the_seed_and_the_scales():
    _, tcfg = _tiny()
    a = t_moe.init(tcfg, 3, device="cpu")
    b = t_moe.init(tcfg, 3, device="cpu")
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    w = a.units["moe"]["experts"]["w_down"]  # (U, E, f, d): fan-in f
    assert abs(float(w.std()) - 1 / np.sqrt(w.shape[-2])) < 0.05


def test_init_without_a_card_raises_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, tcfg = _tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_moe.init(tcfg, 0)


# -- attention -----------------------------------------------------------------------
@pytest.mark.parametrize("window,S,q_chunk", [(0, 12, 1024), (5, 12, 1024),
                                              (0, 12, 4), (3, 10, 4)])
def test_attention_matches_reference(window, S, q_chunk):
    """Full-sequence attention, causal, with and without a sliding window,
    unchunked and q-chunked (10 % 4: the largest divisor, 2)."""
    rng = np.random.default_rng(0)
    B, D, H, K, hd = 2, 32, 4, 2, 8
    p = {n: rng.normal(size=s).astype(np.float32) * 0.2
         for n, s in (("wq", (D, H * hd)), ("wk", (D, K * hd)),
                      ("wv", (D, K * hd)), ("wo", (H * hd, D)))}
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).copy()
    kw = dict(n_heads=H, n_kv_heads=K, head_dim=hd, causal=True,
              window=window, rope_theta=10_000.0, q_chunk=q_chunk)
    want = r_attn.attention(jnp.asarray(x), {k: jnp.asarray(v)
                                             for k, v in p.items()},
                            positions=jnp.asarray(pos), **kw)
    got = t_attn.attention(_t(x), {k: _t(v) for k, v in p.items()},
                           positions=_t(pos), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("window", [0, 4])
def test_decode_attention_matches_reference(window):
    """The model-level decode step over a full cache and a ring buffer,
    several steps; the port writes the cache in place."""
    rng = np.random.default_rng(1)
    B, D, H, K, hd, T = 3, 32, 4, 2, 8, 6
    p = {n: rng.normal(size=s).astype(np.float32) * 0.2
         for n, s in (("wq", (D, H * hd)), ("wk", (D, K * hd)),
                      ("wv", (D, K * hd)), ("wo", (H * hd, D)))}
    kw = dict(n_heads=H, n_kv_heads=K, head_dim=hd, window=window)
    rk = rv = jnp.zeros((B, T, K, hd), jnp.float32)
    tk = torch.zeros((B, T, K, hd))
    tv = torch.zeros((B, T, K, hd))
    lens = np.array([0, 2, 5])
    for step in range(8):
        x = rng.normal(size=(B, D)).astype(np.float32)
        cl = lens + step
        want, rk, rv = r_attn.decode_attention(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, rk,
            rv, jnp.asarray(cl), positions=jnp.asarray(cl), **kw)
        got, k2, v2 = t_attn.decode_attention(
            _t(x), {k: _t(v) for k, v in p.items()}, tk, tv, _t(cl),
            positions=_t(cl), **kw)
        assert k2 is tk and v2 is tv
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        np.testing.assert_allclose(_np(tk), _np(rk), **TOL)


def test_decode_attention_runs_through_attend_partial():
    """The per-partition attention is the kernel's wrapper, and ``attend``
    swaps it (the seam a check on the card uses)."""
    calls = []

    def attend(q, k, v, valid):
        calls.append(tuple(k.shape))
        return t_attn.attend_partial(q, k, v, valid)
    _, tcfg = _tiny()
    params = t_moe.init(tcfg, 0, device="cpu")
    cache = t_moe.init_cache(tcfg, 2, 8, device="cpu")
    tok = torch.tensor([1, 2])
    a, _ = t_moe.decode_step(tcfg, params, cache, tok, attend=attend)
    assert len(calls) == tcfg.n_layers
    cache = t_moe.init_cache(tcfg, 2, 8, device="cpu")
    b, _ = t_moe.decode_step(tcfg, params, cache, tok)
    assert torch.equal(a, b)


# -- the routed MLP ------------------------------------------------------------------
@pytest.mark.parametrize("T,cf,n_shared", [(12, 4.0, 2), (40, 0.5, 2),
                                           (9, 1.25, 0)])
def test_moe_mlp_matches_reference(T, cf, n_shared):
    """Output, ``expert_counts`` and ``dropped`` (0.5 capacity drops
    tokens), shared experts on and off."""
    cfg, tcfg = _tiny(capacity_factor=cf, n_shared=n_shared,
                      shared_d_ff=32 if n_shared else 0, n_experts=8,
                      top_k=3)
    tree, params = _params(cfg, tcfg)
    lp_r = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]),
                                  tree["units"]["moe"])
    lp_t = params.unit(0)["moe"]
    x = np.random.default_rng(2).normal(size=(T, cfg.d_model)) \
        .astype(np.float32)
    want, raux = r_moe.moe_mlp(jnp.asarray(x), lp_r, cfg.moe, cfg.act)
    got, taux = t_moe.routed_mlp(_t(x), lp_t, tcfg.moe, tcfg.act)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert np.array_equal(_np(taux["expert_counts"]),
                          _np(raux["expert_counts"]))
    assert float(taux["dropped"]) == pytest.approx(float(raux["dropped"]))
    if cf < 1:
        assert float(taux["dropped"]) > 0
    for k in ("lb_loss", "z_loss"):
        assert float(taux[k]) == pytest.approx(float(raux[k]), rel=1e-5)


def test_routed_mlp_is_the_single_device_dispatch():
    """Without a process group in the policy's ``_ep`` (none installed,
    or a launch policy's mesh record: one card runs every expert),
    ``routed_mlp`` is ``moe_mlp``; the expert-parallel ``moe_mlp_ep``
    takes a group (``tests/test_torch_launch.py``)."""
    from repro_torch.launch import mesh as t_mesh, shardings as t_sh
    from repro_torch.models.common import activation_sharding
    cfg, tcfg = _tiny()
    _, params = _params(cfg, tcfg)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(6, cfg.d_model)).astype(np.float32))
    lp = params.unit(1)["moe"]
    a, aux_a = t_moe.routed_mlp(x, lp, tcfg.moe, tcfg.act)
    b, aux_b = t_moe.moe_mlp(x, lp, tcfg.moe, tcfg.act)
    assert torch.equal(a, b)
    assert torch.equal(aux_a["expert_counts"], aux_b["expert_counts"])
    policy = t_sh.activation_policy(t_mesh.make_mesh((2, 1), ("data",
                                                             "model")))
    with activation_sharding(policy):
        c, _ = t_moe.routed_mlp(x, lp, tcfg.moe, tcfg.act)
    assert torch.equal(a, c)
    assert hasattr(r_moe, "moe_mlp_ep") and hasattr(t_moe, "moe_mlp_ep")


def test_capacity_follows_the_reference():
    cfg = t_registry.get_config(ARCH)
    assert t_moe.capacity(4096, cfg.moe) == 480  # a 8 x 512 prefill
    assert t_moe.capacity(8, cfg.moe) == 8  # a decode step


def test_combine_order_is_fixed():
    """The combine adds each token's choices in ascending expert id, the
    reference's scatter order: a bf16 run gives the same bits twice and
    the bits of that order."""
    cfg, tcfg = _tiny()
    _, params = _params(cfg, tcfg)
    lp = {k: (v.to(torch.bfloat16) if k not in ("router",) and
              not isinstance(v, dict) else v)
          for k, v in params.unit(0)["moe"].items()}
    lp["experts"] = {k: v.to(torch.bfloat16)
                     for k, v in lp["experts"].items()}
    lp["shared"] = {k: v.to(torch.bfloat16) for k, v in lp["shared"].items()}
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(16, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    spec = dataclasses.replace(tcfg.moe, n_shared=0)
    a, _ = t_moe.moe_mlp(x, lp, spec, tcfg.act)
    b, _ = t_moe.moe_mlp(x, lp, spec, tcfg.act)
    assert torch.equal(a, b)
    # the same sum by a scatter that walks the sorted pairs in order
    E, K = spec.n_experts, spec.top_k
    probs = torch.softmax(x.float() @ lp["router"].float(), -1)
    gw, gi = torch.topk(probs, K)
    gw = gw / gw.sum(-1, keepdim=True)
    out = t_moe.expert_apply(x[None].expand(E, -1, -1).contiguous(),
                             lp["experts"], tcfg.act)  # (E, T, D)
    want = torch.zeros_like(x)
    for i in torch.argsort(gi.reshape(-1), stable=True).tolist():
        t, k = divmod(i, K)
        e = int(gi[t, k])
        want[t] = want[t] + out[e, t] * gw[t, k].to(x.dtype)
    assert torch.equal(a, want)


# -- the model -----------------------------------------------------------------------
def test_forward_with_aux_matches_reference():
    cfg, tcfg = _tiny()
    tree, params = _params(cfg, tcfg)
    toks = np.random.default_rng(4).integers(0, 200, size=(2, 10))
    want, raux = r_moe.forward_with_aux(cfg, tree, jnp.asarray(toks))
    got, taux = t_moe.forward_with_aux(tcfg, params, _t(toks))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert np.array_equal(_np(taux["expert_counts"]),
                          _np(raux["expert_counts"]))
    assert float(taux["expert_counts"].sum()) == 2 * 10 * \
        tcfg.moe.top_k * 2  # two units, dropless at tiny scale
    for k in ("lb_loss", "z_loss", "dropped"):
        assert float(taux[k]) == pytest.approx(float(raux[k]), rel=1e-5,
                                               abs=1e-7)
    last = t_moe.forward(tcfg, params, _t(toks), last_only=True)
    np.testing.assert_allclose(_np(last), _np(want[:, -1:]), **TOL)


def test_dense_forward_and_decode_match_reference():
    """The dense transformer's ``forward``, ``init_cache`` and
    ``decode_step`` (MoE's dense layers run through them)."""
    arch = r_registry.get("starcoder2-3b").tiny()
    cfg = arch.cfg
    tcfg = t_registry.get("starcoder2-3b").tiny().cfg
    tree = jax.tree_util.tree_map(
        np.asarray, r_dense.init(cfg, jax.random.PRNGKey(5)))
    params = params_from_jax(tcfg, tree, device="cpu")
    toks = np.random.default_rng(5).integers(0, 200, size=(2, 6))
    np.testing.assert_allclose(
        _np(t_dense.forward(tcfg, params, _t(toks))),
        _np(r_dense.forward(cfg, tree, jnp.asarray(toks))), **TOL)
    rc = r_dense.init_cache(cfg, 2, 6)
    tc = t_dense.init_cache(tcfg, 2, 6, device="cpu")
    assert tuple(tc["k"].shape) == rc["k"].shape
    assert tc["len"].dtype == torch.int32
    for t in range(6):
        want, rc = r_dense.decode_step(cfg, tree, rc, jnp.asarray(toks[:, t]))
        got, tc = t_dense.decode_step(tcfg, params, tc, _t(toks[:, t]))
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(tc["k"]), _np(rc["k"]), **TOL)


def test_decode_steps_match_reference():
    cfg, tcfg = _tiny()
    tree, params = _params(cfg, tcfg, 2)
    B, S = 2, 8
    toks = np.random.default_rng(6).integers(0, 200, size=(B, S))
    rc = r_moe.init_cache(cfg, B, S)
    tc = t_moe.init_cache(tcfg, B, S, device="cpu")
    for t in range(S):
        want, rc = r_moe.decode_step(cfg, tree, rc, jnp.asarray(toks[:, t]))
        got, tc = t_moe.decode_step(tcfg, params, tc, _t(toks[:, t]))
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert np.array_equal(_np(tc["len"]), _np(rc["len"]))
    np.testing.assert_allclose(_np(tc["v"]), _np(rc["v"]), **TOL)


def test_decode_replay_matches_forward():
    """The reference's serving invariant at its tolerance: a decode replay
    equals the parallel forward."""
    _, tcfg = _tiny()
    params = t_moe.init(tcfg, 7, device="cpu")
    B, S = 2, 8
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, 200,
                                                              size=(B, S)))
    full = t_moe.forward(tcfg, params, toks)
    cache = t_moe.init_cache(tcfg, B, S, device="cpu")
    k_store = cache["k"]
    outs = []
    for t in range(S):
        lg, cache = t_moe.decode_step(tcfg, params, cache, toks[:, t])
        outs.append(lg)
    assert cache["k"] is k_store  # written in place
    err = float((torch.stack(outs, 1) - full).abs().max())
    assert err < REPLAY_TOL, err


# -- registry and the serve CLI ------------------------------------------------------
def test_registry_ports_moe():
    for arch in ("deepseek-moe-16b", "llama4-maverick-400b-a17b"):
        got = t_registry.get(arch)
        assert got.module is t_moe
        assert got.cfg.family == "moe"


def test_serve_cli_refuses_moe():
    """The reference's serve CLI admits ``moe`` but its tiered decode step
    reads a dense tree's ``layers``; the port refuses the family."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="dense and vlm"):
        serve.main(["--arch", ARCH, "--tiny", "--device", "cpu"])
    cfg, _ = _tiny()
    tree = r_moe.init(cfg, jax.random.PRNGKey(0))
    assert "layers" not in tree and {"head_dense", "units"} <= set(tree)
