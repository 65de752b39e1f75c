"""The reference's per-architecture suite (``tests/test_arch_smoke.py``)
on the port, each of the ten arch ids at ``.tiny()`` in fp32, held
against ``repro`` on the same inputs and the same weights: the port's
``init`` as the reference's nested tree of numpy arrays, which the
reference reads as it is and ``params_from_jax`` carries back.  Each
arch's reference forward and ``jax.value_and_grad`` are one jitted
program, run once and shared by the tests that read them.

* the weights' paths, shapes and dtypes are the reference ``init``'s
  (``jax.eval_shape``), and forward logits match the reference's
  (atol 1e-4);
* ``loss_and_grad`` with remat against ``jax.value_and_grad`` of the
  reference's loss (loss rtol 1e-5, every gradient atol 1e-5 plus rtol
  1e-4: rwkv's ``u`` sums B x T products in another order), then one
  AdamW step on the same batch lowers the loss;
* a decode replay against the port's own forward (5e-3, the reference
  test's bound) and, step for step, against the reference's
  ``decode_step`` (atol 1e-4); for the hybrid and audio families the
  reference's final cache, carried across by ``convert``, equals the
  port's (atol 1e-4);
* ``param_count`` within 12% of the advertised size and equal to the
  reference config's.

Two more cases: recurrentgemma with 7 layers (2 units and a tail
layer) and a decode past its ring (24 steps over a 16-row window), both
against the reference; and the registry's and the serving driver's
divergences from nothing: ``all_archs()`` holds the ten ids, and the
serve CLI refuses the ``hybrid`` and ``audio`` families, as the
reference's does."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import registry as r_registry  # noqa: E402
from repro_torch.convert import (params_from_jax,  # noqa: E402
                                 rglru_cache_from_jax,
                                 whisper_cache_from_jax)
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402
from repro_torch.tree import keystr, named_leaves  # noqa: E402

ARCHS = list(t_registry.ARCH_IDS)
B, S = 2, 8


def _pair(arch_id, n_layers=None):
    rarch = r_registry.get(arch_id).tiny()
    tarch = t_registry.get(arch_id).tiny()
    if n_layers is not None:
        rarch = dataclasses.replace(
            rarch, cfg=dataclasses.replace(rarch.cfg, n_layers=n_layers))
        tarch = dataclasses.replace(
            tarch, cfg=dataclasses.replace(tarch.cfg, n_layers=n_layers))
    return rarch, tarch


@functools.lru_cache(maxsize=None)
def _tree(arch_id, n_layers=None):
    """The weights both sides read: the port's ``init`` (seed 0) as the
    reference's nested tree of numpy arrays."""
    _, tarch = _pair(arch_id, n_layers)
    out: dict = {}
    for name, p in tarch.module.init(tarch.cfg, 0,
                                     device="cpu").named_parameters():
        node = out
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.detach().numpy()
    return out


def _inputs(cfg, seq=S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, min(cfg.vocab_padded, 200),
                        size=(B, seq)).astype(np.int32)
    extra = {}
    if cfg.family == "audio":
        extra["frames"] = rng.normal(
            size=(B, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        extra["prefix_embeds"] = rng.normal(
            size=(B, cfg.vision.n_prefix_tokens, cfg.d_model)
        ).astype(np.float32)
    return toks, extra


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _reference(arch_id, n_layers=None, seq=S, seed=0):
    """The reference on ``_tree``'s weights and ``_inputs``' batch (labels
    the tokens), one jitted program: (forward logits, loss, {keystr:
    gradient})."""
    rarch, _ = _pair(arch_id, n_layers)
    cfg, mod = rarch.cfg, rarch.module
    toks, extra = _inputs(cfg, seq, seed)

    def run(p, b):
        logits = mod.forward(cfg, p, b["tokens"], **{k: b[k] for k in extra})
        return logits, jax.value_and_grad(lambda q: mod.loss(cfg, q, b))(p)
    logits, (loss, grads) = jax.jit(run)(
        _tree(arch_id, n_layers), {"tokens": toks, "labels": toks, **extra})
    return np.asarray(logits), float(loss), {
        jax.tree_util.keystr(p): np.asarray(g)
        for p, g in jax.tree_util.tree_leaves_with_path(grads)}


@pytest.mark.parametrize("arch_id", ARCHS)
def test_forward_matches_reference(arch_id):
    rarch, tarch = _pair(arch_id)
    tree = _tree(arch_id)
    shapes = jax.eval_shape(
        lambda: rarch.module.init(rarch.cfg, jax.random.PRNGKey(0)))
    assert {keystr(k): (v.shape, v.dtype) for k, v in named_leaves(tree)} \
        == {jax.tree_util.keystr(p): (tuple(s.shape), np.dtype(s.dtype))
            for p, s in jax.tree_util.tree_leaves_with_path(shapes)}
    params = params_from_jax(tarch.cfg, tree, device="cpu")
    toks, extra = _inputs(rarch.cfg)
    want, _, _ = _reference(arch_id)
    got = tarch.module.forward(tarch.cfg, params, _t(toks),
                               **{k: _t(v) for k, v in extra.items()})
    assert got.shape == (B, S, tarch.cfg.vocab_padded)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_train_step_matches_reference(arch_id):
    rarch, tarch = _pair(arch_id)
    tree = _tree(arch_id)
    params = params_from_jax(tarch.cfg, tree, device="cpu")
    toks, extra = _inputs(rarch.cfg)
    raw = {"tokens": toks, "labels": toks, **extra}
    _, want_loss, want = _reference(arch_id)
    batch = {k: _t(v) for k, v in raw.items()}
    loss0, grads = tarch.module.loss_and_grad(tarch.cfg, params, batch,
                                              remat=True)
    np.testing.assert_allclose(float(loss0), want_loss, rtol=1e-5)
    assert set(want) == {keystr(k) for k in grads}
    for k, g in grads.items():
        assert torch.isfinite(g).all(), k
        np.testing.assert_allclose(g.numpy(), want[keystr(k)], atol=1e-5,
                                   rtol=1e-4, err_msg=k)
    cfg = adamw.AdamWConfig(lr=1e-3, schedule=schedules.constant())
    adamw.apply(cfg, params, grads, adamw.init_state(params))
    with torch.no_grad():
        loss1 = tarch.module.loss(tarch.cfg, params, batch)
    assert float(loss1) < float(loss0)


def _decode_run(rarch, tarch, tree, toks, extra):
    """(port logits (B,T,V) step by step, the reference's, port forward)."""
    rcfg, tcfg = rarch.cfg, tarch.cfg
    rmod, tmod = rarch.module, tarch.module
    T = toks.shape[1]
    params = params_from_jax(tcfg, tree, device="cpu")
    if tcfg.family == "audio":
        frames = extra["frames"]
        full = tmod.forward(tcfg, params, _t(toks), frames=_t(frames))
        xk, xv = tmod.prepare_cross(tcfg, params,
                                    tmod.encode(tcfg, params, _t(frames)))
        cache = tmod.init_cache(tcfg, B, T, device="cpu")
        cache["xk"].copy_(xk)
        cache["xv"].copy_(xv)
        rcache = rmod.init_cache(rcfg, B, T)
        rcache["xk"], rcache["xv"] = rmod.prepare_cross(
            rcfg, tree, rmod.encode(rcfg, tree, jnp.asarray(frames)))
    else:
        full = tmod.forward(tcfg, params, _t(toks))
        cache = tmod.init_cache(tcfg, B, T, device="cpu")
        rcache = rmod.init_cache(rcfg, B, T)
    rstep = jax.jit(lambda p, c, t: rmod.decode_step(rcfg, p, c, t))
    got, want = [], []
    for t in range(T):
        lg, cache = tmod.decode_step(tcfg, params, cache, _t(toks[:, t]))
        got.append(lg)
        rlg, rcache = rstep(tree, rcache, toks[:, t])
        want.append(np.asarray(rlg))
    convert = {"hybrid": rglru_cache_from_jax,
               "audio": whisper_cache_from_jax}.get(tcfg.family)
    if convert is not None:
        # the reference's cache carried across equals the port's own
        carried = convert(jax.tree_util.tree_map(np.asarray, rcache),
                          device="cpu")
        for (k, a), (k2, b) in zip(named_leaves(carried),
                                   named_leaves(cache)):
            assert k == k2 and a.dtype == b.dtype, (k, k2)
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                       err_msg=k)
    return torch.stack(got, 1), np.stack(want, 1), full


@pytest.mark.parametrize("arch_id", ARCHS)
def test_decode_matches_forward_and_reference(arch_id):
    rarch, tarch = _pair(arch_id)
    toks, extra = _inputs(rarch.cfg)
    got, want, full = _decode_run(rarch, tarch, _tree(arch_id), toks, extra)
    assert float((got - full).abs().max()) < 5e-3
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_hybrid_tail_and_wrapped_ring_match_reference():
    """recurrentgemma with 7 layers (2 units of 3 and a tail layer),
    decoding 24 tokens over its 16-row ring: forward, gradients and each
    decode step against the reference, the replay against the forward."""
    rarch, tarch = _pair("recurrentgemma-9b", n_layers=7)
    assert tarch.cfg.local_window == 16
    tree = _tree("recurrentgemma-9b", 7)
    assert "tail_rec" in tree
    toks, _ = _inputs(rarch.cfg, seq=24, seed=1)
    got, want_steps, full = _decode_run(rarch, tarch, tree, toks, {})
    assert tuple(got.shape[:2]) == (B, 24)
    want_full, want_loss, want = _reference("recurrentgemma-9b", 7, 24, 1)
    np.testing.assert_allclose(full.numpy(), want_full, atol=1e-4)
    assert float((got - full).abs().max()) < 5e-3
    np.testing.assert_allclose(got.numpy(), want_steps, atol=1e-4)
    params = params_from_jax(tarch.cfg, tree, device="cpu")
    loss, grads = tarch.module.loss_and_grad(
        tarch.cfg, params, {"tokens": _t(toks), "labels": _t(toks)})
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    assert any(k.startswith("tail_rec.") for k in grads)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[keystr(k)], atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_param_count_matches_claim(arch_id):
    """Analytical parameter count within 12% of the advertised size."""
    cfg = t_registry.get_config(arch_id)
    claimed = {
        "qwen2.5-32b": 32e9, "starcoder2-3b": 3e9, "qwen1.5-32b": 32e9,
        "stablelm-12b": 12e9, "recurrentgemma-9b": 9e9, "internvl2-2b": 2e9,
        "rwkv6-7b": 7e9, "llama4-maverick-400b-a17b": 400e9,
        "deepseek-moe-16b": 16e9, "whisper-large-v3": 1.5e9,
    }[arch_id]
    assert cfg.param_count() == r_registry.get_config(arch_id).param_count()
    assert abs(cfg.param_count() - claimed) / claimed < 0.12


def test_all_archs_and_the_serving_refusals():
    archs = t_registry.all_archs()
    assert list(archs) == list(r_registry.ARCH_IDS) and len(archs) == 10
    for arch_id, arch in archs.items():
        assert arch.cfg.family == r_registry.get_config(arch_id).family
        for fn in ("init", "forward", "loss", "loss_and_grad",
                   "init_cache", "decode_step"):
            assert callable(getattr(arch.module, fn)), (arch_id, fn)
    for arch_id in ("recurrentgemma-9b", "whisper-large-v3"):
        with pytest.raises(SystemExit):
            t_serve.main(["--arch", arch_id, "--tiny", "--device", "cpu",
                          "--requests", "1"])


@pytest.mark.parametrize("T", [1, 2, 37, 64])
def test_rg_lru_scan_matches_reference(T):
    """Intended divergence: the port's RG-LRU scan is a log-depth
    Hillis–Steele scan (the reference's ``jax.lax.associative_scan``,
    same combine); both against the plain sequential recurrence, fp32,
    decays spanning the model's range, a nonzero starting state."""
    from repro.models import rglru as r_rglru
    from repro_torch.models import rglru as t_rglru
    rng = np.random.default_rng(T)
    a = np.exp(-8.0 * rng.uniform(0, 1, size=(2, T, 8))).astype(np.float32)
    x = rng.normal(size=(2, T, 8)).astype(np.float32)
    h0 = rng.normal(size=(2, 8)).astype(np.float32)
    h, last = t_rglru.rg_lru_scan(_t(a), _t(x), _t(h0))
    rh, rlast = jax.jit(lambda *v: r_rglru.rg_lru_scan(None, *v))(a, x, h0)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=1e-5)
    np.testing.assert_allclose(last.numpy(), np.asarray(rlast), atol=1e-5)
    s, seq = h0.astype(np.float64), []
    for t in range(T):
        s = a[:, t] * s + np.sqrt(np.maximum(1 - a[:, t] ** 2, 1e-12)) \
            * x[:, t]
        seq.append(s)
    np.testing.assert_allclose(h.numpy(), np.stack(seq, 1), atol=1e-5)
