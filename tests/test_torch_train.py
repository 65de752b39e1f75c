"""Differential tests for the port's training slice: ``cross_entropy``,
``transformer.loss`` and its gradients, the ``wkv6`` autograd Function,
the LR schedules, AdamW, ``TieredAdamW`` (step, quantized moments,
placement, repartition, the mover's descriptors), the token pipeline,
the checkpointer, gradient compression, the straggler mitigator, the
training driver for every family and ``examples/train_tiny_lm``, each
against ``repro`` on the same inputs (weights carried across by
``params_from_jax``).

Tolerances: losses rtol 1e-5 and gradients atol 1e-5 (fp32 tiny models);
schedules rtol 1e-6; AdamW atol 1e-6 (``tests/test_substrates.py``);
three fused-against-tiered steps atol 5e-5 (``tests/test_system.py``);
the training driver's losses 1e-4; the ``wkv6`` autograd Function's
gradients 1e-6 of the plain loop's on the CPU, 1e-4 on the card.  Billed
bytes, descriptor and batch counts, page-map choices, Caption decisions,
pipeline batches, int8 moments and checkpoint bits match exactly.  The
``cuda`` tests need a card."""
import contextlib
import io
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.checkpointer import Checkpointer as RCheckpointer  # noqa: E402
from repro.core.mover import BulkMover as RMover  # noqa: E402
from repro.core.telemetry import Telemetry as RTel  # noqa: E402
from repro.core.tiers import topology_from_spec as r_topology  # noqa: E402
from repro.data.pipeline import DataConfig as RDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as RPipeline  # noqa: E402
from repro.launch import train as r_train  # noqa: E402
from repro.models import common as r_common  # noqa: E402
from repro.models import registry as r_registry  # noqa: E402
from repro.optim import adamw as r_adamw  # noqa: E402
from repro.optim import compression as r_comp  # noqa: E402
from repro.optim import offload as r_off  # noqa: E402
from repro.optim import schedules as r_sch  # noqa: E402
from repro_torch.checkpoint.checkpointer import Checkpointer  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.mover import BulkMover  # noqa: E402
from repro_torch.core.telemetry import Telemetry  # noqa: E402
from repro_torch.core.tiers import topology_from_spec  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import common as t_common  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402
from repro_torch.optim import adamw, compression, offload, schedules  # noqa: E402
from repro_torch.runtime.straggler import StragglerMitigator  # noqa: E402
from repro_torch.tree import keystr, named_leaves, ref_key  # noqa: E402


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _at(tree, name):
    """The reference tree's leaf at a port leaf's dotted name."""
    for part in name.split("."):
        tree = tree[part]
    return tree


def _routes(tel):
    return {k: (v.bytes_moved, v.descriptors, v.batches)
            for k, v in tel.routes.items() if v.bytes_moved or v.descriptors
            or v.batches}


def _opt_counters(tel):
    return {k: v for k, v in tel.counters.items() if k.startswith("caption.opt")}


# -- the loss ----------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 5, 17)).astype(np.float32) * 3
    labels = rng.integers(0, 17, size=(3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.4).astype(np.float32) if masked else None
    want = r_common.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                  None if mask is None else jnp.asarray(mask))
    got = t_common.cross_entropy(_t(logits), _t(labels),
                                 None if mask is None else _t(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def _tiny_model(arch_id, seed=0):
    rarch = r_registry.get(arch_id).tiny()
    tarch = t_registry.get(arch_id).tiny()
    tree = jax.tree_util.tree_map(
        np.asarray, rarch.module.init(rarch.cfg, jax.random.PRNGKey(seed)))
    return rarch, tarch, tree, params_from_jax(tarch.cfg, tree, device="cpu")


def _batch(cfg, batch=2, seq=16, seed=11):
    raw = RPipeline(RDataConfig(vocab=cfg.vocab_padded, batch=batch, seq=seq,
                                seed=seed)).batch_at(3)
    raw = dict(raw)
    if cfg.family == "vlm":
        raw["prefix_embeds"] = np.random.default_rng(seed).normal(
            size=(batch, cfg.vision.n_prefix_tokens, cfg.d_model)
        ).astype(np.float32)
    return raw


@pytest.mark.parametrize("arch_id", ["starcoder2-3b", "internvl2-2b"])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(arch_id, remat):
    """``loss_and_grad`` against ``jax.value_and_grad`` of the reference's
    loss, every leaf; a stacked leaf's gradient is one [L, ...] tensor."""
    rarch, tarch, tree, params = _tiny_model(arch_id)
    raw = _batch(rarch.cfg)
    rb = {k: jnp.asarray(v) for k, v in raw.items()}
    want_loss, want_grads = jax.value_and_grad(
        lambda p: rarch.module.loss(rarch.cfg, p, rb, remat=remat))(tree)
    tb = {k: _t(v) for k, v in raw.items()}
    loss, grads = tarch.module.loss_and_grad(tarch.cfg, params, tb,
                                             remat=remat)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    assert all(not p.requires_grad for _, p in named_leaves(params))
    want = {jax.tree_util.keystr(p): np.asarray(g) for p, g in
            jax.tree_util.tree_leaves_with_path(want_grads)}
    assert set(want) == {keystr(k) for k in grads}
    for k, g in grads.items():
        w = want[keystr(k)]
        assert tuple(g.shape) == w.shape, k
        np.testing.assert_allclose(_np(g), w, atol=1e-5, err_msg=k)


def test_training_forward_leaves_the_serving_views_alone():
    """Inference keeps ``layer()``'s cached views (no autograd history);
    the training forward reads fresh ones."""
    _, tarch, _, params = _tiny_model("starcoder2-3b")
    cached = params.layer(0)
    assert params.layer_trees()[0] is cached
    tb = {k: _t(v) for k, v in _batch(tarch.cfg).items()}
    tarch.module.loss_and_grad(tarch.cfg, params, tb)
    assert params.layer(0) is cached
    assert not cached["mlp"]["w_up"].requires_grad


# -- schedules and AdamW -------------------------------------------------------
@pytest.mark.parametrize("name,args", [
    ("warmup_cosine", (10, 100)), ("warmup_cosine", (0, 50, 0.2)),
    ("warmup_linear", (5, 40)), ("constant", ())])
def test_schedules_match_reference(name, args):
    rf, tf = getattr(r_sch, name)(*args), getattr(schedules, name)(*args)
    for s in (0, 1, 4, 5, 9, 10, 11, 37, 50, 99, 100, 150):
        want = float(rf(jnp.asarray(s, jnp.int32)))
        got = float(tf(torch.tensor(s, dtype=torch.int32)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _opt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    params = {"big": rng.normal(size=(3_000_000,)).astype(np.float32),
              "small": rng.normal(size=(64,)).astype(np.float32),
              "w": {"mat": rng.normal(size=(700, 1500)).astype(np.float32)}}
    grads = jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * 0.01).astype(np.float32), params)
    return params, grads


def _to_torch(tree):
    return jax.tree_util.tree_map(_t, tree)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_adamw_apply_matches_reference():
    params, grads = _opt_inputs()
    cfg_r = r_adamw.AdamWConfig(lr=1e-3, schedule=r_sch.warmup_cosine(2, 10))
    cfg_t = adamw.AdamWConfig(lr=1e-3, schedule=schedules.warmup_cosine(2, 10))
    rp, rs = _to_jax(params), None
    rs = r_adamw.init_state(rp)
    tp = _to_torch(params)
    ts = adamw.init_state(tp)
    ptrs = {k: p.data_ptr() for k, p in named_leaves(tp)}
    for _ in range(3):
        rp, rs, rm = r_adamw.apply(cfg_r, rp, _to_jax(grads), rs)
        tp, ts, tm = adamw.apply(cfg_t, tp, _to_torch(grads), ts)
    for k, p in named_leaves(tp):
        np.testing.assert_allclose(_np(p), np.asarray(_at(rp, k)), atol=1e-6)
        np.testing.assert_allclose(_np(ts["mu"][k]),
                                   np.asarray(_at(rs["mu"], k)), atol=1e-6)
        np.testing.assert_allclose(_np(ts["nu"][k]),
                                   np.asarray(_at(rs["nu"], k)), atol=1e-6)
    assert {k: p.data_ptr() for k, p in named_leaves(tp)} == ptrs
    assert int(ts["step"]) == 3
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]), rtol=1e-6)


def test_adamw_clips_in_the_gradient_dtype():
    g = {"a": torch.tensor([3.0, 4.0], dtype=torch.bfloat16)}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    want, want_norm = r_adamw.clip_by_global_norm(
        {"a": jnp.asarray([3.0, 4.0], jnp.bfloat16)}, 1.0)
    assert clipped["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(clipped["a"]), _np(want["a"]))
    assert float(norm) == float(want_norm) == 5.0


# -- TieredAdamW -------------------------------------------------------------
def _tiered_pair(slow_fraction, quantized, *, mover=False, params=None,
                 **kw):
    rtel, ttel = RTel(), Telemetry()
    rcfg = r_adamw.AdamWConfig(lr=1e-3, schedule=r_sch.constant())
    tcfg = adamw.AdamWConfig(lr=1e-3, schedule=schedules.constant())
    r_mover = t_mover = None
    if mover:
        r_mover = RMover(r_topology("tpu-v5e"), asynchronous=True,
                         telemetry=rtel)
        t_mover = BulkMover(topology_from_spec("tpu-v5e"), telemetry=ttel,
                            device="cpu")
    ro = r_off.TieredAdamW(rcfg, slow_fraction=slow_fraction,
                           quantize_moments=quantized, telemetry=rtel,
                           mover=r_mover, **kw)
    to = offload.TieredAdamW(tcfg, slow_fraction=slow_fraction,
                             quantize_moments=quantized, telemetry=ttel,
                             mover=t_mover, **kw)
    return ro, to, rtel, ttel


def _compare_slow(rstate, tstate, master_atol=1e-6):
    assert sorted(rstate["slow"]) == sorted(ref_key(k) for k in tstate["slow"])
    for k, leaf in tstate["slow"].items():
        rl = rstate["slow"][ref_key(k)]
        assert (leaf.n_pages, leaf.size, leaf.shape, leaf.quantized,
                leaf.device) == (rl.n_pages, rl.size, rl.shape, rl.quantized,
                                 rl.device)
        np.testing.assert_allclose(leaf.master.numpy(), rl.master,
                                   atol=master_atol)
        if leaf.quantized:
            # int8 moments may differ by one step where the fp32 moment
            # sits on a rounding boundary; the scales agree closely
            for a in ("mu", "nu"):
                d = np.abs(getattr(leaf, a).numpy().astype(int)
                           - getattr(rl, a).astype(int))
                assert d.max() <= 1 and (d > 0).mean() < 1e-3, a
            for a in ("mu_scale", "nu_scale"):
                np.testing.assert_allclose(getattr(leaf, a).numpy(),
                                           getattr(rl, a), rtol=1e-5)
        else:
            np.testing.assert_allclose(leaf.mu.numpy(), rl.mu, atol=1e-9)
            np.testing.assert_allclose(leaf.nu.numpy(), rl.nu, atol=1e-9)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("slow_fraction", [0.9, 1.0])
def test_tiered_step_matches_reference(slow_fraction, quantized):
    params, grads = _opt_inputs()
    ro, to, rtel, ttel = _tiered_pair(slow_fraction, quantized)
    rp, tp = _to_jax(params), _to_torch(params)
    rs, ts = ro.init(rp), to.init(tp)
    _compare_slow(rs, ts)
    assert ro.host_bytes(rs) == to.host_bytes(ts)
    assert ro.traffic_per_step_bytes(rs) == to.traffic_per_step_bytes(ts)
    for _ in range(2):
        rp, rs, rm = ro.step(rp, _to_jax(grads), rs)
        tp, ts, tm = to.step(tp, _to_torch(grads), ts)
    for k, p in named_leaves(tp):
        np.testing.assert_allclose(_np(p), np.asarray(_at(rp, k)), atol=1e-6)
    _compare_slow(rs, ts)
    assert tm["offload_bytes"] == int(rm["offload_bytes"]) > 0
    np.testing.assert_allclose(float(tm["grad_norm"]), float(rm["grad_norm"]),
                               rtol=1e-6)
    assert _routes(ttel) == _routes(rtel)


def test_q_moments_bit_equal():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(size=4096) * 1e-3,
                        np.round(rng.normal(size=4096) * 50) / 127.0 * 3,
                        np.zeros(256), np.abs(rng.normal(size=512)) * 1e-9]
                       ).astype(np.float32)
    for sqrt_domain in (False, True):
        rq, rs = r_off._q_moments(jnp.asarray(x), sqrt_domain=sqrt_domain)
        tq, ts = offload._q_moments(_t(x), sqrt_domain=sqrt_domain)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(
            offload._dq_moments(tq, ts, sqrt_domain=sqrt_domain).numpy(),
            np.asarray(r_off._dq_moments(rq, rs, sqrt_domain=sqrt_domain)))
    # ties round half to even, as jnp.round
    half = np.array([0.5, 1.5, 2.5, -0.5, -2.5] + [127.0] * 251, np.float32)
    np.testing.assert_array_equal(offload._q_moments(_t(half))[0].numpy(),
                                  np.asarray(r_off._q_moments(
                                      jnp.asarray(half))[0]))


@pytest.mark.parametrize("weights", [None, (0.3, 0.5)])
def test_placement_matches_reference_through_the_key_map(weights):
    """``choose_offloaded`` and ``assign_devices`` over a dense model's
    tree, one slow device and two (bandwidth-weighted)."""
    _, _, tree, params = _tiny_model("starcoder2-3b")
    kw = {}
    if weights:
        kw = dict(slow_weights=weights, slow_device_names=("cxl-a", "cxl-b"))
    ro, to, _, _ = _tiered_pair(0.5, False, min_offload_bytes=1024, **kw)
    rp = _to_jax(tree)
    r_picked = [str(p) for p in ro.choose_offloaded(rp)]
    t_picked = to.choose_offloaded(params)
    assert [ref_key(k) for k in t_picked] == r_picked and r_picked
    r_dev = ro.assign_devices(rp, ro.choose_offloaded(rp))
    t_dev = to.assign_devices(params, t_picked)
    assert {ref_key(k): v for k, v in t_dev.items()} == r_dev
    assert ro.achieved_weights(rp, ro.init(rp)) == \
        to.achieved_weights(params, to.init(params))


def test_key_map_is_the_references():
    tree = {"layers": {"mlp": {"w_up": jnp.zeros(2)}}, "embed": jnp.zeros(1)}
    got = [(ref_key(k), keystr(k)) for k, _ in named_leaves(
        {"layers.mlp.w_up": 0, "embed": 1})]
    want = [(str(p), jax.tree_util.keystr(p))
            for p, _ in jax.tree_util.tree_leaves_with_path(tree)]
    assert got == want
    assert ref_key((0, "a")) == str(jax.tree_util.tree_leaves_with_path(
        ({"a": 1},))[0][0])


@pytest.mark.parametrize("quantized", [False, True])
def test_repartition_round_trip_matches_reference(quantized):
    """0 -> 0.5 -> 0 after two steps: the leaves that move, the bills,
    the ``caption.opt_*`` counters and the state after each."""
    params, grads = _opt_inputs(1)
    ro, to, rtel, ttel = _tiered_pair(0.0, quantized)
    rp, tp = _to_jax(params), _to_torch(params)
    rs, ts = ro.init(rp), to.init(tp)
    # (the reference's quantized pages come back read-only from a
    # repartition, so its step cannot follow one: step where none is out)
    for frac, step in ((0.5, True), (0.0, not quantized), (0.5, True)):
        if step:
            rp, rs, _ = ro.step(rp, _to_jax(grads), rs)
            tp, ts, _ = to.step(tp, _to_torch(grads), ts)
        rs = ro.repartition(rp, rs, frac)
        ts = to.repartition(tp, ts, frac)
        # a step from int8 moments that differ by one step (see
        # _compare_slow) moves those elements by lr x that step
        _compare_slow(rs, ts, master_atol=1e-4 if quantized else 1e-6)
        assert sorted(k for k in ts["fast"]["mu"]) == sorted(
            ".".join(p.key for p in path) for path, x in
            jax.tree_util.tree_flatten_with_path(
                rs["fast"]["mu"], is_leaf=lambda x: x is None)[0]
            if x is not None)
        for k, mu in ts["fast"]["mu"].items():
            np.testing.assert_allclose(
                mu.numpy(), np.asarray(_at(rs["fast"]["mu"], k)),
                atol=1e-6 if not quantized else 1e-4)
        assert _opt_counters(ttel) == _opt_counters(rtel)
        assert _routes(ttel) == _routes(rtel)
    for k, p in named_leaves(tp):
        np.testing.assert_allclose(_np(p), np.asarray(_at(rp, k)),
                                   atol=1e-4 if quantized else 1e-6)
    assert _opt_counters(ttel)["caption.opt_repartitions"] == 3


def test_tiered_with_a_cpu_mover_matches_reference():
    """Writebacks and repartitions through a mover: descriptors, bytes
    and batches by route equal the reference's."""
    params, grads = _opt_inputs(2)
    ro, to, rtel, ttel = _tiered_pair(0.9, False, mover=True)
    try:
        rp, tp = _to_jax(params), _to_torch(params)
        rs, ts = ro.init(rp), to.init(tp)
        rp, rs, _ = ro.step(rp, _to_jax(grads), rs)
        tp, ts, _ = to.step(tp, _to_torch(grads), ts)
        rs = ro.repartition(rp, rs, 0.0)
        ts = to.repartition(tp, ts, 0.0)
        rs = ro.repartition(rp, rs, 0.9)
        ts = to.repartition(tp, ts, 0.9)
        ro.mover.wait_all()
        assert to.mover.descriptors_submitted == ro.mover.descriptors_submitted
        assert to.mover.bytes_submitted == ro.mover.bytes_submitted
        assert _routes(ttel) == _routes(rtel)
        _compare_slow(rs, ts)
    finally:
        ro.mover.close()
        to.mover.close()


def test_fused_and_tiered_train_alike():
    """Three steps of a tiny model: fused AdamW and the fully offloaded
    optimizer give the same parameters (``tests/test_system.py``)."""
    rarch, tarch, tree, _ = _tiny_model("starcoder2-3b", seed=1)
    cfg = adamw.AdamWConfig(lr=1e-3, schedule=schedules.constant())
    pf = params_from_jax(tarch.cfg, tree, device="cpu")
    pt = params_from_jax(tarch.cfg, tree, device="cpu")
    sf = adamw.init_state(pf)
    opt = offload.TieredAdamW(cfg, slow_fraction=1.0, min_offload_bytes=1024,
                              telemetry=Telemetry())
    st = opt.init(pt)
    assert st["slow"]
    data = TokenPipeline(DataConfig(vocab=tarch.cfg.vocab_padded, batch=4,
                                    seq=32, seed=11))
    for s in range(3):
        batch = {k: _t(v) for k, v in data.batch_at(s).items()}
        _, gf = tarch.module.loss_and_grad(tarch.cfg, pf, batch)
        pf, sf, _ = adamw.apply(cfg, pf, gf, sf)
        _, gt = tarch.module.loss_and_grad(tarch.cfg, pt, batch)
        pt, st, _ = opt.step(pt, gt, st)
    for (k, a), (_, b) in zip(named_leaves(pf), named_leaves(pt)):
        np.testing.assert_allclose(_np(a), _np(b), atol=5e-5, err_msg=k)


# -- data, checkpoints, compression, stragglers -------------------------------
def test_pipeline_batches_bit_equal(tmp_path):
    toks = (np.arange(20_000, dtype=np.uint32) * 7919) % 60_000
    f = tmp_path / "tokens.bin"
    toks.tofile(f)
    for kw in (dict(vocab=100, batch=4, seq=16, seed=3),
               dict(vocab=100, batch=4, seq=16, seed=3, shard_id=1,
                    num_shards=2),
               dict(vocab=50_000, batch=2, seq=32, path=str(f), seed=5)):
        r, t = RPipeline(RDataConfig(**kw)), TokenPipeline(DataConfig(**kw))
        for s in (0, 7, 123):
            rb, tb = r.batch_at(s), t.batch_at(s)
            assert rb.keys() == tb.keys()
            for k in rb:
                assert rb[k].dtype == tb[k].dtype
                np.testing.assert_array_equal(rb[k], tb[k])
        it = t.iter_from(5, prefetch=True)
        for s in range(5, 9):
            np.testing.assert_array_equal(next(it)["tokens"],
                                          r.batch_at(s)["tokens"])


def test_checkpoint_round_trip_bit_exact_with_bf16(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"a": torch.from_numpy(rng.normal(size=(8, 8)).astype(np.float32)),
            "b": {"c": torch.arange(10, dtype=torch.int32)},
            "h": torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32)
                                  ).to(torch.bfloat16)}
    ck = Checkpointer(str(tmp_path), keep=2, asynchronous=True)
    ck.save(10, tree, metadata={"rng": 7})
    ck.save(20, tree)
    ck.wait()
    index = __import__("json").load(open(tmp_path / "step_20" / "index.json"))
    assert sorted(index["leaves"]) == ["['a']", "['b']['c']", "['h']"]
    assert index["leaves"]["['h']"]["dtype"] == "bfloat16"
    bits = np.load(tmp_path / "step_20" / index["leaves"]["['h']"]["file"])
    assert bits.dtype == np.uint16
    assert zlib.crc32(bits.tobytes()) == index["leaves"]["['h']"]["crc32"]
    target = {"a": torch.zeros(8, 8), "b": {"c": torch.zeros(10, dtype=torch.int32)},
              "h": torch.zeros(5, 3, dtype=torch.bfloat16)}
    ptr = target["h"].data_ptr()
    step, restored, meta = ck.restore(target)
    assert step == 20 and restored["h"].data_ptr() == ptr
    for k in ("a", "h"):
        assert torch.equal(restored[k], tree[k])
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    step, _, meta = ck.restore(target, step=10)
    assert meta["rng"] == 7
    # the reference reads the same layout for the leaves numpy holds
    r_tree = {"a": jnp.zeros((8, 8)), "b": {"c": jnp.zeros(10, jnp.int32)}}
    index_only = {k: v for k, v in index["leaves"].items() if k != "['h']"}
    assert set(index_only) == {jax.tree_util.keystr(p) for p, _ in
                               jax.tree_util.tree_leaves_with_path(r_tree)}


def test_checkpoint_gc_and_corruption(tmp_path):
    tree = {"a": torch.ones(16)}
    ck = Checkpointer(str(tmp_path / "gc"), keep=2, asynchronous=False)
    rk = RCheckpointer(str(tmp_path / "rgc"), keep=2, asynchronous=False)
    for s in (1, 2, 3, 4):
        ck.save(s, tree)
        rk.save(s, {"a": jnp.ones(16)})
    assert ck.available_steps() == rk.available_steps() == [3, 4]
    assert open(tmp_path / "gc" / "step_4" / "leaf_00000.npy", "rb").read() \
        == open(tmp_path / "rgc" / "step_4" / "leaf_00000.npy", "rb").read()
    d = tmp_path / "gc" / "step_4"
    with open(d / "leaf_00000.npy", "r+b") as f:
        f.seek(-4, 2)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(IOError):
        ck.restore(tree)


def test_training_restart_is_bit_exact(tmp_path):
    """Kill at step 12, restore the step-10 checkpoint, finish at 20:
    identical parameters to the uninterrupted run."""
    _, tarch, tree, _ = _tiny_model("starcoder2-3b")
    cfg = adamw.AdamWConfig(lr=1e-3, schedule=schedules.constant())
    data = TokenPipeline(DataConfig(vocab=tarch.cfg.vocab_padded, batch=2,
                                    seq=16, seed=11))

    def run(n_steps, ckpt=None, resume=False):
        params = params_from_jax(tarch.cfg, tree, device="cpu")
        state = adamw.init_state(params)
        start = 0
        if resume:
            start, (params, state), _ = ckpt.restore((params, state))
        for s in range(start, n_steps):
            batch = {k: _t(v) for k, v in data.batch_at(s).items()}
            _, g = tarch.module.loss_and_grad(tarch.cfg, params, batch)
            params, state, _ = adamw.apply(cfg, params, g, state)
            if ckpt and (s + 1) % 10 == 0:
                ckpt.save(s + 1, (params, state))
                ckpt.wait()
        return params

    clean = run(20)
    ck = Checkpointer(str(tmp_path), asynchronous=False)
    run(12, ckpt=ck)
    recovered = run(20, ckpt=ck, resume=True)
    for (k, a), (_, b) in zip(named_leaves(clean), named_leaves(recovered)):
        assert torch.equal(a, b), k


def test_compression_matches_reference():
    rng = np.random.default_rng(0)
    for seed in range(5):
        g = (rng.normal(size=200) * rng.uniform(0.01, 100)).astype(np.float32)
        r = (rng.normal(size=200) * 0.01).astype(np.float32)
        rq, rs, rr = r_comp.compress_with_feedback(jnp.asarray(g), jnp.asarray(r))
        tq, ts, tr = compression.compress_with_feedback(_t(g), _t(r))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        np.testing.assert_allclose(float(ts), float(rs), rtol=1e-7)
        np.testing.assert_allclose(tr.numpy(), np.asarray(rr), atol=1e-6)
        recon = compression.dequantize_int8(tq, ts) + tr
        np.testing.assert_allclose(recon.numpy(), g + r, rtol=1e-5, atol=1e-5)
    total_true, total_q = np.zeros(64), np.zeros(64)
    res = torch.zeros(64)
    for _ in range(100):
        g = torch.from_numpy(rng.normal(size=64).astype(np.float32))
        q, s, res = compression.compress_with_feedback(g, res)
        total_q += compression.dequantize_int8(q, s).numpy()
        total_true += g.numpy()
    assert np.abs(total_q - total_true).max() < \
        np.abs(total_true).max() * 0.05 + 0.5


def test_compressed_mean_over_a_group():
    """One rank: the mean is the dequantized gradient; the residuals
    carry the rest (``gloo`` on this host)."""
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already up")
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:29517",
                            world_size=1, rank=0)
    try:
        rng = np.random.default_rng(1)
        grads = {"w": _t(rng.normal(size=(4, 8)).astype(np.float32))}
        res = compression.init_residuals(grads)
        mean, new_res = compression.cross_group_mean_compressed(grads, res)
        q, s, r = compression.compress_with_feedback(grads["w"], res["w"])
        assert torch.equal(mean["w"], compression.dequantize_int8(q, s))
        assert torch.equal(new_res["w"], r)
    finally:
        dist.destroy_process_group()


def test_straggler_redispatch():
    import itertools
    import time as _t
    strag = StragglerMitigator(threshold=3.0, min_timeout=0.05)
    calls = itertools.count()

    def fast():
        next(calls)
        return 42
    for _ in range(5):
        assert strag.run(fast) == 42
    slow_first = iter([0.5, 0.0])

    def sometimes_slow():
        _t.sleep(next(slow_first, 0.0))
        return 7
    assert strag.run(sometimes_slow) == 7
    assert strag.stats.redispatched >= 1
    strag.close()


def test_a_redispatched_step_runs_once():
    runs = []

    def step():
        import time as _t
        runs.append(1)
        _t.sleep(0.3)
        return len(runs)
    strag = StragglerMitigator(threshold=1.0, min_timeout=0.05)
    for _ in range(3):
        strag.run(lambda: None)
    assert strag.run(t_train.once(step)) == 1
    assert strag.stats.redispatched == 1 and len(runs) == 1
    strag.close()


# -- the driver ---------------------------------------------------------------
def _run(main, argv, **kw):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        losses = main(argv, **kw)
    return losses, out.getvalue()


def _record_init(monkeypatch, module) -> list:
    """The trees the reference's ``module.init`` makes while the test
    runs, kept as numpy copies (``module.init`` is patched in the test
    only): the port starts from the weights the reference driver drew,
    without a second draw of them."""
    made = []
    init = module.init

    def record(*args, **kw):
        tree = init(*args, **kw)
        made.append(jax.tree_util.tree_map(np.array, tree))
        return tree
    monkeypatch.setattr(module, "init", record)
    return made


@pytest.mark.parametrize("arch_id", ["starcoder2-3b", "internvl2-2b"])
def test_train_driver_matches_reference(arch_id, tmp_path):
    """``train.main`` on the CPU from the reference's weights: losses
    within 1e-4 and the same Caption decisions, fused, tiered and tiered
    under Caption."""
    tiny = t_registry.get(arch_id).tiny().cfg
    rarch = r_registry.get(arch_id).tiny()
    tree = rarch.module.init(rarch.cfg, jax.random.PRNGKey(0))
    base = ["--arch", arch_id, "--tiny", "--steps", "12", "--batch", "2",
            "--seq", "16", "--ckpt-every", "100", "--log-every", "6",
            "--ckpt-dir", str(tmp_path)]
    for extra in (["--offload-fraction", "0.0"],
                  ["--offload-fraction", "0.5"],
                  ["--offload-fraction", "0.5", "--caption",
                   "--caption-epoch-steps", "4", "--devices", "tpu-v5e"]):
        want, r_out = _run(r_train.main, base + extra)
        got, t_out = _run(t_train.main, base + extra + ["--device", "cpu"],
                          params=params_from_jax(tiny, tree, device="cpu"))
        np.testing.assert_allclose(got, want, atol=1e-4)
        decisions = [[ln for ln in text.splitlines() if "caption" in ln]
                     for text in (r_out, t_out)]
        assert decisions[0] == decisions[1]
        if "--caption" in extra:
            assert decisions[1], t_out
        assert ("tiered_opt=on" in t_out) == ("0.5" in extra)


def test_train_driver_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_train.main(["--arch", "starcoder2-3b", "--tiny", "--steps", "1"])
    import argparse
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def spy(self, argv=None, namespace=None):
        ns = real(self, argv, namespace)
        seen.update(vars(ns))
        raise SystemExit(0)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", spy)
    with pytest.raises(SystemExit):
        t_train.main([])
    assert seen["device"] == "cuda" and seen["devices"] == "h100"


NEW_FAMILIES = ["rwkv6-7b", "deepseek-moe-16b", "recurrentgemma-9b",
                "whisper-large-v3"]


@pytest.mark.parametrize("arch_id", NEW_FAMILIES)
def test_train_driver_matches_reference_for_each_family(arch_id, tmp_path,
                                                        monkeypatch):
    """``train.main`` on the CPU from the reference's weights, tiered
    under Caption, for the families the dense slice left out: losses
    within 1e-4, the same Caption decisions, and the tiered optimizer's
    placement the reference's through ``tree.ref_key``."""
    tiny = t_registry.get(arch_id).tiny().cfg
    rarch = r_registry.get(arch_id).tiny()
    made = _record_init(monkeypatch, rarch.module)
    argv = ["--arch", arch_id, "--tiny", "--steps", "8", "--batch", "2",
            "--seq", "16", "--ckpt-every", "100", "--log-every", "4",
            "--ckpt-dir", str(tmp_path), "--offload-fraction", "0.5",
            "--caption", "--caption-epoch-steps", "4",
            "--devices", "tpu-v5e"]
    want, r_out = _run(r_train.main, argv)
    tree = made[0]
    params = params_from_jax(tiny, tree, device="cpu")
    got, t_out = _run(t_train.main, argv + ["--device", "cpu"],
                      params=params_from_jax(tiny, tree, device="cpu"))
    np.testing.assert_allclose(got, want, atol=1e-4)
    decisions = [[ln for ln in text.splitlines() if "caption" in ln]
                 for text in (r_out, t_out)]
    assert decisions[0] == decisions[1] and decisions[1], t_out
    ro, to, _, _ = _tiered_pair(0.5, False, min_offload_bytes=1024)
    rp = jax.tree_util.tree_map(jnp.asarray, tree)
    r_picked = [str(p) for p in ro.choose_offloaded(rp)]
    assert [ref_key(k) for k in to.choose_offloaded(params)] == r_picked
    assert r_picked


def test_wkv6_autograd_matches_the_plain_loop():
    """The wrapper's autograd Function (its forward the plain version on
    the CPU, its backward the recomputed plain recurrence) against
    autograd through the plain loop itself: y, the final state and every
    input's gradient."""
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6 import ref as wkv_ref
    g = torch.Generator().manual_seed(0)
    B, T, H, hd = 2, 9, 2, 8
    shapes = [(B, T, H, hd)] * 3 + [(B, T, H, hd), (H, hd), (B, H, hd, hd)]
    base = [torch.randn(s, generator=g) for s in shapes]
    base[3] = torch.sigmoid(base[3])  # decays in (0, 1)
    gy = torch.randn((B, T, H, hd), generator=g)
    gs = torch.randn((B, H, hd, hd), generator=g)
    out = []
    for fn in (wkv_ops.wkv6, wkv_ref.wkv6):
        xs = [t.clone().requires_grad_(True) for t in base]
        y, s = fn(*xs)
        assert y.grad_fn is not None
        grads = torch.autograd.grad((y * gy).sum() + (s * gs).sum(), xs)
        out.append((y.detach(), s.detach(), grads))
    (y1, s1, g1), (y2, s2, g2) = out
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="state_out"):
        xs = [t.clone().requires_grad_(True) for t in base]
        wkv_ops.wkv6(*xs, state_out=torch.empty_like(base[5]))


def test_train_tiny_lm_example_matches_reference(tmp_path, monkeypatch):
    """``repro_torch.examples.train_tiny_lm`` at 2 steps against the
    reference driver on the same ~100M config and weights.  The
    reference example patches ``registry.get``, which its driver bound at
    import, so here ``repro.launch.train.get_arch`` is patched, in the test
    only."""
    import dataclasses
    from repro_torch.examples import train_tiny_lm
    cfg = train_tiny_lm.config()
    rarch = r_registry.get("starcoder2-3b")
    rcfg = dataclasses.replace(
        rarch.cfg.tiny(), name="starcoder2-100m", n_layers=6, d_model=512,
        n_heads=8, n_kv_heads=2, d_ff=2048, vocab=32768, head_dim=64,
        max_seq=512)
    monkeypatch.setattr(r_train, "get_arch", lambda a: dataclasses.replace(
        rarch, cfg=rcfg))
    made = _record_init(monkeypatch, rarch.module)
    want, _ = _run(r_train.main, [
        "--arch", "starcoder2-100m", "--steps", "2", "--batch", "4",
        "--seq", "256", "--lr", "6e-4", "--ckpt-dir", str(tmp_path / "r"),
        "--ckpt-every", "100", "--offload-fraction", "0.0",
        "--log-every", "20"])
    tree = made[0]
    got, out = _run(train_tiny_lm.main, [
        "--steps", "2", "--device", "cpu", "--ckpt-dir", str(tmp_path / "t")],
        params=params_from_jax(cfg, tree, device="cpu"))
    assert "params=" in out and len(got) == 2
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert got[-1] < got[0]


# -- on the card --------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
def test_tiered_step_launches_on_the_card(cuda, quantized):
    """On the card a step is one ``stream_copy`` launch a page load and
    one a writeback run, the state pinned, and its result the CPU's."""
    from repro_torch.kernels.stream_copy import ops as sc_ops
    params, grads = _opt_inputs()
    cfg = adamw.AdamWConfig(lr=1e-3, schedule=schedules.constant())
    out = {}
    for dev in ("cpu", cuda):
        opt = offload.TieredAdamW(cfg, slow_fraction=0.9,
                                  quantize_moments=quantized,
                                  telemetry=Telemetry())
        p = {k: v.to(dev) for k, v in named_leaves(_to_torch(params))}
        g = {k: v.to(dev) for k, v in named_leaves(_to_torch(grads))}
        st = opt.init(p)
        if dev != "cpu":
            assert all(leaf.block.is_pinned() for leaf in st["slow"].values())
        sc_ops.LAUNCHES.reset()
        p, st, m = opt.step(p, g, st)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert sc_ops.LAUNCHES.count == opt.step_launches(st)
        out[str(dev)] = ({k: v.cpu() for k, v in p.items()},
                         {k: leaf.block.cpu() for k, leaf in
                          st["slow"].items()})
    (pc, bc), (pg, bg) = out["cpu"], out[str(cuda)]
    for k in pc:
        np.testing.assert_allclose(pg[k].numpy(), pc[k].numpy(), atol=1e-6)
    for k in bc:
        assert bc[k].numel() == bg[k].numel()


@pytest.mark.cuda
def test_wkv6_kernel_path_gradients_match_the_plain_path(cuda):
    """On the card, rwkv's ``loss_and_grad`` through the ``wkv6`` kernel
    (one launch a layer in the forward) against the same call with
    ``wkv=`` the plain recurrence: every leaf within 1e-4 (fp32)."""
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6 import ref as wkv_ref
    arch = t_registry.get("rwkv6-7b").tiny()
    params = arch.module.init(arch.cfg, 0, device=cuda)
    data = TokenPipeline(DataConfig(vocab=arch.cfg.vocab_padded, batch=2,
                                    seq=32, seed=11))
    batch = {k: _t(v).to(cuda) for k, v in data.batch_at(0).items()}
    wkv_ops.LAUNCHES.reset()
    loss, grads = arch.module.loss_and_grad(arch.cfg, params, batch)
    assert wkv_ops.LAUNCHES.reset() == arch.cfg.n_layers
    want_loss, want = arch.module.loss_and_grad(arch.cfg, params, batch,
                                                wkv=wkv_ref.wkv6)
    assert wkv_ops.LAUNCHES.count == 0
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for k, g in grads.items():
        np.testing.assert_allclose(g.cpu().numpy(), want[k].cpu().numpy(),
                                   atol=1e-4, err_msg=k)


@pytest.mark.cuda
def test_tiered_repartition_through_the_card_mover(cuda):
    from repro_torch.core.mover import stream_executor
    from repro_torch.kernels.stream_copy import ops as sc_ops
    params, grads = _opt_inputs()
    cfg = adamw.AdamWConfig(lr=1e-3, schedule=schedules.constant())
    tel = Telemetry()
    with BulkMover(topology_from_spec("h100"), telemetry=tel,
                   execute=stream_executor(), device=cuda) as mover:
        opt = offload.TieredAdamW(cfg, slow_fraction=0.9, mover=mover,
                                  telemetry=tel)
        p = {k: v.to(cuda) for k, v in named_leaves(_to_torch(params))}
        st = opt.init(p)
        before = {k: leaf.block.clone() for k, leaf in st["slow"].items()}
        sc_ops.LAUNCHES.reset()
        st = opt.repartition(p, st, 0.0)
        st = opt.repartition(p, st, 0.9)
        torch.cuda.synchronize()
        assert sc_ops.LAUNCHES.count == 4 * len(before)
        for k, leaf in st["slow"].items():
            assert torch.equal(leaf.block, before[k])
        assert tel.counters["caption.opt_bytes_down"] == \
            tel.counters["caption.opt_bytes_up"] == opt.host_bytes(st)
