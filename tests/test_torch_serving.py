"""Differential tests for the serving engine: the same requests through the
reference's ``ServingEngine`` and the port's, with the reference's
parameters carried across, must give identical greedy tokens — and, with
Caption, the same controller trajectory; with a shared-prefix pool, the
same hits, misses, copy-on-write copies and avoided prefill tokens; and
across an elastic hot-remove, the same drain.  Each scenario runs once
per package (module-scoped)."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core.arbiter as r_arbiter  # noqa: E402
import repro.core.caption as r_caption  # noqa: E402
import repro.core.donation as r_donation  # noqa: E402
import repro.core.mover as r_mover  # noqa: E402
import repro.core.policy as r_policy  # noqa: E402
import repro.core.telemetry as r_telemetry  # noqa: E402
import repro.core.tiers as r_tiers  # noqa: E402
import repro.serving.engine as r_engine  # noqa: E402
import repro_torch.core.arbiter as t_arbiter  # noqa: E402
import repro_torch.core.caption as t_caption  # noqa: E402
import repro_torch.core.donation as t_donation  # noqa: E402
import repro_torch.core.mover as t_mover  # noqa: E402
import repro_torch.core.policy as t_policy  # noqa: E402
import repro_torch.core.telemetry as t_telemetry  # noqa: E402
import repro_torch.core.tiers as t_tiers  # noqa: E402
import repro_torch.serving.engine as t_engine  # noqa: E402
from repro.models import registry as r_registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402

ARCHS = ("starcoder2-3b", "qwen2.5-32b", "stablelm-12b")


def _pkg(side: str, arch: str):
    """Everything a scenario needs from one package, under one name."""
    r_arch = r_registry.get(arch).tiny()
    params = r_arch.module.init(r_arch.cfg, jax.random.PRNGKey(0))
    if side == "ref":
        mods = dict(arbiter=r_arbiter, caption=r_caption, mover=r_mover,
                    policy=r_policy, telemetry=r_telemetry, tiers=r_tiers,
                    engine=r_engine, donation=r_donation)
        return types.SimpleNamespace(cfg=r_arch.cfg, params=params, kw={},
                                     mover_kw={}, **mods)
    cfg = t_registry.get(arch).tiny().cfg
    mods = dict(arbiter=t_arbiter, caption=t_caption, mover=t_mover,
                policy=t_policy, telemetry=t_telemetry, tiers=t_tiers,
                engine=t_engine, donation=t_donation)
    return types.SimpleNamespace(
        cfg=cfg, kw={"device": "cpu"}, mover_kw={"device": "cpu"},
        params=params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, params),
                               device="cpu"), **mods)


def _tokens(done):
    return sorted((r.rid, tuple(int(t) for t in r.generated)) for r in done)


def _prompts(vocab, n, seed, pre_len=0, suf_len=(2, 9)):
    rng = np.random.default_rng(seed)
    pre = rng.integers(0, vocab, size=pre_len).tolist()
    return [pre + rng.integers(0, vocab, size=int(rng.integers(*suf_len))
                               ).tolist() for _ in range(n)]


# -- plain serving, per architecture ---------------------------------------------
def _serve(p):
    tel = p.telemetry.Telemetry()
    eng = p.engine.ServingEngine(
        p.cfg, p.params, max_batch=3, max_len=64,
        policy=p.policy.MemPolicy.from_slow_fraction("fast", "slow", 0.5),
        topology=p.tiers.tpu_v5e_topology(), page_t=8, telemetry=tel, **p.kw)
    for i, prompt in enumerate(_prompts(p.cfg.vocab_padded, 5, seed=1)):
        eng.submit(prompt, max_new_tokens=6,
                   slo="latency" if i == 1 else "batch")
    eng.step()
    pinned = set(eng.pinned_slots)
    done = eng.run_until_drained()
    return {"tokens": _tokens(done), "pinned": pinned,
            "traces": eng.decode_traces,
            "modeled": [round(r.modeled_seconds, 12) for r in
                        sorted(done, key=lambda r: r.rid)],
            "slow": eng.cache.slow_fraction()}


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    return {side: _serve(_pkg(side, request.param))
            for side in ("ref", "port")}


def test_greedy_tokens_identical(served):
    assert served["port"]["tokens"] == served["ref"]["tokens"]
    assert len(served["port"]["tokens"]) == 5


def test_slo_pins_and_modeled_time_identical(served):
    for key in ("pinned", "modeled", "slow"):
        assert served["port"][key] == served["ref"][key], key
    assert served["port"]["pinned"] == {1}
    # Without slow headroom the latency pin takes the rebuild path: the
    # reference keeps its shapes (one jit trace), the port's pools are
    # new storage (one more binding).
    assert served["ref"]["traces"] == 1
    assert served["port"]["traces"] == 2


# -- Caption under the arbiter -------------------------------------------------------
def _caption_run(p):
    topo = p.tiers.tpu_v5e_topology()
    tel = p.telemetry.Telemetry()
    ctl = p.caption.CaptionController(
        topo, p.caption.CaptionConfig(epoch_steps=2, probe_epochs=1, step=0.1),
        initial_fraction=0.1)
    arb = p.arbiter.CaptionArbiter(topo, p.arbiter.budgeted_config(topo, 0.0))
    eng = p.engine.ServingEngine(
        p.cfg, p.params, max_batch=2, max_len=32,
        policy=p.policy.MemPolicy.from_slow_fraction("fast", "slow", 0.1),
        topology=topo, page_t=4, caption=ctl, arbiter=arb, telemetry=tel,
        **p.kw)
    for prompt in _prompts(p.cfg.vocab_padded, 4, seed=2):
        eng.submit(prompt, max_new_tokens=10)
    p.donation.FULL_SHARD_COPIES.reset()
    done = eng.run_until_drained()
    return {"tokens": _tokens(done), "trace": list(eng.caption_trace),
            "traces": eng.decode_traces,
            "copies": p.donation.FULL_SHARD_COPIES.reset(),
            "grants": arb.grants(), "demands": arb.demands(),
            "phase": ctl.phase.value, "weights": eng.cache.weights()}


@pytest.fixture(scope="module")
def captioned():
    return {side: _caption_run(_pkg(side, "starcoder2-3b"))
            for side in ("ref", "port")}


def test_caption_trace_and_tokens_identical(captioned):
    r, t = captioned["ref"], captioned["port"]
    assert t["tokens"] == r["tokens"]
    assert t["trace"] == r["trace"] and len(t["trace"]) >= 4
    assert t["phase"] == r["phase"] and t["weights"] == r["weights"]
    assert t["grants"] == pytest.approx(r["grants"])
    assert t["demands"] == pytest.approx(r["demands"])


def test_caption_walk_keeps_one_binding_and_no_copies(captioned):
    assert captioned["port"]["traces"] == captioned["ref"]["traces"] == 1
    assert captioned["port"]["copies"] == captioned["ref"]["copies"] == 0


# -- shared-prefix pool ----------------------------------------------------------------
def _prefix_run(p, prefix_pages):
    eng = p.engine.ServingEngine(
        p.cfg, p.params, max_batch=3, max_len=64,
        policy=p.policy.MemPolicy.from_slow_fraction("fast", "slow", 0.5),
        page_t=8, prefix_pages=prefix_pages,
        telemetry=p.telemetry.Telemetry(), **p.kw)
    for prompt in _prompts(p.cfg.vocab_padded, 5, seed=3, pre_len=20,
                           suf_len=(7, 8)):
        eng.submit(prompt, max_new_tokens=6)
    done = eng.run_until_drained()
    idx = eng.prefix_index
    return {"tokens": _tokens(done), "traces": eng.decode_traces,
            "avoided": eng.prefill_tokens_avoided,
            "total": eng.prefill_tokens_total,
            "index": (idx.hits, idx.misses, idx.cow_copies, idx.evictions,
                      idx.allocated_pages()) if idx else None,
            "storage": eng.cache.storage_bytes_per_device()}


@pytest.fixture(scope="module")
def prefixed():
    return {side: _prefix_run(_pkg(side, "starcoder2-3b"), 16)
            for side in ("ref", "port")}


def test_prefix_sharing_identical(prefixed):
    r, t = prefixed["ref"], prefixed["port"]
    assert t == r
    assert t["avoided"] > 0 and t["index"][2] >= 1  # hits and CoW copies
    assert t["traces"] == 1


def test_prefix_sharing_matches_unshared_decode(prefixed):
    plain = _prefix_run(_pkg("port", "starcoder2-3b"), 0)
    assert plain["tokens"] == prefixed["port"]["tokens"]


# -- elastic hot-remove / hot-add ------------------------------------------------------
def _elastic_run(p):
    topo = p.tiers.paper_three_device_topology()
    tel = p.telemetry.Telemetry()
    names = (topo.fast.name,) + topo.slow_names
    with p.mover.BulkMover(topo, asynchronous=False, telemetry=tel,
                           **p.mover_kw) as mover:
        eng = p.engine.ServingEngine(
            p.cfg, p.params, max_batch=2, max_len=32,
            policy=p.policy.MemPolicy.weighted(names, (5, 1, 1, 1)),
            topology=topo, page_t=4, mover=mover, telemetry=tel, **p.kw)
        eng.submit([5, 6, 7], max_new_tokens=10, slo="latency")
        eng.submit([5, 6, 7], max_new_tokens=10)
        for _ in range(3):
            eng.step()
        eng.remove_device("cxl-c")
        dev = eng.cache.page_device
        dev = dev.numpy() if isinstance(dev, torch.Tensor) else np.asarray(dev)
        done = eng.run_until_drained()
        eng.add_device("cxl-c")
        return {"tokens": _tokens(done), "dev": dev.tolist(),
                "routes": tel.snapshot()["routes"],
                "descs": mover.descriptors_submitted,
                "bytes": mover.bytes_submitted,
                "names": eng._device_names}


def test_elastic_remove_and_add_identical():
    r = _elastic_run(_pkg("ref", "starcoder2-3b"))
    t = _elastic_run(_pkg("port", "starcoder2-3b"))
    assert t["tokens"] == r["tokens"]
    assert t["dev"] == r["dev"] and not any(3 in row for row in t["dev"])
    assert (t["descs"], t["bytes"]) == (r["descs"], r["bytes"])
    assert {k: v["bytes_moved"] for k, v in t["routes"].items()} == {
        k: v["bytes_moved"] for k, v in r["routes"].items()}
    assert t["names"] == r["names"]


# -- unfenced migration overlapping decode -----------------------------------------------
def _overlap_run(p):
    topo = p.tiers.paper_topology()
    tel = p.telemetry.Telemetry()
    mover = p.mover.BulkMover(topo, asynchronous=True, batch_size=16,
                              telemetry=tel, **p.mover_kw)
    try:
        eng = p.engine.ServingEngine(
            p.cfg, p.params, max_batch=3, max_len=64,
            policy=p.policy.MemPolicy.from_slow_fraction(
                topo.fast.name, topo.slow.name, 0.5),
            page_t=8, topology=topo, mover=mover, telemetry=tel,
            prefix_pages=8, overlap=True, **p.kw)
        for prompt in _prompts(p.cfg.vocab_padded, 3, seed=4, pre_len=16,
                               suf_len=(4, 5)):
            eng.submit(prompt, max_new_tokens=8)
        eng.step()
        b0 = mover.bytes_submitted
        eng.cache = eng.cache.repartition_fraction(
            0.25, pinned_slots=eng.pinned_slots, mover=mover, telemetry=tel,
            fast_tier=topo.fast.name, slow_tier=topo.slow.name, wait=False)
        eng._account_actuation(mover.bytes_submitted - b0, 0.0)
        inflight = eng._inflight_move_bytes
        for _ in range(4):
            eng.step()
        eng._drain_migrations()
        done = eng.run_until_drained()
        return {"tokens": _tokens(done), "inflight": inflight,
                "hidden": round(eng.migration_hidden_s, 15),
                "exposed": round(eng.migration_exposed_s, 15),
                "pending": mover.pending,
                "descs": mover.descriptors_submitted}
    finally:
        mover.close()


def test_overlap_accounting_identical():
    """The port's unfenced actuation waits only for the copies it lands;
    the modeled hidden/exposed split and the tokens are the reference's."""
    r = _overlap_run(_pkg("ref", "starcoder2-3b"))
    t = _overlap_run(_pkg("port", "starcoder2-3b"))
    assert t == r
    assert t["inflight"] > 0 and t["hidden"] > 0 and t["pending"] == 0


# -- the driver --------------------------------------------------------------------------
def test_serve_driver_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--arch", "starcoder2-3b", "--tiny", "--device", "cpu",
                       "--requests", "4", "--max-batch", "2",
                       "--max-len", "32", "--new-tokens", "4", "--page-t", "8",
                       "--slow-fraction", "0.25", "--caption",
                       "--caption-epoch-steps", "2", "--prefix-pages", "4",
                       "--shared-prefix", "8", "--latency-every", "3"])
    out = capsys.readouterr().out
    assert len(done) == 4 and all(len(r.generated) == 4 for r in done)
    assert "completed=4" in out and "caption: phase=" in out
    assert "prefix: hits=" in out
    # --devices defaults to the h100 preset: the arbiter's budget is the
    # pinned host tier's nt-store rate
    budget = t_tiers.H100_HOST_PINNED.nt_store_bw
    assert f"arbiter: budget={budget:.3g} B/s" in out


def test_serve_driver_defaults_to_the_card():
    from repro_torch.launch import serve
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "starcoder2-3b", "--tiny"])
