"""Differential tests for the port's elastic runtime
(``repro_torch.runtime.fault_tolerance`` and ``runtime.elastic``): the same
inputs, made from seeds with numpy, through ``repro.runtime`` and the port.

``ResilientLoop`` replays bit-exact in both packages, and in the port also
for a step that updates torch tensors in place (the port's optimizer does),
which a snapshot that passed tensors through would replay from mutated
state.  Monitor, injector, ``choose_mesh`` and ``replan`` results are
equal; the perfmodel numbers a degradation gives are equal to the last
bit; the engine's kill -> drain -> recover gives the reference's tokens,
bills and page maps with the reference's internvl2-2b ``.tiny()`` weights
carried across.  The ``cuda`` test needs a card."""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.checkpoint.checkpointer as r_ckpt  # noqa: E402
import repro.core.caption as r_caption  # noqa: E402
import repro.core.classifier as r_classifier  # noqa: E402
import repro.core.mover as r_mover  # noqa: E402
import repro.core.perfmodel as r_perfmodel  # noqa: E402
import repro.core.planner as r_planner  # noqa: E402
import repro.core.policy as r_policy  # noqa: E402
import repro.core.telemetry as r_telemetry  # noqa: E402
import repro.core.tiers as r_tiers  # noqa: E402
import repro.runtime.elastic as r_elastic  # noqa: E402
import repro.runtime.fault_tolerance as r_ft  # noqa: E402
import repro.serving.engine as r_engine  # noqa: E402
import repro_torch.checkpoint.checkpointer as t_ckpt  # noqa: E402
import repro_torch.core.caption as t_caption  # noqa: E402
import repro_torch.core.classifier as t_classifier  # noqa: E402
import repro_torch.core.mover as t_mover  # noqa: E402
import repro_torch.core.perfmodel as t_perfmodel  # noqa: E402
import repro_torch.core.planner as t_planner  # noqa: E402
import repro_torch.core.policy as t_policy  # noqa: E402
import repro_torch.core.telemetry as t_telemetry  # noqa: E402
import repro_torch.core.tiers as t_tiers  # noqa: E402
import repro_torch.runtime.elastic as t_elastic  # noqa: E402
import repro_torch.runtime.fault_tolerance as t_ft  # noqa: E402
import repro_torch.serving.engine as t_engine  # noqa: E402
from repro.models import registry as r_registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import registry as t_registry  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

SIDES = ("ref", "port")


def _pkg(side: str):
    if side == "ref":
        return types.SimpleNamespace(
            ft=r_ft, elastic=r_elastic, ckpt=r_ckpt, perfmodel=r_perfmodel,
            tiers=r_tiers, planner=r_planner, policy=r_policy,
            classifier=r_classifier, caption=r_caption, mover=r_mover,
            telemetry=r_telemetry, engine=r_engine, kw={})
    return types.SimpleNamespace(
        ft=t_ft, elastic=t_elastic, ckpt=t_ckpt, perfmodel=t_perfmodel,
        tiers=t_tiers, planner=t_planner, policy=t_policy,
        classifier=t_classifier, caption=t_caption, mover=t_mover,
        telemetry=t_telemetry, engine=t_engine, kw={"device": "cpu"})


def _loop(p, directory, every):
    return p.ft.ResilientLoop(p.ckpt.Checkpointer(str(directory),
                                                  asynchronous=False),
                              checkpoint_every=every)


def _fail_once_at(p, at: int):
    fired = []

    def injector(step):
        if step == at and not fired:
            fired.append(step)
            raise p.ft.WorkerFailure(f"injected node loss at step {at}")
    return injector, fired


# -- ResilientLoop: the reference's steps in both packages -----------------------
def _numpy_inplace_step(state, step):
    state["x"] += step + 1.0  # in-place numpy update: the replay hazard
    return state


def _numpy_functional_step(state, step):
    return {"x": state["x"] * 1.5 + step}


@pytest.mark.parametrize("every,fail_at", [(100, 3), (5, 13)],
                         ids=["scratch", "checkpoint"])
def test_resilient_loop_replays_numpy_state_like_the_reference(
        tmp_path, every, fail_at):
    """Scratch replay (no checkpoint before the failure, an in-place numpy
    step) and checkpoint replay (the reference's x * 1.5 + step) reach the
    uninterrupted run's state, and the packages agree to the bit."""
    step_fn = _numpy_inplace_step if every > 20 else _numpy_functional_step
    out = {}
    for side in SIDES:
        p = _pkg(side)
        x0 = np.random.default_rng(7).normal(size=4)
        clean = _loop(p, tmp_path / side / "clean", every).run(
            {"x": x0.copy(), "step": 0}, step_fn, 20)
        injector, fired = _fail_once_at(p, fail_at)
        loop = _loop(p, tmp_path / side / "faulty", every)
        got = loop.run({"x": x0.copy(), "step": 0}, step_fn, 20,
                       failure_injector=injector)
        assert fired == [fail_at] and loop.restarts == 1
        assert got["step"] == clean["step"] == 20
        np.testing.assert_array_equal(got["x"], clean["x"])
        out[side] = got["x"]
    assert out["port"].tobytes() == out["ref"].tobytes()


@pytest.mark.parametrize("side", SIDES)
def test_resilient_loop_leaves_callers_dict_alone(tmp_path, side):
    p = _pkg(side)
    state = {"x": np.float64(1.0), "step": 0}
    _loop(p, tmp_path, 5).run(state, lambda s, i: {"x": s["x"] + 1.0}, 4)
    assert state == {"x": 1.0, "step": 0}


def test_resilient_loop_leaves_callers_tensors_alone(tmp_path):
    """The port's tensors: the caller's dict keeps its keys, and a replay
    writes into the tensors it started from."""
    w = torch.zeros(3)
    state = {"w": w, "step": 0}

    def step_fn(s, i):
        s["w"].add_(1.0)
        return s
    injector, _ = _fail_once_at(_pkg("port"), 2)
    out = _loop(_pkg("port"), tmp_path, 100).run(
        state, step_fn, 4, failure_injector=injector)
    assert set(state) == {"w", "step"} and state["step"] == 0
    assert out["w"] is w and torch.equal(w, torch.full((3,), 4.0))


# -- ResilientLoop: an in-place torch step (the port's optimizer) -----------------
def _tensor_state(device="cpu"):
    rng = np.random.default_rng(11)
    params = {"layers": {"w": torch.from_numpy(
        rng.normal(size=(4, 8)).astype(np.float32)).to(torch.bfloat16),
        "b": torch.from_numpy(rng.normal(size=8).astype(np.float32))}}
    opt = {"step": torch.zeros((), dtype=torch.int32),
           "mu": {"layers.w": torch.zeros(4, 8), "layers.b": torch.zeros(8)}}
    tree = {"params": params, "opt": opt, "seen": np.zeros(2), "step": 0}
    return {k: _to(v, device) for k, v in tree.items()}


def _to(node, device):
    if isinstance(node, torch.Tensor):
        return node.to(device)
    if isinstance(node, dict):
        return {k: _to(v, device) for k, v in node.items()}
    return node


def _inplace_step(state, step):
    """A momentum step whose data is a pure function of ``step``: every
    tensor and the numpy counter updated in place, the step count
    replaced, as ``adamw.apply`` does."""
    rng = np.random.default_rng(100 + step)
    p, opt = state["params"]["layers"], state["opt"]
    with torch.no_grad():
        for key, leaf in (("layers.w", p["w"]), ("layers.b", p["b"])):
            g = torch.from_numpy(rng.normal(size=leaf.shape).astype(
                np.float32)).to(leaf.device)
            mu = opt["mu"][key]
            mu.mul_(0.9).add_(g)
            leaf.copy_((leaf.float() - 0.01 * mu).to(leaf.dtype))
    state["seen"] += 1.0
    return {**state, "opt": {**opt, "step": opt["step"] + 1}}


def _tensors(out):
    return {path: leaf.detach().cpu() for path, leaf in flatten(out)
            if isinstance(leaf, torch.Tensor)}


def _run_inplace(tmp_path, sub, every, fail_at=None, device="cpu"):
    p = _pkg("port")
    state = _tensor_state(device)
    ptrs = [state["params"]["layers"][k].data_ptr() for k in ("w", "b")]
    injector, fired = (_fail_once_at(p, fail_at) if fail_at is not None
                       else (None, []))
    loop = _loop(p, tmp_path / sub, every)
    out = loop.run(state, _inplace_step, 6, failure_injector=injector)
    assert fired == ([] if fail_at is None else [fail_at])
    assert loop.restarts == len(fired)
    # the replay wrote into the live tensors: their storage is kept
    assert [out["params"]["layers"][k].data_ptr()
            for k in ("w", "b")] == ptrs
    return out


@pytest.mark.parametrize("every,fail_at", [(100, 3), (2, 3)],
                         ids=["scratch", "checkpoint"])
def test_resilient_loop_replays_an_inplace_tensor_step_bit_exact(
        tmp_path, every, fail_at):
    clean = _run_inplace(tmp_path, "clean", 100)
    got = _run_inplace(tmp_path, "faulty", every, fail_at)
    assert got["step"] == clean["step"] == 6
    want = _tensors(clean)
    for k, v in _tensors(got).items():
        assert torch.equal(v, want[k]), k
    np.testing.assert_array_equal(got["seen"], clean["seen"])
    assert float(got["seen"][0]) == 6.0


def test_a_pass_through_snapshot_replays_mutated_state(tmp_path,
                                                       monkeypatch):
    """The hazard the host copy guards against: with tensors passed through
    as the reference passes its immutable arrays, the scratch replay
    starts from the state the failed run left, and ends elsewhere."""
    clean = _tensors(_run_inplace(tmp_path, "clean", 100))
    real = t_ft._copy_leaf
    monkeypatch.setattr(t_ft, "_copy_leaf", lambda x: x if isinstance(
        x, torch.Tensor) else real(x))
    got = _tensors(_run_inplace(tmp_path, "faulty", 100, fail_at=3))
    assert not all(torch.equal(v, clean[k]) for k, v in got.items())


# -- HeartbeatMonitor ------------------------------------------------------------
@pytest.mark.parametrize("side", SIDES)
def test_heartbeat_remove_and_forgive(side):
    ft = _pkg(side).ft
    mon = ft.HeartbeatMonitor(timeout=1.0)
    mon.beat("w0", now=0.0)
    mon.beat("w1", now=0.5)
    assert mon.dead_workers(now=1.2) == ["w0"]
    mon.beat("cxl-c", now=0.0)
    mon.beat("cxl-a", now=4.9)
    with pytest.raises(ft.WorkerFailure, match="cxl-c"):
        mon.check(now=5.0)
    assert mon.remove("cxl-c") is True
    assert mon.remove("w0") and mon.remove("w1")
    mon.check(now=5.0)  # recovery acknowledged: no re-raise
    assert mon.remove("cxl-c") is False
    mon.beat("w2", now=0.0)
    assert mon.dead_workers(now=7.0) == ["cxl-a", "w2"]
    mon.forgive("w2", now=7.0)
    mon.forgive("cxl-a", now=7.0)
    mon.check(now=7.5)
    assert mon.dead_workers(now=8.5) == ["cxl-a", "w2"]


# -- FaultInjector ---------------------------------------------------------------
@pytest.mark.parametrize("side", SIDES)
def test_fault_injector_kill_and_revive(side):
    p = _pkg(side)
    mon = p.ft.HeartbeatMonitor(timeout=1.0)
    inj = p.elastic.FaultInjector(mon)
    devs = ("cxl-a", "cxl-b", "cxl-c")
    inj.beat_alive(devs, now=0.0)
    mon.check(now=0.5)
    inj.kill("cxl-c")
    assert not inj.alive("cxl-c") and inj.alive("cxl-a")
    inj.beat_alive(devs, now=2.0)
    with pytest.raises(p.ft.WorkerFailure, match="cxl-c"):
        mon.check(now=2.0)
    mon.remove("cxl-c")
    mon.check(now=2.5)
    inj.revive("cxl-c")
    inj.beat_alive(devs, now=3.0)
    mon.check(now=3.5)
    assert [a for _, a, _ in inj.log] == ["kill", "revive"]
    p.elastic.FaultInjector().beat_alive(devs)  # no monitor: a no-op


def _degraded_numbers(p):
    """Every perfmodel entry point on the paper's pool while the schedule's
    degradations hold, and after the context lifted them."""
    topo = p.tiers.paper_three_device_topology()
    a, b, c = topo.slows
    load = p.tiers.OpClass.LOAD

    def numbers():
        out = []
        for dev in (a, b, c, topo.fast):
            out += [p.perfmodel.stream_bandwidth(dev, load, n)
                    for n in (1, 4, 16)]
            out += [p.perfmodel.random_block_bandwidth(dev, load, blk, n)
                    for blk, n in ((64, 1), (4096, 8))]
            out.append(p.perfmodel.chase_seconds(dev, 1000))
        for src, dst in ((a, b), (a, a), (topo.fast, c), (c, topo.fast)):
            out.append(p.perfmodel.bulk_move_cost(src, dst, 1 << 20).seconds)
        return out

    rows = []
    with p.elastic.FaultInjector() as inj:
        inj.schedule(3, "degrade", "cxl-b", bw_scale=0.25) \
           .schedule(3, "degrade", "cxl-a", bw_scale=0.5, latency_scale=3.0) \
           .schedule(5, "restore", "cxl-b") \
           .schedule(5, "kill", "cxl-c").schedule(6, "revive", "cxl-c")
        assert inj.apply(0) == []
        fired = inj.apply(3)
        assert [e.action for e in fired] == ["degrade", "degrade"]
        assert inj.apply(3) == []  # events fire once
        rows.append(numbers())
        assert [e.action for e in inj.apply(5)] == ["restore", "kill"]
        rows.append(numbers())
        inj.apply(6)
        inj.degrade("cxl-c", bw_scale=0.5)  # left dangling on purpose
        rows.append(numbers())
        with pytest.raises(ValueError):
            inj.schedule(7, "explode", "cxl-a").apply(7)
        log = list(inj.log)
    rows.append(numbers())  # the context lifted every degradation
    return rows, log, inj.degradations


def test_fault_injector_schedule_degradations_and_cleanup():
    r_rows, r_log, r_left = _degraded_numbers(_pkg("ref"))
    t_rows, t_log, t_left = _degraded_numbers(_pkg("port"))
    assert t_rows == r_rows  # the same floats, to the bit
    assert t_log == r_log and t_left == r_left == {}
    assert r_rows[0] != r_rows[-1] and r_rows[-1] == _degraded_numbers(
        _pkg("port"))[0][-1]


# -- choose_mesh / replan --------------------------------------------------------
@pytest.mark.parametrize("n_chips", [1, 2, 6, 8, 12, 24, 64, 96, 256, 512])
@pytest.mark.parametrize("hint", [1, 4, 16, 32])
@pytest.mark.parametrize("pods", [1, 2, 4])
def test_choose_mesh_equal(n_chips, hint, pods):
    def mesh(m):
        try:
            out = m.choose_mesh(n_chips, model_parallel_hint=hint, pods=pods)
        except ValueError as e:
            return str(e)
        return (out, out.shape, out.axis_names)
    r, t = mesh(r_elastic), mesh(t_elastic)
    if isinstance(r, str):
        assert t == r
        return
    assert dataclasses.asdict(t[0]) == dataclasses.asdict(r[0])
    assert t[1:] == r[1:]


def _ref_buffers(seed: int):
    rng = np.random.default_rng(seed)
    classes = list(r_policy.BufferClass)
    out = []
    for i in range(int(rng.integers(2, 6))):
        prof = r_classifier.AccessProfile(
            float(rng.uniform(1e8, 1e11)), float(rng.uniform(0, 1e10)),
            int(rng.choice([1, 64])), int(rng.choice([1, 1024])), 2 << 20,
            0.05)
        out.append(r_planner.BufferReq(
            f"b{i}", classes[int(rng.integers(0, len(classes)))],
            int(rng.uniform(0.05, 4) * 2**30), prof,
            pin_fast=bool(rng.random() < 0.2)))
    return out


def _carried(req):
    """The reference's ``BufferReq`` as the port's, field by field."""
    return t_planner.BufferReq(
        req.name, t_policy.BufferClass(req.klass.value), req.nbytes,
        t_classifier.AccessProfile(**dataclasses.asdict(req.profile)),
        pin_fast=req.pin_fast, page_bytes=req.page_bytes)


def _replanned(m, planner, tiers, buffers, preset, surviving, old_mesh):
    topo = tiers.topology_from_spec(preset)
    try:
        old = planner.plan(buffers, topo, compute_seconds=0.05)
        out = m.replan(old_mesh, surviving, buffers, topo,
                       compute_seconds=0.05, old_placement=old,
                       reserve_fast_bytes=1 << 30)
    except (MemoryError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return {"mesh": (dataclasses.asdict(out.old_mesh),
                     dataclasses.asdict(out.new_mesh)),
            "decisions": {k: (d.slow_fraction, d.min_slow_fraction, d.reason,
                              d.boundedness.value, d.device_fractions,
                              d.policy.tiers, d.policy.weights)
                          for k, d in out.placement.decisions.items()},
            "est": (out.placement.est_fast_seconds,
                    out.placement.est_slow_seconds,
                    out.placement.est_step_seconds, out.placement.notes),
            "moves": [dataclasses.asdict(mv) for mv in out.moves]}


@pytest.mark.parametrize("preset", ["tpu-v5e", "paper", "paper3"])
@pytest.mark.parametrize("surviving", [256, 192, 128, 7])
def test_replan_equal(preset, surviving):
    """Mesh, decisions and moves equal; at 7 chips of 256 the state grows
    36x and both planners refuse it with the same message."""
    moves = 0
    for seed in range(4):
        ref = _ref_buffers(seed)
        r = _replanned(r_elastic, r_planner, r_tiers, ref, preset, surviving,
                       r_elastic.MeshPlan(256, 16, 16))
        t = _replanned(t_elastic, t_planner, t_tiers,
                       [_carried(b) for b in ref], preset, surviving,
                       t_elastic.MeshPlan(256, 16, 16))
        assert t == r
        if isinstance(r, str):
            assert surviving == 7 and r.startswith("MemoryError"), r
        else:
            moves += len(r["moves"])
    assert surviving in (256, 7) or moves > 0


# -- ServingEngine: kill -> drain -> recover -> re-add ----------------------------
def _engine_params(side):
    arch = r_registry.get("internvl2-2b").tiny()
    params = arch.module.init(arch.cfg, jax.random.PRNGKey(0))
    if side == "ref":
        return arch.cfg, params
    cfg = t_registry.get("internvl2-2b").tiny().cfg
    return cfg, params_from_jax(
        cfg, jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _kill_drain_recover(side: str, kill: bool):
    """The reference test's timeline (``tests/test_elastic.py``): three
    requests, ``cxl-c`` killed after step 4, drained through
    ``remove_device(monitor=)``, revived and re-added."""
    p = _pkg(side)
    cfg, params = _engine_params(side)
    topo = p.tiers.paper_three_device_topology()
    names = (topo.fast.name,) + topo.slow_names
    tel = p.telemetry.Telemetry()
    mon = p.ft.HeartbeatMonitor(timeout=1.5)
    ctl = p.caption.CaptionController(
        topo, p.caption.CaptionConfig(epoch_steps=2, probe_epochs=1))
    trace = []
    with p.mover.BulkMover(topo, asynchronous=False, telemetry=tel,
                           **p.kw) as mover, \
            p.elastic.FaultInjector(mon) as inj:
        eng = p.engine.ServingEngine(
            cfg, params, max_batch=2, max_len=32,
            policy=p.policy.MemPolicy.weighted(names, (5, 1, 1, 1)),
            topology=topo, page_t=4, caption=ctl, mover=mover,
            telemetry=tel, **p.kw)
        for _ in range(3):
            eng.submit([5, 6, 7], max_new_tokens=8)
        steps, recovered = 0, []
        while eng.queue or any(eng.slots):
            steps += 1
            now = float(steps)
            eng.step()
            inj.beat_alive(topo.slow_names, now=now)
            if kill and steps == 4:
                inj.kill("cxl-c")
            try:
                mon.check(now=now)
            except p.ft.WorkerFailure:
                for name in mon.dead_workers(now=now):
                    eng.remove_device(name, monitor=mon)
                    recovered.append(name)
                    dev = eng.cache.page_device
                    trace.append(np.asarray(
                        dev.numpy() if isinstance(dev, torch.Tensor)
                        else dev).tolist())
            trace.append(tuple(round(w, 12) for w in ctl.weights))
        mon.check(now=float(steps))  # the monitor is not poisoned
        if kill:
            inj.revive("cxl-c")
            eng.add_device("cxl-c")
        return {"tokens": sorted((r.rid, tuple(int(t) for t in r.generated))
                                 for r in eng.done),
                "recovered": recovered, "trace": trace,
                "routes": {k: v["bytes_moved"]
                           for k, v in tel.snapshot()["routes"].items()},
                "descs": (mover.descriptors_submitted, mover.bytes_submitted),
                "slows": (eng.topology.slow_names,
                          ctl.topology.slow_names, ctl.active_slow_device),
                "log": [a for _, a, _ in inj.log]}


@pytest.fixture(scope="module")
def drained():
    return {(side, kill): _kill_drain_recover(side, kill)
            for side in SIDES for kill in (True, False)}


@pytest.mark.parametrize("kill", [True, False], ids=["kill", "clean"])
def test_engine_kill_drain_recover_matches_reference(drained, kill):
    r, t = drained[("ref", kill)], drained[("port", kill)]
    assert t == r
    assert t["recovered"] == (["cxl-c"] if kill else [])


def test_engine_kill_keeps_the_clean_runs_tokens(drained):
    got, want = drained[("port", True)], drained[("port", False)]
    assert got["tokens"] == want["tokens"] and len(got["tokens"]) == 3
    assert got["slows"] == (("cxl-a", "cxl-b", "cxl-c"),) * 2 + ("cxl-c",)
    assert got["log"] == ["kill", "revive"]


# -- on the card --------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_resilient_loop_snapshot_lives_on_the_host(cuda, tmp_path,
                                                   monkeypatch):
    """With card tensors the pristine state is held in host memory (no
    second copy in HBM), and the replay writes it back into the live
    tensors (``data_ptr()``s kept), bit-exact against the CPU."""
    snaps = []
    real = t_ft._snapshot

    def spy(tree):
        snaps.append(real(tree))
        return snaps[-1]
    monkeypatch.setattr(t_ft, "_snapshot", spy)
    got = _run_inplace(tmp_path, "card", 100, fail_at=3, device=cuda)
    (snap,) = snaps
    tensors = [v for v in snap.values() if isinstance(v, torch.Tensor)]
    assert len(tensors) == 5
    assert all(v.device.type == "cpu" for v in tensors)
    assert got["params"]["layers"]["w"].is_cuda
    want = _tensors(_run_inplace(tmp_path, "cpu", 100))
    for k, v in _tensors(got).items():
        assert torch.equal(v, want[k]), k
