"""The port's spans (``core/telemetry.span`` and the collector's hook): off,
no instrumented path builds a profiler marker; under a profiler, the trace
holds each span where the layer's work is, on the calling thread, and the
step's results are the same bits either way."""
import copy
import gc
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.autograd.profiler import record_function  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.core.interleave import InterleavedTensor  # noqa: E402
from repro_torch.core.policy import MemPolicy  # noqa: E402
from repro_torch.core.telemetry import Telemetry, span  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.kernels.stream_copy import ops as stream_ops  # noqa: E402
from repro_torch.models.registry import get as get_arch  # noqa: E402
from repro_torch.optim import adamw, offload, schedules  # noqa: E402

#: a paged leaf of 2.5 pages: three runs of one page, the last one partial
PAGED = int(2.5 * offload.PAGE_ELEMS)
RUNS = 3
STEPS = 2
CALLS = 2


@pytest.fixture
def one_page_runs(monkeypatch):
    monkeypatch.setattr(offload, "WRITEBACK_RUN_PAGES", 1)


@pytest.fixture
def markers(monkeypatch) -> list:
    """Names of the ``record_function`` markers built while the test runs."""
    made, init = [], record_function.__init__

    def counting(self, name, *args, **kwargs):
        made.append(name)
        init(self, name, *args, **kwargs)
    monkeypatch.setattr(record_function, "__init__", counting)
    return made


def _table() -> InterleavedTensor:
    x = torch.randn(512, 8, generator=torch.Generator().manual_seed(1))
    return InterleavedTensor.from_array(
        x, MemPolicy.weighted(("hbm", "host"), (1, 3)), 16, device="cpu")


def _bags(n: int = 4) -> torch.Tensor:
    return torch.randint(0, 512, (n, 6),
                         generator=torch.Generator().manual_seed(2))


def _optimizer():
    """(optimizer, params, grads, state): one paged leaf and one fast."""
    g = torch.Generator().manual_seed(3)
    params = {"w": torch.randn(PAGED, generator=g),
              "b": torch.randn(64, generator=g)}
    grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    opt = offload.TieredAdamW(
        adamw.AdamWConfig(lr=1e-3, schedule=schedules.constant()),
        slow_fraction=0.9, telemetry=Telemetry())
    state = opt.init(params)
    assert list(state["slow"]) == ["w"]
    return opt, params, grads, state


def _loss_and_grad():
    arch = get_arch("starcoder2-3b").tiny()
    params = arch.module.init(arch.cfg, 0, device="cpu")
    data = TokenPipeline(DataConfig(vocab=arch.cfg.vocab_padded, batch=2,
                                    seq=16, seed=5))
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in data.batch_at(0).items()}
    return arch.module.loss_and_grad(arch.cfg, params, batch, remat=True)


def _instrumented_paths():
    it = _table()
    for _ in range(CALLS):
        it.bag_reduce(_bags())
    opt, params, grads, state = _optimizer()
    for _ in range(STEPS):
        params, state, _ = opt.step(params, grads, state)
    _loss_and_grad()
    gc.collect()


def test_no_marker_is_built_without_a_profiler(one_page_runs, markers):
    _instrumented_paths()
    assert markers == []
    # the count sees markers where a profiler records
    with profile(activities=[ProfilerActivity.CPU]):
        _instrumented_paths()
    for name in ("repro.interleave.bag_reduce", "repro.offload.step",
                 "repro.offload.load", "repro.offload.update",
                 "repro.offload.writeback", "repro.gc.gen2"):
        assert name in markers, name


def test_a_span_is_a_marker_only_while_a_profiler_records(markers):
    with span("repro.test"):
        pass
    assert markers == []
    with profile(activities=[ProfilerActivity.CPU]):
        with span("repro.test") as s:
            assert s._marker is not None
        assert s._marker is None
    assert markers == ["repro.test"]


def _user_spans(prof, tmp_path) -> list[tuple[str, float, float, int]]:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    got = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
            e["tid"]) for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e["name"].startswith("repro.")]
    return sorted(got, key=lambda s: s[1])


def test_the_trace_holds_each_span_on_the_calling_thread(one_page_runs,
                                                         monkeypatch,
                                                         tmp_path):
    it = _table()
    opt, params, grads, state = _optimizer()
    leaf = state["slow"]["w"]
    loads = []
    copy_segments = stream_ops.stream_copy_segments

    def spy(srcs, dsts, segs, **kw):
        if srcs[0].data_ptr() == leaf.block.data_ptr():
            loads.append((threading.get_ident(), int(segs[0][1])))
        return copy_segments(srcs, dsts, segs, **kw)
    monkeypatch.setattr(stream_ops, "stream_copy_segments", spy)
    gc.collect()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(CALLS):
            it.bag_reduce(_bags())
        for _ in range(STEPS):
            params, state, _ = opt.step(params, grads, state)
        gc.collect()
    got = _user_spans(prof, tmp_path)
    names = [n for n, *_ in got]
    assert names.count("repro.interleave.bag_reduce") == CALLS
    assert names.count("repro.gc.gen2") >= 1
    steps = [s for s in got if s[0] == "repro.offload.step"]
    assert len(steps) == STEPS
    caller = steps[0][3]
    assert {tid for *_, tid in got} == {caller}
    for _, t0, t1, _ in steps:
        inside = [n for n, a, b, _ in got if t0 <= a and b <= t1
                  and n.startswith("repro.offload.")
                  and n != "repro.offload.step"]
        # run r+1's load is queued just before run r's update
        assert inside == ["repro.offload.load", "repro.offload.load",
                          "repro.offload.update", "repro.offload.writeback",
                          "repro.offload.load", "repro.offload.update",
                          "repro.offload.writeback", "repro.offload.update",
                          "repro.offload.writeback"]
    for kind in ("load", "update", "writeback"):
        assert names.count(f"repro.offload.{kind}") == RUNS * STEPS
    # every load on the calling thread, in run order, a run's pages each
    page_bytes = 4 * offload.PAGE_ELEMS
    assert loads == [(threading.get_ident(), r * page_bytes)
                     for _ in range(STEPS) for r in range(RUNS)]
    assert leaf.n_pages == RUNS


def test_the_step_is_the_same_bits_under_a_profiler(one_page_runs):
    opt, params, grads, state = _optimizer()
    twin = copy.deepcopy((params, state))
    for _ in range(STEPS):
        params, state, _ = opt.step(params, grads, state)
    p2, s2 = twin
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(STEPS):
            p2, s2, _ = opt.step(p2, grads, s2)
    for k in params:
        assert torch.equal(params[k], p2[k]), k
    assert torch.equal(state["step"], s2["step"])
    for m in ("mu", "nu"):
        for k, v in state["fast"][m].items():
            assert torch.equal(v, s2["fast"][m][k]), (m, k)
    for k, leaf in state["slow"].items():
        assert torch.equal(leaf.block, s2["slow"][k].block), k
