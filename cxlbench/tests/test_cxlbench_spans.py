"""The readers of the program's spans (``repro.*`` markers in the profiler's
trace) give the interval arithmetic's values on hand-made traces, and
nothing where there is no trace or no span of their name."""
from __future__ import annotations

import pytest

from checkout import ROOT

pytest.importorskip("torch")

from cxlbench import devtrace  # noqa: E402
from cxlbench.common import load_json, load_piece  # noqa: E402

BENCH = load_json(ROOT / "BENCHMARK.json")
IDLE = ["idle_in_program_share.dlrm", "idle_in_gc_share.train",
        "idle_in_gc_share.train.fused", "idle_in_offload_share"]
PAGE = ["page_load_ms", "page_update_ms", "page_writeback_ms"]


def _trace(events):
    """A window of 0..100 us and (category, name, start, duration[,
    correlation]) events."""
    base = [{"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW,
             "ts": 0.0, "dur": 100.0}]
    return devtrace.Trace(base + [
        {"ph": "X", "cat": e[0], "name": e[1], "ts": e[2], "dur": e[3],
         "args": {"correlation": e[4]} if len(e) > 4 else {}}
        for e in events])


class Run:
    def __init__(self, tr):
        self.devtrace = tr


def _read(name, tr):
    return load_piece("metrics", name).read(Run(tr))


def _idle_trace():
    # busy 0..20 and 50..60: idle 20..50 and 60..100, 70 us in all
    return _trace([("kernel", "k", 0.0, 20.0), ("kernel", "k", 50.0, 10.0),
                   ("user_annotation", "lookup", 0.0, 100.0),
                   ("user_annotation", "repro.interleave.bag_reduce",
                    10.0, 20.0),
                   ("user_annotation", "repro.gc.gen2", 25.0, 3.0),
                   ("user_annotation", "repro.gc.gen0", 55.0, 15.0),
                   ("user_annotation", "repro.offload.step", 40.0, 40.0)])


@pytest.mark.parametrize("name, covered", [
    # every repro.* span: 20..30 (the collector's 25..28 inside it counts
    # once), 40..50 and 60..80
    ("idle_in_program_share.dlrm", 10.0 + 10.0 + 20.0),
    # repro.gc.*: 25..28 and 60..70
    ("idle_in_gc_share.train", 3.0 + 10.0),
    ("idle_in_gc_share.train.fused", 3.0 + 10.0),
    # repro.offload.step: 40..50 and 60..80
    ("idle_in_offload_share", 10.0 + 20.0),
])
def test_idle_readers_give_the_share_of_idle_their_spans_cover(name,
                                                               covered):
    assert _read(name, _idle_trace()) == pytest.approx(covered / 70.0)


def test_an_idle_share_is_zero_where_the_device_never_waits():
    tr = _trace([("kernel", "k", 0.0, 100.0),
                 ("user_annotation", "repro.gc.gen0", 10.0, 5.0)])
    assert _read("idle_in_gc_share.train", tr) == 0.0


def _paging_trace():
    """Two steps that launched work and one that launched none.  Step A's
    two loads launch operations on two streams that overlap (10..30 and
    25..35: 25 us merged), its writeback one at 20..40 beside them, its
    update one at 36..38; step B's load one at 60..70."""
    return _trace([
        ("user_annotation", "repro.offload.step", 0.0, 45.0),
        ("user_annotation", "repro.offload.load", 1.0, 2.0),
        ("user_annotation", "repro.offload.load", 4.0, 1.0),
        ("user_annotation", "repro.offload.update", 5.5, 0.5),
        ("user_annotation", "repro.offload.writeback", 6.0, 2.0),
        ("user_annotation", "repro.offload.step", 50.0, 5.0),
        ("user_annotation", "repro.offload.load", 51.0, 1.0),
        ("user_annotation", "repro.offload.step", 92.0, 3.0),
        ("cuda_runtime", "cudaLaunchKernel", 2.0, 0.5, 1),
        ("cuda_runtime", "cudaLaunchKernel", 4.5, 0.2, 2),
        ("cuda_runtime", "cudaLaunchKernel", 5.7, 0.1, 3),
        ("cuda_runtime", "cudaLaunchKernel", 7.0, 0.5, 4),
        ("cuda_runtime", "cudaLaunchKernel", 51.5, 0.2, 5),
        ("kernel", "segments_kernel", 10.0, 20.0, 1),
        ("kernel", "segments_kernel", 25.0, 10.0, 2),
        ("kernel", "adam", 36.0, 2.0, 3),
        ("kernel", "segments_kernel", 20.0, 20.0, 4),
        ("kernel", "segments_kernel", 60.0, 10.0, 5)])


@pytest.mark.parametrize("name, busy_us", [
    ("page_load_ms", 25.0 + 10.0),
    ("page_update_ms", 2.0),
    ("page_writeback_ms", 20.0),
])
def test_page_readers_give_merged_device_time_a_step(name, busy_us):
    assert _read(name, _paging_trace()) == pytest.approx(busy_us * 1e-3 / 2)


def test_the_three_parts_fit_inside_the_steps_device_time():
    tr = _paging_trace()
    parts = [op for kind in ("load", "update", "writeback")
             for op in tr.in_spans(f"repro.offload.{kind}")]
    step = tr.in_spans("repro.offload.step")
    merged = [sum(b - a for a, b in devtrace.union((a, b) for _, a, b, _ in ops))
              for ops in (parts, step)]
    assert merged[0] <= merged[1]
    assert sorted(parts) == sorted(step)


@pytest.mark.parametrize("name", IDLE + PAGE)
def test_span_readers_read_nothing_without_a_trace_or_their_spans(name):
    assert _read(name, None) is None
    bare = _trace([("kernel", "k", 0.0, 20.0),
                   ("user_annotation", "fwd_bwd", 0.0, 50.0)])
    assert _read(name, bare) is None


@pytest.mark.parametrize("name", IDLE + PAGE)
def test_span_metrics_are_program_spans_of_known_cells(name):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert entry["source"] == "program_span"
    cells = {c["name"] for c in BENCH["workloads"]}
    assert entry["workloads"] and set(entry["workloads"]) <= cells
