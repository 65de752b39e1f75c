"""The profiler's trace of a traced stretch, reduced: the device's
activity (kernels, copies, sets), the benchmark's spans on the host
timeline, and what follows from them (busy seconds, the device work a
span launched, the largest device operations, the longest idle gaps).

A device operation belongs to the span that was open on the host when it
was launched (the launch call and the operation share the profiler's
correlation id), not to the span open when it ran: the host may run
ahead of the card, so a span needs no wait for the card to own its work."""
from __future__ import annotations

import bisect
import contextlib
import json
import tempfile
from pathlib import Path
from typing import Iterator

#: trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: trace categories of the host calls that launch it
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: the marker around a whole traced stretch
WINDOW = "cxlbench.window"


@contextlib.contextmanager
def profiled(spans) -> Iterator[list]:
    """Trace the block with ``torch.profiler`` (host and CUDA); the list
    yielded holds the reduced :class:`Trace` once the block is done."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    box: list = []
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        spans.profiling = True
        try:
            with record_function(WINDOW):
                yield box
                torch.cuda.synchronize()
        finally:
            spans.profiling = False
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            box.append(Trace(json.load(f)["traceEvents"]))


def union(intervals) -> list[tuple[float, float]]:
    """Merged (start, end) of possibly overlapping intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class Trace:
    """Times in microseconds on the profiler's clock."""

    def __init__(self, events: list):
        self.device = []  # (name, start, end, launched on the host)
        self.spans = []  # (name, start, end), the benchmark's markers
        launches, ops = {}, []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            t0, t1 = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            cat = e.get("cat", "")
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                ops.append((e["name"], t0, t1, corr))
            elif cat in LAUNCH_CATS and corr is not None:
                launches[corr] = t0
            elif cat == "user_annotation":
                self.spans.append((e["name"], t0, t1))
        # an operation whose launch is not in the trace counts as launched
        # when it began
        self.device = [(n, a, b, launches.get(c, a)) for n, a, b, c in ops]
        windows = [s for s in self.spans if s[0] == WINDOW]
        if not windows:
            raise RuntimeError("the trace holds no traced window")
        _, self.t0, self.t1 = windows[0]
        if not self.device:
            raise RuntimeError("the trace holds no device activity")

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy(self, within=None) -> list[tuple[float, float]]:
        """Merged intervals in which the device ran something, clipped to
        ``within`` (start, end), the traced window by default."""
        lo, hi = within or (self.t0, self.t1)
        return union((max(a, lo), min(b, hi)) for _, a, b, _ in self.device
                     if b > lo and a < hi)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def by_span(self, name: str) -> list[list[tuple]]:
        """For each span called ``name``, in order, the device operations
        (name, start, end, launch) launched while it was open."""
        spans = sorted((a, b) for n, a, b in self.spans if n == name)
        out: list = [[] for _ in spans]
        starts = [a for a, _ in spans]
        for op in self.device:
            j = bisect.bisect_right(starts, op[3]) - 1
            if j >= 0 and op[3] <= spans[j][1]:
                out[j].append(op)
        return out

    def in_spans(self, name: str) -> list[tuple]:
        """Device operations launched inside a span called ``name``."""
        return [op for ops in self.by_span(name) for op in ops]

    def breakdown(self, limit: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the innermost span open when it began."""
        by_name: dict = {}
        for n, a, b, _ in self.device:
            by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:limit]
        gaps, last = [], self.t0
        for a, b in self.busy() + [(self.t1, self.t1)]:
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:limit]
        named = [[self.open_span(a), (b - a) * 1e-6] for a, b in gaps]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}

    def open_span(self, t: float) -> str:
        inner = [(b - a, n) for n, a, b in self.spans if a <= t < b]
        return min(inner)[1] if inner else "outside the window"

