"""One run of one cell: find its pieces by name, set up, measure, check,
and print the result line.

A cell of ``BENCHMARK.json`` names a configuration (a file under
``cxlbench/configs/``) and a traffic mix (``cxlbench/traffic/<name>.json``,
whose ``driver`` names ``cxlbench/drivers/<driver>.py``).  Each metric that
applies to the cell is read by ``cxlbench/metrics/<name>.py`` (per-layer
metrics, with ``--trace 1``) or by the driver (end-to-end metrics, with
``--trace 0``); a dotted name with no file of its own is read by its
family's (``train_tokens_per_s.fused`` by the driver's
``train_tokens_per_s``, ``idle_share.dlrm`` by ``idle_share.py``).  A
driver has ``KEYS`` (the traffic parameters it implements: a traffic file
with any other is refused), ``setup``, ``window``, ``end_to_end``,
``facts``, ``release`` and ``check``; a reader has ``read(run)``, which
returns None where it finds nothing to read.

Order of a run: set-up (``setup_s`` runs from the process's start to the
end of it; the device's memory peak starts anew after it); with
``--trace 1`` a traced stretch of the traffic's ``trace_seconds`` under
the profiler, with spans; the window of ``--seconds``; the peak of device
memory; the readers' facts; the program's state freed; the check against
the reference; the readers."""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Optional

from cxlbench import devtrace
from cxlbench.common import (ROOT, BenchError, Spans, family_value,
                             forbidden_loaded, load_json, load_piece,
                             use_program)


@dataclasses.dataclass
class Run:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    device: Any
    spans: Spans
    #: the driver's own state (the program's objects, inputs, readings)
    state: dict = dataclasses.field(default_factory=dict)
    #: counts the readers work from, kept past the program's state
    facts: dict = dataclasses.field(default_factory=dict)
    #: the window's tallies, and the traced stretch's
    timed: dict = dataclasses.field(default_factory=dict)
    traced: dict = dataclasses.field(default_factory=dict)
    #: the reduced profiler trace of the traced stretch
    devtrace: Optional[devtrace.Trace] = None
    #: the host clock at the process's start
    t_start: float = 0.0

    def note(self, what: str) -> None:
        """A line on standard error: what is done, and when."""
        print(f"cxlbench: {what} at {time.perf_counter() - self.t_start:.2f} s",
              file=sys.stderr, flush=True)


def _named(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise BenchError(f"BENCHMARK.json has no {what} named {name!r}")


def applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def resolve(root: Path, workload: str) -> tuple[dict, dict, dict, dict]:
    """(benchmark, cell, configuration, traffic) of cell ``workload``."""
    bench = load_json(root / "BENCHMARK.json")
    cell = _named(bench["workloads"], workload, "workload")
    entry = _named(bench["configs"], cell["config"], "configuration")
    config = load_json(root / entry["file"])
    path = root / "cxlbench" / "traffic" / f"{cell['traffic']}.json"
    if not path.is_file():
        raise BenchError(f"no traffic file {path}")
    return bench, cell, config, load_json(path)


def pick_device(chips: int, device: Optional[str]):
    """The card (``device`` None), after checking the cell's chips are
    there; a named device (the CPU tests) as it is."""
    import torch
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} found")
    return torch.device("cuda", 0)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, root: Path = ROOT, device: Optional[str] = None,
             overrides: Optional[dict] = None) -> tuple[dict, list]:
    """(result line, checks) of one run.  ``device`` and ``overrides``
    (keys replaced in the configuration: a control's precision) are for
    the tests and the control runs only."""
    import torch
    bench, cell, config, traffic = resolve(root, workload)
    config = {**config, **(overrides or {})}
    dev = pick_device(int(cell["chips"]), device)
    card = dev.type == "cuda"
    use_program(root)
    driver = load_piece("drivers", traffic["driver"], root)
    unknown = sorted(set(traffic) - set(driver.KEYS))
    if unknown:
        raise BenchError(f"traffic {cell['traffic']!r} sets {unknown}, which "
                         f"driver {traffic['driver']!r} does not implement")
    run = Run(cell=cell, config=config, traffic=traffic, seed=int(seed),
              seconds=float(seconds), device=dev,
              spans=Spans(enabled=False), t_start=t_start)
    driver.setup(run)
    if card:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    if card:
        # the peak is what the measured stretches hold, not set-up's
        # temporaries (a table drawn whole before it is paged)
        torch.cuda.reset_peak_memory_stats(dev)
    run.note("set-up done")
    if trace:
        run.spans.enabled = True
        with devtrace.profiled(run.spans) as box:
            run.traced = driver.window(
                run, min(float(seconds), float(traffic["trace_seconds"])))
        run.devtrace = box[0]
    run.timed = driver.window(run, seconds)
    peak = torch.cuda.max_memory_allocated(dev) if card else 0
    driver.facts(run)
    measured = {} if trace else driver.end_to_end(run)
    driver.release(run)
    run.note("window done, state freed")
    checks = driver.check(run)
    run.note("check done")
    correct = all(math.isfinite(v) and v <= limit for _, v, limit in checks)

    metrics = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if not applies(m, cell["name"]):
            continue
        if trace:
            value = load_piece("metrics", m["name"], root).read(run)
        elif m["name"] == "setup_s":
            value = setup_s
        else:
            value = family_value(measured, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if card else dev.type,
                "kind": torch.cuda.get_device_name(dev) if card else "cpu",
                "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": correct,
              "attempted": run.timed["ops"] + run.traced.get("ops", 0),
              "failed": 0, "metrics": metrics, "device": dev_info}
    if trace:
        dev_info["busy_s"] = run.devtrace.busy_s
        dev_info["window_s"] = run.devtrace.window_s
        result["breakdown"] = run.devtrace.breakdown()
    result["checks"] = {name: {"value": v, "limit": limit}
                        for name, v, limit in checks}
    return result, checks


def main(argv: list, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="cxlbench/run.py", description=(
        "Run one cell of BENCHMARK.json once on the card and print one "
        "JSON result line."))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result, checks = run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=t_start)
        found = forbidden_loaded()
        if found:
            raise BenchError("modules of JAX or of the JAX package were "
                             f"loaded: {', '.join(found)}")
    except BenchError as e:
        print(f"cxlbench: {e}", file=sys.stderr)
        return 2
    sys.stdout.flush()
    for name, v, limit in checks:
        print(f"check {name} = {v!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
