"""Movement/access telemetry: bytes and descriptors per tier route.

The paper's guidelines hinge on knowing per-route traffic (D2C, C2D,
C2C, D2D in Fig. 4).  Every mover/interleave operation records here so
benchmarks and the planner's feedback loop see real traffic, and so a
"centralized daemon" (§6) has the data to throttle writers.

:class:`EpochWindow` is the PMU-sampling analogue the Caption
controller (§7) reads: it closes fixed observation windows over the
cumulative route counters and reports per-epoch deltas plus EWMA
bandwidths, writer concurrency, and fast-tier pressure gauges.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import defaultdict
from typing import Optional


@dataclasses.dataclass
class RouteStats:
    bytes_moved: int = 0
    descriptors: int = 0
    batches: int = 0
    seconds: float = 0.0

    @property
    def bandwidth(self) -> float:
        return self.bytes_moved / self.seconds if self.seconds > 0 else 0.0


class Telemetry:
    def __init__(self):
        self._lock = threading.Lock()
        self.routes: dict[tuple[str, str], RouteStats] = defaultdict(RouteStats)
        self.counters: dict[str, float] = defaultdict(float)
        # Per-buffer attribution: (source, src, dst) -> bytes.  The arbiter
        # bills shared slow-tier traffic to the buffer that caused it.
        self.source_routes: dict[tuple[str, str, str], int] = defaultdict(int)

    def record_move(self, src: str, dst: str, nbytes: int, seconds: float,
                    descriptors: int = 1, batches: int = 1,
                    source: Optional[str] = None) -> None:
        with self._lock:
            r = self.routes[(src, dst)]
            r.bytes_moved += int(nbytes)
            r.descriptors += descriptors
            r.batches += batches
            r.seconds += seconds
            if source is not None:
                self.source_routes[(source, src, dst)] += int(nbytes)

    def bump(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += value

    def record_overlap(self, hidden_s: float, exposed_s: float,
                       source: Optional[str] = None) -> None:
        """Bill one migration's hidden-vs-exposed split (async mover).

        ``hidden_s`` rode under concurrent decode compute; ``exposed_s``
        stalled the issuing thread.  Benchmarks read the counters
        ``migration_hidden_s`` / ``migration_exposed_s`` (optionally
        per-source) to audit how much wire time the overlap actually hid.
        """
        with self._lock:
            self.counters["migration_hidden_s"] += float(hidden_s)
            self.counters["migration_exposed_s"] += float(exposed_s)
            if source is not None:
                self.counters[f"migration_hidden_s|{source}"] += float(hidden_s)
                self.counters[f"migration_exposed_s|{source}"] += float(exposed_s)

    def record_semantic(self, promoted_pages: int, demoted_pages: int,
                        source: Optional[str] = None) -> None:
        """Bill one semantic re-tier (core/hotness.py): pages promoted
        INTO the fast tier and demoted OUT of it.  Lateral slow<->slow
        shuffles appear on the mover routes, not here — these counters
        answer "how much hot-set churn is the placement loop doing",
        which benchmarks and the example read back per source."""
        with self._lock:
            self.counters["semantic_promoted_pages"] += int(promoted_pages)
            self.counters["semantic_demoted_pages"] += int(demoted_pages)
            if source is not None:
                self.counters[f"semantic_promoted_pages|{source}"] += int(
                    promoted_pages)
                self.counters[f"semantic_demoted_pages|{source}"] += int(
                    demoted_pages)

    def route(self, src: str, dst: str) -> RouteStats:
        return self.routes[(src, dst)]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "routes": {
                    f"{s}->{d}": dataclasses.asdict(v)
                    for (s, d), v in self.routes.items()
                },
                "counters": dict(self.counters),
                "source_routes": {
                    f"{src}|{s}->{d}": v
                    for (src, s, d), v in self.source_routes.items()
                },
            }

    def reset(self) -> None:
        with self._lock:
            self.routes.clear()
            self.counters.clear()
            self.source_routes.clear()


GLOBAL_TELEMETRY = Telemetry()


@dataclasses.dataclass(frozen=True)
class EpochCounters:
    """One closed observation window over the telemetry counters.

    ``route_bytes``/``route_bw`` are this epoch's deltas; ``route_bw_ewma``
    smooths bandwidth across epochs (the controller never trusts a single
    sample — Caption's measurement-smoothing stage).  ``gauges`` carry
    instantaneous readings published by the subsystems (writer
    concurrency, fast-tier pressure, per-step throughput proxies).
    """

    epoch: int
    seconds: float
    route_bytes: dict[str, int]
    route_bw: dict[str, float]
    route_bw_ewma: dict[str, float]
    counters: dict[str, float]  # per-epoch deltas of Telemetry.counters
    gauges: dict[str, float]
    #: per-source route deltas, keyed "source|src->dst" (arbiter billing).
    source_route_bytes: dict[str, int] = dataclasses.field(
        default_factory=dict)

    def bytes_into(self, dst, source: Optional[str] = None) -> int:
        """Bytes into tier ``dst`` (a name, or a sequence of device names
        — multi-device topologies sum their slow pool in one call)."""
        if not isinstance(dst, str):
            return sum(self.bytes_into(d, source) for d in dst)
        if source is not None:
            return sum(v for k, v in self.source_route_bytes.items()
                       if k.startswith(f"{source}|") and k.endswith(f"->{dst}"))
        return sum(v for k, v in self.route_bytes.items()
                   if k.endswith(f"->{dst}"))

    def bytes_from(self, src, source: Optional[str] = None) -> int:
        if not isinstance(src, str):
            return sum(self.bytes_from(s, source) for s in src)
        if source is not None:
            return sum(v for k, v in self.source_route_bytes.items()
                       if k.startswith(f"{source}|{src}->"))
        return sum(v for k, v in self.route_bytes.items()
                   if k.startswith(f"{src}->"))

    def workload_features(self, slow, source: Optional[str] = None
                          ) -> dict[str, float]:
        """AccessProfile-style features of this window against the slow
        pool (``slow``: one tier name or a sequence) — the warm-start
        fingerprint inputs: write share, slow-route bandwidth, writer
        parallelism.  Optionally source-scoped (per-buffer billing)."""
        into = self.bytes_into(slow, source)
        out = self.bytes_from(slow, source)
        total = into + out
        return {
            "write_ratio": into / total if total else 0.0,
            "slow_bw": total / max(self.seconds, 1e-9),
            "parallelism": float(self.gauges.get("writer_concurrency", 0)),
        }


class EpochWindow:
    """Windowed view over a :class:`Telemetry`: per-route epoch counters.

    Usage::

        win = EpochWindow(telemetry)
        ... traffic happens ...
        win.gauge("writer_concurrency", mover_writers)
        sample = win.tick()          # closes the epoch, returns deltas
    """

    def __init__(self, telemetry: Telemetry = GLOBAL_TELEMETRY,
                 *, ewma_alpha: float = 0.5):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha in (0, 1]")
        self.telemetry = telemetry
        self.ewma_alpha = ewma_alpha
        self.epoch = 0
        self._gauges: dict[str, float] = {}
        self._ewma: dict[str, float] = {}
        self._t0 = time.perf_counter()
        self._base = self._snapshot()

    def _snapshot(self) -> dict:
        snap = self.telemetry.snapshot()
        return {
            "routes": {k: v["bytes_moved"] for k, v in snap["routes"].items()},
            "counters": dict(snap["counters"]),
            "source_routes": dict(snap.get("source_routes", {})),
        }

    def gauge(self, name: str, value: float) -> None:
        """Publish an instantaneous gauge for the current epoch."""
        self._gauges[name] = float(value)

    def tick(self, seconds: Optional[float] = None) -> EpochCounters:
        """Close the current epoch and start the next one."""
        now = time.perf_counter()
        dt = seconds if seconds is not None else max(now - self._t0, 1e-9)
        cur = self._snapshot()
        route_bytes = {}
        for k, v in cur["routes"].items():
            route_bytes[k] = v - self._base["routes"].get(k, 0)
        route_bw = {k: v / dt for k, v in route_bytes.items()}
        a = self.ewma_alpha
        for k, bw in route_bw.items():
            prev = self._ewma.get(k)
            self._ewma[k] = bw if prev is None else a * bw + (1 - a) * prev
        counters = {}
        for k, v in cur["counters"].items():
            counters[k] = v - self._base["counters"].get(k, 0.0)
        source_bytes = {}
        for k, v in cur["source_routes"].items():
            source_bytes[k] = v - self._base["source_routes"].get(k, 0)
        sample = EpochCounters(
            epoch=self.epoch,
            seconds=dt,
            route_bytes=route_bytes,
            route_bw=route_bw,
            route_bw_ewma=dict(self._ewma),
            counters=counters,
            gauges=dict(self._gauges),
            source_route_bytes=source_bytes,
        )
        self.epoch += 1
        self._base = cur
        self._t0 = now
        self._gauges = {}
        return sample


class Timer:
    """Context-manager wall timer (host clock; callers synchronize first)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.t0
        return False
