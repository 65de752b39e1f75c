"""Straggler mitigation: deadline-based micro-retry of stalled steps.

At pod scale, a slow host (thermal throttle, page-cache storm, a dying
HBM stack) stalls synchronous steps.  The driver-side mitigation here:
track a robust moving estimate of step time, and when a step exceeds
``threshold x`` the estimate, re-dispatch it (in production: to a hot
spare / re-issue the collective); the duplicate result is idempotent
because steps are pure functions of (state, step).
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class StragglerStats:
    median_estimate: float = 0.0
    dispatched: int = 0
    redispatched: int = 0


class StragglerMitigator:
    def __init__(self, *, threshold: float = 3.0, alpha: float = 0.1,
                 min_timeout: float = 0.05):
        self.threshold = threshold
        self.alpha = alpha
        self.min_timeout = min_timeout
        self.stats = StragglerStats()
        self._pool = cf.ThreadPoolExecutor(max_workers=2)

    def _observe(self, dt: float) -> None:
        s = self.stats
        s.median_estimate = (
            dt if s.median_estimate == 0.0
            else (1 - self.alpha) * s.median_estimate + self.alpha * dt
        )

    def run(self, fn: Callable[[], object]) -> object:
        """Execute fn; if it exceeds the deadline, re-dispatch and take
        whichever finishes first WITHOUT raising (results are idempotent,
        so a failed original racing a healthy backup must not lose)."""
        self.stats.dispatched += 1
        deadline = max(self.min_timeout,
                       self.threshold * (self.stats.median_estimate or 1e9))

        def timed():
            # Per-dispatch timing: the EWMA must see the winner's OWN
            # latency.  Wall clock from the first dispatch folds the whole
            # stall (deadline wait + backup runtime) into the estimate,
            # inflating the deadline after every straggle.
            t0 = time.perf_counter()
            return fn(), time.perf_counter() - t0

        fut = self._pool.submit(timed)
        try:
            result, dt = fut.result(timeout=deadline)
        except cf.TimeoutError:
            self.stats.redispatched += 1
            backup = self._pool.submit(timed)
            result, dt = self._first_success((fut, backup))
        self._observe(dt)
        return result

    @staticmethod
    def _first_success(futures):
        """First completed future that did not raise; only when every
        dispatch failed does the first exception propagate."""
        pending = set(futures)
        first_exc = None
        while pending:
            done, pending = cf.wait(pending,
                                    return_when=cf.FIRST_COMPLETED)
            for f in done:
                exc = f.exception()
                if exc is None:
                    return f.result()
                if first_exc is None:
                    first_exc = exc
        raise first_exc

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)
