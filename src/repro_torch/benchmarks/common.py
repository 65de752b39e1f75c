"""What the figure scripts share: their clock and the ``stream_copy``
launch bound of a page move."""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Iterable, Iterator

import torch

#: descriptors a mover batch holds, and so a gather launch moves.
MOVER_BATCH = 16


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stopwatch(device: torch.device) -> Callable[[], float]:
    """Start a clock; the returned callable stops it and gives seconds.

    On the card two CUDA events on the current stream bracket the work
    (the stop waits for the second), so host gaps between launches count;
    on the CPU it is ``time.perf_counter``."""
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)

        def stop() -> float:
            end.record(stream)
            end.synchronize()
            return start.elapsed_time(end) * 1e-3
        return stop
    t0 = time.perf_counter()
    return lambda: time.perf_counter() - t0


@contextlib.contextmanager
def gc_paused() -> Iterator[None]:
    """The garbage collector off over a timed stretch, as ``timeit`` runs
    its loops: a collection of a large heap would land in whichever pass
    it hits."""
    was_on = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_on:
            gc.enable()


def launch_bound(route_descriptors: Iterable[int]) -> int:
    """``stream_copy`` launches a move may make: one gather launch per
    route-pure mover batch of up to ``MOVER_BATCH`` descriptors, and one
    landing launch (none for an empty move)."""
    counts = [int(n) for n in route_descriptors if n]
    if not counts:
        return 0
    return sum(-(-n // MOVER_BATCH) for n in counts) + 1
