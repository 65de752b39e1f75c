"""Fault tolerance: heartbeats, failure detection, checkpoint-restart.

``ResilientLoop`` wraps a step function: it checkpoints every
``checkpoint_every`` steps (async), detects worker failure (raised
``WorkerFailure`` — in production, a missed heartbeat or a collective
timeout), restores the last checkpoint, and replays.  Because the data
pipeline is a pure function of step, recovery is bit-exact (tested).

The port's step functions update parameters and optimizer moments in
place (``optim.adamw.apply``), so the pristine state a scratch replay
starts from is a copy of every tensor leaf too, not only of the numpy
ones: tensors on the card are copied to host memory (no second copy of
the state sits in HBM; pageable, so the memory goes back to the system
when the run ends), and a replay writes the copy back into the live
tensors in place, keeping their ``data_ptr()``s as
``Checkpointer.restore`` does.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.tree import flatten, rebuild


def _copy_leaf(x):
    """A copy of one leaf that no in-place update of ``x`` can reach: a
    tensor in host memory, a numpy array, or the value itself when it is
    immutable."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, np.ndarray):
        return np.array(x, copy=True)
    return x


def _snapshot(tree) -> dict:
    """``{leaf path: host copy}`` of a state tree (its leaves in
    :func:`repro_torch.tree.flatten`'s order)."""
    return {p: _copy_leaf(x) for p, x in flatten(tree)}


def _restore(tree, snap: dict):
    """``tree`` with every leaf set back to ``snap``: tensor leaves written
    in place (under ``torch.no_grad()``), the others replaced by fresh
    copies, so ``snap`` stays pristine for a later replay."""
    values = {}
    with torch.no_grad():
        for p, x in flatten(tree):
            if isinstance(x, torch.Tensor):
                x.copy_(snap[p])
            else:
                values[p] = _copy_leaf(snap[p])
    return rebuild(tree, values)


class WorkerFailure(RuntimeError):
    """A (simulated) node failure: lost heartbeat / dead collective."""


@dataclasses.dataclass
class Heartbeat:
    worker: str
    last_seen: float


class HeartbeatMonitor:
    """Detects missing heartbeats past ``timeout`` seconds."""

    def __init__(self, timeout: float = 10.0):
        self.timeout = timeout
        self._beats: dict[str, Heartbeat] = {}
        self._lock = threading.Lock()

    def beat(self, worker: str, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._beats[worker] = Heartbeat(worker, now)

    def dead_workers(self, now: Optional[float] = None) -> list[str]:
        now = time.monotonic() if now is None else now
        with self._lock:
            return [w for w, hb in self._beats.items()
                    if now - hb.last_seen > self.timeout]

    def check(self, now: Optional[float] = None) -> None:
        dead = self.dead_workers(now)
        if dead:
            raise WorkerFailure(f"lost heartbeat from {dead}")

    def remove(self, worker: str) -> bool:
        """Deregister a worker (elastic shrink / permanent removal).

        Without this, one missed timeout poisons the monitor forever:
        ``check()`` re-raises for the same dead worker on every later
        call, so recovery could never be acknowledged.  Returns whether
        the worker was registered."""
        with self._lock:
            return self._beats.pop(worker, None) is not None

    def forgive(self, worker: str, now: Optional[float] = None) -> None:
        """Recovery reset: the worker is healthy again (elastic re-add);
        restart its timeout window from ``now``."""
        self.beat(worker, now)


class ResilientLoop:
    def __init__(
        self,
        checkpointer: Checkpointer,
        *,
        checkpoint_every: int = 50,
        max_restarts: int = 3,
    ):
        self.ckpt = checkpointer
        self.checkpoint_every = checkpoint_every
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(
        self,
        state: dict,  # {"step": int, ...tree of tensors and arrays}
        step_fn: Callable[[dict, int], dict],  # (state, step) -> state
        n_steps: int,
        *,
        failure_injector: Optional[Callable[[int], None]] = None,
    ) -> dict[str, Any]:
        """Run to ``n_steps``, surviving WorkerFailure via restore+replay."""
        state = dict(state)  # never mutate the caller's dict
        step = start_step = int(state.pop("step"))
        # Snapshot the pristine initial state: a no-checkpoint failure
        # replays from scratch, and "scratch" must be bit-exact — not the
        # post-failure state a partially-executed step may have mutated.
        initial = _snapshot(state)
        while step < n_steps:
            try:
                if failure_injector is not None:
                    failure_injector(step)
                state = step_fn(state, step)
                step += 1
                if step % self.checkpoint_every == 0 or step == n_steps:
                    self.ckpt.save(step, state, metadata={"step": step})
            except WorkerFailure:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                latest = self.ckpt.latest_step()
                if latest is None:
                    # replay from scratch: write the snapshot back (it
                    # stays pristine in case this replay fails too)
                    state = _restore(state, initial)
                    step = start_step
                    continue
                restored_step, state, _ = self.ckpt.restore(state)
                step = restored_step
        self.ckpt.wait()
        return dict(state, step=step)
