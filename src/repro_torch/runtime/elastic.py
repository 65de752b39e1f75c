"""Elastic re-meshing + device fault injection.

When a pod loses hosts (or gains them back), the runtime must (1) choose
a new (data, model) factorization of the surviving chips, (2) re-run the
bandwidth-aware placement planner against the *shrunken* fast-tier
budget — exactly the paper's scenario of demand exceeding DRAM, where
weighted interleaving to the slow tier absorbs the loss — and (3) emit a
resharding plan mapping old checkpoint shards onto the new mesh.

``FaultInjector`` is the emucxl-style harness for the device-level
analogue: per-device bandwidth/latency degradation (installed into the
perfmodel, so the mover's execution timing, the serving engine's modeled
step seconds, and every benchmark throughput model slow down together —
and the billed-bandwidth drift re-opens converged Caption walks) and
mid-run device kills, detected through missed heartbeats and recovered
through the elastic drain path (``ServingEngine.remove_device`` /
``CaptionController.remove_device``).

``choose_mesh`` and ``replan`` are the planner arithmetic of a shrink or
a grow: they name mesh shapes and tier moves and build no device mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core import perfmodel
from repro_torch.core.planner import BufferReq, Plan, plan as plan_placement
from repro_torch.core.tiers import TierTopology
from repro_torch.runtime.fault_tolerance import HeartbeatMonitor


@dataclasses.dataclass(frozen=True)
class InjectionEvent:
    """One scheduled fault: fires when the run reaches ``step``."""

    step: int
    action: str  # "degrade" | "restore" | "kill" | "revive"
    device: str
    bw_scale: float = 1.0
    latency_scale: float = 1.0


class FaultInjector:
    """emucxl-style per-device fault harness.

    ``degrade``/``restore`` install per-device bandwidth/latency
    multipliers into the perfmodel (every model entry point sees them, so
    the degradation is visible end to end, telemetry included); ``kill``/
    ``revive`` mark a device dead so its heartbeats stop — the attached
    :class:`HeartbeatMonitor` then raises ``WorkerFailure`` on the next
    ``check()``, and the caller routes recovery through the elastic
    drain path.  Faults can fire immediately or on a ``schedule`` keyed
    by run step (``apply(step)`` each step).
    """

    def __init__(self, monitor: Optional[HeartbeatMonitor] = None):
        self.monitor = monitor
        self.dead: set[str] = set()
        self.degradations: dict[str, tuple[float, float]] = {}
        self.log: list[tuple[int, str, str]] = []
        self._schedule: list[InjectionEvent] = []
        self._step = 0

    # -- immediate faults ----------------------------------------------------
    def degrade(self, device: str, *, bw_scale: float = 1.0,
                latency_scale: float = 1.0) -> None:
        perfmodel.set_degradation(device, bw_scale=bw_scale,
                                  latency_scale=latency_scale)
        self.degradations[device] = (bw_scale, latency_scale)
        self.log.append((self._step, "degrade",
                         f"{device} bw x{bw_scale:g} lat x{latency_scale:g}"))

    def restore(self, device: str) -> None:
        perfmodel.clear_degradations(device)
        self.degradations.pop(device, None)
        self.log.append((self._step, "restore", device))

    def kill(self, device: str) -> None:
        """The device disappears mid-run: beats stop, so the monitor's
        next ``check()`` raises WorkerFailure naming it."""
        self.dead.add(device)
        self.log.append((self._step, "kill", device))

    def revive(self, device: str) -> None:
        self.dead.discard(device)
        if self.monitor is not None:
            self.monitor.forgive(device)
        self.log.append((self._step, "revive", device))

    def alive(self, device: str) -> bool:
        return device not in self.dead

    def beat_alive(self, devices: Sequence[str],
                   now: Optional[float] = None) -> None:
        """One health-poll round: every live device beats; dead ones go
        silent and age out past the monitor's timeout."""
        if self.monitor is None:
            return
        for d in devices:
            if d not in self.dead:
                self.monitor.beat(d, now)

    # -- scheduled faults ----------------------------------------------------
    def schedule(self, step: int, action: str, device: str, *,
                 bw_scale: float = 1.0,
                 latency_scale: float = 1.0) -> "FaultInjector":
        self._schedule.append(InjectionEvent(step, action, device,
                                             bw_scale, latency_scale))
        return self

    def apply(self, step: int) -> list[InjectionEvent]:
        """Fire every event scheduled for ``step``; returns them."""
        self._step = step
        fired = [e for e in self._schedule if e.step == step]
        for e in fired:
            if e.action == "degrade":
                self.degrade(e.device, bw_scale=e.bw_scale,
                             latency_scale=e.latency_scale)
            elif e.action == "restore":
                self.restore(e.device)
            elif e.action == "kill":
                self.kill(e.device)
            elif e.action == "revive":
                self.revive(e.device)
            else:
                raise ValueError(f"unknown injection action {e.action!r}")
        self._schedule = [e for e in self._schedule if e.step != step]
        return fired

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Lift every degradation this injector installed (the perfmodel
        registry is process-global; tests must not leak faults)."""
        for device in list(self.degradations):
            perfmodel.clear_degradations(device)
        self.degradations.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    n_chips: int
    data: int
    model: int
    pods: int = 1

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.pods, self.data, self.model) if self.pods > 1 else (self.data, self.model)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("pod", "data", "model") if self.pods > 1 else ("data", "model")


def choose_mesh(n_chips: int, *, model_parallel_hint: int = 16,
                pods: int = 1) -> MeshPlan:
    """Largest model axis <= hint that divides chips-per-pod; rest is data."""
    per_pod = n_chips // pods
    if per_pod * pods != n_chips:
        raise ValueError("chips must divide evenly into pods")
    model = min(model_parallel_hint, per_pod)
    while per_pod % model:
        model -= 1
    return MeshPlan(n_chips=n_chips, data=per_pod // model, model=model, pods=pods)


@dataclasses.dataclass
class ReshardMove:
    buffer: str
    kind: str  # "repartition" | "tier_shift"
    detail: str


@dataclasses.dataclass
class ElasticPlan:
    old_mesh: MeshPlan
    new_mesh: MeshPlan
    placement: Plan
    moves: list[ReshardMove]


def replan(
    old_mesh: MeshPlan,
    surviving_chips: int,
    buffers: Sequence[BufferReq],
    topology: TierTopology,
    *,
    compute_seconds: float,
    old_placement: Optional[Plan] = None,
    reserve_fast_bytes: int = 0,
) -> ElasticPlan:
    """Plan the shrink/grow: new mesh + new tier placement + moves.

    Per-chip state grows by old/new chip ratio; the planner decides how
    much of that growth spills to the slow tier (N:M re-weighting).
    """
    new_mesh = choose_mesh(surviving_chips, model_parallel_hint=old_mesh.model,
                           pods=old_mesh.pods if surviving_chips % old_mesh.pods == 0
                           else 1)
    growth = old_mesh.n_chips / new_mesh.n_chips
    scaled = [
        dataclasses.replace(
            b, nbytes=int(b.nbytes * growth),
            profile=dataclasses.replace(
                b.profile,
                bytes_read_per_step=b.profile.bytes_read_per_step * growth,
                bytes_written_per_step=b.profile.bytes_written_per_step * growth,
            ),
        )
        for b in buffers
    ]
    placement = plan_placement(
        scaled, topology, compute_seconds=compute_seconds * growth,
        reserve_fast_bytes=reserve_fast_bytes,
    )
    moves: list[ReshardMove] = []
    if (new_mesh.data, new_mesh.model) != (old_mesh.data, old_mesh.model):
        moves.append(ReshardMove(
            "*", "repartition",
            f"mesh {old_mesh.shape} -> {new_mesh.shape}: all-gather shards on "
            f"dead hosts' peers, re-scatter to the new layout",
        ))
    for name, d in placement.decisions.items():
        old_f = old_placement.slow_fraction(name) if old_placement and \
            name in old_placement.decisions else 0.0
        if abs(d.slow_fraction - old_f) > 1e-3:
            moves.append(ReshardMove(
                name, "tier_shift",
                f"slow fraction {old_f:.1%} -> {d.slow_fraction:.1%} "
                f"(bulk-mover demotion of {d.slow_fraction - old_f:+.1%} pages)",
            ))
    return ElasticPlan(old_mesh, new_mesh, placement, moves)
