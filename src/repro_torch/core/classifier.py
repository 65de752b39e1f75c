"""Latency-bound vs bandwidth-bound classification (paper §6.1).

The paper's final taxonomy: *latency-bound* applications (Redis — µs
responses, dependent single-stream accesses) degrade even with a small
slow-tier fraction and must stay fast-tier; *bandwidth-bound*
applications (DLRM embedding reduction — massively parallel streaming)
follow tier bandwidth and can even *gain* from interleaving when the
fast tier saturates.  ``classify`` operationalizes that decision from a
buffer's access profile so the planner can apply §6's guidelines
mechanically.
"""
from __future__ import annotations

import dataclasses
import enum

from repro_torch.core.tiers import TierSpec


class Boundedness(enum.Enum):
    LATENCY_BOUND = "latency"
    BANDWIDTH_BOUND = "bandwidth"
    COMPUTE_BOUND = "compute"


@dataclasses.dataclass(frozen=True)
class AccessProfile:
    """Per-step access behaviour of one buffer."""

    bytes_read_per_step: float
    bytes_written_per_step: float
    #: length of the dependent access chain (1 = fully parallel gather;
    #: large = pointer-chase / recurrent state update).
    dependent_chain: int
    #: number of independent access streams available to hide latency.
    parallelism: int
    #: typical contiguous access granularity in bytes.
    granularity: int
    #: compute time per step available to amortize access latency (s).
    compute_seconds: float = 0.0
    #: target response deadline, if any (s). µs-level deadlines are the
    #: paper's Redis case; ms-level is the DSB case.
    deadline_seconds: float | None = None

    @property
    def bytes_per_step(self) -> float:
        return self.bytes_read_per_step + self.bytes_written_per_step


def classify(profile: AccessProfile, tier: TierSpec) -> Boundedness:
    """Classify a buffer's access pattern against a candidate tier.

    Heuristic encoding of §6.1:
      * deep dependent chains with low parallelism are latency-bound
        unless per-hop latency is amortized by interleaved compute;
      * otherwise compare streaming time to compute time.
    """
    lat_s = tier.chase_latency_ns * 1e-9
    # Serial latency exposure: hops that cannot be overlapped.
    serial_hops = profile.dependent_chain / max(profile.parallelism, 1)
    latency_exposure = serial_hops * lat_s
    stream_time = profile.bytes_per_step / tier.load_bw if tier.load_bw else 0.0

    if profile.deadline_seconds is not None and profile.deadline_seconds < 100e-6:
        # µs-level SLO (Redis): any far-tier chase shows up in the tail.
        if latency_exposure > 0.05 * profile.deadline_seconds:
            return Boundedness.LATENCY_BOUND

    if latency_exposure > max(stream_time, profile.compute_seconds):
        return Boundedness.LATENCY_BOUND
    if stream_time > profile.compute_seconds:
        return Boundedness.BANDWIDTH_BOUND
    return Boundedness.COMPUTE_BOUND


def tolerates_slow_tier(profile: AccessProfile, slow: TierSpec) -> bool:
    """Paper guideline: offload only what amortizes the far tier's latency."""
    return classify(profile, slow) != Boundedness.LATENCY_BOUND


def classify_pool(profile: AccessProfile, topology) -> Boundedness:
    """Classify a profile against a topology's ACTIVE slow pool.

    Worst case across the slow devices: a buffer that is latency-bound
    against ANY device it could be interleaved onto must be treated as
    latency-bound for seeding (guideline 5 — one slow hop in a dependent
    chain is enough to show up in the tail).  With no slow devices the
    fast tier itself is the candidate (degenerate, never latency-bound
    in practice)."""
    tiers = topology.slows or (topology.fast,)
    verdicts = [classify(profile, t) for t in tiers]
    if Boundedness.LATENCY_BOUND in verdicts:
        return Boundedness.LATENCY_BOUND
    if Boundedness.BANDWIDTH_BOUND in verdicts:
        return Boundedness.BANDWIDTH_BOUND
    return verdicts[0]
