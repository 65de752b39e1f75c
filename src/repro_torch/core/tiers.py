"""Memory-tier model: the paper's testbed, the TPU v5e and the H100 targets.

The paper (Sun et al., MICRO'23) characterizes three tiers on x86:
local 8-channel DDR5, CXL-attached DDR4 behind PCIe Gen5 x16, and
remote-NUMA single-channel DDR5.  On TPU v5e the analogous two tiers are
on-chip HBM and host DRAM behind PCIe.  ``TierSpec`` captures the
characteristics the paper shows matter: peak bandwidth per operation
class, latency (flushed-line and dependent pointer-chase), and the
stream counts beyond which the controller contends (Fig. 3/5 collapse).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

GiB = 1024**3
GB = 1e9


class OpClass(enum.Enum):
    """Access classes from the paper's MEMO microbenchmark."""

    LOAD = "load"
    STORE = "store"  # temporal store (+wb) — incurs RFO on the paper's CXL
    NT_STORE = "nt_store"  # cache-bypass store (nt-store / movdir64B analogue)
    COPY = "copy"  # paired load+store bulk movement


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One memory tier as seen from the compute engine."""

    name: str
    kind: str  # "hbm" | "host" | "ddr_local" | "cxl" | "ddr_remote"
    capacity_bytes: int
    # Peak aggregate bandwidth per op class (bytes/s).
    load_bw: float
    store_bw: float  # temporal store path (RFO-afflicted on CXL-like tiers)
    nt_store_bw: float  # cache-bypass store path
    # Latency (ns).
    load_latency_ns: float  # flushed-line single load
    chase_latency_ns: float  # dependent pointer-chase per hop
    # Contention model (Fig. 3/5): bandwidth ramps ~linearly with streams up
    # to *_peak_streams, stays flat to *_collapse_streams, then degrades by
    # collapse_factor (controller-buffer interference).
    load_peak_streams: int
    store_peak_streams: int
    load_collapse_streams: int
    store_collapse_streams: int
    collapse_factor: float
    # Link behind which the tier sits (PCIe for CXL/host); None = direct.
    link_bw: Optional[float] = None
    # Traffic multiplier for temporal (in-place) writes: read-for-ownership /
    # fetch-modify-flush costs 2x bytes on far tiers (paper §4.2 / F3).
    rfo_traffic_multiplier: float = 1.0

    def peak_bw(self, op: OpClass) -> float:
        if op == OpClass.LOAD:
            return self.load_bw
        if op == OpClass.STORE:
            return self.store_bw
        if op == OpClass.NT_STORE:
            return self.nt_store_bw
        # COPY: harmonic combination of a load and a store stream.
        return 1.0 / (1.0 / self.load_bw + 1.0 / self.nt_store_bw)

    def peak_streams(self, op: OpClass) -> int:
        return self.load_peak_streams if op == OpClass.LOAD else self.store_peak_streams

    def collapse_streams(self, op: OpClass) -> int:
        return (
            self.load_collapse_streams
            if op == OpClass.LOAD
            else self.store_collapse_streams
        )


# ---------------------------------------------------------------------------
# Paper testbed (Table 1 + Figs. 2/3): used to calibrate/validate perfmodel.
# Absolute latencies chosen to satisfy the paper's reported ratios:
#   CXL flushed-load = 2.2x DDR5-L8; CXL chase = 3.7x DDR5-L8 = 2.2x DDR5-R1.
# ---------------------------------------------------------------------------
DDR5_L8 = TierSpec(
    name="ddr5-l8",
    kind="ddr_local",
    capacity_bytes=128 * GiB,
    load_bw=221 * GB,  # Fig. 3a peak
    store_bw=140 * GB,
    nt_store_bw=170 * GB,  # Fig. 3a nt-store peak
    load_latency_ns=170.0,
    chase_latency_ns=90.0,
    load_peak_streams=26,
    store_peak_streams=16,
    load_collapse_streams=64,
    store_collapse_streams=64,
    collapse_factor=0.95,
)

CXL_AGILEX = TierSpec(
    name="cxl-agilex",
    kind="cxl",
    capacity_bytes=16 * GiB,
    load_bw=20 * GB,  # peaks ~8 threads (Fig. 3b)
    store_bw=8 * GB,  # temporal store, RFO-limited
    nt_store_bw=22 * GB,  # ~DDR4-2666 theoretical max, 2 threads
    load_latency_ns=374.0,  # 2.2x DDR5-L8
    chase_latency_ns=333.0,  # 3.7x DDR5-L8
    load_peak_streams=8,
    store_peak_streams=2,
    load_collapse_streams=12,
    store_collapse_streams=4,
    collapse_factor=0.65,  # drops to ~16.8/20 for loads; harsher for stores
    link_bw=64 * GB,  # PCIe Gen5 x16
    rfo_traffic_multiplier=2.0,
)

# ---------------------------------------------------------------------------
# The paper's three CXL devices (Table 1, §4): same host, three different
# manufacturers, markedly different latency/bandwidth/RFO behaviour.  A is
# the ASIC controller with DDR5 behind it (fastest of the three), B an ASIC
# with DDR4, C the FPGA-based prototype (the Agilex card above, renamed into
# the A/B/C scheme so a multi-device topology can hold all three at once).
# ---------------------------------------------------------------------------
CXL_A = TierSpec(
    name="cxl-a",
    kind="cxl",
    capacity_bytes=64 * GiB,
    load_bw=26 * GB,  # ASIC + DDR5-4800 single channel
    store_bw=13 * GB,
    nt_store_bw=24 * GB,
    load_latency_ns=340.0,  # 2.0x DDR5-L8: best of the three
    chase_latency_ns=290.0,
    load_peak_streams=8,
    store_peak_streams=4,
    load_collapse_streams=16,
    store_collapse_streams=8,
    collapse_factor=0.75,
    link_bw=64 * GB,  # PCIe Gen5 x16
    rfo_traffic_multiplier=2.0,
)

CXL_B = TierSpec(
    name="cxl-b",
    kind="cxl",
    capacity_bytes=32 * GiB,
    load_bw=22 * GB,  # ASIC + DDR4-3200
    store_bw=10 * GB,
    nt_store_bw=21 * GB,
    load_latency_ns=360.0,
    chase_latency_ns=310.0,
    load_peak_streams=8,
    store_peak_streams=3,
    load_collapse_streams=14,
    store_collapse_streams=6,
    collapse_factor=0.70,
    link_bw=64 * GB,
    rfo_traffic_multiplier=2.0,
)

#: the FPGA prototype is the paper's worst-case device; alias it into the
#: manufacturer scheme so ``paper_three_device_topology`` reads like Table 1.
CXL_C = dataclasses.replace(CXL_AGILEX, name="cxl-c")

DDR5_R1 = TierSpec(
    name="ddr5-r1",
    kind="ddr_remote",
    capacity_bytes=256 * GiB,
    load_bw=30 * GB,  # single channel DDR5-4800 behind UPI
    store_bw=16 * GB,
    nt_store_bw=26 * GB,
    load_latency_ns=306.0,  # ~1.8x DDR5-L8 (paper: 1x-2.5x band)
    chase_latency_ns=151.0,  # CXL chase / 2.2
    load_peak_streams=8,
    store_peak_streams=4,
    load_collapse_streams=24,
    store_collapse_streams=16,
    collapse_factor=0.85,
)

# ---------------------------------------------------------------------------
# TPU v5e target (deployment): HBM fast tier + host-DRAM "CXL" tier.
# ---------------------------------------------------------------------------
TPU_PEAK_FLOPS_BF16 = 197e12  # per chip
TPU_HBM_BW = 819 * GB
TPU_HBM_BYTES = 16 * GiB
TPU_ICI_LINK_BW = 50 * GB  # per link
TPU_ICI_LINKS_PER_CHIP = 4  # v5e 2D torus: 4 links
TPU_DCN_BW_PER_HOST = 12.5 * GB  # cross-pod (pod axis) effective
TPU_PCIE_BW = 32 * GB  # host<->chip effective (the "CXL" link)
TPU_CHIPS_PER_HOST = 8

HBM_V5E = TierSpec(
    name="hbm",
    kind="hbm",
    capacity_bytes=TPU_HBM_BYTES,
    load_bw=TPU_HBM_BW,
    store_bw=TPU_HBM_BW,
    nt_store_bw=TPU_HBM_BW,
    load_latency_ns=350.0,
    chase_latency_ns=500.0,
    load_peak_streams=8,
    store_peak_streams=8,
    load_collapse_streams=32,
    store_collapse_streams=32,
    collapse_factor=0.95,
)

HOST_V5E = TierSpec(
    name="host",
    kind="host",
    capacity_bytes=512 * GiB // TPU_CHIPS_PER_HOST,  # per-chip share of host DRAM
    load_bw=TPU_PCIE_BW,
    store_bw=TPU_PCIE_BW / 2,  # fetch-modify-flush path
    nt_store_bw=TPU_PCIE_BW,
    load_latency_ns=2_000.0,
    chase_latency_ns=5_000.0,
    load_peak_streams=4,
    store_peak_streams=2,
    load_collapse_streams=8,
    store_collapse_streams=4,
    collapse_factor=0.7,
    link_bw=TPU_PCIE_BW,
    rfo_traffic_multiplier=2.0,
)


# ---------------------------------------------------------------------------
# NVIDIA H100 SXM target: HBM3 fast tier + page-locked host DRAM behind PCIe
# Gen5 x16, which the card's kernels read and write in place through unified
# virtual addressing.  Every field but the link is MEMO's measure mode on the
# card: ``chip_smoke.py`` phase 10 (``memo.calibrate``: load and store over
# 1-528 lanes and a stream_copy into the tier on a 1 GiB buffer, random
# blocks and a single-cycle chase over 256 MiB tables), run on three
# machines with an NVIDIA H100 80GB HBM3 at its 700.00 W power limit, and
# fitted once from the three runs' records (``tools/memo_medians.py``,
# ``memo.fit_tier``: each measurement the median of its runs; a lane count
# falls short of a sweep's peak only where every run reads it short).
# Beside each value, [min, max] of the three runs' own fits.
# ---------------------------------------------------------------------------
H100_PCIE_BW = 64 * GB  # PCIe Gen5 x16, one direction (data sheet)

H100_HBM = TierSpec(
    name="h100-hbm",
    kind="hbm",
    capacity_bytes=85_017_493_504,  # cudaDeviceProp.totalGlobalMem (all three)
    load_bw=3.10658e12,  # [3.10569e12, 3.10964e12]
    store_bw=2.7634e12,  # [2.76203e12, 2.76522e12]
    nt_store_bw=1.38884e12,  # stream_copy HBM->HBM writes [1.38763e12, 1.39066e12]
    load_latency_ns=1008.57,  # 1 KiB random blocks, one lane [1007.82, 1009.21]
    chase_latency_ns=331.793,  # a hop of the 256 MiB cycle [331.782, 332.362]
    load_peak_streams=132,  # (all three)
    store_peak_streams=132,  # (all three)
    load_collapse_streams=1 << 20,  # no collapse up to 528 lanes (all three)
    store_collapse_streams=1 << 20,  # no collapse up to 528 lanes (all three)
    collapse_factor=1.0,  # (all three)
)

H100_HOST_PINNED = TierSpec(
    name="h100-host-pinned",
    kind="host",
    capacity_bytes=108_447_924_224,  # the host's physical memory (all three)
    # SM loads of pinned memory read at 25-31 GB/s from 2 lanes on two
    # machines and at 48.5-51.3 GB/s from 4 lanes on the third; stores at
    # 52 GB/s from 2 lanes on all three
    load_bw=3.12764e10,  # [2.91873e10, 5.12448e10]
    store_bw=5.26243e10,  # [5.26127e10, 5.26367e10]
    nt_store_bw=3.34241e10,  # stream_copy HBM->pinned writes [3.14754e10, 3.77956e10]
    load_latency_ns=3552.88,  # 1 KiB random blocks, one lane [3337.76, 3567.83]
    chase_latency_ns=1245.46,  # a hop of the 256 MiB cycle [1238.66, 1320.25]
    load_peak_streams=2,  # [2, 4]
    store_peak_streams=2,  # (all three)
    # no collapse measured: the runs' own fits put one at 2, 4 and 264
    # lanes (factors 0.81-0.95), each from its own noise; the 50 GB/s
    # machine reads every count from 4 lanes at its peak
    load_collapse_streams=1 << 20,
    store_collapse_streams=1 << 20,  # no collapse measured [64, none]
    collapse_factor=1.0,  # [0.813512, 0.946959] in the runs' own fits
    link_bw=H100_PCIE_BW,
)


@dataclasses.dataclass(frozen=True, init=False)
class TierTopology:
    """An ordered fast tier + N slow devices, as one compute engine sees them.

    ``slow`` accepts a single :class:`TierSpec` (the historical two-tier
    shape) or a sequence of them (the paper's multi-device pool: CXL-A/B/C
    from three manufacturers attached to one host).  The two-device
    compatibility path is the ``slow`` property: the *first* slow device,
    which every ``slow_fraction``-era call site keeps addressing.

    ``extra`` holds devices that are *present* (ledger-visible, memo-
    characterizable) but not placement targets — e.g. the remote-NUMA node
    the paper measures but never interleaves onto.
    """

    fast: TierSpec
    slows: tuple[TierSpec, ...]
    extra: tuple[TierSpec, ...]

    def __init__(self, fast: TierSpec, slow=None, extra: tuple = (), *,
                 slows=None):
        if slows is not None and slow is not None:
            raise ValueError("pass slow= or slows=, not both")
        if slows is None:
            if slow is None:
                slows = ()
            elif isinstance(slow, (tuple, list)):
                slows = tuple(slow)
            else:
                slows = (slow,)
        names = [fast.name] + [t.name for t in slows] + [t.name for t in extra]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names in topology: {names}")
        object.__setattr__(self, "fast", fast)
        object.__setattr__(self, "slows", tuple(slows))
        object.__setattr__(self, "extra", tuple(extra))

    @property
    def slow(self) -> Optional[TierSpec]:
        """Two-device compatibility: the first (primary) slow device."""
        return self.slows[0] if self.slows else None

    @property
    def n_slow(self) -> int:
        return len(self.slows)

    @property
    def slow_names(self) -> tuple[str, ...]:
        return tuple(t.name for t in self.slows)

    @property
    def tiers(self) -> tuple[TierSpec, ...]:
        return (self.fast,) + self.slows + self.extra

    @property
    def devices(self) -> tuple[TierSpec, ...]:
        """Placement targets in canonical order: fast first, then slows."""
        return (self.fast,) + self.slows

    def by_name(self, name: str) -> TierSpec:
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(name)

    def device_index(self, name: str) -> int:
        """Ordinal of ``name`` in the canonical device order (0 = fast)."""
        for i, t in enumerate(self.devices):
            if t.name == name:
                return i
        raise KeyError(name)

    def effective_bw(self, tier: TierSpec, op: OpClass = OpClass.LOAD) -> float:
        bw = tier.peak_bw(op)
        return min(bw, tier.link_bw) if tier.link_bw else bw

    def bandwidth_weights(self, op: OpClass = OpClass.LOAD
                          ) -> tuple[float, ...]:
        """Per-slow-device share of the aggregate slow bandwidth.

        The Fig. 10 seed: the best static interleave ratio tracks each
        device's relative bandwidth, so a weight vector proportional to
        effective (link-clipped) bandwidth is the planner's prior for how
        to split a given slow fraction across devices."""
        if not self.slows:
            return ()
        bws = [self.effective_bw(t, op) for t in self.slows]
        total = sum(bws)
        return tuple(b / total for b in bws)

    # -- elastic hot-plug / hot-remove ---------------------------------------
    def remove_device(self, name: str, *,
                      keep_visible: bool = True) -> "TierTopology":
        """Hot-remove a slow device: a new topology without ``name`` as a
        placement target.

        With ``keep_visible`` (the default) the departing spec moves to
        ``extra`` — still ledger-visible so in-flight drain descriptors
        and telemetry routes naming it keep resolving via ``by_name`` —
        but ``slows``/``devices``/``bandwidth_weights`` no longer include
        it, so every weight simplex rebuilt from this topology excludes
        the dead device.  Removing the fast tier is not a thing."""
        if name == self.fast.name:
            raise ValueError("cannot remove the fast tier")
        spec = next((t for t in self.slows if t.name == name), None)
        if spec is None:
            raise KeyError(name)
        slows = tuple(t for t in self.slows if t.name != name)
        extra = self.extra + ((spec,) if keep_visible else ())
        return TierTopology(fast=self.fast, slows=slows, extra=extra)

    def add_device(self, spec) -> "TierTopology":
        """Hot-add a slow device: a new topology with ``spec`` appended to
        the placement targets.

        ``spec`` is a :class:`TierSpec` or a name — a name is promoted
        back from ``extra`` (the re-add of a previously removed device)
        or looked up in :data:`DEVICE_REGISTRY`."""
        if isinstance(spec, str):
            match = next((t for t in self.extra if t.name == spec), None)
            if match is None:
                match = DEVICE_REGISTRY.get(spec)
            if match is None:
                raise KeyError(spec)
            spec = match
        if spec.name == self.fast.name or spec.name in self.slow_names:
            raise ValueError(f"device {spec.name!r} already in topology")
        extra = tuple(t for t in self.extra if t.name != spec.name)
        return TierTopology(fast=self.fast, slows=self.slows + (spec,),
                            extra=extra)


def paper_topology() -> TierTopology:
    """The paper's testbed: local DDR5 fast tier + CXL slow tier (+ remote)."""
    return TierTopology(fast=DDR5_L8, slow=CXL_AGILEX, extra=(DDR5_R1,))


def paper_three_device_topology() -> TierTopology:
    """Table 1's full pool: DDR5 fast tier + the three CXL devices at once."""
    return TierTopology(fast=DDR5_L8, slows=(CXL_A, CXL_B, CXL_C))


def tpu_v5e_topology() -> TierTopology:
    """Deployment target: HBM fast tier + host-DRAM-behind-PCIe slow tier."""
    return TierTopology(fast=HBM_V5E, slow=HOST_V5E)


def h100_topology() -> TierTopology:
    """One H100: HBM3 fast tier + pinned host DRAM behind PCIe Gen5."""
    return TierTopology(fast=H100_HBM, slow=H100_HOST_PINNED)


#: devices addressable from a ``--devices`` spec (first name = fast tier).
DEVICE_REGISTRY: dict[str, TierSpec] = {
    t.name: t
    for t in (DDR5_L8, CXL_AGILEX, CXL_A, CXL_B, CXL_C, DDR5_R1, HBM_V5E,
              HOST_V5E, H100_HBM, H100_HOST_PINNED)
}

_NAMED_TOPOLOGIES = {
    "tpu-v5e": tpu_v5e_topology,
    "paper": paper_topology,
    "paper3": paper_three_device_topology,
    "h100": h100_topology,
}


def topology_from_spec(spec: str) -> TierTopology:
    """Build a topology from a CLI ``--devices`` spec.

    Either a named preset (``tpu-v5e``, ``paper``, ``paper3``, ``h100``) or a
    ``+``-joined device list from :data:`DEVICE_REGISTRY` with the first
    entry as the fast tier, e.g. ``ddr5-l8+cxl-a+cxl-b``."""
    key = spec.strip().lower()
    if key in _NAMED_TOPOLOGIES:
        return _NAMED_TOPOLOGIES[key]()
    names = [n.strip() for n in key.split("+") if n.strip()]
    if not names:
        raise ValueError(f"empty --devices spec: {spec!r}")
    try:
        devs = [DEVICE_REGISTRY[n] for n in names]
    except KeyError as e:
        raise ValueError(
            f"unknown device {e.args[0]!r}; choose from "
            f"{sorted(DEVICE_REGISTRY)} or a preset "
            f"{sorted(_NAMED_TOPOLOGIES)}") from None
    return TierTopology(fast=devs[0], slows=tuple(devs[1:]))
