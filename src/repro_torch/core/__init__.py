"""TierMesh core on PyTorch — the paper's contribution as a composable library.

Demystifying CXL Memory (Sun et al., MICRO'23), ported to PyTorch and
CUDA: tier characterization (tiers/perfmodel), placement policies
(policy/planner/classifier), page interleaving (interleave), bulk
movement (mover), capacity accounting (ledger), the Caption
controller and its fleet-level arbiter (caption, warmstart, arbiter),
and hotness-driven semantic tiering (hotness).
"""
from repro_torch.core.arbiter import (ArbiterConfig, CaptionArbiter,
                                      budgeted_config)
from repro_torch.core.caption import (
    CaptionConfig,
    CaptionController,
    EpochMetrics,
)
from repro_torch.core.classifier import AccessProfile, Boundedness, classify
from repro_torch.core.hotness import (HotnessLedger, HotSetCoordinator,
                                      SemanticTensor, semantic_assignment)
from repro_torch.core.interleave import InterleavedTensor
from repro_torch.core.ledger import CapacityError, TierLedger
from repro_torch.core.mover import (BulkMover, Descriptor, double_buffer,
                                    stream_executor)
from repro_torch.core.planner import BufferReq, Decision, Plan, plan
from repro_torch.core.policy import BufferClass, MemPolicy, PolicyKind
from repro_torch.core.tiers import (
    CXL_A,
    CXL_AGILEX,
    CXL_B,
    CXL_C,
    DDR5_L8,
    DDR5_R1,
    DEVICE_REGISTRY,
    H100_HBM,
    H100_HOST_PINNED,
    HBM_V5E,
    HOST_V5E,
    OpClass,
    TierSpec,
    TierTopology,
    h100_topology,
    paper_three_device_topology,
    paper_topology,
    topology_from_spec,
    tpu_v5e_topology,
)
from repro_torch.core.warmstart import WarmStartMemo

__all__ = [
    "ArbiterConfig", "CaptionArbiter", "budgeted_config",
    "CaptionConfig", "CaptionController", "EpochMetrics",
    "AccessProfile", "Boundedness", "classify",
    "HotnessLedger", "HotSetCoordinator", "SemanticTensor",
    "semantic_assignment",
    "InterleavedTensor", "CapacityError", "TierLedger",
    "BulkMover", "Descriptor", "double_buffer", "stream_executor",
    "BufferReq", "Decision", "Plan", "plan",
    "BufferClass", "MemPolicy", "PolicyKind",
    "OpClass", "TierSpec", "TierTopology",
    "CXL_A", "CXL_AGILEX", "CXL_B", "CXL_C",
    "DDR5_L8", "DDR5_R1", "DEVICE_REGISTRY", "H100_HBM", "H100_HOST_PINNED",
    "HBM_V5E", "HOST_V5E",
    "h100_topology", "paper_three_device_topology", "paper_topology",
    "topology_from_spec", "tpu_v5e_topology",
    "WarmStartMemo",
]
