"""Assigned input-shape set (per-arch applicability rules included): the
reference's cells, over the port's configs."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq: int
    batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment rules."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k decode needs "
                       "sub-quadratic attention (DESIGN.md skip note)")
    return True, ""


def cells(cfgs: dict[str, ArchConfig]):
    """All (arch, shape) cells with applicability flags."""
    out = []
    for arch_id, cfg in cfgs.items():
        for s in SHAPES.values():
            ok, why = applicable(cfg, s)
            out.append((arch_id, s, ok, why))
    return out
