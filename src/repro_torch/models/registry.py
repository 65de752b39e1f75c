"""Architecture registry: ``--arch <id>`` -> (config, model module).

All ten configs of the reference, DeepSeek-V2-Lite beside them, and all
six model families: ``dense`` and ``vlm`` (the
transformer backbone), ``moe``, ``ssm`` (rwkv6), ``hybrid`` (RG-LRU +
local attention) and ``audio`` (whisper's encoder-decoder).  Every model
module exposes ``init(cfg, seed, device=)``, ``forward``, ``loss``,
``loss_and_grad``, ``init_cache`` and ``decode_step``."""
from __future__ import annotations

import dataclasses
import importlib
from types import ModuleType

from repro_torch.configs.base import ArchConfig

_CONFIG_MODULES = {
    "qwen2.5-32b": "qwen2_5_32b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen1.5-32b": "qwen1_5_32b",
    "stablelm-12b": "stablelm_12b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "internvl2-2b": "internvl2_2b",
    "rwkv6-7b": "rwkv6_7b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "whisper-large-v3": "whisper_large_v3",
}

_FAMILY_MODULES = {
    "dense": "repro_torch.models.transformer",
    "vlm": "repro_torch.models.transformer",  # backbone
    "moe": "repro_torch.models.moe",
    "ssm": "repro_torch.models.rwkv",
    "hybrid": "repro_torch.models.rglru",
    "audio": "repro_torch.models.whisper",
}

ARCH_IDS = tuple(_CONFIG_MODULES)

#: configurations found by id beside the reference's ten (not in
#: ``ARCH_IDS``, which stays the reference's)
_MORE_CONFIG_MODULES = {
    "deepseek-v2-lite": "deepseek_v2_lite",
}


@dataclasses.dataclass(frozen=True)
class Arch:
    cfg: ArchConfig
    module: ModuleType

    @property
    def name(self) -> str:
        return self.cfg.name

    def tiny(self) -> "Arch":
        return Arch(self.cfg.tiny(), self.module)


def get_config(arch_id: str) -> ArchConfig:
    known = {**_CONFIG_MODULES, **_MORE_CONFIG_MODULES}
    if arch_id not in known:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(known)}")
    mod = importlib.import_module(f"repro_torch.configs.{known[arch_id]}")
    return mod.CONFIG


def get(arch_id: str) -> Arch:
    cfg = get_config(arch_id)
    return Arch(cfg, importlib.import_module(_FAMILY_MODULES[cfg.family]))


def all_archs() -> dict[str, Arch]:
    return {a: get(a) for a in ARCH_IDS}
