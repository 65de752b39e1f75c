"""Architecture registry: ``--arch <id>`` -> (config, model module).

All ten configs are here; of the model families ``dense`` and ``vlm``
(the transformer backbone) and ``ssm`` (rwkv6) are ported.  Asking for
another family raises."""
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
    "ssm": "repro_torch.models.rwkv",
}

ARCH_IDS = tuple(_CONFIG_MODULES)


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
    if arch_id not in _CONFIG_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_CONFIG_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_CONFIG_MODULES[arch_id]}")
    return mod.CONFIG


def get(arch_id: str) -> Arch:
    cfg = get_config(arch_id)
    if cfg.family not in _FAMILY_MODULES:
        raise NotImplementedError(
            f"{arch_id}: the {cfg.family!r} family is not ported yet "
            f"(ported: {sorted(_FAMILY_MODULES)})")
    return Arch(cfg, importlib.import_module(_FAMILY_MODULES[cfg.family]))
