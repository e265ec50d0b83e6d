"""Architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

from typing import List

from repro_torch.configs import (gemma2_27b, gemma3_12b, granite_3_8b,
                                 grok_1_314b, internlm2_1_8b,
                                 llama4_scout_17b_a16e, paligemma_3b,
                                 recurrentgemma_9b, whisper_small,
                                 xlstm_350m)
from repro_torch.configs.base import ArchConfig

_MODULES = {
    "granite-3-8b": granite_3_8b,
    "internlm2-1.8b": internlm2_1_8b,
    "gemma2-27b": gemma2_27b,
    "gemma3-12b": gemma3_12b,
    "whisper-small": whisper_small,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "paligemma-3b": paligemma_3b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "xlstm-350m": xlstm_350m,
    "grok-1-314b": grok_1_314b,
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ArchConfig:
    if arch_id not in _MODULES:
        raise ValueError(f"unknown arch {arch_id!r}; the port serves "
                         f"{ARCH_IDS}")
    mod = _MODULES[arch_id]
    return mod.SMOKE if smoke else mod.FULL


__all__ = ["ArchConfig", "ARCH_IDS", "get_config"]
