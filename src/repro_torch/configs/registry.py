"""--arch id → config module registry (all 10 assigned architectures)."""
from __future__ import annotations

import importlib
from typing import Dict

ARCHS: Dict[str, str] = {
    "granite-20b": "repro_torch.configs.granite_20b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "llama3.2-3b": "repro_torch.configs.llama3_2_3b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "internvl2-26b": "repro_torch.configs.internvl2_26b",
    "whisper-small": "repro_torch.configs.whisper_small",
}


def get_config(arch: str, smoke: bool = False):
    mod = importlib.import_module(ARCHS[arch])
    return mod.smoke() if smoke else mod.config()


def all_archs():
    return list(ARCHS)
