"""Architecture registry: the 10 assigned configs + reduced smoke variants
(the same registry and aliases as the reference's ``repro.configs``)."""
from __future__ import annotations

import importlib
from typing import Dict

from .base import (LayerSpec, MambaConfig, ModelConfig, MoEConfig,
                   ShapeConfig, SHAPES, XLSTMConfig, shapes_for)

ARCH_IDS = [
    "qwen3_moe_30b_a3b",
    "granite_moe_3b_a800m",
    "qwen15_32b",
    "glm4_9b",
    "llama3_8b",
    "gemma2_9b",
    "xlstm_125m",
    "seamless_m4t_medium",
    "jamba_v01_52b",
    "paligemma_3b",
]

# canonical --arch ids (hyphenated, as in the assignment)
ALIASES = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen1.5-32b": "qwen15_32b",
    "glm4-9b": "glm4_9b",
    "llama3-8b": "llama3_8b",
    "gemma2-9b": "gemma2_9b",
    "xlstm-125m": "xlstm_125m",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "paligemma-3b": "paligemma_3b",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.smoke_config() if smoke else mod.config()


def all_configs(smoke: bool = False) -> Dict[str, ModelConfig]:
    return {a: get_config(a, smoke) for a in ARCH_IDS}


__all__ = ["ARCH_IDS", "ALIASES", "get_config", "all_configs", "LayerSpec",
           "MambaConfig", "ModelConfig", "MoEConfig", "ShapeConfig", "SHAPES",
           "XLSTMConfig", "shapes_for"]
