"""Assigned-architecture registry: ``--arch <id>`` -> ModelConfig.

Each module defines ``config()`` (the full published config) and
``smoke_config()`` (a reduced same-family config for CPU smoke tests).
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCHS = {
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "whisper-small": "whisper_small",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "qwen3-8b": "qwen3_8b",
    "nemotron-4-340b": "nemotron_4_340b",
    "llama3.2-3b": "llama3_2_3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "internvl2-1b": "internvl2_1b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "rhapsody-demo": "rhapsody_demo",
}


def get_config(arch: str, **overrides) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    cfg = mod.config()
    return cfg.scaled(**overrides) if overrides else cfg


def get_smoke_config(arch: str, **overrides) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    cfg = mod.smoke_config()
    return cfg.scaled(**overrides) if overrides else cfg


def list_archs():
    return [a for a in ARCHS if a != "rhapsody-demo"]
