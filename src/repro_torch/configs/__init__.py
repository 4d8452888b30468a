"""Configurations: the paper's XCT datasets (Table II) and the LM
architectures (``--arch <id>`` resolution)."""
from __future__ import annotations

import dataclasses
import importlib

from .base import ArchConfig
from .xct_datasets import DATASETS as XCT_DATASETS

__all__ = ["ARCH_NAMES", "ArchConfig", "SHAPES", "XCT_DATASETS",
           "get_config"]

_MODULES = {
    "recurrentgemma-9b": "recurrentgemma_9b",
    "musicgen-large": "musicgen_large",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "grok-1-314b": "grok_1_314b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "qwen3-4b": "qwen3_4b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "smollm-135m": "smollm_135m",
    "xlstm-350m": "xlstm_350m",
}

ARCH_NAMES = tuple(_MODULES)

# (seq_len, global_batch, step kind) per assigned input shape
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}


def get_config(name: str, smoke: bool = False, **overrides) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; one of {ARCH_NAMES}")
    mod = importlib.import_module(f".{_MODULES[name]}", __package__)
    cfg = mod.SMOKE if smoke else mod.CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
