"""Architecture registry of the port: ``get_config(name)`` / ``--arch``.

Each module defines CONFIG (full size) and SMOKE (a reduced same-family
config for CPU tests), field for field the JAX package's: all fifteen of
its architectures.  paligemma-3b (a patch-embedding prefix) and
hubert-xlarge (an encoder) run at model level only: the serving engines
prefill tokens alone, and an encoder has no decode step.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ALL_ARCHS = ("zamba2-2.7b", "mamba2-2.7b", "llama3.2-1b", "deepseek-v2-236b",
             "gla-2.7b", "retnet-2.7b", "hgrn2-2.7b", "opt-6.7b", "yi-9b",
             "xlstm-1.3b", "smollm-360m", "yi-34b", "dbrx-132b",
             "paligemma-3b", "hubert-xlarge")


def _module_name(arch: str) -> str:
    return "repro_torch.configs." + arch.replace("-", "_").replace(".", "p")


def _module(arch: str):
    if arch not in ALL_ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {ALL_ARCHS}")
    return importlib.import_module(_module_name(arch))


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
