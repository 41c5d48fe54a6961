"""Architecture registry of the port: ``get_config(name)`` / ``--arch``.

Each module defines CONFIG (full size) and SMOKE (a reduced same-family
config for CPU tests), field for field the JAX package's: all fifteen of
its architectures.  paligemma-3b (a patch-embedding prefix) and
hubert-xlarge (an encoder) run at model level only: the serving engines
prefill tokens alone, and an encoder has no decode step.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import SHAPES, ModelConfig

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


# the JAX package's split: the assigned architectures (public-literature
# configs) and the paper's own evaluation models, each in its order
ASSIGNED_ARCHS = ("yi-9b", "llama3.2-1b", "yi-34b", "smollm-360m",
                  "xlstm-1.3b", "deepseek-v2-236b", "dbrx-132b",
                  "zamba2-2.7b", "paligemma-3b", "hubert-xlarge")
PAPER_ARCHS = ("mamba2-2.7b", "retnet-2.7b", "gla-2.7b", "hgrn2-2.7b",
               "opt-6.7b")

# ---------------------------------------------------------------------------
# shape-cell applicability (the dry run's)
# ---------------------------------------------------------------------------

_FULL_ATTENTION = {
    "yi-9b", "llama3.2-1b", "yi-34b", "smollm-360m", "deepseek-v2-236b",
    "dbrx-132b", "paligemma-3b", "opt-6.7b",
}
_ENCODER_ONLY = {"hubert-xlarge"}


def cell_supported(arch: str, shape: str) -> tuple:
    """(supported, reason) for an (arch x shape) dry-run cell."""
    sc = SHAPES[shape]
    if arch in _ENCODER_ONLY and sc.kind == "decode":
        return False, "encoder-only: no autoregressive decode step"
    if shape == "long_500k" and arch in _FULL_ATTENTION:
        return False, ("pure full-attention arch: 524k context needs "
                       "sub-quadratic attention (skipped per spec)")
    return True, ""
