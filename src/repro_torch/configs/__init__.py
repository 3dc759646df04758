"""Config registry: ``--arch <id>`` -> ModelConfig, plus shapes.

The port of ``repro.configs``, registry and arch modules unchanged (they
are plain data). Also exposes ``cb-paper``: the paper-representative
variant (granite-8b with CB block-sparse MLPs) that ``chip_smoke.py``
serves on the card, and ``cb-paper-smoke`` at smoke size.
"""
from __future__ import annotations

import importlib

from .base import (  # noqa: F401
    LONG_500K, PREFILL_32K, SHAPES, TRAIN_4K, DECODE_32K,
    ModelConfig, ShapeConfig, input_specs, supports_shape,
)

_MODULES = {
    "granite-8b": "granite_8b",
    "qwen3-32b": "qwen3_32b",
    "stablelm-3b": "stablelm_3b",
    "phi3-mini-3.8b": "phi3_mini",
    "internvl2-2b": "internvl2_2b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "mixtral-8x7b": "mixtral_8x7b",
    "mamba2-130m": "mamba2_130m",
    "whisper-small": "whisper_small",
    "zamba2-2.7b": "zamba2_2p7b",
}

ARCH_IDS = tuple(_MODULES)


def _load(arch: str):
    if arch == "cb-paper":
        mod = importlib.import_module(".granite_8b", __package__)
        cfg = mod.CONFIG.scaled(
            name="cb-paper", sparse_mlp=True, sparse_block=128, sparse_keep=0.25
        )
        smoke = mod.SMOKE.scaled(
            name="cb-paper-smoke", sparse_mlp=True, sparse_block=16,
            sparse_keep=0.5,
        )
        return cfg, smoke
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)} + ['cb-paper']")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.CONFIG, mod.SMOKE


def get_config(arch: str) -> ModelConfig:
    return _load(arch)[0]


def get_smoke_config(arch: str) -> ModelConfig:
    return _load(arch)[1]


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def cells() -> list[tuple[str, str]]:
    """Every (arch, shape) dry-run cell; ``supports_shape`` says which of
    them a run skips, and why."""
    return [(arch, shape.name) for arch in ARCH_IDS for shape in SHAPES.values()]
