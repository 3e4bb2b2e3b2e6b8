"""Architecture registry of the port (counterpart of ``repro.configs``).

The port runs the attention / MLA × dense / MoE archs (deepseek-v3-671b,
whose full width does not fit one card, runs there as ``cfg.reduced()``);
the other archs of the reference raise ``NotImplementedError`` naming the
``ROADMAP.md`` item that brings their family.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_ARCH_MODULES = {
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
}

#: archs of the reference not ported yet → the ROADMAP item that brings them
_WAITING = {
    "qwen2-vl-2b": "queue 1, item 11 (M-RoPE and the VLM front end)",
    "whisper-base": "queue 1, item 11 (models/whisper.py)",
    "deepseek-67b": "queue 1, item 11 (a 67B dense model needs sharded weights, item 13)",
    "xlstm-125m": "queue 1, item 11 (models/xlstm.py)",
    "jamba-1.5-large-398b": "queue 1, item 11 (models/mamba.py)",
}

ARCHS = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name in _WAITING:
        raise NotImplementedError(
            f"{name} is not ported yet: ROADMAP.md {_WAITING[name]}")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG
