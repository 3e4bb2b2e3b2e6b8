"""Architecture registry of the port (counterpart of ``repro.configs``): the
reference's ten configs, field for field, and the four launch input shapes
with their applicability table.

All of them run through the port.  jamba-1.5-large-398b (398 B parameters),
deepseek-v3-671b (671 B) and deepseek-67b at its full depth (67 B) do not
fit one 80 GB card; there they run as ``cfg.reduced()``, or at full width
with fewer layers.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

from repro_torch.models.config import ModelConfig

_ARCH_MODULES = {
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "deepseek-67b": "repro_torch.configs.deepseek_67b",
    "qwen2-1.5b": "repro_torch.configs.qwen2_1_5b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1_5_large_398b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
}

ARCHS = tuple(_ARCH_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def applicable(arch: str, shape: str) -> tuple[bool, str]:
    """(runs?, reason) — the reference's arch-applicability skip table."""
    cfg = get_config(arch)
    if shape == "long_500k":
        if cfg.family == "audio":
            return False, "enc-dec ASR: 448-token decoder context by construction"
        if cfg.family in ("dense", "moe", "vlm"):
            return True, "sliding-window attention variant (window 8192)"
        return True, "sub-quadratic decode state (SSM/hybrid)"
    return True, ""
