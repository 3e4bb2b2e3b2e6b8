"""LM substrate of the port (counterpart of ``repro.models``): the config,
layers, KV caches, GQA attention and the decoder of the attention ×
dense-FFN family.  MLA, MoE, Mamba, xLSTM and whisper wait for their slice
(``ROADMAP.md`` queue 1, item 11)."""

from repro_torch.models import attention, cache, config, layers, transformer
from repro_torch.models.config import (
    MLAConfig,
    MoEConfig,
    ModelConfig,
    SSMConfig,
    XLSTMConfig,
)

__all__ = [
    "attention",
    "cache",
    "config",
    "layers",
    "transformer",
    "MLAConfig",
    "MoEConfig",
    "ModelConfig",
    "SSMConfig",
    "XLSTMConfig",
]
