"""LM substrate of the port (counterpart of ``repro.models``): the config,
layers, KV and MLA caches, GQA attention, MLA, the MoE FFN and the decoder
of the attention / MLA × dense / MoE families with multi-token prediction.
Mamba, xLSTM and whisper wait for their slice (``ROADMAP.md`` queue 1,
item 11, second half)."""

from repro_torch.models import attention, cache, config, layers, mla, moe, transformer
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
    "mla",
    "moe",
    "transformer",
    "MLAConfig",
    "MoEConfig",
    "ModelConfig",
    "SSMConfig",
    "XLSTMConfig",
]
