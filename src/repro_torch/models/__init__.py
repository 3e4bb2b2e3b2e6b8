"""Model substrate of the port (counterpart of ``repro.models``): the
config, layers, every mixer family's decode caches, GQA attention with
RoPE / M-RoPE, MLA, the MoE FFN, mamba, xLSTM, the unified decoder with
multi-token prediction and the VLM front end, and whisper's
encoder-decoder."""

from repro_torch.models import (
    attention,
    cache,
    config,
    layers,
    mamba,
    mla,
    moe,
    transformer,
    whisper,
    xlstm,
)
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
    "mamba",
    "mla",
    "moe",
    "transformer",
    "whisper",
    "xlstm",
    "MLAConfig",
    "MoEConfig",
    "ModelConfig",
    "SSMConfig",
    "XLSTMConfig",
]
