"""Model configuration (port of ``repro.models.config``).

A copy of the reference's plain-data ``ModelConfig`` and its sub-configs,
field for field, so a configuration means the same in both packages.  The
port runs the attention × dense-FFN family so far; the other families'
fields are kept so every config of the repo can still be described (and is
rejected where it is run, naming its ``ROADMAP.md`` item).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal

Mixer = Literal["attn", "mla", "mamba", "mlstm", "slstm"]


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3, MiniCPM3)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    d_ff_expert: int = 2048
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    aux_loss_coef: float = 0.01
    capacity_factor: float = 1.25
    # which layers use MoE FFN: "all", "every_other" (odd layers), or
    # "after_first_k" (dense for the first `first_k_dense` layers)
    layer_mode: str = "all"
    first_k_dense: int = 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-1 selective SSM (Jamba's mixer)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 → ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block stack (sLSTM + mLSTM)."""

    slstm_at: tuple = ()  # layer indices using sLSTM; the rest are mLSTM
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3333333333333333


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio

    # transformer trunk
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    d_ff: int = 512
    vocab_size: int = 1024
    head_dim: int = 0  # 0 → d_model // num_heads

    # attention details
    mixer: Mixer = "attn"  # default mixer for attention-family layers
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    sliding_window: int = 0  # 0 → full causal attention
    mrope_sections: tuple = ()  # e.g. (16, 24, 24) → M-RoPE (qwen2-vl)
    tie_embeddings: bool = False
    rms_eps: float = 1e-6

    # optional sub-configs
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    xlstm: XLSTMConfig | None = None

    # hybrid (jamba): per-super-block layer pattern
    hybrid_pattern: tuple = ()

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 1500

    # multi-token prediction (deepseek-v3)
    num_mtp_layers: int = 0
    mtp_loss_coef: float = 0.3

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat_policy: str = "none"  # none | dots | full

    # query-chunked attention for the plain path; 0 = off
    attn_q_chunk: int = 0

    # cost-probe controls of the reference (telemetry.costprobe); kept so a
    # config carries across.  The port reads only unroll_time_scans, which
    # turns attn_q_chunk off as there
    scan_layers: bool = True
    segment_repeats: tuple = ()
    unroll_time_scans: bool = False

    # citation for the config values (model card / paper)
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError("num_heads must be divisible by num_kv_heads")
        if self.hybrid_pattern and self.num_layers % len(self.hybrid_pattern) != 0:
            raise ValueError("num_layers must be a multiple of the hybrid pattern")

    # ---- derived ----
    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows, padded to a multiple of 256 (padded logit
        columns are masked to -1e30)."""
        return -(-self.vocab_size // 256) * 256

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: ≤2 pattern-lengths of layers, d_model ≤ 256,
        ≤4 experts — same family and code paths, CPU-runnable."""
        d_model = min(self.d_model, 256)
        num_heads = min(self.num_heads, 4)
        num_kv = max(1, min(self.num_kv_heads, num_heads))
        # keep GQA ratio where it exists
        if self.num_kv_heads < self.num_heads:
            num_kv = max(1, num_heads // max(1, self.q_per_kv))
        layers = len(self.hybrid_pattern) if self.hybrid_pattern else 2
        kw = dict(
            num_layers=max(2, layers),
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=64,
            num_encoder_layers=2 if self.is_encoder_decoder else 0,
            encoder_seq_len=16 if self.is_encoder_decoder else self.encoder_seq_len,
            compute_dtype="float32",
            param_dtype="float32",
        )
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 256),
                d_ff_shared=min(self.moe.d_ff_shared, 256),
                first_k_dense=min(self.moe.first_k_dense, 1),
            )
        if self.mla is not None:
            kw["mla"] = MLAConfig(
                q_lora_rank=64,
                kv_lora_rank=32,
                qk_nope_head_dim=32,
                qk_rope_head_dim=16,
                v_head_dim=32,
            )
        if self.xlstm is not None:
            kw["xlstm"] = dataclasses.replace(
                self.xlstm, slstm_at=tuple(i for i in self.xlstm.slstm_at if i < 2) or (0,)
            )
        if self.num_mtp_layers:
            kw["num_mtp_layers"] = 1
        if self.mrope_sections:
            kw["mrope_sections"] = (8, 12, 12)  # sums to reduced head_dim/2
        return self.replace(**kw)
