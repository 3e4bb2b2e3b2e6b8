"""jamba-1.5-large-398b [hybrid] — Jamba 1.5 Large [arXiv:2403.19887].

72L, d_model 8192, 64 heads (GQA kv=8), vocab 65536.  Mamba:attention
1:7 interleave (attention at offset 4 of every 8-layer block, HF config
convention) + MoE every other layer: 16 experts top-2, d_ff 24576.
Mamba state is O(1) and attention layers are 1/8 of the stack → runs
``long_500k`` (KV cache sequence-sharded over the data axis).
"""

from repro_torch.models.config import MoEConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    hybrid_pattern=(
        "mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba",
    ),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    moe=MoEConfig(
        num_experts=16,
        top_k=2,
        d_ff_expert=24576,
        aux_loss_coef=0.001,
        capacity_factor=1.25,
        layer_mode="every_other",
    ),
    remat_policy="dots",
    source="arXiv:2403.19887",
)
