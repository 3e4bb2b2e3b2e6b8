"""olmoe-1b-7b [moe] — OLMoE 1B active / 7B total [arXiv:2409.02060].

16L, d_model 2048, 16 heads (MHA kv=16), vocab 50304.  MoE on every layer:
64 experts top-8, expert d_ff 1024, no shared expert.
"""

from repro_torch.models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    moe=MoEConfig(
        num_experts=64,
        top_k=8,
        d_ff_expert=1024,
        aux_loss_coef=0.01,
        capacity_factor=1.25,
        layer_mode="all",
    ),
    source="arXiv:2409.02060",
)
