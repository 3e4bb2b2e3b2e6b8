"""deepseek-v3-671b [moe] — DeepSeek-V3 [arXiv:2412.19437].

61L, d_model 7168, 128 heads (MLA), vocab 129280.  MoE: 256 routed experts
(d_ff 2048) top-8 + 1 shared expert, first 3 layers dense (d_ff 18432).
MLA: q_lora 1536, kv_lora 512, qk_nope 128, qk_rope 64, v_head 128.
MTP: 1 depth-1 multi-token-prediction module (predicts t+2, shared head).
"""

from repro_torch.models.config import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=18432,  # the 3 dense layers
    vocab_size=129280,
    mixer="mla",
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_ff_expert=2048,
        num_shared_experts=1,
        d_ff_shared=2048,
        aux_loss_coef=0.001,
        capacity_factor=1.25,
        layer_mode="after_first_k",
        first_k_dense=3,
    ),
    num_mtp_layers=1,
    mtp_loss_coef=0.3,
    remat_policy="dots",
    source="arXiv:2412.19437",
)
