"""minicpm3-4b [dense] — MiniCPM3 4B with MLA [hf:openbmb/MiniCPM3-4B].

62L, d_model 2560, 40 heads, d_ff 6400, vocab 73448.  Multi-head Latent
Attention: q_lora_rank 768, kv_lora_rank 256, qk_nope 64, qk_rope 32,
v_head 64 (model-card values).
"""

from repro_torch.models.config import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    head_dim=64,
    d_ff=6400,
    vocab_size=73448,
    mixer="mla",
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    rope_theta=10000.0,
    tie_embeddings=True,
    source="hf:openbmb/MiniCPM3-4B",
)
