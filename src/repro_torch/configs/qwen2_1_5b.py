"""qwen2-1.5b [dense] — Qwen2 1.5B [arXiv:2407.10671].

28L, d_model 1536, 12 heads (GQA kv=2), d_ff 8960, vocab 151936, QKV bias,
tied embeddings.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
    source="arXiv:2407.10671",
)
