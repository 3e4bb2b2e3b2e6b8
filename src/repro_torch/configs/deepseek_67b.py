"""deepseek-67b [dense] — DeepSeek LLM 67B, llama-arch [arXiv:2401.02954].

95L, d_model 8192, 64 heads (GQA kv=8), d_ff 22016, vocab 102400.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    rope_theta=10000.0,
    remat_policy="dots",
    source="arXiv:2401.02954",
)
