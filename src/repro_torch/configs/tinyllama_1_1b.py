"""tinyllama-1.1b [dense] — TinyLlama 1.1B, llama2-arch [arXiv:2401.02385].

22L, d_model 2048, 32 heads (GQA kv=4), d_ff 5632, vocab 32000.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    rope_theta=10000.0,
    source="arXiv:2401.02385",
)
