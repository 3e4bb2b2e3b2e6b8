"""qwen2-vl-2b [vlm] — Qwen2-VL 2B language backbone [arXiv:2409.12191].

28L, d_model 1536, 12 heads (GQA kv=2), d_ff 8960, vocab 151936, M-RoPE
(sections 16/24/24 over head_dim/2 = 64), QKV bias, tied embeddings.
The ViT vision encoder + projector is a stub: ``input_specs`` supplies
precomputed patch embeddings (dynamic-resolution token budget folded into
the sequence prefix).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
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
    mrope_sections=(16, 24, 24),
    source="arXiv:2409.12191",
)
