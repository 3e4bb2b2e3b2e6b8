"""whisper-base [audio] — Whisper base enc-dec backbone [arXiv:2212.04356].

6 encoder + 6 decoder layers, d_model 512, 8 heads (MHA), d_ff 2048,
vocab 51865; encoder consumes 1500 stubbed mel/conv frame embeddings
(30 s at 50 Hz).  LayerNorm + GELU (not RMSNorm/SwiGLU), learned positions.
Decode shapes exercise the decoder self-attention cache; ``long_500k`` is
skipped (448-token decoder context by construction — DESIGN.md).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    is_encoder_decoder=True,
    num_encoder_layers=6,
    encoder_seq_len=1500,
    tie_embeddings=True,
    source="arXiv:2212.04356",
)
