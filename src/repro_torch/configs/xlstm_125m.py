"""xlstm-125m [ssm] — xLSTM 125M-class stack [arXiv:2405.04517].

12 blocks, d_model 768, 4 heads, vocab 50304 (GPT-NeoX tokenizer size).
sLSTM at every 4th block (indices 3, 7, 11), mLSTM elsewhere — a periodic
approximation of the paper's [7:1] ratio that keeps the stack scannable.
No separate FFN (xLSTM blocks embed their projections).  Decode state is
O(1) → runs ``long_500k`` natively.
"""

from repro_torch.models.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    xlstm=XLSTMConfig(slstm_at=(3, 7, 11)),
    tie_embeddings=True,
    source="arXiv:2405.04517",
)
