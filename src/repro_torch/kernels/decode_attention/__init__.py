"""Single-token decode attention over a KV cache (port of
``repro.kernels.decode_attention``)."""
