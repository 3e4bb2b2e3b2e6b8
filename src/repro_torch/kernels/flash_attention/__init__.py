"""Forward flash attention for the cache-free train/prefill path (port of
``repro.kernels.flash_attention``)."""
