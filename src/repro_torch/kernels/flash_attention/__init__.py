"""Forward flash attention for the cache-free train/prefill path (port of
``repro.kernels.flash_attention``)."""

from repro_torch.kernels.flash_attention import ops, ref

__all__ = ["ops", "ref"]
