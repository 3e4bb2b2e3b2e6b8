"""Single-token decode attention over a KV cache (port of
``repro.kernels.decode_attention``)."""

from repro_torch.kernels.decode_attention import ops, ref

__all__ = ["ops", "ref"]
