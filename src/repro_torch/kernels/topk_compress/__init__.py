"""Fused top-k wire encode (port of ``repro.kernels.topk_compress``)."""

from repro_torch.kernels.topk_compress import ops, ref

__all__ = ["ops", "ref"]
