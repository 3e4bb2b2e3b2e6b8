"""Fused top-k wire encode (port of ``repro.kernels.topk_compress``)."""
