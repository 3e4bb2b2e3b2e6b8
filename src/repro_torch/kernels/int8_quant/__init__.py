"""Int8 wire round trip (port of ``repro.kernels.int8_quant``)."""

from repro_torch.kernels.int8_quant import ops, ref

__all__ = ["ops", "ref"]
