"""Int8 wire round trip (port of ``repro.kernels.int8_quant``)."""
