"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
#: f32 outside the tensor cores
F32_OPS_PER_S = 67e12
#: TF32 on the tensor cores: the fastest rate at which the card multiplies
#: f32 inputs, so no f32-exact implementation can read over 100 % of it
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12

#: the rate that prices an operation by the type of its operands
OPS_PER_S = {"float32": TF32_OPS_PER_S, "bfloat16": BF16_OPS_PER_S}


def least_s(ops: float, nbytes: float, dtype: str = "float32") -> float:
    """The least time of ``ops`` operations on ``dtype`` operands and
    ``nbytes`` of compulsory traffic: the longer of the two at the peaks."""
    return max(ops / OPS_PER_S[dtype], nbytes / HBM_BYTES_PER_S)
