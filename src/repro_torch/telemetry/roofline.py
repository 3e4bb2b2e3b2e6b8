"""Three-term roofline model for one NVIDIA H100 SXM (port of
``repro.telemetry.roofline``, on the H100's constants)::

    compute    = FLOPs_per_device / peak_FLOPs            [s]
    memory     = HBM_bytes_per_device / HBM_bw            [s]
    collective = collective_bytes_per_device / link_bw    [s]

The dominant term is the bottleneck; MODEL_FLOPS / (FLOPs × chips)
measures how much of the counted compute is useful (catches recompute).
The port has no compiled artifact to read FLOPs from: a caller counts them
(``telemetry.costprobe.probe_costs`` counts a step's products with
``torch.utils.flop_counter``'s formulas, as the dry run does).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

# H100 SXM constants (per card)
#: dense bf16 tensor-core rate (NVIDIA H100 Tensor Core GPU data sheet,
#: SXM5: 1,979 TFLOP/s with sparsity, half of it dense)
PEAK_FLOPS_BF16 = 989e12  # FLOP/s
#: HBM3 bandwidth (same data sheet, H100 SXM5 80 GB)
HBM_BW = 3.35e12  # B/s
#: NVLink 4: 900 GB/s per card in both directions together (same data
#: sheet), 450 GB/s in one direction
NVLINK_BW = 450e9  # B/s per direction


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops: float
    useful_ratio: float  # MODEL_FLOPS / (FLOPs × chips)
    chips: int

    def to_dict(self):
        return asdict(self)


def roofline(
    *,
    flops_per_device: float,
    bytes_per_device: float,
    collective_bytes_per_device: float,
    chips: int,
    model_flops: float = 0.0,
) -> Roofline:
    compute = flops_per_device / PEAK_FLOPS_BF16
    memory = bytes_per_device / HBM_BW
    coll = collective_bytes_per_device / NVLINK_BW
    terms = {"compute": compute, "memory": memory, "collective": coll}
    dominant = max(terms, key=terms.get)
    total_flops = flops_per_device * chips
    useful = model_flops / total_flops if (model_flops and total_flops) else 0.0
    return Roofline(
        compute_s=compute,
        memory_s=memory,
        collective_s=coll,
        dominant=dominant,
        flops_per_device=flops_per_device,
        bytes_per_device=bytes_per_device,
        collective_bytes_per_device=collective_bytes_per_device,
        model_flops=model_flops,
        useful_ratio=useful,
        chips=chips,
    )


def model_flops_train(n_params_active: float, tokens: float) -> float:
    """6·N·D — the standard dense training FLOP count (forward + backward)."""
    return 6.0 * n_params_active * tokens


def model_flops_decode(n_params_active: float, tokens: float) -> float:
    """2·N per generated token (forward only)."""
    return 2.0 * n_params_active * tokens
