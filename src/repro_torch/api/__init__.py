"""``repro_torch.api`` — the unified training API on PyTorch (port of
``repro.api``: Strategy × Transport × Wire × Executor; the executors are
``local``, ``mesh``, ``multipod``, ``sweep``, ``serve`` and
``mesh+sweep`` / ``multipod+sweep``).

    from repro_torch import api
    from repro_torch.ml.linear import lsq_loss

    res = api.fit(api.GradientDescent(lsq_loss, lr=0.1), (Xs, ys),
                  transport="allreduce", wire="topk:0.25+ef", steps=100,
                  device="cuda")
    res.ledger.total_bytes, res.metrics["wire_kernel_hits"]
"""

from repro_torch.api.engine import FitResult, fit
from repro_torch.api.executor import (
    COMPOSED_EXECUTORS,
    EXECUTORS,
    Executor,
    LocalExecutor,
    MeshExecutor,
    MultiPodExecutor,
    ServingExecutor,
    SweepExecutor,
    make_executor,
)
from repro_torch.api.faults import FaultCarry, FaultDraws, FaultPlan
from repro_torch.api.strategy import (
    LBFGS,
    FunctionStrategy,
    GradientDescent,
    OptimizerStrategy,
    ProxStrategy,
    Strategy,
)
from repro_torch.api.transport import (
    TRANSPORTS,
    AdmmTransport,
    ServerTransport,
    Transport,
    UpdateTransport,
    make_transport,
)
from repro_torch.api.wire import (
    ChainWire,
    CompressedWire,
    DenseWire,
    DPWire,
    Int8Wire,
    SecAggWire,
    ThresholdWire,
    TopKWire,
    Wire,
    make_wire,
)

__all__ = [
    "fit", "FitResult",
    "Strategy", "FunctionStrategy", "GradientDescent",
    "LBFGS", "ProxStrategy", "OptimizerStrategy",
    "Transport", "ServerTransport", "UpdateTransport", "AdmmTransport",
    "make_transport",
    "TRANSPORTS",
    "Wire", "DenseWire", "CompressedWire", "ThresholdWire", "TopKWire",
    "Int8Wire", "DPWire", "SecAggWire", "ChainWire", "make_wire",
    "Executor", "LocalExecutor", "MeshExecutor", "MultiPodExecutor", "SweepExecutor",
    "ServingExecutor",
    "make_executor", "EXECUTORS", "COMPOSED_EXECUTORS",
    "FaultPlan", "FaultDraws", "FaultCarry",
]
