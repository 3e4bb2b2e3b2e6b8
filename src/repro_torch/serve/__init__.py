"""``repro_torch.serve`` — serving on the card (port of ``repro.serve``).

Train → serve is an executor swap (``api.fit(..., executor="serve")``), and
the pieces compose à la carte:

* ``ServeEngine``   — ``Strategy.predict`` on the θ device with
  hot-swappable parameters (``repro_torch.serve.engine``);
* ``MicroBatcher``  — bucketed-padding request batching with timeout
  flush (``repro_torch.serve.batcher``);
* ``ModelRegistry`` — name/version store over ``checkpoint/io`` with an
  atomic LATEST pointer, in the reference's layout
  (``repro_torch.serve.registry``);
* ``ServeMetrics``  — latency / throughput / time to first token and
  ``CommLedger`` inference-byte metering (``repro_torch.serve.metrics``);
* ``ContinuousLMEngine`` / ``DecodeScheduler`` — continuous-batching LM
  decode over a paged KV cache, decode attention in CUDA
  (``repro_torch.serve.continuous``).

Quickstart::

    res = api.fit(strategy, data, transport="allreduce", steps=400)
    registry = ModelRegistry("registry/")
    registry.publish("linreg", res.theta)
    engine = ServeEngine.from_registry(registry, "linreg", strategy)
    batcher = MicroBatcher(engine, max_batch=8, timeout_s=0.005)
    ticket = batcher.submit(x)          # one client request
    y = ticket.result()                 # bucketed, padded, metered
"""

from repro_torch.serve.batcher import MicroBatcher, Ticket
from repro_torch.serve.continuous import ContinuousLMEngine, DecodeScheduler, EvictedError
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.registry import ModelRegistry

__all__ = [
    "ContinuousLMEngine",
    "DecodeScheduler",
    "EvictedError",
    "MicroBatcher",
    "ModelRegistry",
    "ServeEngine",
    "ServeMetrics",
    "Ticket",
]
