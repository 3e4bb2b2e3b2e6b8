"""``repro_torch.serve`` — the continuous-batching LM server of the port
(counterpart of ``repro.serve``).

* ``ContinuousLMEngine`` / ``DecodeScheduler`` — slot-scheduled decode over
  a paged KV cache: requests join and retire independently, one step
  advances every slot, decode attention runs through the CUDA kernel of
  ``kernels/decode_attention`` (``repro_torch.serve.continuous``);
* ``ServeMetrics`` — latency, decode throughput, time to first token and
  inference bytes on a ``CommLedger`` (``repro_torch.serve.metrics``);
* ``Ticket`` — the request handle (``repro_torch.serve.batcher``).

``ServeEngine``, ``MicroBatcher`` and ``ModelRegistry`` wait for the
request/response slice (``ROADMAP.md`` queue 1, item 10).
"""

from repro_torch.serve.batcher import Ticket
from repro_torch.serve.continuous import ContinuousLMEngine, DecodeScheduler, EvictedError
from repro_torch.serve.metrics import ServeMetrics

__all__ = [
    "ContinuousLMEngine",
    "DecodeScheduler",
    "EvictedError",
    "ServeMetrics",
    "Ticket",
]
