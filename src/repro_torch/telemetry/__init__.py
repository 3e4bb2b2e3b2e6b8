"""``repro_torch.telemetry`` — the run timeline (port of
``repro.telemetry``): ``Tracer`` (spans, counters, gauges, Chrome export,
``device_trace`` over ``torch.profiler``), ``RunReport`` (one artifact
joining a fit's or a server's ledger, spans, dispatch counts and kernel
hits) and ``roofline`` (the three-term model on the H100's constants).

``repro_torch.telemetry.phases`` (the ``trace="phases"`` probes) is
imported lazily by ``api.fit``; nothing imported here imports the
models or the API, so ``api.executor`` can import ``trace`` at module load.
``hlo`` records collectives and counts operations as a step runs;
``costprobe`` (the dry run's FLOP and byte count) imports the models and
is imported by name.
"""

from repro_torch.telemetry import hlo, roofline, trace
from repro_torch.telemetry.report import RunReport
from repro_torch.telemetry.trace import Tracer

__all__ = ["hlo", "roofline", "trace", "Tracer", "RunReport"]
