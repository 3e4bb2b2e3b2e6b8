"""``repro_torch.telemetry`` — the run timeline (port of
``repro.telemetry``): ``Tracer`` (spans, counters, gauges, Chrome export,
``device_trace`` over ``torch.profiler``), ``RunReport`` (one artifact
joining a fit's or a server's ledger, spans, dispatch counts and kernel
hits) and ``roofline`` (the three-term model on the H100's constants).

``repro_torch.telemetry.phases`` (the ``trace="phases"`` probes) is
imported lazily by ``api.fit``; everything here stays standard-library
only at import, so ``api.executor`` can import ``trace`` at module load.
``hlo`` and ``costprobe`` read lowered XLA programs and have no
counterpart yet: they belong with the dry run (``ROADMAP.md`` queue 1,
item 13).
"""

from repro_torch.telemetry import roofline, trace
from repro_torch.telemetry.report import RunReport
from repro_torch.telemetry.trace import Tracer

__all__ = ["roofline", "trace", "Tracer", "RunReport"]
