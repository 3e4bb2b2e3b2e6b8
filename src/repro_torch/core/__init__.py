"""The paper's distributed primitives (port of ``repro.core``: compression,
allreduce + ``CommLedger``, staleness, the §5 server, schedules)."""
