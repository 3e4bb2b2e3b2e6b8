"""Pytree helpers (port of ``repro.utils``)."""
