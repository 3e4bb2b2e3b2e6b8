"""Synthetic data (port of ``repro.data``)."""
