"""Learners (port of ``repro.ml``; the losses so far)."""
