"""Learners (port of ``repro.ml``): the linear losses and consensus LASSO
pieces, and the §4 clustering family (``clustering``, ``kwindows``)."""

from repro_torch.ml import clustering, kwindows

__all__ = ["clustering", "kwindows"]
