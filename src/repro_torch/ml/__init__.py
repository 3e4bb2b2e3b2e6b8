"""Learners (port of ``repro.ml``): ``linear`` (§3.1: losses, the
allreduce-GD / L-BFGS / consensus-LASSO shims, ISTA, second-order private
regression), ``svm`` (§3.2), ``gp`` (§3.3), ``graphical`` (§3.4) and the §4
clustering family (``clustering``, ``kwindows``)."""

from repro_torch.ml import clustering, gp, graphical, kwindows, linear, svm

__all__ = ["clustering", "gp", "graphical", "kwindows", "linear", "svm"]
