"""Checkpoints in the reference's format (port of ``repro.checkpoint``)."""

from repro_torch.checkpoint.io import latest_step, restore, restore_dict, save

__all__ = ["latest_step", "restore", "restore_dict", "save"]
