"""Synthetic data (port of ``repro.data``)."""

from repro_torch.data.pipeline import (
    make_feature_shards,
    synthetic_lm_batch,
    synthetic_lm_batches,
)

__all__ = ["make_feature_shards", "synthetic_lm_batch", "synthetic_lm_batches"]
