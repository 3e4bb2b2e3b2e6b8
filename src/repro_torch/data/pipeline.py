"""Deterministic synthetic feature shards (port of the feature half of
``repro.data.pipeline``; the LM token streams come with the LM slice).

Generated with numpy ``default_rng`` exactly as the JAX package does, then
cast to float32 as ``jnp.asarray`` does with 64-bit mode off — so both
packages hand their learners the same arrays bit for bit.
"""

from __future__ import annotations

import numpy as np

from repro_torch.device import resolve_device, to_device


def make_feature_shards(
    seed: int,
    num_nodes: int,
    per_node: int,
    dim: int,
    *,
    task: str = "regression",
    heterogeneity: float = 0.0,
    noise: float = 0.05,
    device="cuda",
):
    """Per-node ``(Xs, ys, w_true)`` with Xs (K, N, d), ys (K, N), float32.

    ``heterogeneity`` shifts each node's feature distribution by a
    node-specific offset of that magnitude (0.0 = the paper's homogeneous
    case).  ``task`` is ``"regression"`` (y = Xw + noise) or
    ``"classification"`` (y = sign(Xw + noise) ∈ {−1, +1}).
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(dim,))
    Xs, ys = [], []
    for _ in range(num_nodes):
        offset = heterogeneity * rng.normal(size=(dim,))
        X = rng.normal(size=(per_node, dim)) + offset
        if task == "regression":
            y = X @ w_true + noise * rng.normal(size=(per_node,))
        elif task == "classification":
            y = np.sign(X @ w_true + noise * rng.normal(size=(per_node,)))
            y[y == 0] = 1.0
        else:
            raise ValueError(task)
        Xs.append(X)
        ys.append(y)
    arrays = (np.stack(Xs), np.stack(ys), w_true)
    return to_device(tuple(a.astype(np.float32) for a in arrays), dev)
