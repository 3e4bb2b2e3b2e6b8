"""Deterministic synthetic data (port of ``repro.data.pipeline``).

Two kinds of data feed the framework:

* **LM token streams** — a seeded Markov-ish synthetic language (token t+1
  is ``(7·tok_t + 1) mod V`` except where sparse noise replaces it), so
  models have structure to learn while staying offline and reproducible.
  The draws come from an explicit ``torch.Generator`` seeded from
  ``(seed, step, shard)``: ``jax.random`` cannot be matched, so parity
  tests hand the reference's batches in.
* **Feature shards** — generated with numpy ``default_rng`` exactly as the
  JAX package does, then cast to float32 as ``jnp.asarray`` does with
  64-bit mode off, so both packages hand their learners the same arrays
  bit for bit.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device, to_device


def synthetic_lm_batch(gen: torch.Generator, batch: int, seq: int, vocab: int, *,
                       structure: int = 7, device="cuda") -> dict:
    """One (tokens, labels) LM batch with learnable bigram structure:
    ``tok_{t+1} = (structure · tok_t + 1) mod vocab`` except where a
    Bernoulli(0.1) mask puts a uniform noise token; ``labels`` are the
    tokens rolled by −1, both int64 (B, T) on ``device``.

    Drawn on ``gen``'s device (the first token, the noise, the mask) and
    unrolled without a loop over T: token t is the affine map applied
    ``t − s`` times to the value at the last reset ``s`` (a noise position,
    or the first token before position 0), and that power of the map is
    ``(7ⁿ·x + (7ⁿ − 1)/6) mod V`` from a table of n = 0 … T.
    """
    dev = resolve_device(device)
    first = torch.randint(0, vocab, (batch, 1), generator=gen, device=gen.device)
    noise = torch.randint(0, vocab, (batch, seq), generator=gen, device=gen.device)
    keep = torch.rand((batch, seq), generator=gen, device=gen.device) < 0.1
    a, b = [1], [0]  # the map applied n times: x -> a[n]·x + b[n] (mod vocab)
    for _ in range(seq):
        a.append(a[-1] * structure % vocab)
        b.append((b[-1] * structure + 1) % vocab)
    a = torch.tensor(a, dtype=torch.int64, device=gen.device)
    b = torch.tensor(b, dtype=torch.int64, device=gen.device)
    pos = torch.arange(seq, device=gen.device).expand(batch, seq)
    reset = torch.cummax(torch.where(keep, pos, -1), dim=1).values
    base = torch.where(reset >= 0, torch.gather(noise, 1, reset.clamp_min(0)), first)
    n = pos - reset  # ≥ 1 from the first token, 0 at a noise position
    tokens = (a[n] * base + b[n]) % vocab
    labels = torch.roll(tokens, -1, dims=1)
    return {"tokens": tokens.to(dev), "labels": labels.to(dev)}


def synthetic_lm_batches(seed: int, batch: int, seq: int, vocab: int, *,
                         shard_index: int = 0, num_shards: int = 1,
                         device="cuda") -> Iterator[dict]:
    """Infinite deterministic stream; step ``s`` of shard ``i`` draws from a
    generator seeded from ``(seed, s, i)``, so shards are disjoint.  The
    draws run on the CPU, so the card and the CPU see the same tokens."""
    if batch % num_shards:
        raise ValueError(f"batch {batch} does not divide into {num_shards} shards")
    local = batch // num_shards
    step = 0
    while True:
        key = np.random.SeedSequence([seed, step, shard_index]).generate_state(1, np.uint64)
        gen = torch.Generator().manual_seed(int(key[0]))
        yield synthetic_lm_batch(gen, local, seq, vocab, device=device)
        step += 1


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
