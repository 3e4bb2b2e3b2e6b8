"""Contact schedules for the §5 server algorithm (port of
``repro.core.schedules``).

* **Round-robin** — ``S_t = t mod K`` (≡ mini-batch GD for first-order F).
* **Asynchronous** — ``S_t ~ S`` i.i.d. with ``p(S = i) > 0`` for all i.

Schedules are host-side int32 tensors: the transport walks them in a
Python loop.  ``asynchronous`` draws from a ``torch.Generator``, which does
not reproduce ``jax.random``; to replay a JAX schedule, pass its array to
``fit(schedule=...)`` instead.
"""

from __future__ import annotations

import torch


def round_robin(num_nodes: int, num_rounds: int) -> torch.Tensor:
    """``S_t = t mod K`` for ``num_rounds`` full passes over the K nodes."""
    return torch.arange(num_nodes, dtype=torch.int32).repeat(num_rounds)


def asynchronous(
    generator: torch.Generator,
    num_nodes: int,
    num_contacts: int,
    probs: torch.Tensor | None = None,
) -> torch.Tensor:
    """I.i.d. random contacts ``S_t ~ S``; ``probs`` defaults to uniform.
    Raises if any node has zero probability (the paper's §5 convergence
    condition requires ``p(S=i) > 0`` for every node)."""
    if probs is None:
        probs = torch.full((num_nodes,), 1.0 / num_nodes)
    probs = torch.as_tensor(probs, dtype=torch.float32)
    if probs.shape != (num_nodes,):
        raise ValueError(f"probs must have shape ({num_nodes},), got {tuple(probs.shape)}")
    if bool(torch.any(probs <= 0.0)):
        raise ValueError(
            "p(S=i) must be > 0 for every node (paper §5 convergence condition)"
        )
    return torch.multinomial(
        probs, num_contacts, replacement=True, generator=generator
    ).to(torch.int32)


def work_proportional_probs(shard_sizes) -> torch.Tensor:
    """Contact probabilities ∝ 1 / shard size (a node with less data
    finishes sooner and contacts the server more often)."""
    sizes = torch.as_tensor(shard_sizes, dtype=torch.float32)
    rates = 1.0 / torch.clamp_min(sizes, 1.0)
    return rates / torch.sum(rates)


def coverage(schedule, num_nodes: int) -> torch.Tensor:
    """Fraction of nodes that appear at least once in ``schedule``."""
    hits = torch.zeros((num_nodes,), dtype=torch.int32)
    hits[torch.as_tensor(schedule, dtype=torch.long)] = 1
    return torch.mean(hits.to(torch.float32))
