"""Fault layer — seeded dropout, stragglers and quorum rounds (port of
``repro.api.faults``; numpy only, so the draws are bit-identical).

* **dropout** — each round each node independently fails to respond with
  probability ``dropout_p``: its message is masked out of the aggregate,
  its wire state frozen, and it costs no uplink bytes.
* **straggler** — each node draws an integer lag in ``[0, straggler]`` per
  round; the round reads the delay line at ``staleness + max(live lags)``.
* **quorum** — a round commits only when at least ``quorum`` nodes
  responded; below it θ, strategy state, wire state and the delay line
  roll back (survivors' uplink is still metered, no downlink happens).

All draws are host-side numpy arrays from ``seed``, counter-addressed, so a
fit resumed from a carry mid-plan replays the identical schedule.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

PyTree = Any

#: numpy SeedSequence stream tags — keep draw families independent
_STREAM_UNIFORM = 1
_STREAM_LAG = 2


class FaultDraws(NamedTuple):
    """Host-side per-round draws for a window of rounds.

    ``u`` are uniforms in [0, 1): node (t, k) drops iff ``u[t, k] <
    dropout_p``.  ``lag`` are integer straggler lags in ``[0, straggler]``.
    """

    u: np.ndarray  # (T, K) float32
    lag: np.ndarray  # (T, K) int32


class FaultCarry(NamedTuple):
    """Resume token for a faulted fit: the transport's own carry plus the
    plan round offset, so a resumed fit replays the draw stream from where
    the previous run stopped."""

    inner: Any
    next_round: int


class FaultPlan:
    """Seeded declarative fault model for one fit.

    Args:
      seed: base seed for all draws (dropout uniforms, straggler lags).
      dropout_p: per-round per-node drop probability in [0, 1].
      straggler: max per-node integer lag per round (0 = no stragglers).
      quorum: minimum surviving responders for a round to commit, or None.
    """

    def __init__(
        self,
        seed: int,
        *,
        dropout_p: float = 0.0,
        straggler: int = 0,
        quorum: int | None = None,
    ):
        if not 0.0 <= float(dropout_p) <= 1.0:
            raise ValueError(f"dropout_p must be in [0, 1], got {dropout_p}")
        if int(straggler) < 0:
            raise ValueError(f"straggler must be >= 0, got {straggler}")
        if quorum is not None and int(quorum) < 1:
            raise ValueError(f"quorum must be >= 1 (or None), got {quorum}")
        self.seed = int(seed)
        self.dropout_p = float(dropout_p)
        self.straggler = int(straggler)
        self.quorum = None if quorum is None else int(quorum)

    def draws(self, start_round: int, rounds: int, num_nodes: int) -> FaultDraws:
        """Per-round draws for rounds ``[start_round, start_round+rounds)``,
        identical whether the window starts at 0 or resumes at t."""
        stop = start_round + rounds
        rng_u = np.random.default_rng([self.seed, _STREAM_UNIFORM])
        u = rng_u.random((stop, num_nodes), dtype=np.float32)[start_round:]
        rng_l = np.random.default_rng([self.seed, _STREAM_LAG])
        lag = rng_l.integers(
            0, self.straggler + 1, size=(stop, num_nodes), dtype=np.int32
        )[start_round:]
        return FaultDraws(u=u, lag=lag)

    def describe(self) -> dict:
        return {
            "seed": self.seed,
            "dropout_p": self.dropout_p,
            "straggler": self.straggler,
            "quorum": self.quorum,
        }

    def __repr__(self) -> str:
        return (
            f"FaultPlan(seed={self.seed}, dropout_p={self.dropout_p}, "
            f"straggler={self.straggler}, quorum={self.quorum})"
        )


def make_fault_plan(spec: "FaultPlan | None") -> "FaultPlan | None":
    """Engine-side resolution hook (mirrors ``make_wire``/``make_transport``)."""
    if spec is None or isinstance(spec, FaultPlan):
        return spec
    raise TypeError(
        f"faults= takes a repro_torch.api.faults.FaultPlan or None, got {type(spec)!r}"
    )
