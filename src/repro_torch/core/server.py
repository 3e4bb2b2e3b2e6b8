"""The paper's §5 central-information-server algorithm (port of
``repro.core.server``).

    "the server in iteration t when a node would push a computed parameter
     θ the server would record this as θ_t ← θ and would send to the node
     the parameter θ_{t-1} from memory."

Two handoff semantics: ``"sequential"`` — the pusher receives the current
server value (its own push), so θ_t = F^(S_t)(θ_{t-1}) exactly (the
round-robin ≡ mini-batch GD equivalence); ``"stale"`` — the literal text:
the pusher receives θ_{t-1}.  The protocol loop is a Python loop over the
contact schedule.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.tree import tree_stack

PyTree = Any


class ServerState(NamedTuple):
    """``theta`` is θ_t (the most recent push); ``theta_prev`` is θ_{t-1};
    ``t`` counts contacts."""

    theta: PyTree
    theta_prev: PyTree
    t: torch.Tensor  # int32 scalar


def init_server(theta_init: PyTree) -> ServerState:
    """θ_0 (central server) is initialized to θ_init (paper §5)."""
    return ServerState(
        theta=theta_init,
        theta_prev=theta_init,
        t=torch.tensor(0, dtype=torch.int32),
    )


def contact(
    state: ServerState, theta_pushed: PyTree, *, handoff: str = "sequential"
) -> tuple[ServerState, PyTree]:
    """One node contact: push ``theta_pushed``, receive the handoff
    parameter.  Returns ``(new_state, theta_received)``."""
    new_state = ServerState(theta=theta_pushed, theta_prev=state.theta, t=state.t + 1)
    if handoff == "sequential":
        return new_state, new_state.theta
    if handoff == "stale":
        return new_state, new_state.theta_prev
    raise ValueError(f"unknown handoff: {handoff!r}")


def pull(state: ServerState) -> PyTree:
    """A pure pull (first contact of a node before it has computed anything)."""
    return state.theta


def run_protocol(
    theta_init: PyTree,
    local_updates: Callable[[int, PyTree], PyTree],
    schedule,
    *,
    handoff: str = "sequential",
) -> tuple[ServerState, PyTree]:
    """Run the full §5 protocol under a contact ``schedule`` (node indices
    S_1..S_T).  Returns ``(final_server_state, per_contact_thetas)``, the
    handed-back parameters stacked on a leading axis."""
    state = init_server(theta_init)
    received = []
    for k in schedule:
        theta_start = state.theta if handoff == "sequential" else state.theta_prev
        state, got = contact(state, local_updates(int(k), theta_start), handoff=handoff)
        received.append(got)
    return state, tree_stack(received)
