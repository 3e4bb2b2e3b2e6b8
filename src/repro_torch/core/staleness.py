"""Bounded-staleness delay line (port of ``repro.core.staleness``).

The §5 protocol without a literal server: the aggregated update pushed at
round t is applied ``D`` rounds later (``D = 0`` → synchronous mini-batch
GD, ``D = 1`` → the paper's literal one-step-stale protocol).  The line is
a FIFO of the last ``D`` pushes, leaves stacked on axis 0.
``make_stale_update`` wraps an optimizer update with such a line: the §5
bounded-staleness trainer.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

PyTree = Any


class DelayLine(NamedTuple):
    """FIFO of the last ``D`` pushed gradients (leaves stacked on axis 0)."""

    buffer: PyTree  # each leaf: (D, *leaf_shape)
    step: torch.Tensor  # int32 scalar


def delay_init(params: PyTree, depth: int) -> DelayLine:
    if depth < 1:
        raise ValueError("use depth >= 1; depth 0 means 'no delay line at all'")
    buf = tree_map(lambda p: torch.zeros((depth,) + tuple(p.shape), dtype=p.dtype,
                                         device=p.device), params)
    return DelayLine(buffer=buf, step=torch.tensor(0, dtype=torch.int32))


def delay_push_pop(state: DelayLine, grads: PyTree) -> tuple[DelayLine, PyTree]:
    """Push fresh ``grads``, pop the D-step-old gradient to apply (zeros for
    the first D steps — the replies that have not arrived yet)."""
    popped = tree_map(lambda b: b[0], state.buffer)
    # a line of depth 1 holds the push itself (a view, not a θ-sized copy:
    # nothing writes to a pushed tensor)
    new_buf = tree_map(
        lambda b, g: g[None] if b.shape[0] == 1 else torch.cat([b[1:], g[None]], dim=0),
        state.buffer, grads,
    )
    return DelayLine(buffer=new_buf, step=state.step + 1), popped


def delay_push_read(
    state: DelayLine, grads: PyTree, delay
) -> tuple[DelayLine, PyTree]:
    """Push fresh ``grads`` and read the value pushed ``delay`` steps ago,
    ``delay`` in ``[0, D]``: ``delay == D`` is ``delay_push_pop``,
    ``delay == 0`` reads the fresh push.  ``delay`` may be a Python int or
    an int tensor — under a scenario sweep a batched one, each scenario's
    own staleness: S levels then share one line of depth max D, read at a
    per-scenario index (an ``index_select``, which batches)."""
    depth = tree_leaves(state.buffer)[0].shape[0]
    ext = tree_map(
        lambda b, g: torch.cat([b, g[None]], dim=0), state.buffer, grads
    )
    if isinstance(delay, torch.Tensor):
        idx = (depth - delay).reshape(1).to(torch.long)
        read = tree_map(
            lambda e: torch.index_select(e, 0, idx.to(e.device))[0], ext)
    else:
        if not 0 <= int(delay) <= depth:
            raise ValueError(f"delay {delay} outside [0, {depth}]")
        read = tree_map(lambda e: e[depth - int(delay)], ext)
    new_buf = tree_map(lambda e: e[1:], ext)
    return DelayLine(buffer=new_buf, step=state.step + 1), read


class AsyncSGDState(NamedTuple):
    params: PyTree
    delay: DelayLine | None
    opt_state: Any


def make_stale_update(
    optimizer_update: Callable[[PyTree, Any, PyTree], tuple[PyTree, Any]],
    *,
    staleness: int = 0,
):
    """Wrap an optimizer-update fn with a staleness-D delay line.

    ``optimizer_update(grads, opt_state, params) -> (new_params, new_opt_state)``.

    Returns ``(init_fn, update_fn)`` where ``update_fn(state, grads)`` applies
    the (possibly stale) gradient.  With ``staleness == 0`` this is exactly
    the synchronous optimizer (paper's round-robin ≡ mini-batch GD limit).
    """

    def init_fn(params: PyTree, opt_state: Any) -> AsyncSGDState:
        delay = delay_init(params, staleness) if staleness > 0 else None
        return AsyncSGDState(params=params, delay=delay, opt_state=opt_state)

    def update_fn(state: AsyncSGDState, grads: PyTree) -> AsyncSGDState:
        if staleness > 0:
            delay, grads_applied = delay_push_pop(state.delay, grads)
        else:
            delay, grads_applied = None, grads
        new_params, new_opt = optimizer_update(grads_applied, state.opt_state, state.params)
        return AsyncSGDState(params=new_params, delay=delay, opt_state=new_opt)

    return init_fn, update_fn


def staleness_bound_lr(base_lr: float, staleness: int) -> float:
    """Heuristic staleness-compensated learning rate: ``lr / (1 + D)``, the
    conservative choice of the classic async-SGD analysis (the step size
    shrinks with the maximum delay)."""
    return base_lr / (1.0 + float(staleness))
