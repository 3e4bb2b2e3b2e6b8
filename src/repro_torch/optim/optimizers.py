"""Optimizers (port of ``repro.optim.optimizers``): SGD, momentum, AdamW,
Adagrad, global-norm clipping and the warmup-cosine schedule.

The API is the reference's, a minimal optax: ``opt.init(params) -> state``,
``opt.update(grads, state, params) -> (updates, new_state)``, applied with
``apply_updates``.  States are dicts with the reference's keys (``count``
as an int32 tensor, ``m``/``v``, ``mu``, ``G``), so a JAX optimizer state
converts one to one (``repro_torch.convert.carry_from_reference``).

The arithmetic is the reference's, in f32 and in its order: each Python
scalar meets an f32 tensor as an f32 (as a weak-typed JAX scalar does),
the bias corrections are ``1 - b ** step`` with the step in f32, and
moments pass through ``moment_dtype``.  XLA may contract ``a·x + b·y``
into a fused multiply-add where PyTorch rounds twice, so results agree
to the last bits, not bitwise.  Every update is functional: each leaf's
new values are fresh tensors, and a leaf's temporaries die before the
next leaf's are made, so the peak holds one leaf of them.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

PyTree = Any


class Optimizer(NamedTuple):
    init: Callable[[PyTree], Any]
    update: Callable[[PyTree, Any, PyTree], tuple[PyTree, Any]]


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def _count(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def _eta(lr, step):
    return lr(step) if callable(lr) else lr


# ----------------------------------------------------------------------------


def sgd(lr: float | Callable[[torch.Tensor], torch.Tensor]) -> Optimizer:
    def init(params):
        return {"count": _count(params)}

    def update(grads, state, params=None):
        step = state["count"]
        eta = _eta(lr, step)
        return tree_map(lambda g: -eta * g, grads), {"count": step + 1}

    return Optimizer(init, update)


def momentum(lr, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"count": _count(params), "mu": tree_map(torch.zeros_like, params)}

    def update(grads, state, params=None):
        step = state["count"]
        eta = _eta(lr, step)
        mu = tree_map(lambda m, g: beta * m + g, state["mu"], grads)
        if nesterov:
            upd = tree_map(lambda m, g: -eta * (beta * m + g), mu, grads)
        else:
            upd = tree_map(lambda m: -eta * m, mu)
        return upd, {"count": step + 1, "mu": mu}

    return Optimizer(init, update)


def adam(
    lr,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    moment_dtype: str | None = None,
) -> Optimizer:
    """AdamW.  ``moment_dtype="bfloat16"`` halves optimizer memory."""
    mdt = getattr(torch, moment_dtype) if moment_dtype else None

    def _cast(x):
        return x.to(mdt) if mdt is not None else x

    def init(params):
        def zeros(p):
            return _cast(torch.zeros_like(p, dtype=torch.float32))

        return {"count": _count(params), "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(grads, state, params=None):
        step = state["count"] + 1
        eta = _eta(lr, step)
        m = tree_map(
            lambda m_, g: _cast(b1 * m_.float() + (1 - b1) * g.float()),
            state["m"], grads,
        )
        v = tree_map(
            lambda v_, g: _cast(b2 * v_.float() + (1 - b2) * torch.square(g.float())),
            state["v"], grads,
        )
        stepf = step.float()
        bc1 = 1 - b1 ** stepf
        bc2 = 1 - b2 ** stepf

        def upd(m_, v_, p):
            mhat = m_.float() / bc1
            vhat = v_.float() / bc2
            u = -eta * mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                u = u - eta * weight_decay * p.float()
            return u.to(p.dtype)

        return tree_map(upd, m, v, params), {"count": step, "m": m, "v": v}

    return Optimizer(init, update)


def adagrad(lr, eps: float = 1e-10) -> Optimizer:
    """Duchi et al. [19] — the paper's cited adaptive method."""

    def init(params):
        return {"count": _count(params),
                "G": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)}

    def update(grads, state, params=None):
        step = state["count"]
        eta = _eta(lr, step)
        G = tree_map(lambda a, g: a + torch.square(g.float()), state["G"], grads)
        updates = tree_map(
            lambda g, a: (-eta * g.float() / (torch.sqrt(a) + eps)).to(g.dtype),
            grads, G,
        )
        return updates, {"count": step + 1, "G": G}

    return Optimizer(init, update)


# ----------------------------------------------------------------------------


def clip_by_global_norm(opt: Optimizer, max_norm: float) -> Optimizer:
    def update(grads, state, params=None):
        norm = torch.sqrt(
            sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
        scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
        grads = tree_map(lambda g: g * scale.to(g.dtype), grads)
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update)


def warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor · peak_lr`` at ``total``; the step is taken in f32."""

    def schedule(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)

    return schedule
