"""Faults planted in the program's timed path, underneath the harness: the
check has to find each of them not correct.  The benchmark's runs plant
none; the CPU tests plant each in every cell at a tiny size, and
``calibrate.py --program-faults`` reads them at a cell's own size.

``plant(setattr, entry, fault)`` patches the port through ``setattr``
(``pytest``'s ``monkeypatch.setattr``, or ``planted``'s, which undoes it)."""

from __future__ import annotations

import contextlib

import torch

#: faults of every cell: a step that returns its state unchanged; half of
#: the batch left out; the exchange leaves a node out; an answer altered
#: where it is produced
FAULTS = ("unchanged", "half_batch", "exchange", "answer")
#: faults of a training run that carries its state from round to round and
#: from fit to fit: θ stops after round 1, the error feedback stops after
#: round 1, a fit starts afresh instead of from the last one's carry
FIT_FAULTS = ("frozen", "ef_dropped", "carry_lost")


def _negate_largest(o):
    flat = o.reshape(-1)
    j = flat.abs().argmax()
    return torch.where(torch.arange(flat.numel(), device=flat.device) == j, -flat, flat
                       ).view_as(o)


def _from_second_call(plain, broken):
    """``plain`` on the first call, ``broken`` on every later one."""
    calls = [0]

    def f(*args, **kwargs):
        calls[0] += 1
        return (plain if calls[0] == 1 else broken)(*args, **kwargs)

    return f


def _fit(setattr, fault):
    from repro_torch import api
    from repro_torch.api.strategy import GradientDescent, Strategy

    if fault == "unchanged":
        setattr(GradientDescent, "apply_update",
                            lambda self, theta, agg, state, data: (theta, state))
    elif fault == "frozen":
        setattr(GradientDescent, "apply_update", _from_second_call(
            GradientDescent.apply_update, lambda self, theta, agg, state, data: (theta, state)))
    elif fault == "ef_dropped":
        orig = api.TopKWire._encode_rows
        setattr(api.TopKWire, "_encode_rows", _from_second_call(
            orig, lambda self, m, r, kernel: orig(self, m, torch.zeros_like(r), kernel)))
    elif fault == "carry_lost":
        orig = api.fit
        setattr(api, "fit", _from_second_call(
            orig, lambda *a, carry=None, **kw: orig(*a, carry=None, **kw)))
    elif fault == "half_batch":
        orig = GradientDescent.local_updates

        def half(self, theta, state, data, batch):
            Xs, ys = data
            h = Xs.shape[1] // 2
            return orig(self, theta, state, (Xs[:, :h], ys[:, :h]), batch)

        setattr(GradientDescent, "local_updates", half)
    elif fault == "exchange":
        orig = Strategy.aggregate
        setattr(Strategy, "aggregate", lambda self, msgs: orig(self, msgs[:-1]))
    elif fault == "answer":
        orig = api.TopKWire._encode_rows

        def altered(self, m, r, kernel):
            o, res = orig(self, m, r, kernel)
            return _negate_largest(o), res

        setattr(api.TopKWire, "_encode_rows", altered)


def _kmeans(setattr, fault):
    from repro_torch.ml import clustering

    stats, nearest = clustering.node_stats, clustering.nearest
    if fault == "unchanged":
        def unchanged(Xs, assign, K):
            s, c = stats(Xs, assign, K)
            return torch.zeros_like(s), torch.zeros_like(c)

        setattr(clustering, "node_stats", unchanged)
    elif fault == "half_batch":
        def half(Xs, assign, K):
            n = Xs.shape[1]
            return stats(Xs[:, :n // 2], assign.view(Xs.shape[0], n)[:, :n // 2].reshape(-1), K)

        setattr(clustering, "node_stats", half)
    elif fault == "exchange":
        setattr(clustering, "node_stats",
                            lambda Xs, assign, K: stats(Xs[:-1], assign[:-Xs.shape[1]], K))
    elif fault == "answer":
        def altered(X, C, metric="l2"):
            idx, dist = nearest(X, C, metric)
            idx = idx.clone()
            idx[0] = (idx[0] + 1) % C.shape[0]
            return idx, dist

        setattr(clustering, "nearest", altered)


def plant(setattr, entry: str, fault: str) -> None:
    """Plant ``fault`` in the port's path of ``entry`` (``fit``, ``kmeans``)."""
    known = FAULTS + (FIT_FAULTS if entry == "fit" else ())
    if fault not in known:
        raise ValueError(f"no fault {fault!r} for the {entry} entry")
    (_fit if entry == "fit" else _kmeans)(setattr, fault)


@contextlib.contextmanager
def planted(entry: str, fault: str):
    """``fault`` planted for the ``with`` block, then undone."""
    undo = []

    def setattr_(obj, name, value):
        undo.append((obj, name, obj.__dict__[name]))
        setattr(obj, name, value)

    try:
        plant(setattr_, entry, fault)
        yield
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)
