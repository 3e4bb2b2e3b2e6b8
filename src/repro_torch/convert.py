"""Carry weights and resume state across from the JAX package.

The JAX package's pytrees arrive as numpy (``jax.tree.map(np.asarray,
tree)``); these functions turn them into the port's tensors and types so a
fit started in ``repro`` resumes in ``repro_torch``::

    res = repro.api.fit(..., steps=3)
    carry = jax.tree.map(np.asarray, res.metrics["carry"])
    more = repro_torch.api.fit(..., carry=carry_from_reference(carry), steps=3)

The reference's NamedTuples are recognised by class name and fields (this
module imports nothing of ``repro``): ``DelayLine``, ``ServerState``,
``FaultCarry``, ``EFState`` and ``KWindows`` map to the port's classes of
the same name.
Dicts, lists and tuples keep their structure (dicts keep their keys).

Model weights cross the same way: ``params_from_reference`` takes the tree
of ``repro.models.transformer.init_params`` (as numpy) to the port's tree,
which has the same names and shapes, bit for bit — the MoE expert stacks
``(E, d, f)``, the f32 ``router`` and the ``shared`` SwiGLU, MLA's
projections and norms, and the ``mtp`` subtree as a whole among them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.faults import FaultCarry
from repro_torch.core.compression import EFState
from repro_torch.core.server import ServerState
from repro_torch.core.staleness import DelayLine
from repro_torch.device import resolve_device
from repro_torch.ml.kwindows import KWindows

_NAMED = {cls.__name__: cls for cls in (DelayLine, ServerState, FaultCarry, EFState, KWindows)}


def _convert(x, dev):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        cls = _NAMED.get(type(x).__name__)
        if cls is None or tuple(cls._fields) != tuple(x._fields):
            raise TypeError(
                f"no repro_torch counterpart for {type(x).__name__}{x._fields}"
            )
        return cls(*(_convert(v, dev) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_convert(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _convert(v, dev) for k, v in x.items()}
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        return x  # host-side counters (FaultCarry.next_round)
    arr = np.asarray(x)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        # JAX hands out read-only views; a copy keeps 0-d arrays 0-d
        # (np.ascontiguousarray would make them (1,))
        arr = np.array(arr, order="C")
    if arr.dtype == object:
        raise TypeError(f"cannot convert {type(x).__name__} to a tensor")
    if arr.dtype.name == "bfloat16":
        # numpy has no bf16 of its own (JAX hands out ml_dtypes' type):
        # cross as the 16-bit patterns
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(arr).to(dev)


def theta_from_reference(tree, device="cuda"):
    """The JAX package's θ (a pytree of numpy arrays) as the port's
    tensors on ``device``, bit for bit."""
    return _convert(tree, resolve_device(device))


def carry_from_reference(carry, device="cuda"):
    """``FitResult.metrics["carry"]`` of a JAX fit (as numpy) as the port's
    carry: θ, strategy state, wire state (EF residuals), the delay line and
    ``FaultCarry`` — accepted by ``repro_torch.api.fit(..., carry=...)``."""
    return _convert(carry, resolve_device(device))


def params_from_reference(tree, device="cuda"):
    """The JAX package's model parameters (``init_params``'s tree as
    numpy) as the port's parameter tree on ``device``, bit for bit — f32
    and bf16 leaves alike.  The names and shapes agree leaf for leaf, so
    the result goes to ``repro_torch.models.transformer`` as it is."""
    return _convert(tree, resolve_device(device))
