"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  Without a
usable CUDA device it raises: the port never carries on on the CPU unless
the caller asks for it with ``device="cpu"`` (as the tests do).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', not {device!r}")
    return dev


def to_device(tree, device: torch.device):
    """Move every array leaf of ``tree`` (tensors, numpy arrays or numpy
    scalars) to ``device``; other leaves (ints, None) pass through."""

    def move(x):
        if isinstance(x, (np.ndarray, np.generic)):
            x = np.asarray(x)  # a numpy scalar: 0-d, as it came
            x = torch.from_numpy(x if x.flags.c_contiguous else np.ascontiguousarray(x))
        if isinstance(x, torch.Tensor):
            return x.to(device)
        return x

    return tree_map(move, tree)
