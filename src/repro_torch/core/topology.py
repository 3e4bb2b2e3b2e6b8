"""Reduction topologies — which link a message crosses, and what it costs
(port of ``repro.core.topology``).

The paper's cost model (§3, §5) does not price communication by byte
alone: the client↔server round trip is the expensive tier and the
intra-cluster reduction the cheap one.  A ``Topology`` is an ordered list
of ``Hop``s, each naming the mesh axes reduced at that stage (innermost
first), a tier name for the ledger, and a per-byte price.
``core.allreduce.hierarchical_allreduce`` runs the hops as staged
collectives over ``torch.distributed`` process groups, one group per hop;
``CommLedger.attribute_hops`` decomposes its byte totals by tier through
``Topology.hop_messages``.

* ``Topology.flat(axes)`` — one hop over every node axis at once: the
  classical undifferentiated client-server accounting.
* ``Topology.from_mesh(axes)`` — ``pod`` split out as its own outermost
  ``inter_pod`` hop, everything else reduced first as ``intra_pod``.

The byte decomposition telescopes, so tiers always sum to the flat total:
with K node messages and g_h aggregation groups left after hop h (g_0 =
K), hop h carries g_{h-1} − g_h messages and the outermost hop carries
all g_{H-1} root pushes to the server.  Σ_h m_h = K.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Mapping

#: default per-byte prices by tier: the inter-pod (client↔server) link is
#: priced an order of magnitude above the intra-pod reduction
DEFAULT_PRICES = {"flat": 1.0, "intra_pod": 1.0, "inter_pod": 10.0}


@dataclass(frozen=True)
class Hop:
    """One reduction stage: a joint sum over ``axes``, priced per byte."""

    axes: tuple  # mesh axis name(s) reduced together at this stage
    name: str  # ledger tier ("flat" / "intra_pod" / "inter_pod" / ...)
    price_per_byte: float = 1.0

    def __post_init__(self):
        axes = (self.axes,) if isinstance(self.axes, str) else tuple(self.axes)
        object.__setattr__(self, "axes", axes)

    def size(self, axis_sizes: Mapping[str, int]) -> int:
        s = 1
        for a in self.axes:
            s *= int(axis_sizes[a])
        return s


@dataclass(frozen=True)
class Topology:
    """Ordered reduction hops, innermost (cheapest) first."""

    hops: tuple

    def __post_init__(self):
        object.__setattr__(self, "hops", tuple(self.hops))
        if not self.hops:
            raise ValueError("a Topology needs at least one hop")
        seen = set()
        for hop in self.hops:
            for a in hop.axes:
                if a in seen:
                    raise ValueError(f"axis {a!r} appears in more than one hop")
                seen.add(a)

    @property
    def axes(self) -> tuple:
        """All mesh axes the topology reduces over, in hop order."""
        return tuple(a for hop in self.hops for a in hop.axes)

    @property
    def tiers(self) -> tuple:
        return tuple(h.name for h in self.hops)

    @staticmethod
    def flat(axes, *, name: str = "flat", price_per_byte: float | None = None):
        """One undifferentiated hop over every node axis."""
        price = DEFAULT_PRICES.get(name, 1.0) if price_per_byte is None else price_per_byte
        return Topology((Hop(axes=axes, name=name, price_per_byte=price),))

    @staticmethod
    def from_mesh(axes, *, pod_axis: str = "pod", intra_price: float | None = None,
                  inter_price: float | None = None):
        """Split ``pod_axis`` out as the outermost ``inter_pod`` hop; the
        other node axes reduce first as one ``intra_pod`` hop.  Without a
        pod axis this is the single-hop flat topology."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        intra = tuple(a for a in axes if a != pod_axis)
        if pod_axis not in axes:
            return Topology.flat(intra, price_per_byte=intra_price)
        intra_p = DEFAULT_PRICES["intra_pod"] if intra_price is None else intra_price
        inter_p = DEFAULT_PRICES["inter_pod"] if inter_price is None else inter_price
        hops = []
        if intra:
            hops.append(Hop(axes=intra, name="intra_pod", price_per_byte=intra_p))
        hops.append(Hop(axes=(pod_axis,), name="inter_pod", price_per_byte=inter_p))
        return Topology(tuple(hops))

    @staticmethod
    def calibrated(mesh, *, pod_axis: str = "pod"):
        """``from_mesh`` with prices measured on ``mesh`` by
        ``calibrate_prices`` instead of the ×1/×10 defaults."""
        from repro_torch.launch.mesh import axis_names

        prices = calibrate_prices(mesh, pod_axis=pod_axis)
        return Topology.from_mesh(axis_names(mesh), pod_axis=pod_axis,
                                  intra_price=prices["intra_pod"],
                                  inter_price=prices["inter_pod"])

    def hop_messages(self, num_nodes: int, axis_sizes: Mapping[str, int]):
        """Decompose K per-round node messages across tiers:
        ``[(tier, messages, price_per_byte), ...]`` with messages summing
        exactly to ``num_nodes``."""
        sizes = [h.size(axis_sizes) for h in self.hops]
        groups = []
        g = 1
        for s in reversed(sizes[1:]):
            g *= s
            groups.append(g)
        groups = list(reversed(groups)) + [0]
        out = []
        g_prev = int(num_nodes)
        for i, hop in enumerate(self.hops):
            if i == len(self.hops) - 1:
                m = g_prev  # every top-level group root pushes to the server
            else:
                g_next = groups[i]
                if g_prev % g_next:
                    raise ValueError(
                        f"{num_nodes} nodes do not divide into {g_next} "
                        f"groups at hop {hop.name!r}")
                m = g_prev - g_next
                g_prev = g_next
            out.append((hop.name, m, hop.price_per_byte))
        return out


#: memoized calibration results per (ranks, mesh shape, pod split, sample
#: size): the measurement is a property of the machines, not of a fit
_CALIBRATION_CACHE: dict = {}


def calibrate_prices(mesh, *, pod_axis: str = "pod", sample_kib: int = 256,
                     repeats: int = 5, cache: bool = True) -> dict:
    """One-shot per-hop bandwidth measurement on ``mesh``.

    Times one sum collective over the intra-pod axes' process group and
    one over the pod axis' (best of ``repeats`` over a ``sample_kib`` f32
    payload on the mesh's device), normalizes so the intra tier costs 1.0
    a byte, and returns prices shaped like ``DEFAULT_PRICES``::

        {"flat": 1.0, "intra_pod": 1.0, "inter_pod": <measured ratio>,
         "seconds": {...}, "sample_bytes": ..., "calibrated": True}

    A hop whose axes have no process group (a world of one with none
    initialized) has nothing to time: its seconds are None.  Every rank
    must call this together (the timed collectives are collective)."""
    import torch

    from repro_torch.core.allreduce import psum_allreduce
    from repro_torch.launch.mesh import axis_group, axis_names, mesh_device, mesh_ranks

    axes = axis_names(mesh)
    key = (mesh_ranks(mesh), axes, pod_axis, int(sample_kib))
    if cache and key in _CALIBRATION_CACHE:
        return dict(_CALIBRATION_CACHE[key])
    n = max((int(sample_kib) * 1024) // 4, 128)
    dev = mesh_device(mesh)
    x = torch.zeros((n,), dtype=torch.float32, device=dev)

    def _timed(hop_axes) -> float | None:
        group = axis_group(mesh, hop_axes) if hop_axes else None
        if group is None:
            return None
        psum_allreduce(x, group)  # first call sets up the links, untimed
        best = None
        for _ in range(max(int(repeats), 1)):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            psum_allreduce(x, group)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return best

    t_intra = _timed(tuple(a for a in axes if a != pod_axis))
    t_inter = _timed((pod_axis,) if pod_axis in axes else ())
    if t_intra and t_inter:
        ratio = max(t_inter / t_intra, 1e-3)
    else:
        ratio = DEFAULT_PRICES["inter_pod"] if t_inter else 1.0
    out = {
        "flat": 1.0,
        "intra_pod": 1.0,
        "inter_pod": float(ratio),
        "seconds": {"intra_pod": t_intra, "inter_pod": t_inter},
        "sample_bytes": n * 4,
        "calibrated": True,
    }
    _CALIBRATION_CACHE[key] = dict(out)
    return out
