"""Allreduce over a stacked node axis + byte-accurate communication accounting
(port of ``repro.core.allreduce``).

The paper (§3.1) observes that the MPI ``Allreduce`` used by [47] and [5]
"can be simulated by a two step communication with a central server".
``server_allreduce`` is that two-phase simulation over a leading node axis
of K logical nodes on one device.  ``CommLedger`` counts bytes under the
paper's client-server cost model, optionally decomposed by reduction tier.

The mesh and hierarchical collectives (``psum_allreduce``,
``mesh_allreduce``, ``hierarchical_allreduce`` and the overlap halves) are
not ported yet: they come with the mesh executors (``ROADMAP.md``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.utils.tree import tree_bytes, tree_map

PyTree = Any


def server_allreduce(stacked: PyTree, op: str = "sum") -> PyTree:
    """Two-phase central-server Allreduce over a leading node axis: the
    server receives all K estimates (the stacked layout itself), reduces,
    and every node receives the same global value (one copy here)."""
    if op == "sum":
        return tree_map(lambda x: torch.sum(x, dim=0), stacked)
    if op == "mean":
        return tree_map(lambda x: torch.mean(x, dim=0), stacked)
    if op == "max":
        return tree_map(lambda x: torch.amax(x, dim=0), stacked)
    if op == "any":
        return tree_map(lambda x: torch.any(x, dim=0), stacked)
    raise ValueError(f"unknown op: {op!r}")


@dataclass
class CommLedger:
    """Byte accounting under the paper's strict client-server cost model.

    Totals optionally decompose by reduction tier (``hops``): which link a
    byte crossed, priced per byte per hop.  Tier bytes always sum to the
    undifferentiated flat totals.
    """

    uplink_bytes: int = 0
    downlink_bytes: int = 0
    rounds: int = 0
    events: list = field(default_factory=list)
    #: per-tier attribution: name -> {uplink_bytes, downlink_bytes,
    #: priced_cost}; empty for flat (single-tier) accounting
    hops: dict = field(default_factory=dict)

    def record_allreduce(self, tree: PyTree, num_nodes: int, tag: str = "") -> None:
        """One Allreduce = K pushes of |θ| + K pulls of |θ|."""
        nbytes = tree_bytes(tree)
        self.uplink_bytes += num_nodes * nbytes
        self.downlink_bytes += num_nodes * nbytes
        self.rounds += 1
        self.events.append(("allreduce", tag, num_nodes * nbytes * 2))

    def _hop_add(
        self, hop: str, up: int, down: int, price_per_byte: float = 1.0
    ) -> None:
        bucket = self.hops.setdefault(
            hop, {"uplink_bytes": 0, "downlink_bytes": 0, "priced_cost": 0.0}
        )
        bucket["uplink_bytes"] += up
        bucket["downlink_bytes"] += down
        bucket["priced_cost"] += (up + down) * price_per_byte

    def record_hop(
        self,
        tree: PyTree,
        hop: str,
        fanin: int,
        *,
        price_per_byte: float = 1.0,
        tag: str = "",
    ) -> None:
        """One reduction stage of a hierarchical Allreduce: ``fanin``
        messages of |tree| climb the tier and ``fanin`` copies come back —
        charged to the hop's bucket AND the global totals."""
        nbytes = tree_bytes(tree) * fanin
        self.uplink_bytes += nbytes
        self.downlink_bytes += nbytes
        self._hop_add(hop, nbytes, nbytes, price_per_byte)
        self.events.append(("hop", tag or hop, nbytes * 2))

    def attribute_hops(self, hop_messages) -> None:
        """Decompose the ledger's CURRENT totals across tiers.

        ``hop_messages`` is ``[(tier, messages, price_per_byte), ...]``;
        each tier gets its message-weighted share, the integer remainder
        goes to the outermost hop, so tier bytes sum exactly to the totals.
        """
        total_m = sum(m for _, m, _ in hop_messages)
        if total_m <= 0:
            # legal exactly when there is nothing to attribute (every
            # participant of every round dropped); buckets still appear
            if self.uplink_bytes or self.downlink_bytes:
                raise ValueError(
                    "hop attribution needs a positive message count "
                    f"({self.uplink_bytes}B up / {self.downlink_bytes}B down "
                    "unattributed)"
                )
            for name, _, price in hop_messages:
                self._hop_add(name, 0, 0, price)
            return
        up_rem, down_rem = self.uplink_bytes, self.downlink_bytes
        for i, (name, m, price) in enumerate(hop_messages):
            if i == len(hop_messages) - 1:
                up_h, down_h = up_rem, down_rem
            else:
                up_h = self.uplink_bytes * m // total_m
                down_h = self.downlink_bytes * m // total_m
                up_rem -= up_h
                down_rem -= down_h
            self._hop_add(name, up_h, down_h, price)

    def record_push(self, tree: PyTree, tag: str = "") -> None:
        """One node→server push (the §5 protocol is push+pull per contact)."""
        nbytes = tree_bytes(tree)
        self.uplink_bytes += nbytes
        self.events.append(("push", tag, nbytes))

    def record_pull(self, tree: PyTree, tag: str = "") -> None:
        nbytes = tree_bytes(tree)
        self.downlink_bytes += nbytes
        self.events.append(("pull", tag, nbytes))

    def record_inference(self, request: PyTree, response: PyTree, tag: str = "") -> None:
        """One served batch: clients upload request features, download
        predictions."""
        up = tree_bytes(request)
        down = tree_bytes(response)
        self.uplink_bytes += up
        self.downlink_bytes += down
        self.events.append(("inference", tag, up + down))

    def merge(self, other: "CommLedger") -> None:
        """Fold another ledger's accounting into this one."""
        self.uplink_bytes += other.uplink_bytes
        self.downlink_bytes += other.downlink_bytes
        self.rounds += other.rounds
        self.events.extend(other.events)
        for name, b in other.hops.items():
            bucket = self.hops.setdefault(
                name,
                {"uplink_bytes": 0, "downlink_bytes": 0, "priced_cost": 0.0},
            )
            bucket["uplink_bytes"] += b["uplink_bytes"]
            bucket["downlink_bytes"] += b["downlink_bytes"]
            bucket["priced_cost"] += b["priced_cost"]

    @property
    def total_bytes(self) -> int:
        return self.uplink_bytes + self.downlink_bytes

    def priced_cost(self) -> float:
        """Byte total weighted by per-hop link prices; bytes not attributed
        to any tier are priced at 1.0 (the flat model)."""
        attributed = 0
        cost = 0.0
        for b in self.hops.values():
            attributed += b["uplink_bytes"] + b["downlink_bytes"]
            cost += b["priced_cost"]
        return cost + (self.total_bytes - attributed)

    def summary(self) -> dict:
        def hop_entry(b):
            nbytes = b["uplink_bytes"] + b["downlink_bytes"]
            return {
                "uplink_bytes": b["uplink_bytes"],
                "downlink_bytes": b["downlink_bytes"],
                "total_bytes": nbytes,
                "price_per_byte": b["priced_cost"] / nbytes if nbytes else 1.0,
            }

        return {
            "uplink_bytes": self.uplink_bytes,
            "downlink_bytes": self.downlink_bytes,
            "total_bytes": self.total_bytes,
            "rounds": self.rounds,
            "by_hop": {name: hop_entry(b) for name, b in self.hops.items()},
            "priced_cost": self.priced_cost(),
        }
