"""The paper's distributed primitives (port of ``repro.core``): the §5
central information server, contact schedules, the bounded-staleness
trainer, consensus ADMM, allreduce with ``CommLedger``, and the compressed
push."""

from repro_torch.core import admm, allreduce, compression, schedules, server, staleness
from repro_torch.core.schedules import asynchronous, round_robin, work_proportional_probs
from repro_torch.core.server import ServerState, contact, init_server, pull, run_protocol
from repro_torch.core.staleness import (
    AsyncSGDState,
    DelayLine,
    delay_init,
    delay_push_pop,
    make_stale_update,
    staleness_bound_lr,
)

__all__ = [
    "admm",
    "allreduce",
    "compression",
    "schedules",
    "server",
    "staleness",
    "ServerState",
    "contact",
    "init_server",
    "pull",
    "run_protocol",
    "asynchronous",
    "round_robin",
    "work_proportional_probs",
    "AsyncSGDState",
    "DelayLine",
    "delay_init",
    "delay_push_pop",
    "make_stale_update",
    "staleness_bound_lr",
]
