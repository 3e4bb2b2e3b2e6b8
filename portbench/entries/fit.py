"""The ``fit`` entry: ``repro_torch.api.fit`` with ``GradientDescent`` over
the logistic loss under allreduce and a top-k wire with error feedback.

Set-up makes the data on the card from the seed, runs the first checked
rounds through the window's own call (fits of one round, each resumed from
the last one's carry), and one warm chunk; after the window as many checked
rounds continue from the state that its last fit handed on.  A chunk is one fit of the traffic's
``rounds_per_fit`` rounds resumed from the previous fit's carry, as
``launch/train.py`` drives training; the window's chunks continue the same
training run.
"""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import torch

from portbench.counts import fit as fit_counts
from portbench.reference import fit as fit_ref
from portbench.reference import readings as _readings

UNIT = "rounds"
#: the port's kernel library that the cell runs
LIBRARY = "wire_kernels"


def make_data(cfg: dict, traffic: dict, seed: int, device: str):
    """Planted classification data of the configuration's shape as the
    traffic's nodes: w ~ N(0, I), X ~ N(0, 1), y = sign(X·w + noise·N(0, 1))
    ∈ {−1, +1}, made in three calls of one generator seeded by ``seed``."""
    nodes, d = traffic["nodes"], cfg["features"]
    per = cfg["records"] // nodes
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((d,), generator=gen, device=device)
    X = torch.randn((nodes, per, d), generator=gen, device=device)
    noise = torch.randn((nodes, per), generator=gen, device=device)
    y = torch.sign(X @ w + cfg["assumed"]["noise"] * noise)
    y[y == 0] = 1.0
    return X, y


def _spec(traffic: dict) -> dict:
    spec = {"transport": traffic["transport"],
            "wire": f"topk:{traffic['topk_fraction']}+ef",
            "executor": traffic["executor"]}
    if traffic["executor"] == "sweep":
        spec["sweep"] = {"lr": list(traffic["lrs"])}
    return spec


def _row_norms(x: torch.Tensor, block: int = 8192) -> torch.Tensor:
    """Float64 norms of the rows of ``x``, a block of rows at a time."""
    return torch.cat([x[a:a + block].double().norm(dim=1) for a in range(0, x.shape[0], block)])


def _uplink(ledger) -> int:
    return sum(l.uplink_bytes for l in ledger) if isinstance(ledger, list) else ledger.uplink_bytes


def _state(carry, S: int, D: int) -> tuple[torch.Tensor, torch.Tensor]:
    """θ (S, D) and Σ_k r_k (S, D) of a carry, in float64."""
    return (carry[0].reshape(S, D).double().clone(),
            carry[2].reshape(S, -1, D).sum(dim=1, dtype=torch.float64))


def _checked_block(st, carry, rounds: int, first: bool):
    """``rounds`` fits of one round through the window's own call from
    ``carry``: a block of the check (its start, θ and Σ_k r_k after each
    round, the losses reported at them) and the carry after it; after the
    first round of the ``first`` block also the residual's row norms and
    the ledger's bytes."""
    S, D = st.S, st.X.shape[-1]
    if carry is None:
        zeros = torch.zeros((S, D), dtype=torch.float64, device=st.device)
        theta0, rsum0 = zeros, zeros
    else:
        theta0, rsum0 = _state(carry, S, D)
    thetas, rsums, losses = [], [], []
    for t in range(rounds):
        res = st.fit(1, carry)
        carry = res.metrics["carry"]
        theta, rsum = _state(carry, S, D)
        thetas.append(theta)
        rsums.append(rsum)
        losses.append(res.trajectory.reshape(S, -1).double())
        if first and t == 0:
            st.check["residual1"] = _row_norms(carry[2].reshape(-1, D)).view(S, -1)
            st.check["uplink_bytes_per_round"] = _uplink(res.ledger)
        del res
    block = {"theta0": theta0, "rsum0": rsum0, "thetas": torch.stack(thetas, dim=1),
             "rsums": torch.stack(rsums, dim=1)}
    return block, torch.cat(losses, dim=1), carry


def setup(cfg: dict, traffic: dict, seed: int, device: str) -> SimpleNamespace:
    t0 = time.perf_counter()
    from repro_torch import api
    from repro_torch.kernels import build
    from repro_torch.ml.linear import logistic_loss

    t1 = time.perf_counter()
    if device == "cuda":
        build.library(LIBRARY)
        built = build.build_info(LIBRARY)["seconds"]
        print(f"set-up: kernel library {LIBRARY} {time.perf_counter() - t1:.3f} s, of it "
              f"nvcc {built:.3f} s", file=sys.stderr, flush=True)
    t2 = time.perf_counter()
    X, y = make_data(cfg, traffic, seed, device)
    lrs = list(traffic["lrs"])
    S = len(lrs)
    st = SimpleNamespace(cfg=cfg, traffic=traffic, X=X, y=y, lrs=lrs, S=S, device=device,
                         rounds=0, uplink=0, check={}, last_loss=None)
    st.strategy = api.GradientDescent(logistic_loss, lr=lrs[0])
    st.fit = lambda steps, carry, tracer=None: api.fit(
        st.strategy, (X, y), steps=steps, carry=carry, device=device, tracer=tracer,
        **_spec(traffic))
    if device == "cuda":
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    block, losses, st.carry = _checked_block(st, None, traffic["checked_rounds"], True)
    st.check.update(blocks=[block], loss_thetas=block["thetas"], losses=losses)
    t4 = time.perf_counter()
    chunk(st, None)  # the warm chunk
    print(f"set-up: imports {t1 - t0:.3f} s, data {t3 - t2:.3f} s, "
          f"{traffic['checked_rounds']} checked rounds {t4 - t3:.3f} s, warm chunk "
          f"{time.perf_counter() - t4:.3f} s", file=sys.stderr, flush=True)
    st.rounds = st.uplink = 0
    return st


def chunk(st: SimpleNamespace, tracer) -> int:
    rounds = st.traffic["rounds_per_fit"]
    res = st.fit(rounds, st.carry, tracer)
    st.carry = res.metrics["carry"]
    st.last_loss = res.trajectory.reshape(st.S, -1)[:, -1:]
    st.rounds += rounds
    st.uplink += _uplink(res.ledger)
    return rounds


def counters(st) -> dict:
    """What the program's ledger counted over the window."""
    return {"uplink_bytes_per_round": st.uplink / st.rounds if st.rounds else None}


def program_output(st) -> dict:
    """The check: the set-up's block of rounds from θ = 0, and a second
    block continued from the state that the window's last fit handed on,
    with the loss that fit reported at its end and the ledger's bytes a
    round over the window."""
    S, D = st.S, st.X.shape[-1]
    theta_end, _ = _state(st.carry, S, D)
    block, losses, st.carry = _checked_block(st, st.carry, st.traffic["checked_rounds"], False)
    c = st.check
    out = dict(c, blocks=c["blocks"] + [block],
               loss_thetas=torch.cat([c["loss_thetas"], theta_end[:, None], block["thetas"]],
                                     dim=1),
               losses=torch.cat([c["losses"], st.last_loss.double(), losses], dim=1))
    if st.rounds:
        out["uplink_bytes_per_round"] = st.uplink / st.rounds
    return out


def free(st) -> None:
    st.carry = st.fit = st.strategy = st.last_loss = None


def reference(st, precision: str, fault):
    return fit_ref.run(st.X, st.y, st.lrs, fraction=st.traffic["topk_fraction"],
                       rounds=st.traffic["checked_rounds"], precision=precision, fault=fault)


def readings(st, prog: dict, ref: dict) -> dict:
    return _readings.fit(prog, ref, lambda thetas: fit_ref.at(st.X, st.y, thetas), st.lrs)


def end_to_end(units: int, window_s: float) -> dict:
    return {"rounds_per_s": units / window_s}


def counts(cfg: dict, traffic: dict) -> dict:
    records, d, nodes = cfg["records"], cfg["features"], traffic["nodes"]
    S = len(traffic["lrs"])
    return {"round_least_s": fit_counts.round_least_s(records, d, nodes, S),
            "topk_encode_least_s": fit_counts.topk_encode_least_s(nodes * S, d)}
