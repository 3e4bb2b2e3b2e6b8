"""Training launcher of the port (counterpart of ``repro.launch.train``).

The per-step update pipeline is the unified ``repro_torch.api`` engine:

* strategy  — ``OptimizerStrategy`` (the gradient of the LM loss through a
  ``repro_torch.optim`` optimizer: Adam under a warmup-cosine schedule,
  clipped to global norm 1);
* transport — ``delay_line`` (``--staleness D``: D = 0 synchronous; D = 1
  the paper's literal one-step-stale protocol);
* wire      — ``--compress-topk f`` selects ``topk:f+ef`` (top-k
  sparsified push with error feedback; on the card the encode kernel runs
  once per leaf per step), otherwise dense.

The launcher calls ``api.fit`` in chunks aligned to the logging and
checkpoint cadence, resuming each chunk from the previous
``FitResult.metrics["carry"]`` so the delay line, the error-feedback
residuals and the optimizer state flow through unchanged, and prints one
final JSON line with ``final_loss``, ``uplink_bytes`` and ``history``.
``--ckpt-dir/--ckpt-every`` write θ in the reference's checkpoint format.

Example (CPU smoke; on the card drop ``--device cpu``):
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --steps 12 \\
      --batch 2 --seq 32 --device cpu

``--arch`` takes the MLA and MoE archs too: ``--arch deepseek-v3-671b
--reduced`` trains MLA, a first-k dense layer, MoE with a shared expert
and the multi-token-prediction loss (the full model does not fit one
card), ``--arch olmoe-1b-7b`` / ``minicpm3-4b`` the MoE and MLA families.

``--sweep-staleness 0,1,2,4`` trains one model per staleness level in
one sweep (``api.SweepExecutor({"staleness": ...})``): the levels share one
delay line of depth max D and each reads it at its own index; the
optimizer strategy is not vmappable, so the levels run in turn inside each
step, and every level holds its own copy of the training state.  The
history then carries one ``loss_D<d>`` per level.

Not ported yet: ``--multipod`` (activation sharding over a mesh,
``ROADMAP.md`` queue 1, item 13); it raises.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import api
from repro_torch.checkpoint import save
from repro_torch.configs import get_config
from repro_torch.data import synthetic_lm_batches
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.optim import adam, clip_by_global_norm, warmup_cosine
from repro_torch.utils.tree import tree_leaves, tree_map


def _chunk_end(done: int, steps: int, log_every: int, ckpt_every: int) -> int:
    """Next boundary where the launcher needs control back."""
    targets = [steps, (done // log_every + 1) * log_every]
    if ckpt_every:
        targets.append((done // ckpt_every + 1) * ckpt_every)
    return min(t for t in targets if t > done)


def make_optimizer(lr: float, steps: int):
    """The launcher's optimizer: Adam under warmup-cosine, clipped to 1."""
    return clip_by_global_norm(adam(warmup_cosine(lr, steps // 10 + 1, steps)), 1.0)


def make_strategy(cfg, optimizer) -> api.OptimizerStrategy:
    """The LM loss of ``cfg`` behind ``optimizer``."""
    return api.OptimizerStrategy(
        lambda p, batch: tf.loss_fn(p, cfg, batch), optimizer, has_aux=True)


def wire_spec(compress_topk: float) -> str:
    return f"topk:{compress_topk}+ef" if compress_topk > 0 else "dense"


def stack_batches(batches: list) -> dict:
    """A chunk's batches as one stream with a leading time axis."""
    return tree_map(lambda *xs: torch.stack(xs), batches[0], *batches[1:])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true", help="CPU smoke variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--staleness", type=int, default=0)
    ap.add_argument("--sweep-staleness", default="",
                    help="comma-separated staleness levels trained in one sweep")
    ap.add_argument("--compress-topk", type=float, default=0.0)
    ap.add_argument("--multipod", action="store_true",
                    help="multipod mesh placement (not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed for the FaultPlan draw streams")
    ap.add_argument("--dropout-p", type=float, default=0.0,
                    help="per-round drop probability of the push")
    ap.add_argument("--straggler", type=int, default=0,
                    help="max per-round lag; deepens the delay line by it")
    ap.add_argument("--quorum", type=int, default=0,
                    help="minimum responders for a round to commit (0 = none)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.multipod:
        raise NotImplementedError(
            "--multipod needs the mesh placement, not ported yet: ROADMAP.md "
            "queue 1, item 13")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    # θ under one name only: a second would keep θ_0 alive all run
    theta = tf.init_params(torch.Generator(device=device).manual_seed(args.seed), cfg)
    n_params = sum(x.numel() for x in tree_leaves(theta))
    strategy = make_strategy(cfg, make_optimizer(args.lr, args.steps))
    wire = wire_spec(args.compress_topk)
    faults = None
    if args.dropout_p or args.straggler or args.quorum:
        faults = api.FaultPlan(seed=args.fault_seed, dropout_p=args.dropout_p,
                               straggler=args.straggler, quorum=args.quorum or None)

    sweep_levels = None
    executor = "local"
    if args.sweep_staleness:
        if args.ckpt_dir:
            raise SystemExit("--sweep-staleness is incompatible with --ckpt-dir")
        sweep_levels = [int(s) for s in args.sweep_staleness.split(",")]
        executor = api.SweepExecutor({"staleness": sweep_levels})

    data = synthetic_lm_batches(args.seed, args.batch, args.seq, cfg.vocab_size,
                                device=device)
    fault_note = f", faults={faults!r}" if faults is not None else ""
    print(f"training {cfg.name} ({n_params / 1e6:.1f}M params, "
          f"staleness={sweep_levels or args.staleness}, wire={wire}, "
          f"device={device}{fault_note})")
    t0 = time.time()
    history = []
    carry, done = None, 0
    wire_bytes = 0
    while done < args.steps:
        end = _chunk_end(done, args.steps, args.log_every, args.ckpt_every)
        stream = stack_batches([next(data) for _ in range(end - done)])
        res = api.fit(
            strategy, None, transport="delay_line", staleness=args.staleness,
            wire=wire, executor=executor, stream=stream, theta0=theta, carry=carry,
            faults=faults, tag="train", device=device,
        )
        carry = res.metrics["carry"]
        if sweep_levels is None:
            theta = res.theta
            wire_bytes += res.ledger.uplink_bytes
            losses = {"loss": float(res.trajectory[-1])}
            first = {"loss": float(res.trajectory[0])}
        else:
            # θ0 stays the shared start; the sweep resumes from its carry
            wire_bytes += res.ledger[0].uplink_bytes  # the same in every level
            losses = {f"loss_D{d}": float(res.trajectory[i, -1])
                      for i, d in enumerate(sweep_levels)}
            first = {f"loss_D{d}": float(res.trajectory[i, 0])
                     for i, d in enumerate(sweep_levels)}
        if done == 0:
            history.append({"step": 1, **first})
        done = end
        if done % args.log_every == 0 or done == args.steps:
            if history[-1]["step"] != done:
                history.append({"step": done, **losses})
            shown = "  ".join(f"{k} {v:.4f}" for k, v in losses.items())
            print(f"step {done:5d}  {shown}  ({(time.time() - t0) / done:.2f}s/step)")
        if args.ckpt_dir and args.ckpt_every and done % args.ckpt_every == 0:
            save(args.ckpt_dir, done, theta)
    final = {k: v for k, v in history[-1].items() if k != "step"}
    print(json.dumps({"final_loss": final["loss"] if sweep_levels is None else final,
                      "uplink_bytes": wire_bytes, "history": history}))
    return history


if __name__ == "__main__":
    main()
