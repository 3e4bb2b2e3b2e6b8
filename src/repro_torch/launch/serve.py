"""Serving launcher of the port — a thin CLI over ``repro_torch.serve``
(counterpart of ``repro.launch.serve``).

Three paths:

* ``--arch`` (LM decode): batched prefill + decode through a
  ``ServeEngine`` / ``MicroBatcher`` pair, with per-request bytes metered
  on the engine's ``CommLedger``.  Attention stacks prefill the whole
  prompt in ONE call into a contiguous f32 cache of ``P + gen + 1``
  (``prefill_and_decode``); decode attention there is the plain ``_sdpa``
  over that cache (``decode_attn="off"``), as in the reference.  Stacks
  with a recurrent mixer (xlstm-125m, jamba-1.5-large-398b) prefill token
  by token into their fixed-size states; whisper-base (encoder-decoder)
  is refused, as in the reference.
* ``--arch ... --continuous``: continuous batching over a paged KV cache
  (``ContinuousLMEngine``, decode attention in CUDA); prints the stats and
  ``RunReport.from_serve``.  Attention stacks only (dense or MoE FFNs,
  e.g. olmoe-1b-7b): an MLA arch (minicpm3-4b, deepseek-v3-671b) raises
  the reference's ``ValueError`` and serves through the contiguous
  ``MLACache`` of the path above.
* ``--strategy gd|kwindows`` (classical fits): train a small ``api.fit``,
  publish it to a ``ModelRegistry``, load it back and serve a query stream
  through a ``MicroBatcher`` — the fit → publish → serve round trip.

Examples (on the card; add ``--reduced --device cpu`` on a CPU)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --batch 8 --requests 22 --prompt-len 128 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --continuous --batch 16 --requests 48 --prompt-len 256 --gen 64
    PYTHONPATH=src python -m repro_torch.launch.serve --strategy gd \\
        --registry /tmp/registry --requests 12

Weights are made from ``--seed`` on the device (``init_params`` on a
seeded ``torch.Generator``); prompts and queries from a seeded numpy
generator.  ``--device`` defaults to ``cuda`` and the command raises
without a GPU unless ``--device cpu`` is given.  ``--mesh`` places the
served θ on a ``("data",)`` mesh over the world
(``launch.mesh.make_node_mesh``: a world of one without a process group).
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.serve.continuous import _hash32, _mul32, sample_tokens

# ----------------------------------------------------------------------------
# Prefill + decode (the OptimizerStrategy.predict_fn of LM serving)
# ----------------------------------------------------------------------------


def batched_prefill_supported(cfg) -> bool:
    """True when every layer's mixer can append the whole prompt in one
    decode call (``transformer.MULTI_TOKEN_MIXERS``)."""
    return all(spec.mixer in tf.MULTI_TOKEN_MIXERS for spec in tf.layer_specs(cfg))


def _row_seeds(seed: int, B: int, device) -> torch.Tensor:
    """One sampling stream a batch row: a function of (seed, row) only."""
    rows = torch.arange(B, dtype=torch.int64, device=device)
    return _hash32(_mul32(rows, 0x9E3779B9) ^ (int(seed) & 0xFFFFFFFF))


def prefill_and_decode(cfg, params, prompts, *, gen: int, cache_len: int,
                       temperature: float = 0.0, seed: int = 0, prefill: str = "auto"):
    """prompts: (B, P) int32 → (B, gen) int32 generated ids, on the
    prompts' device.

    ``prefill``: ``"batched"`` (one call over the whole prompt — attention
    stacks only), ``"loop"`` (token by token), or ``"auto"``.  Greedy
    (``temperature`` 0) takes the argmax; otherwise row b's token at step g
    is a Gumbel-max draw from the counter-based stream of (seed, b, g)
    (``serve.continuous.sample_tokens``): a row's sample depends only on its
    index, so bucket padding (appended at the end) cannot change a real
    request's tokens.  The reference draws ``jax.random.categorical`` from
    per-row ``fold_in`` keys, which torch cannot reproduce (``ROADMAP.md``
    queue 3, item 22)."""
    if prefill == "auto":
        prefill = "batched" if batched_prefill_supported(cfg) else "loop"
    if prefill == "batched" and not batched_prefill_supported(cfg):
        raise ValueError(
            f"{cfg.name} has recurrent mixers — batched prefill needs an "
            "attention/MLA-only stack; use prefill='loop'")
    if prefill not in ("batched", "loop"):
        raise ValueError(f"unknown prefill mode {prefill!r}")
    prompts = torch.as_tensor(prompts)
    dev = prompts.device
    B, P = prompts.shape
    # the weights as the forward reads them, cast once for the whole call
    W = tf.compute_params(params, cfg)
    cache = tf.init_cache(cfg, B, cache_len, torch.float32, device=dev)
    toks = prompts.long()
    if prefill == "batched":
        positions = torch.arange(P, device=dev).expand(B, P)
        logits, cache = tf.decode_step(W, cfg, toks, cache, positions=positions)
    else:
        logits = None
        for t in range(P):
            logits, cache = tf.decode_step(W, cfg, toks[:, t: t + 1], cache)
    seeds = _row_seeds(seed, B, dev) if temperature > 0 else None
    outs = []
    for g in range(gen):
        lg = logits[:, -1, : cfg.vocab_size].float()
        if temperature > 0:
            step = torch.full((B,), g, dtype=torch.int64, device=dev)
            tok = sample_tokens(lg, seeds, step, temperature)
        else:
            tok = torch.argmax(lg, dim=-1)
        outs.append(tok)
        logits, cache = tf.decode_step(W, cfg, tok[:, None], cache)
    return torch.stack(outs, dim=1).to(torch.int32)


def lm_predict_fn(cfg, *, gen: int, temperature: float = 0.0, seed: int = 0):
    """The ``OptimizerStrategy.predict_fn`` closure for LM serving: prompts
    in, generated ids out, the cache sized per prompt length."""

    def predict(params, prompts):
        P = prompts.shape[1]
        return prefill_and_decode(cfg, params, prompts, gen=gen, cache_len=P + gen + 1,
                                  temperature=temperature, seed=seed)

    return predict


# ----------------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------------


def _print_stats(stats: dict) -> None:
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                      for k, v in stats.items()}))


def serve_continuous(args):
    """Build the model and the engine, serve ``--requests`` prompts to the
    end, print the stats and the run report; returns the (requests, gen)
    generated ids."""
    from repro_torch.serve import ContinuousLMEngine
    from repro_torch.telemetry.report import RunReport
    from repro_torch.telemetry.trace import Tracer

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = tf.init_params(gen, cfg)
    engine = ContinuousLMEngine(
        cfg, params, n_slots=args.batch, page_size=args.page_size,
        max_seq=args.prompt_len + args.gen, temperature=args.temperature,
        seed=args.seed, tracer=Tracer(), tag=f"serve/{cfg.name}", device=device,
    )
    rng = np.random.default_rng(args.seed + 1)
    prompts = rng.integers(
        0, cfg.vocab_size, size=(args.requests, args.prompt_len)).astype(np.int32)
    print(f"continuous serving {cfg.name} (slots={args.batch}, "
          f"page_size={args.page_size}, plan={engine.kernel_plan})")
    tickets = [engine.submit(p, max_new=args.gen) for p in prompts]
    engine.run_until_idle()
    outs = np.stack([t.result() for t in tickets])
    _print_stats(engine.stats())
    print(RunReport.from_serve(engine).to_markdown())
    print("sample:", outs[0].tolist())
    return outs


def _serve_arch(args):
    """Microbatched LM serving: ``ServeEngine`` over ``lm_predict_fn``
    behind a ``MicroBatcher``; returns the (requests, gen) ids (numpy)."""
    from repro_torch.api.strategy import OptimizerStrategy
    from repro_torch.serve import MicroBatcher, ServeEngine

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder_decoder:
        raise SystemExit("enc-dec serving: see examples/whisper_serve.py")
    params = tf.init_params(torch.Generator(device=device).manual_seed(args.seed), cfg)
    strategy = OptimizerStrategy(None, None, predict_fn=lm_predict_fn(
        cfg, gen=args.gen, temperature=args.temperature, seed=args.seed))
    engine = ServeEngine(strategy, params, mesh=_make_mesh(args), tag=f"serve/{cfg.name}",
                         device=device)
    batcher = MicroBatcher(engine, max_batch=args.batch, timeout_s=args.timeout_ms / 1e3)
    rng = np.random.default_rng(args.seed + 1)
    prompts = rng.integers(
        0, cfg.vocab_size, size=(args.requests, args.prompt_len)).astype(np.int32)
    mode = "batched" if batched_prefill_supported(cfg) else "loop"
    print(f"serving {cfg.name} ({mode} prefill, buckets={batcher.buckets}, "
          f"mesh={engine.mesh is not None})")
    tickets = [batcher.submit(p) for p in prompts]
    _drain(batcher)
    outs = torch.stack([t.result() for t in tickets]).cpu().numpy()
    _print_stats(engine.stats())
    print("sample:", outs[0].tolist())
    return outs


def _serve_strategy(args):
    """fit → publish → ``from_registry`` → ``MicroBatcher``; returns the
    predictions (numpy, one a query)."""
    from repro_torch import api
    from repro_torch.ml.linear import lsq_loss
    from repro_torch.serve import MicroBatcher, ModelRegistry, ServeEngine

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    registry = ModelRegistry(args.registry or tempfile.mkdtemp(prefix="registry-"))
    mesh = _make_mesh(args)

    if args.strategy == "gd":
        K, Nk, n = 8, 32, 16
        X = rng.normal(size=(K, Nk, n)).astype(np.float32)
        w = rng.normal(size=(n,)).astype(np.float32)
        y = np.einsum("kni,i->kn", X, w)
        strategy = api.GradientDescent(lsq_loss, lr=0.1)
        res = api.fit(strategy, (X, y), transport="allreduce", steps=200, device=device)
        like = None
    elif args.strategy == "kwindows":
        from repro_torch.core.schedules import round_robin
        from repro_torch.ml.kwindows import KWindowsStrategy

        K, Nk, d = 4, 64, 2
        centers = rng.normal(size=(3, d)) * 4.0
        Xs = (centers[rng.integers(0, 3, size=(K, Nk))]
              + rng.normal(size=(K, Nk, d)) * 0.3).astype(np.float32)
        strategy = KWindowsStrategy(args.seed, num_windows=6, r=1.0)
        res = api.fit(strategy, Xs, transport="sequential_server",
                      schedule=round_robin(K, 1), device=device)
        like = res.theta
    else:
        raise SystemExit(f"unknown --strategy {args.strategy!r}")

    version = registry.publish(args.strategy, res.theta,
                               meta={"transport": res.metrics["transport"]})
    engine = ServeEngine.from_registry(registry, args.strategy, strategy, like=like,
                                       mesh=mesh, tag=f"serve/{args.strategy}",
                                       device=device)
    batcher = MicroBatcher(engine, max_batch=args.batch, timeout_s=args.timeout_ms / 1e3)
    if args.strategy == "gd":
        queries = rng.normal(size=(args.requests, engine.theta.shape[0]))
    else:
        # queries near the true clusters, so assignments are observable
        # (far-off points are correctly -1: uncaptured)
        queries = (centers[rng.integers(0, len(centers), size=args.requests)]
                   + rng.normal(size=(args.requests, centers.shape[1])) * 0.3)
    tickets = [batcher.submit(q.astype(np.float32)) for q in queries]
    _drain(batcher)
    preds = [t.result().cpu().numpy() for t in tickets]
    print(f"published {args.strategy} v{version} -> {registry.root}")
    print(json.dumps(engine.stats()))
    print("predictions:", np.asarray(preds)[: min(8, len(preds))].round(3).tolist())
    return preds


def _drain(batcher) -> None:
    """Serve the queue the way a real loop would: full buckets flushed on
    arrival (submit), the ragged tail by timeout — so ``--timeout-ms`` is an
    observable latency bound, not just a constructor argument."""
    while batcher.pending():
        if not batcher.poll():
            time.sleep(batcher.timeout_s / 4)


def _make_mesh(args):
    if not args.mesh:
        return None
    from repro_torch.launch.mesh import make_node_mesh

    return make_node_mesh()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="")
    ap.add_argument("--strategy", default="",
                    help="serve a classical fit instead: gd | kwindows")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="largest microbatch bucket (--continuous: decode slots)")
    ap.add_argument("--requests", type=int, default=0,
                    help="number of synthetic requests (default: --batch)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching: slot-scheduled decode over a paged "
                         "KV cache (--batch = n_slots)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (continuous path)")
    ap.add_argument("--timeout-ms", type=float, default=10.0)
    ap.add_argument("--registry", default="", help="model registry root (strategy path)")
    ap.add_argument("--mesh", action="store_true",
                    help="place the engine on a mesh over the world's ranks")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not args.requests:
        args.requests = args.batch
    if args.strategy:
        return _serve_strategy(args)
    if not args.arch:
        args.arch = "tinyllama-1.1b"
    if args.continuous:
        return serve_continuous(args)
    return _serve_arch(args)


if __name__ == "__main__":
    main()
