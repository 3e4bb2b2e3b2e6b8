"""Serving launcher of the port: continuous-batching LM decode over a paged
KV cache (counterpart of ``repro.launch.serve``'s ``--continuous`` path).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --continuous --batch 16 --requests 48 --prompt-len 256 --gen 64

Weights are made from ``--seed`` on the device (``init_params`` on a seeded
``torch.Generator``); prompts from a seeded numpy generator.  Prints the
plan, the stats JSON (latency, tokens/s, time to first token, request and
response bytes) and one sample.  ``--device`` defaults to ``cuda`` and the
command raises without a GPU unless ``--device cpu`` is given.  The
microbatched path (without ``--continuous``) and ``--strategy`` wait for
``ServeEngine`` / ``MicroBatcher`` (``ROADMAP.md`` queue 1, item 10).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf


def serve_continuous(args):
    """Build the model and the engine, serve ``--requests`` prompts to the
    end, print the stats; returns the (requests, gen) generated ids."""
    from repro_torch.serve import ContinuousLMEngine

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = tf.init_params(gen, cfg)
    engine = ContinuousLMEngine(
        cfg, params, n_slots=args.batch, page_size=args.page_size,
        max_seq=args.prompt_len + args.gen, temperature=args.temperature,
        seed=args.seed, tag=f"serve/{cfg.name}", device=device,
    )
    rng = np.random.default_rng(args.seed + 1)
    prompts = rng.integers(
        0, cfg.vocab_size, size=(args.requests, args.prompt_len)).astype(np.int32)
    print(f"continuous serving {cfg.name} (slots={args.batch}, "
          f"page_size={args.page_size}, plan={engine.kernel_plan})")
    tickets = [engine.submit(p, max_new=args.gen) for p in prompts]
    engine.run_until_idle()
    outs = np.stack([t.result() for t in tickets])
    print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                      for k, v in engine.stats().items()}))
    print("kernel hits:", engine.kernel_hits)
    print("sample:", outs[0].tolist())
    return outs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4, help="decode slots")
    ap.add_argument("--requests", type=int, default=0,
                    help="number of synthetic requests (default: --batch)")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous batching over a paged KV cache "
                         "(the only serving path ported so far)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not args.requests:
        args.requests = args.batch
    if not args.continuous:
        raise NotImplementedError(
            "only --continuous is ported: the microbatched LM path waits for "
            "ServeEngine / MicroBatcher (ROADMAP.md queue 1, item 10)")
    return serve_continuous(args)


if __name__ == "__main__":
    main()
