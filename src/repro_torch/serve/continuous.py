"""Continuous-batching LM decode plane (port of ``repro.serve.continuous``):
slot-scheduled serving over a paged KV cache.

* ``DecodeScheduler`` owns the host-side control plane: ``n_slots`` decode
  slots, a ``PageAllocator`` over one shared paged arena, the slot → page
  **block table**, and a FIFO backlog for requests the arena cannot place
  yet.
* ``ContinuousLMEngine`` owns the data plane: one step advances every slot
  one token against the persistent paged cache, which it updates in place.
  The block table, per-slot lengths and sampling seeds are host numpy of
  static shape copied to the device each step, so joins, leaves and
  evictions are pure data changes.  Joins prefill the prompt through the
  dense B=1 path (power-of-two prompt buckets) and write the result into
  the slot's pages; leaves free the pages, and freed rows point at the null
  page, so in-flight writes for them stay invisible.

The reference's step is one compiled XLA program (``compiled_step_cache_size
== 1``); PyTorch runs the step eagerly, so that property has no counterpart
here — capturing the step in a CUDA graph is its successor, speed work
that waits for a benchmark (``ROADMAP.md`` queue 2).  Decode attention runs through the CUDA kernel of
``kernels/decode_attention`` (``use_kernel="auto"`` on a CUDA device) or its
plain PyTorch version, reported in ``kernel_plan``, with per-token hit
counts in ``kernel_hits``.

Requests resolve through ``Ticket``; an evicted or errored request fails
its ticket at once instead of hanging until a timeout.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.attention import decode_kernel_plan, resolve_decode_attn
from repro_torch.models.cache import NULL_PAGE, PageAllocator
from repro_torch.models.config import ModelConfig
from repro_torch.serve.batcher import Ticket
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.telemetry import trace as _trace
from repro_torch.utils.tree import tree_map


class EvictedError(RuntimeError):
    """Raised from ``Ticket.result()`` when the request was evicted
    mid-generation (admin action or slot reclaim) rather than completed."""


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray  # (P,) int32
    max_new: int
    ticket: Ticket
    t_submit: float
    seed: int
    slot: int = -1
    pages: list = field(default_factory=list)
    tokens: list = field(default_factory=list)


class DecodeScheduler:
    """Host-side control plane: slots, pages, backlog.

    Admission is all or nothing: a request needs a free slot and enough
    pages for its whole lifetime (``ceil((prompt + max_new) / page_size)``,
    known up front, so a placed request never runs out of pages
    mid-generation).  When either is missing the request waits in the FIFO
    backlog until a retiring request frees capacity.
    """

    def __init__(self, *, n_slots: int, n_pages: int, page_size: int, max_seq: int):
        if max_seq < 1:
            raise ValueError(f"max_seq={max_seq}")
        self.n_slots = n_slots
        self.page_size = page_size
        self.max_seq = max_seq
        self.pages_per_slot = -(-max_seq // page_size)
        self.alloc = PageAllocator(n_pages)
        self.block = np.full((n_slots, self.pages_per_slot), NULL_PAGE, np.int32)
        self.length = np.zeros((n_slots,), np.int32)
        self.slots: list = [None] * n_slots
        self.backlog: deque = deque()

    def pages_needed(self, req: _Request) -> int:
        return -(-(len(req.prompt) + req.max_new) // self.page_size)

    def check_fits(self, req: _Request) -> None:
        """Raise if ``req`` could never be placed, even on an idle arena."""
        total = len(req.prompt) + req.max_new
        if total > self.max_seq:
            raise ValueError(f"request needs {total} positions > max_seq={self.max_seq}")
        if self.pages_needed(req) > self.alloc.n_pages - 1:
            raise ValueError(
                f"request needs {self.pages_needed(req)} pages but the "
                f"arena only has {self.alloc.n_pages - 1} allocatable"
            )

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.slots)

    def admit(self, req: _Request) -> int | None:
        """Place ``req`` in a free slot with pages reserved, or return None
        (the caller keeps it in the backlog)."""
        slot = next((s for s, r in enumerate(self.slots) if r is None), None)
        if slot is None:
            return None
        pages = self.alloc.alloc(self.pages_needed(req))
        if pages is None:
            return None
        self.slots[slot] = req
        req.slot = slot
        req.pages = pages
        self.block[slot, :] = NULL_PAGE
        self.block[slot, : len(pages)] = pages
        self.length[slot] = 0
        return slot

    def release(self, slot: int) -> _Request:
        """Free a slot's pages and point its block row back at the null page
        (the step keeps writing for this slot, into memory no live sequence
        reads)."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"release of empty slot {slot}")
        self.alloc.free(req.pages)
        req.pages = []
        req.slot = -1
        self.slots[slot] = None
        self.block[slot, :] = NULL_PAGE
        self.length[slot] = 0
        return req


# ----------------------------------------------------------------------------
# Sampling: Gumbel-max over counter-based uniforms
# ----------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for int64 ``x`` in [0, 2³²), in 16-bit halves of ``c``
    so no product leaves the int64 range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A bijective 32-bit integer mixer (Wellons' lowbias32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def sample_uniform(seeds: torch.Tensor, positions: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) f32 uniforms in (0, 1), a pure function of (seed, position,
    column): what a request draws depends on nothing but its own seed and
    the position it samples at, so it is invariant to its slot and to who
    else is in flight.  (The reference's ``fold_in(key(seed), position)``
    draws cannot be reproduced in PyTorch; the draws agree in distribution,
    not bit for bit.)"""
    base = _hash32(_hash32(seeds.long() & _M32) ^ (positions.long() & _M32))
    cols = torch.arange(n, device=seeds.device, dtype=torch.int64)
    h = _hash32(_hash32((base[:, None] + _mul32(cols, 0x9E3779B9)[None, :]) & _M32))
    return ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))


def sample_tokens(logits: torch.Tensor, seeds: torch.Tensor, positions: torch.Tensor,
                  temperature: float) -> torch.Tensor:
    """Next ids from (B, V) f32 logits: argmax when ``temperature`` is 0
    (first index on ties, as ``jnp.argmax``), else a categorical draw of
    softmax(logits / T) by the Gumbel-max trick on ``sample_uniform``."""
    if temperature > 0:
        u = sample_uniform(seeds, positions, logits.shape[-1])
        return torch.argmax(logits / temperature - torch.log(-torch.log(u)), dim=-1)
    return torch.argmax(logits, dim=-1)


def _build_step(cfg: ModelConfig, impl: str, temperature: float):
    """The decode plane's step: advance every slot a token and sample the
    next on the device (no (n_slots, V) transfer to the host)."""

    def step(params, tokens, cache, block, length, seeds):
        logits, _ = tf.paged_decode_step(
            params, cfg, tokens, cache, block, length, decode_attn=impl)
        nxt = sample_tokens(logits[:, 0, : cfg.vocab_size], seeds, length, temperature)
        return nxt.to(torch.int32)

    return step


class ContinuousLMEngine:
    """Slot-scheduled LM serving over a paged KV cache.

    Args:
      cfg / params: an attention-only LM (``init_paged_cache`` rejects
        other mixers) and its parameter tree (``transformer.init_params``
        or ``convert.params_from_reference``).
      n_slots: in-flight sequences one step advances together.
      page_size: tokens per physical KV page.
      max_seq: longest prompt + generation a request may need (sets the
        block-table width).
      n_pages: arena capacity; default fully provisions ``n_slots ×
        max_seq`` (+ the null page).  Smaller values oversubscribe —
        admission control queues what does not fit.
      use_kernel: decode-attention path — True forces the CUDA kernel
        (raises off CUDA), False the plain PyTorch version, "auto" the
        kernel on a CUDA device; reported in ``kernel_plan``.
      temperature / seed: sampling knobs (0 → greedy argmax).
      metrics / tracer / tag: observability.  ``tracer`` (a
        ``repro_torch.telemetry.trace.Tracer``, or anything with ``span``,
        ``count`` and ``gauge``) defaults to the ambient tracer at
        construction; None with none installed: no tracing.
      device: where the engine runs (default ``"cuda"``; raises without a
        GPU unless ``"cpu"`` is asked for).  Parameters are moved there.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        params,
        *,
        n_slots: int = 8,
        page_size: int = 16,
        max_seq: int = 256,
        n_pages: int | None = None,
        use_kernel="auto",
        temperature: float = 0.0,
        seed: int = 0,
        metrics: ServeMetrics | None = None,
        tracer=None,
        tag: str = "serve/continuous",
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.tag = tag
        self.temperature = float(temperature)
        self.seed = seed
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.tracer = tracer if tracer is not None else _trace.current_tracer()
        self.kernel_plan = decode_kernel_plan(cfg, use_kernel=use_kernel, device=self.device)
        self._impl = resolve_decode_attn(
            use_kernel, sliding_window=cfg.sliding_window, device=self.device)
        #: tokens advanced through each decode-attention implementation
        self.kernel_hits = {"cuda": 0, "plain": 0}

        pages_per_slot = -(-max_seq // page_size)
        if n_pages is None:
            n_pages = 1 + n_slots * pages_per_slot
        self.sched = DecodeScheduler(
            n_slots=n_slots, n_pages=n_pages, page_size=page_size, max_seq=max_seq)
        self._cd = getattr(torch, cfg.compute_dtype)
        # one compute-type copy of the weights, made once (see compute_params)
        self._weights = tf.compute_params(
            tree_map(lambda x: x.to(self.device), params), cfg)
        self._cache = tf.init_paged_cache(cfg, n_pages, page_size, self._cd, self.device)
        self._last_tok = np.zeros((n_slots,), np.int32)
        self._seeds = np.zeros((n_slots,), np.int32)
        self._rid = 0
        self._lock = threading.RLock()
        self._step = _build_step(cfg, self._impl, self.temperature)

    # -- introspection -------------------------------------------------------

    @property
    def ledger(self):
        return self.metrics.ledger

    def stats(self) -> dict:
        out = self.metrics.summary()
        out["slots"] = self.sched.n_slots
        out["backlog"] = len(self.sched.backlog)
        return out

    # -- request lifecycle ---------------------------------------------------

    def submit(self, prompt, *, max_new: int) -> Ticket:
        """Queue one generation request; returns a ``Ticket`` whose
        ``result()`` is the (max_new,) int32 generated ids."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new={max_new}")
        with self._lock:
            rid = self._rid
            self._rid += 1
            req = _Request(
                rid=rid, prompt=prompt, max_new=max_new,
                ticket=Ticket(self, rid), t_submit=time.perf_counter(),
                seed=(self.seed * 1_000_003 + rid) & 0x7FFFFFFF,
            )
            self.sched.check_fits(req)  # reject the never-servable loudly
            self.sched.backlog.append(req)
        return req.ticket

    def evict(self, ticket: Ticket, reason: str = "evicted") -> None:
        """Drop a request (in flight or queued) and fail its ticket with
        ``EvictedError`` at once."""
        with self._lock:
            rid = ticket._key
            req = next(
                (r for r in self.sched.slots if r is not None and r.rid == rid), None)
            if req is not None:
                self.sched.release(req.slot)
            else:
                req = next((r for r in self.sched.backlog if r.rid == rid), None)
                if req is None:
                    return  # already resolved
                self.sched.backlog.remove(req)
            self.metrics.record_eviction()
            if self.tracer is not None:
                self.tracer.count("serve/evictions")
            req.ticket._fail(
                EvictedError(f"request {rid} {reason} after "
                             f"{len(req.tokens)}/{req.max_new} tokens"))

    # -- the decode loop -----------------------------------------------------

    def _admit_from_backlog(self) -> int:
        """Join as many queued requests as the arena can place (FIFO — a
        stuck head request is not starved by smaller later ones)."""
        joined = 0
        while self.sched.backlog:
            req = self.sched.backlog[0]
            slot = self.sched.admit(req)
            if slot is None:
                break
            self.sched.backlog.popleft()
            self._join(req, slot)
            joined += 1
        return joined

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _join(self, req: _Request, slot: int) -> None:
        """Prefill the prompt (dense B=1 path, power-of-two bucket) and
        write the result into the slot's pages; the first generated token
        comes from the prefill logits."""
        P = len(req.prompt)
        bucket = 1 << max(0, (P - 1).bit_length())
        tr = self.tracer
        with (tr.span("serve/prefill", prompt=P, bucket=bucket, slot=slot)
              if tr is not None else nullcontext()):
            toks = np.zeros((1, bucket), np.int32)
            toks[0, :P] = req.prompt
            dense = tf.init_cache(self.cfg, 1, bucket, self._cd, device=self.device)
            pos = torch.arange(bucket, device=self.device)[None]
            logits, dense = tf.decode_step(
                self._weights, self.cfg, self._tensor(toks).long(), dense, positions=pos)
            tf.paged_insert_prompt(
                self._cache, dense, self._tensor(self.sched.block[slot]), P)
        first = self._sample_host(logits[0, P - 1], req.seed, P - 1)
        req.tokens.append(first)
        self.metrics.record_first_token(time.perf_counter() - req.t_submit)
        self.sched.length[slot] = P
        self._last_tok[slot] = first
        self._seeds[slot] = req.seed
        if tr is not None:
            tr.count("serve/joins")
        self._retire_if_done(slot)

    def _sample_host(self, logits_row, seed: int, position: int) -> int:
        """The step's sampling for the one token that comes from the prefill
        logits (a function of (seed, position), as in the step)."""
        dev = logits_row.device
        return int(sample_tokens(
            logits_row[None, : self.cfg.vocab_size],
            torch.tensor([seed], device=dev), torch.tensor([position], device=dev),
            self.temperature)[0])

    def _retire_if_done(self, slot: int) -> None:
        req = self.sched.slots[slot]
        if req is None or len(req.tokens) < req.max_new:
            return
        self.sched.release(slot)
        e2e = time.perf_counter() - req.t_submit
        out = np.asarray(req.tokens, np.int32)
        self.metrics.record_request_stream(
            len(req.tokens), e2e, request=req.prompt, response=out, tag=self.tag)
        if self.tracer is not None:
            self.tracer.count("serve/requests")
        req.ticket._resolve(out)

    def step(self) -> int:
        """One scheduler tick: admit what fits, advance every slot one
        token, retire finished requests.  Returns tokens produced."""
        with self._lock:
            self._admit_from_backlog()
            active = [s for s, r in enumerate(self.sched.slots) if r is not None]
            if not active:
                return 0
            n_slots = self.sched.n_slots
            tr = self.tracer
            t0 = time.perf_counter()
            try:
                with (tr.span("serve/decode_step", active=len(active), slots=n_slots)
                      if tr is not None else nullcontext()):
                    nxt = self._step(
                        self._weights,
                        self._tensor(self._last_tok[:, None]).long(),
                        self._cache,
                        self._tensor(self.sched.block).long(),
                        self._tensor(self.sched.length),
                        self._tensor(self._seeds),
                    )
                    nxt = nxt.cpu().numpy()  # waits for the step
            except BaseException as e:
                # fail every in-flight ticket now — a dead decode loop must
                # not leave callers hanging until their timeout
                for s in list(active):
                    req = self.sched.release(s)
                    req.ticket._fail(e)
                raise
            dt = time.perf_counter() - t0
            self.metrics.record_decode_step(len(active), n_slots, dt)
            self.kernel_hits[self._impl] += len(active)
            if tr is not None:
                tr.count("serve/decode_tokens", len(active))
                tr.gauge("serve/slot_occupancy", len(active) / n_slots)
            for s in active:
                req = self.sched.slots[s]
                req.tokens.append(int(nxt[s]))
                self.sched.length[s] += 1
                self._last_tok[s] = nxt[s]
                self._retire_if_done(s)
            return len(active)

    def flush(self, key=None) -> int:
        """Drive the loop until request ``key`` resolves (None → until
        idle).  This is the ``Ticket.result()`` hook."""
        served = 0
        while True:
            with self._lock:
                if key is not None:
                    req = self._find(key)
                    if req is None or req.ticket.done:
                        return served
                elif not (self.sched.backlog or self.sched.n_active):
                    return served
            if self.step() == 0:
                with self._lock:
                    if self.sched.backlog and not self.sched.n_active:
                        # nothing in flight frees capacity — unreachable for
                        # requests that passed check_fits; guards a wedged loop
                        raise RuntimeError("backlog cannot be placed on an idle arena")
            else:
                served += 1

    def _find(self, rid: int) -> _Request | None:
        # resolved or evicted requests are in neither structure — their
        # tickets already hold the value or the error
        for r in self.sched.slots:
            if r is not None and r.rid == rid:
                return r
        for r in self.sched.backlog:
            if r.rid == rid:
                return r
        return None

    def run_until_idle(self) -> int:
        """Serve everything queued; returns decode steps taken."""
        return self.flush()
