"""Port parity: ``repro_torch.serve.ContinuousLMEngine`` against
``repro.serve.ContinuousLMEngine``, and the engine's own contracts (after
``tests/test_serve_continuous.py``).

Weights come from the reference's ``init_params`` and cross with
``params_from_reference``; prompts are made with numpy from a seed.  On the
CPU the port's engine decodes through the decode kernel's plain version;
the JAX engine runs with ``use_kernel=False`` (its XLA mirror) and ``True``
(the Pallas kernel in interpret mode).  Greedy ids must be identical, and
the test checks that every sampled token's top-2 logit margin exceeds the
logit tolerance (atol = rtol = 1e-4, ``tests/test_torch_models.py``), so
identical ids are not an accident of near ties.  Temperature draws cannot
match ``jax.random``'s: they are tested for occupancy invariance and
against the softmax distribution.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.serve import ContinuousLMEngine as JEngine  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ContinuousLMEngine,
    DecodeScheduler,
    EvictedError,
)
from repro_torch.serve import continuous as t_cont  # noqa: E402

LOGIT_ATOL = LOGIT_RTOL = 1e-4

TINY = dict(
    name="tiny", vocab_size=97, d_model=32, num_layers=2, num_heads=4,
    num_kv_heads=2, head_dim=8, d_ff=64, compute_dtype="float32",
    param_dtype="float32",
)
PROMPTS = [(3, 6), (5, 3), (1, 5), (7, 2), (2, 4), (4, 6)]


def _configs(name):
    if name == "tiny":
        return JConfig(**TINY), TConfig(**TINY)
    return j_get_config(name).reduced(), t_get_config(name).reduced()


def _models(name):
    jc, tc = _configs(name)
    jp = j_tf.init_params(jax.random.key(0), jc)
    return jc, tc, jp, params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def tiny():
    _, tc, _, tp = _models("tiny")
    return tc, tp


def _engine(cfg, params, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("max_seq", 16)
    return ContinuousLMEngine(cfg, params, device="cpu", **kw)


def _requests(vocab, spec=PROMPTS, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=n).astype(np.int32), g) for n, g in spec]


def _serve(engine, reqs):
    tickets = [engine.submit(p, max_new=g) for p, g in reqs]
    engine.run_until_idle()
    return [t.result().tolist() for t in tickets]


def _record_margins(engine):
    """Wrap the engine's step and host sampler so every sampled token's
    top-2 margin, and the tolerance its logits are held to, are recorded."""
    cfg = engine.cfg
    seen = []

    def note(lg):
        top2 = lg.topk(2, dim=-1).values
        tol = 2 * (LOGIT_ATOL + LOGIT_RTOL * lg.abs().amax(dim=-1))
        seen.extend(zip((top2[..., 0] - top2[..., 1]).reshape(-1).tolist(),
                        tol.reshape(-1).tolist()))

    def step(params, tokens, cache, block, length, seeds):
        logits, _ = t_tf.paged_decode_step(
            params, cfg, tokens, cache, block, length, decode_attn=engine._impl)
        lg = logits[:, 0, : cfg.vocab_size]
        note(lg[[s for s, r in enumerate(engine.sched.slots) if r is not None]])
        return torch.argmax(lg, dim=-1).to(torch.int32)

    host = engine._sample_host

    def sample_host(logits_row, seed, position):
        note(logits_row[None, : cfg.vocab_size])
        return host(logits_row, seed, position)

    engine._step = step
    engine._sample_host = sample_host
    return seen


@pytest.mark.parametrize("name", ["tiny", "tinyllama-1.1b", "qwen2-1.5b", "olmoe-1b-7b"])
def test_greedy_ids_identical_to_jax_engine(name):
    jc, tc, jp, tp = _models(name)
    reqs = _requests(jc.vocab_size)
    port = _engine(tc, tp, n_slots=3, max_seq=24)
    margins = _record_margins(port)
    got = _serve(port, reqs)
    kernels = (False, True) if name == "tiny" else (False,)
    for use_kernel in kernels:
        ref = JEngine(jc, jp, n_slots=3, page_size=4, max_seq=24, use_kernel=use_kernel)
        assert got == _serve(ref, reqs), f"use_kernel={use_kernel}"
    assert len(margins) == sum(g for _, g in reqs)
    assert all(m > tol for m, tol in margins), min(m - t for m, t in margins)
    assert port.kernel_plan["path"] == "plain"
    assert port.kernel_hits == {"cuda": 0, "plain": sum(g - 1 for _, g in reqs)}


def test_continuous_equals_one_at_a_time(tiny):
    cfg, params = tiny
    reqs = _requests(cfg.vocab_size)
    batched = _serve(_engine(cfg, params, n_slots=3, max_seq=24), reqs)
    solo = [_serve(_engine(cfg, params, n_slots=1, max_seq=24), [r])[0] for r in reqs]
    assert batched == solo


def test_under_provisioned_arena_still_serves_everything(tiny):
    cfg, params = tiny
    reqs = _requests(cfg.vocab_size)
    eng = _engine(cfg, params, n_slots=3, max_seq=24, n_pages=8)
    assert _serve(eng, reqs) == _serve(_engine(cfg, params, n_slots=3, max_seq=24), reqs)
    assert eng.sched.alloc.used_pages == 0


def test_use_kernel_false_and_auto_agree_on_cpu(tiny):
    cfg, params = tiny
    reqs = _requests(cfg.vocab_size)[:3]
    off = _engine(cfg, params, max_seq=24, use_kernel=False)
    assert "opt-out" in off.kernel_plan["reason"]
    assert _serve(off, reqs) == _serve(_engine(cfg, params, max_seq=24), reqs)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        _engine(cfg, params, use_kernel=True)


def test_default_device_is_cuda(tiny):
    cfg, params = tiny
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default engine runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousLMEngine(cfg, params)


# ----------------------------------------------------------------------------
# Scheduler
# ----------------------------------------------------------------------------


def _req(rid, plen, gen):
    return t_cont._Request(rid=rid, prompt=np.zeros(plen, np.int32), max_new=gen,
                           ticket=None, t_submit=0.0, seed=0)


class TestDecodeScheduler:
    def test_admit_release_cycle(self):
        s = DecodeScheduler(n_slots=2, n_pages=9, page_size=4, max_seq=16)
        r1, r2, r3 = _req(1, 8, 8), _req(2, 4, 4), _req(3, 4, 4)
        assert s.admit(r1) is not None
        assert s.admit(r2) is not None
        assert s.n_active == 2
        assert s.admit(r3) is None
        s.release(r1.slot)
        assert (s.block[0] == 0).all() and s.length[0] == 0
        assert s.admit(r3) is not None
        assert s.alloc.used_pages == 4
        slot = r2.slot
        s.release(slot)
        with pytest.raises(ValueError, match="empty slot"):
            s.release(slot)

    def test_oversubscribed_arena_queues_by_pages(self):
        s = DecodeScheduler(n_slots=2, n_pages=5, page_size=4, max_seq=16)
        a, b = _req(1, 8, 8), _req(2, 8, 8)
        assert s.admit(a) is not None
        assert s.admit(b) is None
        s.release(a.slot)
        assert s.admit(b) is not None

    def test_never_servable_rejected_at_submit(self, tiny):
        cfg, params = tiny
        eng = _engine(cfg, params)
        with pytest.raises(ValueError, match="max_seq"):
            eng.submit(np.zeros(12, np.int32), max_new=8)
        with pytest.raises(ValueError, match="pages"):
            _engine(cfg, params, n_pages=3).submit(np.zeros(8, np.int32), max_new=4)
        with pytest.raises(ValueError, match="empty prompt"):
            eng.submit(np.zeros(0, np.int32), max_new=2)
        with pytest.raises(ValueError, match="max_new"):
            eng.submit(np.zeros(2, np.int32), max_new=0)


# ----------------------------------------------------------------------------
# Failure semantics
# ----------------------------------------------------------------------------


class TestFailureSemantics:
    def test_eviction_fails_ticket_immediately(self, tiny):
        cfg, params = tiny
        eng = _engine(cfg, params)
        keep = eng.submit(np.asarray([1, 2, 3], np.int32), max_new=4)
        drop = eng.submit(np.asarray([4, 5], np.int32), max_new=4)
        eng.step()
        eng.evict(drop, reason="test reclaim")
        with pytest.raises(EvictedError, match="test reclaim"):
            drop.result(timeout=0.1)
        assert len(keep.result()) == 4
        assert eng.stats()["evictions"] == 1
        eng.evict(keep)  # already resolved: nothing to do
        assert eng.stats()["evictions"] == 1

    def test_queued_request_eviction(self, tiny):
        cfg, params = tiny
        eng = _engine(cfg, params, n_slots=1)
        first = eng.submit(np.asarray([1, 2], np.int32), max_new=3)
        queued = eng.submit(np.asarray([3], np.int32), max_new=3)
        eng.step()
        eng.evict(queued)
        with pytest.raises(EvictedError):
            queued.result(timeout=0.1)
        assert len(first.result()) == 3

    def test_decode_error_fails_all_inflight_tickets(self, tiny):
        cfg, params = tiny
        eng = _engine(cfg, params)
        t1 = eng.submit(np.asarray([1, 2], np.int32), max_new=4)
        t2 = eng.submit(np.asarray([3], np.int32), max_new=4)
        eng.step()
        boom = RuntimeError("device fell over")
        eng._step = lambda *a, **k: (_ for _ in ()).throw(boom)
        with pytest.raises(RuntimeError, match="device fell over"):
            eng.step()
        for t in (t1, t2):
            with pytest.raises(RuntimeError, match="device fell over"):
                t.result(timeout=0.1)
        assert eng.sched.n_active == 0
        assert eng.sched.alloc.used_pages == 0


# ----------------------------------------------------------------------------
# Metrics and the duck-typed tracer
# ----------------------------------------------------------------------------


class _Tracer:
    """The three methods the engine calls (the telemetry port waits)."""

    def __init__(self):
        self.spans, self.counters, self.gauges = [], {}, {}

    def span(self, name, **tags):
        from contextlib import nullcontext

        self.spans.append(name)
        return nullcontext()

    def count(self, name, n=1):
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name, value):
        self.gauges[name] = value


def test_metrics_ledger_and_tracer(tiny):
    cfg, params = tiny
    tr = _Tracer()
    eng = _engine(cfg, params, tracer=tr, tag="serve/t")
    rng = np.random.default_rng(5)
    tickets = [eng.submit(rng.integers(0, cfg.vocab_size, size=3).astype(np.int32),
                          max_new=g) for g in (4, 2, 3)]
    eng.run_until_idle()
    for t in tickets:
        t.result()
    s = eng.stats()
    assert s["requests"] == 3
    assert s["tokens"] == (4 - 1) + (2 - 1) + (3 - 1)
    assert s["tokens_per_s"] > 0 and 0 < s["slot_utilization"] <= 1
    assert s["decode_steps"] > 0 and s["p50_token_ms"] >= 0 and s["p50_ttft_ms"] > 0
    assert s["request_bytes"] == 3 * 3 * 4 and s["response_bytes"] == (4 + 2 + 3) * 4
    assert [e for e in eng.ledger.events if e[0] == "inference"] == \
           [("inference", "serve/t", 3 * 3 * 4 + 9 * 4)]
    assert "serve/decode_step" in tr.spans and "serve/prefill" in tr.spans
    assert tr.counters["serve/joins"] == 3 and tr.counters["serve/requests"] == 3
    assert tr.counters["serve/decode_tokens"] == s["tokens"]
    assert 0 < tr.gauges["serve/slot_occupancy"] <= 1
    assert sum(eng.kernel_hits.values()) == s["tokens"]


# ----------------------------------------------------------------------------
# Temperature sampling
# ----------------------------------------------------------------------------


def test_temperature_sampling_is_occupancy_invariant(tiny):
    cfg, params = tiny
    rng = np.random.default_rng(3)
    p0 = rng.integers(0, cfg.vocab_size, size=4).astype(np.int32)
    others = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (2, 6)]
    kw = dict(n_slots=3, temperature=0.7, seed=11)
    alone = _engine(cfg, params, **kw).submit(p0, max_new=5).result().tolist()
    crowd = _engine(cfg, params, **kw)
    tickets = [crowd.submit(p0, max_new=5)] + [crowd.submit(p, max_new=4) for p in others]
    crowd.run_until_idle()
    assert tickets[0].result().tolist() == alone
    hot = _engine(cfg, params, n_slots=3, temperature=5.0, seed=11)
    greedy = _engine(cfg, params, n_slots=3)
    assert hot.submit(p0, max_new=5).result().tolist() != \
           greedy.submit(p0, max_new=5).result().tolist()


def test_temperature_draws_follow_softmax():
    """4,000 draws (one per position) from fixed logits: every category's
    frequency within 4.5 standard errors of softmax(logits / T)."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, -3.0])
    n, temp = 4000, 0.8
    pos = torch.arange(n)
    ids = t_cont.sample_tokens(logits.expand(n, -1), torch.full((n,), 7), pos, temp)
    p = torch.softmax(logits / temp, dim=-1)
    freq = torch.bincount(ids, minlength=6).double() / n
    se = torch.sqrt(p * (1 - p) / n)
    assert bool(((freq - p).abs() <= 4.5 * se + 1e-3).all()), (freq, p)
    u = t_cont.sample_uniform(torch.tensor([1, 1, 2]), torch.tensor([5, 6, 5]), 10_000)
    assert bool(((u > 0) & (u < 1)).all())
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    again = t_cont.sample_uniform(torch.tensor([1]), torch.tensor([5]), 10_000)
    assert torch.equal(u[0], again[0])


# ----------------------------------------------------------------------------
# The CLI
# ----------------------------------------------------------------------------


def test_launch_serve_continuous_cpu(capsys):
    from repro_torch.launch import serve as launch

    outs = launch.main(["--arch", "tinyllama-1.1b", "--reduced", "--continuous",
                        "--batch", "2", "--requests", "3", "--prompt-len", "5",
                        "--gen", "4", "--device", "cpu"])
    assert outs.shape == (3, 4) and outs.dtype == np.int32
    out = capsys.readouterr().out
    assert '"tokens": 9' in out and "RunReport (serve)" in out and "serve/decode_step" in out
    # without --continuous: the microbatched path (ROADMAP queue 1, item 10,
    # ported; tests/test_torch_serve_engine.py holds it to the JAX package)
    ids = launch.main(["--reduced", "--device", "cpu", "--batch", "2", "--requests", "3",
                       "--prompt-len", "5", "--gen", "2"])
    assert ids.shape == (3, 2) and ids.dtype == np.int32
    with pytest.raises(NotImplementedError, match="queue 1, item 13"):
        launch.main(["--reduced", "--device", "cpu", "--mesh"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch.main(["--reduced", "--continuous"])
