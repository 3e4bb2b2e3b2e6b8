"""Mamba-1 selective SSM mixer, Jamba's recurrent layer (port of
``repro.models.mamba``).

Training and prefill run the recurrence ``h_t = a_t ⊙ h_{t-1} + b_t`` in
chunks of ``chunk`` tokens, as the reference does: inside a chunk an
inclusive scan, across chunks a loop that carries the state, so only a
(B, chunk, d_inner, d_state) tensor is live.  The reference's in-chunk scan
is ``jax.lax.associative_scan``; the port's is a doubling (Hillis–Steele)
scan, log2(chunk) steps of ``(a, b)[t] ∘= (a, b)[t − s]`` over the whole
chunk.  Both combine the same pairs by the same rule in another tree order,
so the two agree to f32 rounding, not bitwise.  Neither forms
``a_cum · cumsum(b / a_cum)``: with A down to −16 and a softplus dt,
``a_cum`` underflows to 0 inside a chunk.

Decode carries a ``MambaCache`` (the conv tail and the SSM state), O(1) in
the context length.  With a cache the function returns a new cache, as the
reference does; ``transformer.forward`` writes it into the stacked cache.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.cache import MambaCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense, dense_init, truncated_normal


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or max(1, -(-cfg.d_model // 16))  # ceil(d/16)
    return d_inner, dt_rank, s.d_state, s.d_conv


def mamba_init(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    d_inner, dt_rank, d_state, d_conv = _dims(cfg)
    d = cfg.d_model
    device = device or gen.device
    A = torch.arange(1, d_state + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, d, 2 * d_inner, dtype=dtype, device=device),
        "conv_w": truncated_normal(gen, (d_conv, d_inner), dtype, (1.0 / d_conv) ** 0.5,
                                   device),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=device),
        "x_proj": dense_init(gen, d_inner, dt_rank + 2 * d_state, dtype=dtype, device=device),
        "dt_proj": dense_init(gen, dt_rank, d_inner, bias=True, dtype=dtype, device=device),
        "A_log": torch.log(A).repeat(d_inner, 1),  # f32 whatever the parameter type
        "D": torch.ones((d_inner,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, d_inner, d, dtype=dtype, device=device),
    }


def _scan(a, b):
    """Inclusive scan of (a, b) pairs along dim 1 under
    (a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2): doubling steps, each
    combining position t with t − s."""
    L = a.shape[1]
    s = 1
    while s < L:
        a, b = (torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1),
                torch.cat([b[:, :s], a[:, s:] * b[:, :-s] + b[:, s:]], dim=1))
        s *= 2
    return a, b


def _ssm_chunk(carry_h, a, b):
    """One chunk of the selective scan from state ``carry_h`` (B, di, ds),
    a / b (B, L, di, ds) f32 → (last state, all states)."""
    a_cum, b_cum = _scan(a, b)
    h = a_cum * carry_h[:, None] + b_cum
    return h[:, -1], h


def _causal_conv(xs, pad, w, bias):
    """Depthwise causal conv over time: xs (B, T, di) after ``pad`` (B,
    dc−1, di), taps summed in f32 and rounded once to the compute type
    (as the reference's einsum accumulates)."""
    T = xs.shape[1]
    xpad = torch.cat([pad, xs], dim=1)
    acc = sum(xpad[:, c:c + T].float() * w[c].float() for c in range(w.shape[0]))
    return acc.to(xs.dtype) + bias.to(xs.dtype)


def mamba_apply(p, cfg: ModelConfig, x: torch.Tensor, *, cache: MambaCache | None = None,
                chunk: int = 256, **_):
    """x: (B, T, d) → (y, new_cache); new_cache is None without a cache."""
    d_inner, dt_rank, d_state, d_conv = _dims(cfg)
    B, T, _ = x.shape
    cd = x.dtype
    if cfg.unroll_time_scans:
        chunk = T

    xs, z = dense(p["in_proj"], x).chunk(2, dim=-1)
    if cache is None:
        pad = torch.zeros((B, d_conv - 1, d_inner), dtype=cd, device=x.device)
        conv_tail = None
    else:
        pad = cache.conv.to(cd)
        conv_tail = torch.cat([pad, xs], dim=1)[:, -(d_conv - 1):]
    xc = F.silu(_causal_conv(xs, pad, p["conv_w"], p["conv_b"]))

    # input-dependent SSM parameters
    proj = dense(p["x_proj"], xc)
    dt, Bmat, Cmat = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(dense(p["dt_proj"], dt)).float()  # (B, T, di)
    A = -torch.exp(p["A_log"].float())  # (di, ds)
    Bf, Cf, xf = Bmat.float(), Cmat.float(), xc.float()
    a = torch.exp(dt[..., None] * A)  # (B, T, di, ds)
    b = (dt * xf)[..., None] * Bf[:, :, None, :]
    h0 = (torch.zeros((B, d_inner, d_state), dtype=torch.float32, device=x.device)
          if cache is None else cache.ssm.float())

    if T == 1:  # decode: one recurrent step
        h_last = a[:, 0] * h0 + b[:, 0]
        y = torch.einsum("bds,bs->bd", h_last, Cf[:, 0])[:, None]
    else:
        Lc = min(chunk, T)
        npad = (-T) % Lc
        if npad:  # identity steps: a = 1, b = 0
            a = torch.cat([a, a.new_ones((B, npad, d_inner, d_state))], dim=1)
            b = torch.cat([b, b.new_zeros((B, npad, d_inner, d_state))], dim=1)
        h, hs = h0, []
        for i in range(0, T + npad, Lc):
            h, h_chunk = _ssm_chunk(h, a[:, i:i + Lc], b[:, i:i + Lc])
            hs.append(h_chunk)
        hs = torch.cat(hs, dim=1)[:, :T]
        y = torch.einsum("btds,bts->btd", hs, Cf)
        h_last = hs[:, -1]  # the final state comes from position T−1, not padding

    y = y + p["D"].float() * xf
    out = dense(p["out_proj"], y.to(cd) * F.silu(z))
    new_cache = None
    if cache is not None:
        new_cache = MambaCache(conv=conv_tail.to(cache.conv.dtype), ssm=h_last)
    return out, new_cache
