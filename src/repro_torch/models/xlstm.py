"""xLSTM blocks, sLSTM (scalar memory) and mLSTM (matrix memory) (port of
``repro.models.xlstm``; arXiv:2405.04517).

mLSTM trains and prefills in the chunkwise-parallel, stabilised form: each
chunk of ``chunk`` tokens is attention-like with the exponential-gating
decay matrix, and the (C, n, m) state carries across chunks in a loop.  It
decodes with the O(1)-state recurrent step.  sLSTM is sequential: a loop
over time of the block-diagonal recurrence, carrying (c, n, h, m).  The
stabiliser is the reference's: ``max(|n·q|, exp(−m))`` for mLSTM, gates in
log space through ``logsigmoid`` in f32, ``m`` starting at −1e30.

As in the reference, the small causal conv before mLSTM's q / k is left
out and the projection factors are the paper's (2 for mLSTM, 4/3 for
sLSTM's FFN).  With a cache each apply returns a new cache;
``transformer.forward`` writes it into the stacked cache.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.cache import MLSTMCache, SLSTMCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense, dense_init, gelu, rmsnorm, rmsnorm_init

# ----------------------------------------------------------------------------
# mLSTM
# ----------------------------------------------------------------------------


def _mlstm_inner(cfg: ModelConfig) -> int:
    di = int(cfg.xlstm.proj_factor_mlstm * cfg.d_model)
    return (di // cfg.num_heads) * cfg.num_heads  # divisible by heads


def mlstm_init(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    d, H = cfg.d_model, cfg.num_heads
    di = _mlstm_inner(cfg)
    kw = dict(dtype=dtype, device=device)
    return {
        "up_proj": dense_init(gen, d, 2 * di, **kw),
        "wq": dense_init(gen, di, di, **kw),
        "wk": dense_init(gen, di, di, **kw),
        "wv": dense_init(gen, di, di, **kw),
        "w_i": dense_init(gen, di, H, bias=True, **kw),
        "w_f": dense_init(gen, di, H, bias=True, **kw),
        "mh_norm": rmsnorm_init(di, dtype, device or gen.device),
        "down_proj": dense_init(gen, di, d, **kw),
    }


def _mlstm_chunk(state: MLSTMCache, q, k, v, i_pre, f_pre):
    """One chunk of the chunkwise-parallel mLSTM: q, k, v (B, L, H, Dh),
    i / f (B, L, H) → (state at the chunk's end, h (B, L, H, Dh) f32).

    With the in-chunk cumulative log-forget b_t = Σ_{r≤t} log σ(f_r) and
    the running stabiliser g_t = max(m_0, max_{s≤t}(i_s − b_s)) (so
    m_t = b_t + g_t):
        h_t ∝ Σ_{s≤t} exp(i_s − b_s − g_t)·(q̃_t·k_s)·v_s + exp(m_0 − g_t)·(q̃_t·C_0)
    normalised by max(|den|, exp(−m_t)); the end state uses t = L."""
    L, Dh = q.shape[1], q.shape[-1]
    C0, n0, m0 = state.C, state.n, state.m  # (B,H,Dk,Dv), (B,H,Dk), (B,H)

    logf = F.logsigmoid(f_pre.float())
    logi = i_pre.float()
    b = torch.cumsum(logf, dim=1)  # (B, L, H)
    a = torch.clamp_min(torch.cummax(logi - b, dim=1).values, -1e30)
    g = torch.maximum(m0[:, None], a)
    m = b + g

    qf = q.float() * (Dh ** -0.5)
    kf, vf = k.float(), v.float()

    ib = logi - b  # (B, L, H) at s
    Dmat = ib[:, None, :, :] - g[:, :, None, :]  # (B, T, S, H)
    tri = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()[None, :, :, None]
    W = torch.where(tri, torch.exp(Dmat), 0.0)
    WS = W * torch.einsum("bthd,bshd->btsh", qf, kf)
    num = torch.einsum("btsh,bshd->bthd", WS, vf)
    den = WS.sum(dim=2)

    scale0 = torch.exp(m0[:, None] - g)  # (B, L, H)
    num = num + torch.einsum("bthd,bhdv->bthv", qf, C0) * scale0[..., None]
    den = den + torch.einsum("bthd,bhd->bth", qf, n0) * scale0
    h = num / torch.maximum(den.abs(), torch.exp(-m))[..., None]

    gL = g[:, -1]  # (B, H)
    wL = torch.exp(ib - gL[:, None])
    carry = torch.exp(m0 - gL)
    C_new = carry[..., None, None] * C0 + torch.einsum("blh,blhk,blhv->bhkv", wL, kf, vf)
    n_new = carry[..., None] * n0 + torch.einsum("blh,blhk->bhk", wL, kf)
    return MLSTMCache(C=C_new, n=n_new, m=b[:, -1] + gL), h


def _mlstm_parallel(q, k, v, i_pre, f_pre, *, chunk: int = 256):
    """Chunkwise-parallel mLSTM over the whole sequence: q, k, v (B, T, H,
    Dh); i, f (B, T, H).  Padded steps neither write nor forget (forget
    gate 30, input gate −1e30)."""
    B, T, H, Dh = q.shape
    L = min(chunk, T)
    pad = (-T) % L
    if pad:
        def zpad(x):
            return torch.cat([x, x.new_zeros((B, pad, *x.shape[2:]))], dim=1)

        q, k, v = zpad(q), zpad(k), zpad(v)
        f_pre = torch.cat([f_pre, f_pre.new_full((B, pad, H), 30.0)], dim=1)
        i_pre = torch.cat([i_pre, i_pre.new_full((B, pad, H), -1e30)], dim=1)
    f32 = dict(dtype=torch.float32, device=q.device)
    state = MLSTMCache(C=torch.zeros((B, H, Dh, Dh), **f32), n=torch.zeros((B, H, Dh), **f32),
                       m=torch.full((B, H), -1e30, **f32))
    hs = []
    for s in range(0, T + pad, L):
        sl = slice(s, s + L)
        state, h = _mlstm_chunk(state, q[:, sl], k[:, sl], v[:, sl], i_pre[:, sl], f_pre[:, sl])
        hs.append(h)
    return torch.cat(hs, dim=1)[:, :T].to(q.dtype)


def _mlstm_step(cache: MLSTMCache, q, k, v, i_pre, f_pre):
    """Recurrent mLSTM step: q, k, v (B, H, Dh); i, f (B, H)."""
    logf = F.logsigmoid(f_pre.float())
    logi = i_pre.float()
    m_new = torch.maximum(logf + cache.m, logi)
    fw = torch.exp(logf + cache.m - m_new)[..., None]
    iw = torch.exp(logi - m_new)[..., None]
    kf, vf = k.float(), v.float()
    C = cache.C * fw[..., None] + iw[..., None] * kf[..., None] * vf[..., None, :]
    n = cache.n * fw + iw * kf
    qf = q.float() * (q.shape[-1] ** -0.5)
    num = torch.einsum("bhkv,bhk->bhv", C, qf)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qf).abs(), torch.exp(-m_new))
    return MLSTMCache(C=C, n=n, m=m_new), (num / den[..., None]).to(q.dtype)


def mlstm_apply(p, cfg: ModelConfig, x, *, cache: MLSTMCache | None = None, **_):
    B, T, _ = x.shape
    H = cfg.num_heads
    xi, z = dense(p["up_proj"], x).chunk(2, dim=-1)
    di = xi.shape[-1]
    Dh = di // H
    q = dense(p["wq"], xi).reshape(B, T, H, Dh)
    k = dense(p["wk"], xi).reshape(B, T, H, Dh)
    v = dense(p["wv"], xi).reshape(B, T, H, Dh)
    i_pre = dense(p["w_i"], xi)
    f_pre = dense(p["w_f"], xi)
    if cache is None:
        chunk = T if cfg.unroll_time_scans else 256
        h = _mlstm_parallel(q, k, v, i_pre, f_pre, chunk=chunk)
        new_cache = None
    else:
        if T != 1:
            raise ValueError("the recurrent mLSTM path decodes one token (T == 1)")
        new_cache, h1 = _mlstm_step(cache, q[:, 0], k[:, 0], v[:, 0], i_pre[:, 0], f_pre[:, 0])
        h = h1[:, None]
    h = rmsnorm(p["mh_norm"], h.reshape(B, T, di), eps=cfg.rms_eps)
    return dense(p["down_proj"], h * F.silu(z)), new_cache


# ----------------------------------------------------------------------------
# sLSTM
# ----------------------------------------------------------------------------


def slstm_init(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    d, H = cfg.d_model, cfg.num_heads
    dh = d // H
    df = int(cfg.xlstm.proj_factor_slstm * d)
    device = device or gen.device
    kw = dict(dtype=dtype, device=device)

    def rinit():  # block-diagonal recurrent weights, stored (H, dh, dh)
        r = torch.empty((H, dh, dh), dtype=torch.float32, device=device)
        return ((1.0 / dh) ** 0.5 * r.normal_(generator=gen)).to(dtype)

    p = {g: dense_init(gen, d, d, bias=True, **kw) for g in ("w_z", "w_i", "w_f", "w_o")}
    p.update({g: rinit() for g in ("r_z", "r_i", "r_f", "r_o")})
    p["group_norm"] = rmsnorm_init(d, dtype, device)
    p["ffn_up"] = dense_init(gen, d, 2 * df, **kw)
    p["ffn_down"] = dense_init(gen, df, d, **kw)
    return p


def _block_recur(r, h, H, dh):
    """Block-diagonal recurrence: h (B, d) by r (..., H, dh, dh) → (..., B, d)."""
    B = h.shape[0]
    out = torch.einsum("bhk,...hkd->...bhd", h.reshape(B, H, dh), r)
    return out.reshape(*r.shape[:-3], B, H * dh)


def _slstm_step(r, H: int, state: SLSTMCache, zifo):
    """One sLSTM time step: ``r`` the four recurrent matrices (z, i, f, o)
    stacked (4, H, dh, dh) in f32, ``zifo`` the (B, d) input
    pre-activations."""
    rec = _block_recur(r, state.h, H, state.h.shape[-1] // H)  # (4, B, d)
    xz, xi, xf, xo = zifo
    z = torch.tanh(xz + rec[0])
    logi = xi + rec[1]  # exponential input gate, in log space
    logf = F.logsigmoid(xf + rec[2])
    o = torch.sigmoid(xo + rec[3])
    m_new = torch.maximum(logf + state.m, logi)
    fw = torch.exp(logf + state.m - m_new)
    iw = torch.exp(logi - m_new)
    c = fw * state.c + iw * z
    n = fw * state.n + iw
    return SLSTMCache(c=c, n=n, h=o * c / torch.clamp_min(n, 1e-6), m=m_new)


def slstm_apply(p, cfg: ModelConfig, x, *, cache: SLSTMCache | None = None, **_):
    B, T, d = x.shape
    cd = x.dtype
    zifo = [dense(p[g], x).float() for g in ("w_z", "w_i", "w_f", "w_o")]
    if cache is None:
        f32 = dict(dtype=torch.float32, device=x.device)
        state = SLSTMCache(c=torch.zeros((B, d), **f32), n=torch.zeros((B, d), **f32),
                           h=torch.zeros((B, d), **f32), m=torch.full((B, d), -1e30, **f32))
    else:
        state = cache
    r = torch.stack([p[g].float() for g in ("r_z", "r_i", "r_f", "r_o")])
    hs = []
    for t in range(T):
        state = _slstm_step(r, cfg.num_heads, state, [u[:, t] for u in zifo])
        hs.append(state.h)
    h = rmsnorm(p["group_norm"], torch.stack(hs, dim=1).to(cd), eps=cfg.rms_eps)
    # post up/down GLU FFN (the paper's projection factor 4/3)
    a, b = dense(p["ffn_up"], h).chunk(2, dim=-1)
    out = dense(p["ffn_down"], gelu(a) * b)
    return out, (state if cache is not None else None)
