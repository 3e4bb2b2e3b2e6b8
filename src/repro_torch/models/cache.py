"""Decode caches of every mixer family (port of ``repro.models.cache``).

``KVCache`` is the dense per-sequence cache the prefill runs on.
``PagedKVCache`` is the continuous-batching arena: one physical page pool
per layer shared by every in-flight sequence, addressed through a per-slot
block table (slot → ordered page ids) that the host owns.  Page 0 is the
reserved **null page**: freed and inactive slots point their whole block row
at it, so a decode step can keep writing "their" keys without masking — the
writes land in memory no live sequence reads.

Where the JAX package returns new arrays (and donates the old arena to the
compiled step, ``serve/continuous.py:260``), the port updates the caches in
place (``index_put_``, slice assignment) and returns the same tensors: a
decode step moves one token per slot, not the whole arena.

``MLACache`` is MLA's dense latent cache.  ``MambaCache``, ``MLSTMCache``
and ``SLSTMCache`` are the recurrent mixers' states: their size does not
grow with the context, and they carry no fill index (the state is
position-free).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S, H_kv, D), or (L, B, S, H_kv, D) stacked
    v: torch.Tensor
    #: valid positions, the same for every layer of a stack.  A host int
    #: where the reference keeps a device scalar: the port slices with it.
    index: int


def kv_cache_init(batch: int, seq: int, n_kv: int, head_dim: int, dtype,
                  device=None) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, seq, n_kv, head_dim), dtype=dtype, device=device),
        v=torch.zeros((batch, seq, n_kv, head_dim), dtype=dtype, device=device),
        index=0,
    )


class MLACache(NamedTuple):
    """DeepSeek MLA latent cache: the compressed KV and one shared roped
    key per position."""

    c_kv: torch.Tensor  # (B, S, kv_lora_rank), or (L, B, S, r) stacked
    k_rope: torch.Tensor  # (B, S, qk_rope_head_dim)
    index: int  # a host int, as ``KVCache.index``


def mla_cache_init(batch: int, seq: int, kv_lora: int, rope_dim: int, dtype,
                   device=None) -> MLACache:
    return MLACache(
        c_kv=torch.zeros((batch, seq, kv_lora), dtype=dtype, device=device),
        k_rope=torch.zeros((batch, seq, rope_dim), dtype=dtype, device=device),
        index=0,
    )


class MambaCache(NamedTuple):
    conv: torch.Tensor  # (B, d_conv - 1, d_inner) — conv tail window
    ssm: torch.Tensor  # (B, d_inner, d_state), f32


class MLSTMCache(NamedTuple):
    C: torch.Tensor  # (B, H, Dk, Dv) matrix memory, f32
    n: torch.Tensor  # (B, H, Dk) normalizer
    m: torch.Tensor  # (B, H) gate stabilizer


class SLSTMCache(NamedTuple):
    c: torch.Tensor  # (B, d), f32
    n: torch.Tensor  # (B, d)
    h: torch.Tensor  # (B, d)
    m: torch.Tensor  # (B, d)


def mamba_cache_init(batch: int, d_conv: int, d_inner: int, d_state: int, dtype,
                     device=None) -> MambaCache:
    return MambaCache(
        conv=torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype, device=device),
        ssm=torch.zeros((batch, d_inner, d_state), dtype=torch.float32, device=device),
    )


def mlstm_cache_init(batch: int, heads: int, dk: int, dv: int, device=None) -> MLSTMCache:
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMCache(
        C=torch.zeros((batch, heads, dk, dv), **f32),
        n=torch.zeros((batch, heads, dk), **f32),
        m=torch.full((batch, heads), -1e30, **f32),
    )


def slstm_cache_init(batch: int, d: int, device=None) -> SLSTMCache:
    f32 = dict(dtype=torch.float32, device=device)
    return SLSTMCache(
        c=torch.zeros((batch, d), **f32),
        n=torch.zeros((batch, d), **f32),
        h=torch.zeros((batch, d), **f32),
        m=torch.full((batch, d), -1e30, **f32),
    )


#: physical page id every freed / inactive block-table entry points at;
#: never handed out by ``PageAllocator``, so masked writes are harmless
NULL_PAGE = 0


class PagedKVCache(NamedTuple):
    """Physical KV page arena for one layer (or a stack of layers with a
    leading layer dimension).  Position is owned by the caller's block
    table and per-slot lengths."""

    k: torch.Tensor  # (n_pages, page_size, H_kv, D)
    v: torch.Tensor


def paged_kv_cache_init(n_pages: int, page_size: int, n_kv: int, head_dim: int,
                        dtype, device=None) -> PagedKVCache:
    shape = (n_pages, page_size, n_kv, head_dim)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
    )


def paged_view(cache: PagedKVCache, block: torch.Tensor):
    """Gather each slot's pages into a dense per-slot view.

    ``block``: (n_slots, pages_per_slot) physical page ids.  Returns
    ``(k, v)`` of shape (n_slots, pages_per_slot · page_size, H_kv, D),
    contiguous — the layout the decode-attention kernel reads; positions
    beyond a slot's length hold stale or null-page values and must be
    masked by the attention's ``valid_len``.
    """
    n_slots, pp = block.shape
    P = cache.k.shape[1]
    tail = cache.k.shape[2:]
    idx = block.reshape(-1).long()
    k = torch.index_select(cache.k, 0, idx)
    v = torch.index_select(cache.v, 0, idx)
    return k.reshape(n_slots, pp * P, *tail), v.reshape(n_slots, pp * P, *tail)


def paged_append(cache: PagedKVCache, block: torch.Tensor, length: torch.Tensor,
                 k_tok: torch.Tensor, v_tok: torch.Tensor) -> PagedKVCache:
    """Write one token per slot at its next logical position, in place.

    ``length`` (n_slots,): tokens already stored per slot; ``k_tok`` /
    ``v_tok`` (n_slots, H_kv, D).  Inactive slots need no masking: their
    block row is all ``NULL_PAGE``, so the write lands in the trash page
    (several inactive slots may collide there; which one wins is undefined
    on the card and harmless).
    """
    P = cache.k.shape[1]
    length = length.long()
    page = torch.gather(block.long(), 1, (length // P)[:, None])[:, 0]
    off = length % P
    cache.k.index_put_((page, off), k_tok.to(cache.k.dtype))
    cache.v.index_put_((page, off), v_tok.to(cache.v.dtype))
    return cache


def paged_write(cache: PagedKVCache, block_row: torch.Tensor, k_seq: torch.Tensor,
                v_seq: torch.Tensor, n_valid: int) -> PagedKVCache:
    """Write a prefilled sequence into one slot's pages, in place (the join
    path).  ``k_seq`` / ``v_seq``: (S, H_kv, D), or (L, S, H_kv, D) for a
    stacked arena (L, n_pages, …).  Rows ≥ ``n_valid`` (prompt-bucket
    padding) are redirected to the null page instead of being masked out.
    """
    P = cache.k.shape[-3]
    S = k_seq.shape[-3]
    pos = torch.arange(S, device=block_row.device)
    # a bucket may reach past the slot's pages: those rows are padding
    # (≥ n_valid) and go to the null page, so clamping the lookup is exact
    page_of = block_row.long()[(pos // P).clamp(max=block_row.shape[0] - 1)]
    page = torch.where(pos < n_valid, page_of, NULL_PAGE)
    off = pos % P
    if cache.k.dim() == 4:
        cache.k[page, off] = k_seq.to(cache.k.dtype)
        cache.v[page, off] = v_seq.to(cache.v.dtype)
    else:
        cache.k[:, page, off] = k_seq.to(cache.k.dtype)
        cache.v[:, page, off] = v_seq.to(cache.v.dtype)
    return cache


class PageAllocator:
    """Host-side free-list allocator over a ``PagedKVCache`` arena.

    LIFO reuse keeps recently freed pages hot.  Page ``NULL_PAGE`` (0) is
    reserved and never allocated.  Freeing a page that is not live raises;
    allocation beyond capacity returns None (callers queue the request
    instead of corrupting a live slot).
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError("need ≥ 2 pages (page 0 is the null page)")
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, 0, -1))  # pop() yields 1, 2, …
        self._used: set = set()

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return len(self._used)

    def alloc(self, n: int) -> list | None:
        """``n`` physical page ids, or None if the arena cannot supply them
        (all or nothing: a partial allocation is never handed out)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        self._used.update(pages)
        return pages

    def free(self, pages) -> None:
        for p in pages:
            if p not in self._used:
                raise ValueError(
                    f"free() of page {p} which is not allocated "
                    f"(double free or foreign page)"
                )
            self._used.remove(p)
            self._free.append(p)
