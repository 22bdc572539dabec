"""Paged, optionally INT8/FP8/INT4-quantized KV cache.

Serving-side state for multi-sequence decode (no reference counterpart —
the reference is a stateless op library, SURVEY.md §5).  Virtual-memory
layout: K/V live in fixed-size pages scattered across HBM; each sequence
owns a page table.  Values may be stored INT8/FP8 with per-token scales,
or INT4 (two tokens nibble-packed per int8 byte), dequantized inside the
decode kernel.

Layouts (``pack`` = tokens per stored byte row: 1 for int8/fp8, 2 for int4):
  k_pages, v_pages: (n_kv_heads, n_pages, page_size // pack, head_dim)
  k_scales, v_scales: (n_kv_heads, n_pages, pack, page_size // pack) f32
  page_tables: (max_seqs, max_pages_per_seq) int32
  lengths:     (max_seqs,) int32

Scales are stored *token-minor* — one contiguous row per page (two for
int4: row 0 = even-position tokens, row 1 = odd) — so the decode kernel
reads a tile's scales as one contiguous vector.

INT4 packs tokens pairwise along the *token* axis (byte row r of a page
holds token 2r in its low nibble, token 2r+1 in its high nibble), keeping
the feature axis at full width so every tile shape is unchanged — native
``jnp.int4`` arrays cannot cross jit boundaries on all platforms.  The
decode kernel sign-extends the nibbles with two shifts and attends to the
even/odd halves as two half-tile key/value sets.

Writes are XLA scatters and ``dynamic_update_slice`` on the cache arrays,
which the engine donates to its compiled steps so they update in place.
The page allocator is host-side (free-list); device state is a pytree so
the whole cache threads through jit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..block_sizes import pad_dim

__all__ = ["KVCacheConfig", "PagedKVCache", "PageAllocator", "write_tokens_at",
           "gather_sequence_kv"]


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    n_kv_heads: int
    head_dim: int
    page_size: int = 512
    n_pages: int = 64
    max_seqs: int = 8
    max_pages_per_seq: int = 16
    quantized: bool = True
    # int8, float8_e4m3fn, float8_e5m2, or the string "int4" (nibble-packed
    # int8 bytes)
    quant_dtype: object = jnp.int8
    dtype: object = jnp.bfloat16      # payload dtype when not quantized

    @property
    def head_dim_store(self) -> int:
        # storage feature dim padded to the decode kernel's tile width (the
        # next power of two >= 16) so its loads never read past the array
        return pad_dim(self.head_dim)

    @property
    def is_int4(self) -> bool:
        return self.quantized and isinstance(self.quant_dtype, str) \
            and self.quant_dtype == "int4"

    @property
    def tok_pack(self) -> int:
        """Tokens per stored byte row (2 for int4, else 1)."""
        return 2 if self.is_int4 else 1

    @property
    def page_rows(self) -> int:
        """Payload sublane rows per page (= page_size / tok_pack)."""
        return self.page_size // self.tok_pack

    @property
    def payload_dtype(self):
        if not self.quantized:
            return self.dtype
        return jnp.int8 if self.is_int4 else self.quant_dtype


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PagedKVCache:
    k_pages: jax.Array
    v_pages: jax.Array
    k_scales: Optional[jax.Array]
    v_scales: Optional[jax.Array]
    page_tables: jax.Array  # (max_seqs, max_pages_per_seq) int32
    lengths: jax.Array      # (max_seqs,) int32

    @staticmethod
    def create(cfg: KVCacheConfig) -> "PagedKVCache":
        shape = (cfg.n_kv_heads, cfg.n_pages, cfg.page_rows, cfg.head_dim_store)
        scales_shape = (cfg.n_kv_heads, cfg.n_pages, cfg.tok_pack, cfg.page_rows)
        return PagedKVCache(
            k_pages=jnp.zeros(shape, cfg.payload_dtype),
            v_pages=jnp.zeros(shape, cfg.payload_dtype),
            k_scales=jnp.ones(scales_shape, jnp.float32) if cfg.quantized else None,
            v_scales=jnp.ones(scales_shape, jnp.float32) if cfg.quantized else None,
            page_tables=jnp.zeros((cfg.max_seqs, cfg.max_pages_per_seq), jnp.int32),
            lengths=jnp.zeros((cfg.max_seqs,), jnp.int32),
        )


def _pad_feature(x, d_store):
    d = x.shape[-1]
    if d == d_store:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, d_store - d)])


def _quant_max(qdtype) -> float:
    if isinstance(qdtype, str) and qdtype == "int4":
        return 7.0
    if jnp.dtype(qdtype) == jnp.int8:
        return 127.0
    if jnp.dtype(qdtype) == jnp.dtype(jnp.float8_e4m3fn):
        return 448.0
    if jnp.dtype(qdtype) == jnp.dtype(jnp.float8_e5m2):
        return 57344.0
    raise ValueError(f"unsupported quant dtype {qdtype}")


def _quantize_tokens(x, qdtype=jnp.int8):
    """Per-token symmetric quantization to ``qdtype`` (int8, fp8-e4m3, or
    "int4"): x (..., t, d) -> (payload, f32 scales (..., t, 1)).  int4
    values come back *unpacked*, one int8 in [-7, 7] per token — pack
    pairs with ``_pack_nibbles``."""
    qmax = _quant_max(qdtype)
    amax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1, keepdims=True)
    scale = jnp.where(amax == 0.0, 1.0, amax / qmax)
    scaled = x.astype(jnp.float32) / scale
    if isinstance(qdtype, str) and qdtype == "int4":
        q = jnp.clip(jnp.round(scaled), -7, 7).astype(jnp.int8)
    elif jnp.dtype(qdtype) == jnp.int8:
        q = jnp.clip(jnp.round(scaled), -127, 127).astype(jnp.int8)
    else:
        q = scaled.astype(qdtype)
    return q, scale


def _pack_nibbles(q):
    """Pack token pairs along the second-to-last axis: int8 values in
    [-7, 7] of shape (..., t, d) -> int8 bytes (..., t//2, d), token 2r in
    the low nibble of byte row r, token 2r+1 in the high nibble."""
    lo = q[..., 0::2, :].astype(jnp.int32) & 0xF
    hi = q[..., 1::2, :].astype(jnp.int32) & 0xF
    return (lo | (hi << 4)).astype(jnp.int8)


def _pack_scales(sc):
    """Per-token scales (..., t) -> (..., 2, t//2): sublane 0 = scales of
    even-position tokens, sublane 1 = odd (matching ``_pack_nibbles``)."""
    return jnp.stack([sc[..., 0::2], sc[..., 1::2]], axis=-2)


def _unpack_nibbles(x):
    """Sign-extend packed int4 bytes (Pallas-safe: shifts only).
    (..., rows, d) int8 -> (even, odd) int32 pair, each (..., rows, d)."""
    xi = x.astype(jnp.int32)
    even = (xi << 28) >> 28
    odd = (xi << 24) >> 28
    return even, odd


def _head_index(cfg: KVCacheConfig):
    """``(n_kv_heads, 1)`` head indices for per-token cache scatters.

    Indexing the head axis with an array, rather than slicing it, makes
    every scattered axis a leading one: with a sliced head axis XLA
    transposes the whole cache to move the scattered axes first, and back.
    """
    return jnp.arange(cfg.n_kv_heads, dtype=jnp.int32)[:, None]


def append_token(cache: PagedKVCache, cfg: KVCacheConfig, slot, k_new, v_new) -> PagedKVCache:
    """Append one token's K/V for sequence ``slot``.

    ``k_new, v_new``: (n_kv_heads, head_dim).  Page index and intra-page
    offset derive from the current length; the page table must already map
    the target page (see ``PageAllocator.ensure_capacity``).
    """
    k_new = _pad_feature(k_new, cfg.head_dim_store)
    v_new = _pad_feature(v_new, cfg.head_dim_store)
    length = cache.lengths[slot]
    logical_page = (length // cfg.page_size) % cfg.max_pages_per_seq
    offset = length % cfg.page_size
    page = cache.page_tables[slot, logical_page]
    n_kv, d_store = cfg.n_kv_heads, cfg.head_dim_store

    def scatter(pages, scales, new):
        if cfg.is_int4:
            qv, sc = _quantize_tokens(new, cfg.quant_dtype)  # (n_kv, d), [-7,7]
            byte_row = offset // 2
            nib = offset % 2
            old = jax.lax.dynamic_slice(
                pages, (0, page, byte_row, 0), (n_kv, 1, 1, d_store)
            ).astype(jnp.int32)
            q32 = qv.astype(jnp.int32)[:, None, None, :] & 0xF
            # RMW the byte: an even append owns the whole byte (its odd
            # partner doesn't exist yet -> high nibble 0); an odd append
            # preserves the even token in the low nibble
            new_byte = jnp.where(nib == 0,
                                 q32,
                                 (old & 0xF) | (q32 << 4)).astype(jnp.int8)
            pages = jax.lax.dynamic_update_slice(
                pages, new_byte, (0, page, byte_row, 0))
            scales = jax.lax.dynamic_update_slice(
                scales, sc[:, None, None, :], (0, page, nib, byte_row))
            return pages, scales
        if cfg.quantized:
            qv, sc = _quantize_tokens(new, cfg.quant_dtype)
            pages = jax.lax.dynamic_update_slice(
                pages, qv[:, None, None, :], (0, page, offset, 0))
            # token-minor scale layout: one f32 per token along the lane dim
            scales = jax.lax.dynamic_update_slice(
                scales, sc[:, None, None, :], (0, page, 0, offset))
            return pages, scales
        pages = jax.lax.dynamic_update_slice(
            pages, new.astype(pages.dtype)[:, None, None, :], (0, page, offset, 0))
        return pages, scales

    k_pages, k_scales = scatter(cache.k_pages, cache.k_scales, k_new)
    v_pages, v_scales = scatter(cache.v_pages, cache.v_scales, v_new)
    return dataclasses.replace(
        cache,
        k_pages=k_pages, v_pages=v_pages,
        k_scales=k_scales, v_scales=v_scales,
        lengths=cache.lengths.at[slot].add(1),
    )


def write_prompt(cache: PagedKVCache, cfg: KVCacheConfig, slot: int,
                 pages: np.ndarray, k: jax.Array, v: jax.Array) -> PagedKVCache:
    """Bulk-write a prompt's K/V into pre-allocated physical ``pages``.

    ``k, v``: (n_kv_heads, t, head_dim); ``pages``: host int32 array of the
    physical pages backing the prompt (``ceil(t / page_size)`` entries).
    """
    k = _pad_feature(k, cfg.head_dim_store)
    v = _pad_feature(v, cfg.head_dim_store)
    t = k.shape[1]
    n_used = -(-t // cfg.page_size)
    assert len(pages) >= n_used
    pad = n_used * cfg.page_size - t
    kp = jnp.pad(k, ((0, 0), (0, pad), (0, 0)))
    vp = jnp.pad(v, ((0, 0), (0, pad), (0, 0)))
    kp = kp.reshape(cfg.n_kv_heads, n_used, cfg.page_size, cfg.head_dim_store)
    vp = vp.reshape(cfg.n_kv_heads, n_used, cfg.page_size, cfg.head_dim_store)

    k_pages, v_pages = cache.k_pages, cache.v_pages
    k_scales, v_scales = cache.k_scales, cache.v_scales
    if cfg.is_int4:
        kq, ks = _quantize_tokens(kp, cfg.quant_dtype)
        vq, vs = _quantize_tokens(vp, cfg.quant_dtype)
        kq, vq = _pack_nibbles(kq), _pack_nibbles(vq)  # (n_kv, n_used, page/2, d)
        ks = _pack_scales(ks[..., 0])                  # (n_kv, n_used, 2, page/2)
        vs = _pack_scales(vs[..., 0])
    elif cfg.quantized:
        kq, ks = _quantize_tokens(kp, cfg.quant_dtype)
        vq, vs = _quantize_tokens(vp, cfg.quant_dtype)
        ks = jnp.swapaxes(ks, 2, 3)  # -> token-minor (n_kv, n_used, 1, page)
        vs = jnp.swapaxes(vs, 2, 3)
    else:
        kq, vq, ks, vs = kp.astype(k_pages.dtype), vp.astype(v_pages.dtype), None, None
    for i in range(n_used):
        p = int(pages[i])
        k_pages = k_pages.at[:, p].set(kq[:, i])
        v_pages = v_pages.at[:, p].set(vq[:, i])
        if cfg.quantized:
            k_scales = k_scales.at[:, p].set(ks[:, i])
            v_scales = v_scales.at[:, p].set(vs[:, i])
    table = cache.page_tables.at[slot, :n_used].set(jnp.asarray(pages[:n_used], jnp.int32))
    return dataclasses.replace(
        cache,
        k_pages=k_pages, v_pages=v_pages, k_scales=k_scales, v_scales=v_scales,
        page_tables=table,
        lengths=cache.lengths.at[slot].set(t),
    )


def _owned_token_count(total, page_size, stride, offset):
    """Tokens in [0, total) on the shard owning every ``stride``-th page
    starting at ``offset`` (sequence sharding; stride 1 owns everything)."""
    total = jnp.asarray(total, jnp.int32)
    if stride == 1:
        return total
    n_g = total // page_size
    full = jnp.where(n_g > offset, (n_g - offset + stride - 1) // stride, 0)
    tail = jnp.where((n_g % stride) == offset, total % page_size, 0)
    return full * page_size + tail


def write_tokens_at(cache: PagedKVCache, cfg: KVCacheConfig, slot, start,
                    k: jax.Array, v: jax.Array, true_len,
                    trash_page: int,
                    page_stride: int = 1, page_offset=None) -> PagedKVCache:
    """Write a chunk of tokens at absolute position ``start`` (chunked prefill).

    ``k, v``: (n_kv_heads, chunk, head_dim); ``slot``, ``start`` and
    ``true_len`` are traced scalars so one compilation serves every chunk
    of every prompt.  Rows past ``true_len`` (chunk padding) are routed to
    the reserved ``trash_page`` so the scatter stays branch-free and never
    touches unassigned pages.  The slot's length becomes
    ``start + true_len``.

    Sequence sharding: with ``page_stride``/``page_offset`` this cache
    holds every ``page_stride``-th global page starting at ``page_offset``
    — tokens of other shards' pages route to the trash page and the
    slot's (local) length becomes its owned-token count.
    """
    chunk = k.shape[1]
    pack = cfg.tok_pack
    if pack == 2 and chunk % 2:
        raise ValueError(f"int4 KV requires an even chunk, got {chunk}")
    if pack == 2 and jnp.ndim(start) == 0 and isinstance(start, int) and start % 2:
        raise ValueError("int4 chunked writes must start at even positions")
    pos = jnp.asarray(start, jnp.int32) + jnp.arange(chunk, dtype=jnp.int32)
    valid = jnp.arange(chunk) < true_len
    poff = (jnp.asarray(0, jnp.int32) if page_offset is None
            else jnp.asarray(page_offset, jnp.int32))
    g = pos // cfg.page_size
    if page_stride == 1:
        logical = g % cfg.max_pages_per_seq
    else:
        logical = ((g - poff) // page_stride) % cfg.max_pages_per_seq
        valid = jnp.logical_and(valid, (g % page_stride) == poff)
    phys = cache.page_tables[slot, logical]
    phys = jnp.where(valid, phys, trash_page)
    offset = pos % cfg.page_size

    h = _head_index(cfg)

    def scatter(pages, scales, new):
        vals = _pad_feature(new, cfg.head_dim_store)      # (n_kv, chunk, d_store)
        if cfg.is_int4:
            # start is even (engine invariant), so the chunk covers whole
            # byte rows; route a byte row to trash only if BOTH its tokens
            # are padding (an odd true_len leaves a zero high nibble that
            # later appends overwrite nibble-wise)
            qv, sc = _quantize_tokens(vals, cfg.quant_dtype)
            qb = _pack_nibbles(qv)                        # (n_kv, chunk/2, d)
            scp = _pack_scales(sc[..., 0])                # (n_kv, 2, chunk/2)
            phys_b = phys[0::2]
            off_b = offset[0::2] // 2
            pages = pages.at[h, phys_b, off_b].set(qb)
            scales = scales.at[h, phys_b, 0, off_b].set(scp[:, 0])
            scales = scales.at[h, phys_b, 1, off_b].set(scp[:, 1])
            return pages, scales
        if cfg.quantized:
            qv, sc = _quantize_tokens(vals, cfg.quant_dtype)
            pages = pages.at[h, phys, offset].set(qv)
            scales = scales.at[h, phys, 0, offset].set(sc[..., 0])
            return pages, scales
        return pages.at[h, phys, offset].set(vals.astype(pages.dtype)), scales

    k_pages, k_scales = scatter(cache.k_pages, cache.k_scales, k)
    v_pages, v_scales = scatter(cache.v_pages, cache.v_scales, v)
    total = jnp.asarray(start, jnp.int32) + jnp.asarray(true_len, jnp.int32)
    loc_len = _owned_token_count(total, cfg.page_size, page_stride, poff)
    return dataclasses.replace(
        cache,
        k_pages=k_pages, v_pages=v_pages,
        k_scales=k_scales, v_scales=v_scales,
        lengths=cache.lengths.at[slot].set(loc_len),
    )


def assign_page(cache: PagedKVCache, slot: int, logical_page: int, physical_page: int) -> PagedKVCache:
    """Map ``logical_page`` of ``slot`` to ``physical_page`` in the table."""
    return dataclasses.replace(
        cache,
        page_tables=cache.page_tables.at[slot, logical_page].set(physical_page),
    )


def append_tokens_batched(cache: PagedKVCache, cfg: KVCacheConfig,
                          k_new: jax.Array, v_new: jax.Array,
                          active: jax.Array, trash_page: int) -> PagedKVCache:
    """Append one token per sequence slot (vectorised decode-step write).

    ``k_new, v_new``: (max_seqs, n_kv_heads, head_dim); ``active``:
    (max_seqs,) bool.  Inactive slots write to the reserved ``trash_page``
    so the scatter stays branch-free; their lengths do not advance.
    """
    lengths = cache.lengths
    logical = (lengths // cfg.page_size) % cfg.max_pages_per_seq
    offset = lengths % cfg.page_size
    phys = jnp.take_along_axis(cache.page_tables, logical[:, None], axis=1)[:, 0]
    phys = jnp.where(active, phys, trash_page)
    h = _head_index(cfg)

    def scatter(pages, scales, new):
        # new: (max_seqs, n_kv_heads, d) -> write at [:, phys[s], offset[s], :]
        vals = jnp.swapaxes(_pad_feature(new, cfg.head_dim_store), 0, 1)
        if cfg.is_int4:
            qv, sc = _quantize_tokens(vals, cfg.quant_dtype)   # (n_kv, S, d)
            brow = offset // 2
            nib = offset % 2
            old = pages[h, phys, brow].astype(jnp.int32)       # (n_kv, S, d)
            q32 = qv.astype(jnp.int32) & 0xF
            # even append owns the byte; odd append keeps the low nibble
            byte = jnp.where(nib[None, :, None] == 0,
                             q32, (old & 0xF) | (q32 << 4)).astype(jnp.int8)
            pages = pages.at[h, phys, brow].set(byte)
            scales = scales.at[h, phys, nib, brow].set(sc[..., 0])
            return pages, scales
        if cfg.quantized:
            qv, sc = _quantize_tokens(vals, cfg.quant_dtype)
            pages = pages.at[h, phys, offset].set(qv)
            # token-minor layout: slot s writes scales[:, phys[s], 0, offset[s]]
            scales = scales.at[h, phys, 0, offset].set(sc[..., 0])
            return pages, scales
        return pages.at[h, phys, offset].set(vals.astype(pages.dtype)), scales

    k_pages, k_scales = scatter(cache.k_pages, cache.k_scales, k_new)
    v_pages, v_scales = scatter(cache.v_pages, cache.v_scales, v_new)
    return dataclasses.replace(
        cache,
        k_pages=k_pages, v_pages=v_pages,
        k_scales=k_scales, v_scales=v_scales,
        lengths=cache.lengths + active.astype(jnp.int32),
    )


def gather_sequence_kv(cache: PagedKVCache, cfg: KVCacheConfig, slot: int,
                       length: Optional[int] = None):
    """Host-side: gather and dequantize one sequence's K/V from its pages.

    Returns ``(k, v)`` float32 of shape (n_kv_heads, length, head_dim) —
    exactly the values the decode kernel and the prefill path reconstruct,
    so their outputs can be checked against a dense oracle on these with
    tight tolerances (quantization error cancels out).  Test/debug utility.

    Rolling page tables (sliding-window sequences longer than the table):
    logical pages wrap modulo the table width, so tokens whose table slot
    has been reused return the OVERWRITING page's data — only the last
    window of a wrapped sequence is recoverable (which is all attention
    ever reads).
    """
    table = np.asarray(cache.page_tables)[slot]
    L = int(cache.lengths[slot]) if length is None else int(length)
    n_used = -(-L // cfg.page_size)
    kp = np.asarray(cache.k_pages)
    vp = np.asarray(cache.v_pages)
    ksc = np.asarray(cache.k_scales) if cfg.quantized else None
    vsc = np.asarray(cache.v_scales) if cfg.quantized else None

    def page_tokens(pages, scales, p):
        if cfg.is_int4:
            b = pages[:, p].astype(np.int32)          # (n_kv, page/2, d)
            even = ((b << 28) >> 28).astype(np.float32)
            odd = ((b << 24) >> 28).astype(np.float32)
            out = np.empty((b.shape[0], b.shape[1] * 2, b.shape[2]), np.float32)
            out[:, 0::2] = even * scales[:, p, 0][:, :, None]
            out[:, 1::2] = odd * scales[:, p, 1][:, :, None]
            return out
        if cfg.quantized:
            return pages[:, p].astype(np.float32) * scales[:, p, 0][:, :, None]
        return pages[:, p].astype(np.float32)

    mp = cfg.max_pages_per_seq
    ks = [page_tokens(kp, ksc, int(table[i % mp])) for i in range(n_used)]
    vs = [page_tokens(vp, vsc, int(table[i % mp])) for i in range(n_used)]
    k = np.concatenate(ks, axis=1)[:, :L, :cfg.head_dim]
    v = np.concatenate(vs, axis=1)[:, :L, :cfg.head_dim]
    return k, v


class PageAllocator:
    """Host-side free-list page allocator (the runtime's memory manager)."""

    def __init__(self, n_pages: int):
        self._free = list(range(n_pages - 1, -1, -1))
        self._owned = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, slot: int, n: int):
        if n > len(self._free):
            raise MemoryError(f"out of KV pages: want {n}, have {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        self._owned.setdefault(slot, []).extend(pages)
        return pages

    def owned(self, slot: int):
        return list(self._owned.get(slot, []))

    def free(self, slot: int):
        pages = self._owned.pop(slot, [])
        self._free.extend(reversed(pages))
        return pages
