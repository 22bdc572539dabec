"""Paged decode attention (q_len = 1, INT8/FP8/INT4/bf16 KV, GQA).

The served path's per-token cost: one new query token per sequence
attends to its paged, optionally quantized KV cache.  Decode reads every
live KV byte once and does little arithmetic on it, so it is bound by
device-memory bandwidth; the kernel's job is to read the cache in its
stored bytes and nothing else.

* ``paged_decode_attention`` — the Triton kernel.  One program owns one
  (sequence, kv head).  It reads its row of the page table, its page
  count and its first live page, and loops over the live pages in tiles
  of ``block_rows`` tokens, carrying the fp32 online-softmax state in
  registers.  Pages below a ``LocalRule`` window are skipped before any
  load.  Quantized pages are dequantized in registers and *post-scaled*:
  the (rows, d) payload tile is only cast to bf16, and the per-token
  scales multiply the small (group, rows) score and probability tiles
  (K scales into the logits, V scales into the probabilities before the
  PV product).  INT4 pages (two tokens per byte, ``kv_cache.py``) are
  sign-extended with shifts and attended as even/odd half-tiles under one
  online softmax.  GQA: the ``g`` query heads of a KV head are the rows of
  one (g, d) @ (d, rows) product.
* ``paged_multitoken_decode`` — speculative verification (``gamma`` query
  rows per slot), off the default path: plain XLA over the gathered,
  dequantized pages (``paged_attention_xla``).
* ``paged_attention_xla`` — the plain version of both: gather the live
  pages into new arrays, dequantize, run masked attention with an fp32
  softmax.  It is the reference the kernel is checked and timed against.

``returning_l_m`` returns the per-row online-softmax statistics
``(o, l, m)`` with ``m`` in the base-2 domain, so partial attentions over
disjoint KV shards merge exactly (sequence-sharded decode).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from ..block_sizes import next_pow2
from ..mask_rules import CausalRule, LocalRule, MaskRule
from ..ops.backend import ROUTE, compiler_params, default_interpret
from ..ops.kernel_common import LOG2E, NEG_INF_F32, dot_nn, dot_nt
from .kv_cache import KVCacheConfig, PagedKVCache, _unpack_nibbles

__all__ = ["paged_decode_attention", "paged_multitoken_decode",
           "paged_attention_xla"]


def _rule_visible(rule, q_pos, kv_pos):
    """Element predicate: may kv_pos feed the query row at q_pos?

    Left-to-right ordering (kv_pos <= q_pos) is always enforced — at a
    decode step the tokens to the right of a row do not exist yet — and a
    ``LocalRule`` adds its strided-window constraint on the distance
    (``mask_rules.LocalRule.check`` semantics on 1d token positions).
    """
    ok = kv_pos <= q_pos
    if isinstance(rule, LocalRule):
        diff = q_pos - kv_pos
        ok = jnp.logical_and(ok, (diff >> rule.log2_stride_size) < rule.window_size)
        if rule.log2_stride_size:
            ok = jnp.logical_and(ok, (diff & rule.remainder_mask) == 0)
    return ok


def _first_live_page(rule, lengths, gamma, page_size, stride=1, offset=0):
    """Per-slot LOCAL index of the first page the rule can see
    (skip-before-load).

    The oldest query row sits at GLOBAL position ``length - gamma``; a
    LocalRule cannot see kv below ``oldest - (strided_window - 1)``.  With
    sequence sharding (``stride`` = number of shards, ``offset`` = this
    shard's index) local page j holds global page ``j*stride + offset``,
    so the first live local page is the count of local pages strictly
    below the global first-live page.
    """
    if isinstance(rule, LocalRule):
        lo = jnp.maximum(0, lengths - gamma - (rule.strided_window_size - 1))
        gfp = lo // page_size
        if stride == 1:
            return gfp.astype(jnp.int32)
        local = jnp.where(gfp > offset, (gfp - offset + stride - 1) // stride, 0)
        return local.astype(jnp.int32)
    return jnp.zeros_like(lengths, jnp.int32)


def _decode_kernel(
    tables_ref, starts_ref, counts_ref, lengths_ref, offset_ref,
    q_ref, k_ref, ks_ref, v_ref, vs_ref,
    o_ref, l_ref, m_ref,
    *,
    page_size: int,
    max_pages: int,
    block_rows: int,
    pack: int,
    quantized: bool,
    rule: MaskRule,
    page_stride: int,
):
    b = pl.program_id(0)
    h = pl.program_id(1)
    page_rows = page_size // pack
    n_sub = page_rows // block_rows
    start = starts_ref[b]
    n_tiles = (counts_ref[b] - start) * n_sub
    q_pos = lengths_ref[b] - 1          # the one query row's GLOBAL position
    offset = offset_ref[0]
    q = q_ref[...]                       # (g_pad, d), prescaled by scale·log2e
    cdt = jnp.bfloat16 if quantized else k_ref.dtype
    q = q.astype(cdt)
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, block_rows), 1)

    def body(i, carry):
        acc, m_prev, l_prev = carry
        lp = start + jax.lax.div(i, jnp.int32(n_sub))
        sub = jax.lax.rem(i, jnp.int32(n_sub))
        # rolling table: logical pages wrap modulo the table width
        phys = tables_ref[b * max_pages + jax.lax.rem(lp, jnp.int32(max_pages))]
        gp = lp * page_stride + offset               # global page index
        rows = pl.ds(pl.multiple_of(sub * block_rows, block_rows), block_rows)
        k = k_ref[h, phys, rows, :]
        v = v_ref[h, phys, rows, :]
        if pack == 2:
            ke, ko = _unpack_nibbles(k)
            ve, vo = _unpack_nibbles(v)
            halves = ((ke, ve, 0), (ko, vo, 1))
        else:
            halves = ((k, v, 0),)
        parts = []
        for kh, vh, nib in halves:
            s = dot_nt(q, kh.astype(cdt))            # (g_pad, block_rows)
            if quantized:
                s = s * ks_ref[h, phys, nib, rows][None, :]
            tok = gp * page_size + nib + pack * (sub * block_rows + iota)
            s = jnp.where(_rule_visible(rule, q_pos, tok), s, NEG_INF_F32)
            parts.append((s, vh, nib))
        m_curr = jnp.max(parts[0][0], axis=1)
        for s, _, _ in parts[1:]:
            m_curr = jnp.maximum(m_curr, jnp.max(s, axis=1))
        m_next = jnp.maximum(m_prev, m_curr)
        alpha = jnp.exp2(m_prev - m_next)
        # a row with no visible key yet keeps m at the masking floor, where
        # exp2(s - m) of its masked entries would be 1: zero such rows
        # (a LocalRule can put a row's first live key past the first tile)
        live = (m_next > jnp.float32(NEG_INF_F32 * 0.5))[:, None]
        l_next = alpha * l_prev
        acc = acc * alpha[:, None]
        for s, vh, nib in parts:
            p = jnp.where(live, jnp.exp2(s - m_next[:, None]), 0.0)
            l_next = l_next + jnp.sum(p, axis=1)
            if quantized:
                p = p * vs_ref[h, phys, nib, rows][None, :]
            acc = acc + dot_nn(p.astype(cdt), vh.astype(cdt))
        return acc, m_next, l_next

    g_pad = q.shape[0]
    init = (jnp.zeros((g_pad, o_ref.shape[1]), jnp.float32),
            jnp.full((g_pad,), NEG_INF_F32, jnp.float32),
            jnp.zeros((g_pad,), jnp.float32))
    acc, m_i, l_i = jax.lax.fori_loop(0, n_tiles, body, init)
    l_safe = jnp.where(l_i == 0.0, 1.0, l_i)
    o_ref[...] = (acc / l_safe[:, None]).astype(o_ref.dtype)
    l_ref[...] = l_i
    m_ref[...] = m_i


def _block_rows(cfg: KVCacheConfig) -> int:
    """Tokens (byte rows for int4) per kernel tile: a power of two that
    divides the page."""
    want = 128 if jnp.dtype(cfg.payload_dtype).itemsize == 1 else 64
    rows = cfg.page_rows
    return min(want, rows & -rows)


def paged_decode_attention(
    q: jax.Array,
    cache: PagedKVCache,
    cfg: KVCacheConfig,
    *,
    scale: Optional[float] = None,
    rule: MaskRule = CausalRule(),
    returning_l_m: bool = False,
    page_stride: int = 1,
    page_offset=None,
    global_lengths=None,
    interpret: Optional[bool] = None,
):
    """One decode step of attention against the paged cache.

    ``q``: (max_seqs, n_q_heads, head_dim) — the current token's queries.
    Returns ``o`` of the same shape.  Sequences with length 0 yield zeros.

    Sequence sharding (``seq_sharded_decode.py``): when the cache holds
    every ``page_stride``-th global page starting at ``page_offset``
    (a traced scalar), pass ``global_lengths`` so masking and window
    skipping run on global token positions while page counts stay local.

    ``rule``: Full and Causal behave identically at decode (left-to-right
    ordering is always enforced); ``LocalRule`` restricts each query to
    its strided window and pages below the window are never loaded.
    """
    if interpret is None:
        interpret = default_interpret()
    max_seqs, n_q_heads, d = q.shape
    n_kv = cfg.n_kv_heads
    if n_q_heads % n_kv:
        raise ValueError(f"q heads {n_q_heads} not a multiple of kv heads {n_kv}")
    g = n_q_heads // n_kv
    g_pad = max(16, next_pow2(g))
    d_pad = cfg.head_dim_store
    assert cache.k_pages.shape[-1] == d_pad, (cache.k_pages.shape, d_pad)
    if scale is None:
        scale = 1.0 / np.sqrt(d)

    # scale·log2(e) folded into q: the kernel's logits feed exp2 directly
    qg = (q.astype(jnp.float32) * jnp.float32(scale * LOG2E)).astype(q.dtype)
    qg = qg.reshape(max_seqs, n_kv, g, d)
    qg = jnp.pad(qg, ((0, 0), (0, 0), (0, g_pad - g), (0, d_pad - d)))

    glob_len = cache.lengths if global_lengths is None else global_lengths
    offset = jnp.zeros((1,), jnp.int32) if page_offset is None else (
        jnp.asarray(page_offset, jnp.int32).reshape(1))
    counts = -(-cache.lengths // cfg.page_size)
    starts = _first_live_page(rule, glob_len, 1, cfg.page_size,
                              page_stride, offset[0])
    k_scales, v_scales = cache.k_scales, cache.v_scales
    if not cfg.quantized:
        # placeholders keep the kernel signature uniform; never read
        k_scales = v_scales = jnp.ones((1,), jnp.float32)

    whole = pl.BlockSpec()
    per_head = lambda *tail: pl.BlockSpec(
        (None, None) + tail, lambda b, h: (b, h) + (0,) * len(tail))
    kernel = functools.partial(
        _decode_kernel, page_size=cfg.page_size,
        max_pages=cfg.max_pages_per_seq, block_rows=_block_rows(cfg),
        pack=cfg.tok_pack, quantized=cfg.quantized, rule=rule,
        page_stride=page_stride)
    o, l, m = pl.pallas_call(
        kernel,
        grid=(max_seqs, n_kv),
        in_specs=[whole] * 5 + [per_head(g_pad, d_pad)] + [whole] * 4,
        out_specs=[per_head(g_pad, d_pad), per_head(g_pad), per_head(g_pad)],
        out_shape=[
            jax.ShapeDtypeStruct((max_seqs, n_kv, g_pad, d_pad), q.dtype),
            jax.ShapeDtypeStruct((max_seqs, n_kv, g_pad), jnp.float32),
            jax.ShapeDtypeStruct((max_seqs, n_kv, g_pad), jnp.float32),
        ],
        backend=ROUTE,
        compiler_params=compiler_params(num_warps=4, num_stages=2),
        interpret=interpret,
        name="fa_paged_decode",
    )(jnp.asarray(cache.page_tables, jnp.int32).reshape(-1), starts,
      counts.astype(jnp.int32), glob_len.astype(jnp.int32), offset,
      qg, cache.k_pages, k_scales, cache.v_pages, v_scales)

    o = o[:, :, :g, :d].reshape(max_seqs, n_q_heads, d)
    if returning_l_m:
        return (o, l[:, :, :g].reshape(max_seqs, n_q_heads),
                m[:, :, :g].reshape(max_seqs, n_q_heads))
    return o


def _dequantized_pages(cache: PagedKVCache, cfg: KVCacheConfig, phys):
    """K/V of physical pages ``phys`` (any int shape ``P``), dequantized to
    float32 in token order: ``(n_kv, *P, page_size, d_store)`` each."""

    def deq(pages, scales):
        x = pages[:, phys]                        # (n_kv, *P, rows, d)
        if cfg.is_int4:
            even, odd = _unpack_nibbles(x)
            x = jnp.stack([even, odd], axis=-2)   # (..., rows, 2, d)
            x = x.reshape(x.shape[:-3] + (cfg.page_size, x.shape[-1]))
        x = x.astype(jnp.float32)
        if cfg.quantized:
            sc = scales[:, phys]                  # (n_kv, *P, pack, rows)
            sc = jnp.swapaxes(sc, -1, -2).reshape(sc.shape[:-2] + (cfg.page_size,))
            x = x * sc[..., None]
        return x

    return deq(cache.k_pages, cache.k_scales), deq(cache.v_pages, cache.v_scales)


def paged_attention_xla(qg, cache, cfg, tables, first, counts, q_pos, *,
                        rule: MaskRule, total=None, page_stride: int = 1,
                        offset=0):
    """Plain XLA paged attention: gather, dequantize, masked softmax.

    ``qg``: (R, n_kv, rows, d_store), already scaled by ``scale·log2e``;
    ``tables``: (R, max_pages) page-table rows; ``first``/``counts``: (R,)
    LOCAL first live page and page count; ``q_pos``: (R, rows) GLOBAL
    query positions; ``total`` (optional, (R,)) bounds the visible keys.
    Returns ``(o, l, m)`` — (R, n_kv, rows, d_store) and (R, n_kv, rows)
    float32, ``m`` in the base-2 domain, rows with no visible key give
    ``o = 0, l = 0, m = NEG_INF``.
    """
    max_pages = cfg.max_pages_per_seq
    lp = first[:, None] + jnp.arange(max_pages, dtype=jnp.int32)[None, :]
    page_ok = lp < counts[:, None]                          # (R, P)
    phys = jnp.take_along_axis(tables, lp % max_pages, axis=1)
    k, v = _dequantized_pages(cache, cfg, phys)             # (n_kv, R, P, ps, d)
    R = qg.shape[0]
    T = max_pages * cfg.page_size
    k = k.reshape(k.shape[0], R, T, k.shape[-1])
    v = v.reshape(v.shape[0], R, T, v.shape[-1])
    gp = lp * page_stride + offset
    kv_pos = (gp[:, :, None] * cfg.page_size
              + jnp.arange(cfg.page_size, dtype=jnp.int32)).reshape(R, T)
    kv_ok = jnp.repeat(page_ok, cfg.page_size, axis=1)
    if total is not None:
        kv_ok = kv_ok & (kv_pos < total[:, None])
    s = jnp.einsum("bhrd,hbtd->bhrt", qg.astype(jnp.float32), k,
                   precision="highest")
    mask = (kv_ok[:, None, None, :]
            & _rule_visible(rule, q_pos[:, None, :, None],
                            kv_pos[:, None, None, :]))
    s = jnp.where(mask, s, NEG_INF_F32)
    m = jnp.max(s, axis=-1)
    p = jnp.where(mask, jnp.exp2(s - m[..., None]), 0.0)
    l = jnp.sum(p, axis=-1)
    o = jnp.einsum("bhrt,hbtd->bhrd", p, v, precision="highest")
    o = o / jnp.where(l == 0.0, 1.0, l)[..., None]
    return o, l, m


def paged_multitoken_decode(
    q: jax.Array,
    cache: PagedKVCache,
    cfg: KVCacheConfig,
    *,
    scale: Optional[float] = None,
    rule: MaskRule = CausalRule(),
    returning_l_m: bool = False,
    page_stride: int = 1,
    page_offset=None,
    global_lengths=None,
):
    """Speculative verification attention: ``gamma`` tokens per slot.

    ``q``: (max_seqs, gamma, n_q_heads, head_dim) — queries for the
    gamma draft tokens sitting at absolute positions
    ``lengths - gamma .. lengths`` of each slot (their K/V must already be
    appended, so ``cache.lengths`` INCLUDES the drafts).  Draft i attends
    causally through position ``lengths - gamma + i``.  Returns
    (max_seqs, gamma, n_q_heads, head_dim).  Plain XLA: speculative
    decoding is off the default serving path.
    """
    max_seqs, gamma, n_q_heads, d = q.shape
    n_kv = cfg.n_kv_heads
    if n_q_heads % n_kv:
        raise ValueError(f"q heads {n_q_heads} not a multiple of kv heads {n_kv}")
    g = n_q_heads // n_kv
    d_pad = cfg.head_dim_store
    if scale is None:
        scale = 1.0 / np.sqrt(d)

    # gamma-minor rows: row r = head_in_group * gamma + draft_index
    qg = q.reshape(max_seqs, gamma, n_kv, g, d).astype(jnp.float32)
    qg = jnp.transpose(qg, (0, 2, 3, 1, 4)).reshape(max_seqs, n_kv, g * gamma, d)
    qg = jnp.pad(qg * jnp.float32(scale * LOG2E),
                 ((0, 0), (0, 0), (0, 0), (0, d_pad - d)))

    glob_len = cache.lengths if global_lengths is None else global_lengths
    offset = 0 if page_offset is None else jnp.asarray(page_offset, jnp.int32)
    counts = -(-cache.lengths // cfg.page_size)
    first = _first_live_page(rule, glob_len, gamma, cfg.page_size,
                             page_stride, offset)
    draft = jnp.arange(g * gamma, dtype=jnp.int32) % gamma
    q_pos = glob_len[:, None] - gamma + draft[None, :]
    o, l, m = paged_attention_xla(
        qg, cache, cfg, cache.page_tables, first, counts.astype(jnp.int32),
        q_pos, rule=rule, page_stride=page_stride, offset=offset)

    def rowsplit(x):
        x = x.reshape((max_seqs, n_kv, g, gamma) + x.shape[3:])
        x = jnp.moveaxis(x, 3, 1)                 # (S, gamma, n_kv, g, ...)
        return x.reshape((max_seqs, gamma, n_q_heads) + x.shape[4:])

    o = rowsplit(o[..., :d]).astype(q.dtype)
    if returning_l_m:
        return o, rowsplit(l), rowsplit(m)
    return o
