"""Paged prefill attention (chunked prefill, q_len = chunk).

The prefill counterpart of ``decode.paged_decode_attention``: a chunk of
new query tokens for ONE sequence attends to that sequence's paged
(optionally quantized) KV cache, causally.  This is the attention behind
vLLM-style *chunked prefill* and *prefix caching* in the engine (no
reference counterpart — the reference, a stateless op library, has no
serving runtime; SURVEY.md §5):

* long prompts are processed ``prefill_chunk`` tokens at a time, so a
  prompt never holds the device for a full-sequence step — decode steps
  for other sequences interleave between chunks;
* a prompt whose page-aligned prefix is already cached (shared,
  refcounted pages) starts at ``start = cached_len`` and only the suffix
  is ever computed.

Chunked prefill is compute-bound: the (g·chunk × ctx) products dominate
and the page gather is small beside them.  So this is plain XLA — gather
and dequantize the live pages, then masked attention with an fp32
softmax (``decode.paged_attention_xla``) — whose matrix products XLA
hands to the GPU's libraries.  Causality and window rules are
per-element predicates on absolute positions, as everywhere in this
framework.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..mask_rules import CausalRule, MaskRule
from ..ops.kernel_common import LOG2E
from .decode import _first_live_page, paged_attention_xla
from .kv_cache import KVCacheConfig, PagedKVCache

__all__ = ["paged_prefill_attention"]


def paged_prefill_attention(
    q,
    cache: PagedKVCache,
    cfg: KVCacheConfig,
    slot,
    start,
    true_len,
    *,
    scale: Optional[float] = None,
    rule: MaskRule = CausalRule(),
    returning_l_m: bool = False,
    page_stride: int = 1,
    page_offset=None,
):
    """Causal attention of a prompt chunk against one sequence's paged cache.

    ``q``: (chunk, n_q_heads, head_dim) — queries for tokens at absolute
    positions ``start .. start+chunk``.  The chunk's own K/V must already
    be written to the cache (``kv_cache.write_tokens_at``); ``true_len``
    (a traced scalar) marks how many of the chunk's rows are real — rows
    past it are padding whose output is garbage and must be sliced off by
    the caller.  ``slot`` and ``start`` are traced scalars, so one
    compilation serves every (slot, chunk position).
    """
    chunk, n_q_heads, d = q.shape
    n_kv = cfg.n_kv_heads
    if n_q_heads % n_kv:
        raise ValueError(f"q heads {n_q_heads} not a multiple of kv heads {n_kv}")
    g = n_q_heads // n_kv
    d_pad = cfg.head_dim_store
    if scale is None:
        scale = 1.0 / np.sqrt(d)

    # chunk-minor rows: (chunk, n_kv, g, d) -> (n_kv, g*chunk, d), row r at
    # absolute position start + (r mod chunk)
    qg = jnp.swapaxes(q.reshape(chunk, n_kv, g, d), 0, 1)
    qg = jnp.swapaxes(qg, 1, 2).reshape(n_kv, g * chunk, d)
    qg = qg.astype(jnp.float32) * jnp.float32(scale * LOG2E)
    qg = jnp.pad(qg, ((0, 0), (0, 0), (0, d_pad - d)))[None]

    start = jnp.asarray(start, jnp.int32)
    total = start + jnp.asarray(true_len, jnp.int32)
    offset = (jnp.asarray(0, jnp.int32) if page_offset is None
              else jnp.asarray(page_offset, jnp.int32))
    n_global = -(-total // cfg.page_size)
    if page_stride == 1:
        count = n_global
    else:
        # local pages on this shard: global pages g with g % stride == offset
        count = jnp.where(n_global > offset,
                          (n_global - offset + page_stride - 1) // page_stride, 0)
    first = _first_live_page(rule, start + 1, 1, cfg.page_size,
                             page_stride, offset)
    q_pos = start + jnp.arange(g * chunk, dtype=jnp.int32) % chunk
    table = jnp.asarray(cache.page_tables)[jnp.asarray(slot, jnp.int32)]
    o, l, m = paged_attention_xla(
        qg, cache, cfg, table[None], first.reshape(1),
        count.astype(jnp.int32).reshape(1), q_pos[None], rule=rule,
        total=total.reshape(1), page_stride=page_stride, offset=offset)

    def chunkify(x):
        x = x[0].reshape((n_kv, g, chunk) + x.shape[3:])
        x = jnp.moveaxis(x, 2, 0)                  # (chunk, n_kv, g, ...)
        return x.reshape((chunk, n_q_heads) + x.shape[3:])

    o = chunkify(o[..., :d]).astype(q.dtype)
    if returning_l_m:
        return o, chunkify(l), chunkify(m)
    return o
