"""Sequence-sharded (context-parallel) paged decode.

The long-context serving topology from SURVEY §2's parallelism inventory:
the KV cache is sharded **along the sequence** over a mesh axis, so a
context larger than one chip's HBM spreads across the slice and every
chip streams only its own pages.  Each chip runs the ordinary paged
decode kernel over its local pages, producing partial ``(o, l, m)``
online-softmax statistics; one tiny ``psum`` merges them exactly — the
same (m, l, O) merge the training-path ring attention uses per hop
(``parallel/ring.py``), and mathematically the reference's online merge
(``flash_attention.cu:974-1035``) applied across chips instead of across
tiles.  The collective payload is (seqs, heads, d) — independent of
context length — so its cost is negligible next to the cache scan it
parallelises.

Placement is round-robin at page granularity: global logical page ``g``
of a sequence lives on shard ``g % n_shards`` at local logical index
``g // n_shards``.  Consequences:

* load balance: a growing sequence's pages spread evenly, so every chip
  scans ~``ctx / n_shards`` tokens per step;
* the *local* page stream of every shard stays dense (full pages plus one
  growing tail page on the tail's owner), so local page counts drive the
  grid while the kernels reconstruct **global** token positions from the
  placement (``global page = local page * n_shards + shard``, the
  ``page_stride``/``page_offset`` kernel arguments) — masking rules,
  including LocalRule windows with their skip-before-load page pruning,
  apply unchanged across shards.

Appends route to the single owner shard of the written position via the
batched-append kernel's ``active`` mask (inactive shards write their
trash page); the owner is derived inside ``shard_map`` from the global
length ``psum(local lengths)`` — no host bookkeeping beyond page-table
mapping.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..mask_rules import CausalRule, MaskRule
from .decode import paged_decode_attention
from .kv_cache import KVCacheConfig, PagedKVCache, append_tokens_batched, write_prompt
from .prefill import paged_prefill_attention

__all__ = ["create_seq_sharded_cache", "write_prompt_seq_sharded",
           "seq_sharded_paged_decode", "seq_sharded_paged_prefill",
           "seq_sharded_append"]


def _shard_pspec(cfg: KVCacheConfig, axis: str,
                 head_axis=None) -> PagedKVCache:
    """Leading dim sharded over ``axis``; optionally the KV-head dim (axis
    1 of the page/scale arrays) over ``head_axis`` (TP x CP composition).
    Tables and lengths replicate over the head axis."""
    pages = P(axis, head_axis)
    lead = P(axis)
    return PagedKVCache(
        k_pages=pages, v_pages=pages,
        k_scales=pages if cfg.quantized else None,
        v_scales=pages if cfg.quantized else None,
        page_tables=lead, lengths=lead)


def create_seq_sharded_cache(cfg: KVCacheConfig, mesh: Mesh, axis: str,
                             head_axis=None) -> PagedKVCache:
    """A PagedKVCache whose every array gains a leading shard dimension
    sharded over ``axis``.  ``cfg`` describes ONE shard (its ``n_pages``/
    ``max_pages_per_seq`` are per-shard capacities).  With ``head_axis``
    the KV-head dim additionally shards over that mesh axis (TP x CP)."""
    n = int(mesh.shape[axis])
    specs = _shard_pspec(cfg, axis, head_axis)
    shardings = jax.tree.map(
        lambda s: None if s is None else NamedSharding(mesh, s), specs,
        is_leaf=lambda x: x is None or isinstance(x, P))

    def init():
        local = PagedKVCache.create(cfg)
        return jax.tree.map(
            lambda x: None if x is None
            else jnp.broadcast_to(x[None], (n,) + x.shape),
            local, is_leaf=lambda x: x is None)

    # materialize directly with the target sharding: never builds the
    # n-fold cache on the host (for the workloads CP exists for, the full
    # cache does not fit one device, let alone host RAM x n)
    return jax.jit(init, out_shardings=shardings)()


def write_prompt_seq_sharded(cache: PagedKVCache, cfg: KVCacheConfig,
                             mesh: Mesh, axis: str, slot: int,
                             per_shard_pages, k: jax.Array, v: jax.Array
                             ) -> PagedKVCache:
    """Write a prompt's K/V round-robin across shards (host-side setup).

    ``per_shard_pages[r]`` lists shard ``r``'s free physical pages to use
    (host ints, as from a per-shard ``PageAllocator``).  ``k, v``:
    (n_kv_heads, t, head_dim).
    """
    n = int(mesh.shape[axis])
    ps = cfg.page_size
    t = k.shape[1]
    n_global = -(-t // ps)
    shards = []
    for r in range(n):
        local = jax.tree.map(
            lambda x: x[r] if x is not None else None, cache,
            is_leaf=lambda x: x is None)
        g_pages = list(range(r, n_global, n))          # global pages on r
        if g_pages:
            kparts = [k[:, g * ps:(g + 1) * ps] for g in g_pages]
            vparts = [v[:, g * ps:(g + 1) * ps] for g in g_pages]
            k_loc = jnp.concatenate(kparts, axis=1)
            v_loc = jnp.concatenate(vparts, axis=1)
            local = write_prompt(local, cfg, slot,
                                 np.asarray(per_shard_pages[r][:len(g_pages)]),
                                 k_loc, v_loc)
        shards.append(local)
    stacked = jax.tree.map(
        lambda *xs: None if xs[0] is None else jnp.stack(xs), *shards,
        is_leaf=lambda x: x is None)
    specs = _shard_pspec(cfg, axis)
    return jax.tree.map(
        lambda x, s: None if x is None
        else jax.device_put(x, NamedSharding(mesh, s)),
        stacked, specs, is_leaf=lambda x: x is None)


def _merge_partials(o, l, m, axis):
    """Exact cross-shard online-softmax merge (base-2 domain, as in the
    kernels): the reference's (m, l, O) merge applied across chips."""
    m_star = jax.lax.pmax(m, axis)
    w = l * jnp.exp2(m - m_star)              # 0 for shards with no keys
    num = jax.lax.psum(o.astype(jnp.float32) * w[..., None], axis)
    den = jax.lax.psum(w, axis)[..., None]
    return num / jnp.where(den == 0.0, 1.0, den)


def seq_sharded_paged_decode(mesh: Mesh, cfg: KVCacheConfig, axis: str,
                             *, scale: Optional[float] = None,
                             rule: MaskRule = CausalRule(),
                             interpret: Optional[bool] = None):
    """Build ``fn(q, cache) -> o``: context-parallel decode over ``axis``.

    ``q`` replicated (max_seqs, n_q_heads, d); ``cache`` from
    ``create_seq_sharded_cache``/``write_prompt_seq_sharded``.  Window
    rules work: the kernel masks on global positions (page stride/offset)
    and each shard skips its pages below the window before any load.
    """
    n = int(mesh.shape[axis])
    cache_specs = _shard_pspec(cfg, axis)

    def local_fn(q, cache):
        local = jax.tree.map(lambda x: x[0] if x is not None else None,
                             cache, is_leaf=lambda x: x is None)
        glob_len = jax.lax.psum(local.lengths, axis)
        o, l, m = paged_decode_attention(
            q, local, cfg, scale=scale, rule=rule, returning_l_m=True,
            page_stride=n, page_offset=jax.lax.axis_index(axis),
            global_lengths=glob_len, interpret=interpret)
        return _merge_partials(o, l, m, axis).astype(q.dtype)

    return jax.jit(
        shard_map(
            local_fn, mesh=mesh,
            in_specs=(P(), cache_specs),
            out_specs=P(),
            check_vma=False,
        )
    )


def seq_sharded_paged_prefill(mesh: Mesh, cfg: KVCacheConfig, axis: str,
                              *, scale: Optional[float] = None,
                              rule: MaskRule = CausalRule()):
    """Build ``fn(q, cache, slot, start, true_len) -> o``: context-parallel
    chunked prefill — every chip scans its own pages for the whole chunk
    and the per-row partials merge with one psum, so long-prompt prefill
    compute AND bandwidth scale with the slice.  The chunk's K/V must
    already be written (round-robin, like the rest of the cache).
    """
    n = int(mesh.shape[axis])
    cache_specs = _shard_pspec(cfg, axis)

    def local_fn(q, cache, slot, start, true_len):
        local = jax.tree.map(lambda x: x[0] if x is not None else None,
                             cache, is_leaf=lambda x: x is None)
        o, l, m = paged_prefill_attention(
            q, local, cfg, slot, start, true_len, scale=scale, rule=rule,
            returning_l_m=True, page_stride=n,
            page_offset=jax.lax.axis_index(axis))
        return _merge_partials(o, l, m, axis).astype(q.dtype)

    return jax.jit(
        shard_map(
            local_fn, mesh=mesh,
            in_specs=(P(), cache_specs, P(), P(), P()),
            out_specs=P(),
            check_vma=False,
        )
    )


def seq_sharded_append(mesh: Mesh, cfg: KVCacheConfig, axis: str,
                       trash_page: int):
    """Build ``fn(cache, k_new, v_new, active) -> cache``: one decode-step
    append routed to each position's owner shard.

    ``k_new, v_new``: (max_seqs, n_kv_heads, head_dim) replicated.  The
    target page of every slot must already be mapped in the owner shard's
    local table (the caller's ``_ensure_capacity`` analog).
    """
    n = int(mesh.shape[axis])
    cache_specs = _shard_pspec(cfg, axis)

    def local_fn(cache, k_new, v_new, active):
        local = jax.tree.map(lambda x: x[0] if x is not None else None,
                             cache, is_leaf=lambda x: x is None)
        me = jax.lax.axis_index(axis)
        global_len = jax.lax.psum(local.lengths, axis)   # (max_seqs,)
        owner = (global_len // cfg.page_size) % n
        mine = jnp.logical_and(active, owner == me)
        new = append_tokens_batched(local, cfg, k_new, v_new, mine,
                                    trash_page)
        return jax.tree.map(lambda x: x[None] if x is not None else None,
                            new, is_leaf=lambda x: x is None)

    return jax.jit(
        shard_map(
            local_fn, mesh=mesh,
            in_specs=(cache_specs, P(), P(), P()),
            out_specs=cache_specs,
            check_vma=False,
        ),
        donate_argnums=(0,),
    )
