"""Multi-device decode: heads + quantized KV cache sharded over ``model``.

Every device holds the KV pages of its head shard (including their INT8
scales) and runs the paged decode kernel on its local heads — **zero
collectives inside attention**; the surrounding projections perform the
usual tensor-parallel reduce.  Page tables and lengths are tiny and
replicated.  Across hosts the same mesh simply spans multiple processes
(``jax.distributed``); sharding specs are unchanged — axis placement is
the only control surface.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..parallel.mesh import AXIS_MODEL
from .decode import paged_decode_attention
from .kv_cache import KVCacheConfig, PagedKVCache

__all__ = ["sharded_paged_decode"]


def sharded_paged_decode(
    mesh: Mesh,
    cfg: KVCacheConfig,
    *,
    model_axis: str = AXIS_MODEL,
    scale: Optional[float] = None,
    interpret: Optional[bool] = None,
):
    """Build a jitted head-sharded paged-decode callable.

    Returns ``fn(q, cache) -> o`` with ``q: (max_seqs, n_q_heads, d)``;
    the cache's head dimension (axis 0 of the page arrays) is sharded over
    ``model_axis``.
    """
    tp = int(mesh.shape[model_axis])
    if cfg.n_kv_heads % tp:
        raise ValueError(f"n_kv_heads {cfg.n_kv_heads} not divisible by tp {tp}")
    local_cfg = dataclasses.replace(cfg, n_kv_heads=cfg.n_kv_heads // tp)

    heads_spec = P(None, model_axis, None)
    pages_spec = P(model_axis, None, None, None)
    repl = P()
    cache_specs = PagedKVCache(
        k_pages=pages_spec, v_pages=pages_spec,
        k_scales=pages_spec if cfg.quantized else None,
        v_scales=pages_spec if cfg.quantized else None,
        page_tables=repl, lengths=repl,
    )

    def local_fn(q, cache):
        return paged_decode_attention(
            q, cache, local_cfg, scale=scale, interpret=interpret)

    return jax.jit(
        shard_map(
            local_fn,
            mesh=mesh,
            in_specs=(heads_spec, cache_specs),
            out_specs=heads_spec,
            check_vma=False,
        )
    )
