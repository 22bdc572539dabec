"""Continuous-batching decode engine for the flagship transformer.

Multi-sequence serving loop (BASELINE north star; no reference
counterpart): prompts are prefetched through the training-path flash
kernel, their K/V written into the paged (optionally INT8) cache, and all
active sequences then advance one token per ``step()`` through the paged
decode kernel — new requests are admitted into free slots between steps
(continuous batching), finished sequences retire and release their pages.

jit boundaries: ``prefill`` is compiled per prompt-length bucket (prompts
pad up to the bucket); ``decode_step`` compiles once for the static
(max_seqs, …) shapes.  Admission/retirement/page management run on the
host between steps (the scheduler in ``scheduler.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..mask_rules import LocalRule
from ..ops.backend import default_interpret
from ..models.transformer import ModelConfig, _mlp_block, _rms_norm
from ..parallel.sharded import mha
from .decode import paged_decode_attention, paged_multitoken_decode
from .kv_cache import (
    KVCacheConfig,
    PagedKVCache,
    append_tokens_batched,
    assign_page,
    write_prompt,
    write_tokens_at,
)
from .prefill import paged_prefill_attention
from .seq_sharded_decode import _merge_partials
from .prefix_cache import PrefixCache, SharedPageAllocator
from .sampling import SamplingParams, sample_tokens
from .scheduler import Request, Scheduler

__all__ = ["EngineConfig", "DecodeEngine"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_seqs: int = 4
    page_size: int = 128
    n_pages: int = 64           # includes 1 reserved trash page
    max_pages_per_seq: int = 16
    quantized_kv: bool = True
    # int8 (default), float8_e4m3fn, or "int4" (nibble-packed; halves the
    # decode-path HBM traffic again vs int8 — decode is bandwidth-bound)
    kv_quant_dtype: object = jnp.int8
    prefill_buckets: tuple = (128, 512)
    seed: int = 0               # PRNG seed for sampled requests
    # "chunked": prompts run prefill_chunk tokens at a time through the
    # paged prefill path (bounded step latency; enables prefix caching).
    # "bucketed": whole prompt in one padded pass through the training
    # kernel (legacy path, kept as a cross-check).
    prefill_mode: str = "chunked"
    prefill_chunk: int = 128
    prefix_caching: bool = True  # chunked mode only
    # speculative decoding: number of draft tokens per step proposed by
    # prompt-lookup (n-gram) self-speculation; 0 disables.  Greedy slots
    # verify losslessly (output identical to non-speculative greedy);
    # sampled slots fall back to 1 token/step within the same batch.
    speculative_tokens: int = 0
    spec_lookup_window: int = 512  # n-gram search window (host)


def _rope_at_batch(x, pos, theta):
    """Rotary embedding for token grids: x (S, T, h, d), pos (S, T)."""
    S, T, h, d = x.shape
    return _rope_at(x.reshape(S * T, h, d), pos.reshape(S * T), theta
                    ).reshape(S, T, h, d)


def _rope_at(x, pos, theta):
    """Rotary embedding for single tokens: x (S, h, d), pos (S,)."""
    S, h, d = x.shape
    half = d // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    angles = pos.astype(jnp.float32)[:, None] * freqs[None, :]
    cos = jnp.cos(angles)[:, None, :].astype(x.dtype)
    sin = jnp.sin(angles)[:, None, :].astype(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return jnp.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], axis=-1)


class DecodeEngine:
    """Continuous-batching engine; optionally tensor- or context-parallel.

    Tensor parallel — ``mesh`` with a ``model`` axis: parameters shard
    Megatron-style (wq/wk/wv/w1/w3 column, wo/w2 row), the paged KV cache
    shards on its head axis (each chip holds its head shard's pages AND
    their INT8 scales — zero collectives inside attention), and every
    compiled step runs under ``shard_map`` with one ``psum`` per
    projection.  Across hosts the same specs span processes via
    ``jax.distributed`` — axis placement is the only control surface.

    Context parallel — ``mesh`` with a ``seq`` axis: KV pages place
    round-robin across chips (``n_pages`` is per shard), every chip scans
    only its own pages in decode/prefill, and the per-row ``(o, l, m)``
    partials merge with one tiny ``psum`` per layer — context capacity
    and attention bandwidth both scale with the slice.  Writes route to
    each position's owner shard inside the compiled steps (chunk writes
    trash non-owned pages; appends use the owner mask).  Composes with
    chunked prefill and speculative decoding; exact greedy parity with
    the single-chip engine.
    """

    def __init__(self, model_cfg: ModelConfig, params, engine_cfg: EngineConfig = EngineConfig(),
                 interpret: Optional[bool] = None, mesh=None, model_axis: str = "model",
                 seq_axis: str = "seq"):
        self.mcfg = model_cfg
        self.ecfg = engine_cfg
        self.params = params
        self.interpret = default_interpret() if interpret is None else interpret

        self.mesh = mesh
        axes = dict(mesh.shape) if mesh is not None else {}
        tp = int(axes.get(model_axis, 1))
        cp = int(axes.get(seq_axis, 1))
        self._tp_axis = model_axis if tp > 1 else None
        self.tp = tp
        self.cp = cp
        self._seq_axis = seq_axis if cp > 1 else None
        if tp > 1:
            if model_cfg.n_heads % tp or model_cfg.n_kv_heads % tp:
                raise ValueError(
                    f"heads ({model_cfg.n_heads}/{model_cfg.n_kv_heads}) not "
                    f"divisible by tensor-parallel degree {tp}")
            if model_cfg.n_experts:
                raise ValueError("tensor-parallel engine does not support MoE")
            if engine_cfg.prefill_mode != "chunked":
                raise ValueError("tensor-parallel engine requires chunked prefill")
        rule = model_cfg.rule
        if not (isinstance(rule, LocalRule) and rule.is_causal
                or type(rule).__name__ == "CausalRule"):
            raise ValueError(
                "the serving engine is autoregressive: ModelConfig.rule must "
                "be CausalRule or LocalRule(is_causal=True) (the paged "
                "kernels always enforce left-to-right ordering, so a "
                "non-causal rule would silently diverge from the model)")
        if isinstance(rule, LocalRule) and engine_cfg.prefill_mode != "chunked":
            raise ValueError(
                "sliding-window models require chunked prefill (lazy paging "
                "and the rolling page table have no bucketed-path analog)")
        if cp > 1:
            # context-parallel serving: KV pages round-robin over seq_axis,
            # every chip scans its own pages, partials merge by one psum.
            # Composes with tensor parallelism: a (model x seq) mesh shards
            # heads AND pages.
            if model_cfg.n_experts:
                raise ValueError("context-parallel engine does not support MoE")
            if engine_cfg.prefill_mode != "chunked":
                raise ValueError("context-parallel engine requires chunked prefill")
            # window rules work across shards (the kernels mask on global
            # positions and skip per-shard pages below the window before
            # any load); page EVICTION and rolling tables remain
            # single-shard features, so CP window sequences are bounded by
            # cp * max_pages_per_seq * page_size like causal ones
            if engine_cfg.speculative_tokens and engine_cfg.page_size <= engine_cfg.speculative_tokens:
                raise ValueError("page_size must exceed speculative_tokens")
        self._n_heads_loc = model_cfg.n_heads // tp
        self._n_kv_loc = model_cfg.n_kv_heads // tp

        self.ccfg = KVCacheConfig(
            n_kv_heads=model_cfg.n_kv_heads,
            head_dim=model_cfg.d_head,
            page_size=engine_cfg.page_size,
            n_pages=engine_cfg.n_pages,
            max_seqs=engine_cfg.max_seqs,
            max_pages_per_seq=engine_cfg.max_pages_per_seq,
            quantized=engine_cfg.quantized_kv,
            quant_dtype=engine_cfg.kv_quant_dtype,
            dtype=model_cfg.dtype,
        )
        self._ccfg_loc = (dataclasses.replace(self.ccfg, n_kv_heads=self._n_kv_loc)
                          if tp > 1 else self.ccfg)
        self.trash_page = engine_cfg.n_pages - 1
        if cp > 1:
            from .seq_sharded_decode import create_seq_sharded_cache
            self.caches: List[PagedKVCache] = [
                create_seq_sharded_cache(
                    self.ccfg, mesh, seq_axis,
                    head_axis=model_axis if tp > 1 else None)
                for _ in range(model_cfg.n_layers)]
            if tp > 1:
                # Megatron param placement (cache is already sharded)
                from jax.sharding import NamedSharding
                from jax.sharding import PartitionSpec as P
                ns = lambda spec: NamedSharding(mesh, spec)
                self.params = jax.device_put(
                    self.params,
                    jax.tree.map(ns, self._param_pspec(),
                                 is_leaf=lambda x: isinstance(x, P)))
            # one physical-page allocator per SEQ shard (n_pages is per
            # shard; head shards share their seq shard's page tables)
            self.allocators = [SharedPageAllocator(engine_cfg.n_pages - 1)
                               for _ in range(cp)]
            self.allocator = self.allocators[0]
        else:
            self.caches = [
                PagedKVCache.create(self.ccfg) for _ in range(model_cfg.n_layers)
            ]
            if tp > 1:
                self._shard_state()
            self.allocator = SharedPageAllocator(engine_cfg.n_pages - 1)  # exclude trash
            self.allocators = [self.allocator]
        self.prefix_cache = (
            PrefixCache(engine_cfg.page_size)
            if engine_cfg.prefix_caching and engine_cfg.prefill_mode == "chunked"
            and cp == 1
            else None)
        # sliding-window models: lazy prompt paging + eviction keep the
        # live page set window-bounded (rolling page table), so admission
        # reserves only the capped page count.  The prefix registry cannot
        # retain evicted prompt pages, so window models run without it.
        self._window = (model_cfg.rule.strided_window_size
                        if isinstance(model_cfg.rule, LocalRule) else None)
        if self._window is not None:
            self.prefix_cache = None
            gamma = max(1, engine_cfg.speculative_tokens + 1)
            span = self._window + gamma + engine_cfg.prefill_chunk
            live_pages = -(-span // engine_cfg.page_size) + 2
            # under CP the live set spreads round-robin; the binding shard
            # holds at most ceil(live/cp)+1 of its pages
            self._pages_cap = (-(-live_pages // cp) + 1) if cp > 1 else live_pages
            if self._pages_cap > engine_cfg.max_pages_per_seq:
                raise ValueError(
                    f"max_pages_per_seq={engine_cfg.max_pages_per_seq} too "
                    f"small for the window's live set ({self._pages_cap} "
                    f"local pages: window {self._window} + chunk/gamma)")
        else:
            self._pages_cap = -1
        # budget counts pages on the BINDING shard: round-robin placement
        # always puts a sequence's global page 0 on shard 0, so shard 0
        # holds ceil(G/cp) pages of a G-page sequence — the scheduler
        # budget is per-shard and CP requests reserve that amount (see
        # submit); cp == 1 degenerates to the plain global budget
        self.scheduler = Scheduler(engine_cfg.max_seqs,
                                   engine_cfg.n_pages - 1,
                                   engine_cfg.page_size)
        self._slots: List[Optional[dict]] = [None] * engine_cfg.max_seqs
        self._next_rid = 0
        self._results: Dict[int, List[int]] = {}
        self._prompts: Dict[int, List[int]] = {}
        self._sampling: Dict[int, tuple] = {}
        self._decode_step = self._compile(self._decode_step_impl, n_out_scalars=1)
        self._spec_step = self._compile(self._spec_step_impl, n_out_scalars=2)
        self.spec_stats = {"proposed": 0, "accepted": 0}
        # serving observability: cumulative counters + page high-water mark
        # (the role the reference's benchmark harness plays for the op
        # library — tests/test_base.py:86-90 peak-memory reporting — here
        # as a production metrics surface)
        self.stats = {"steps": 0, "decode_tokens": 0, "prefill_chunks": 0,
                      "prefill_tokens": 0, "admitted": 0, "retired": 0,
                      "pages_in_use_peak": 0, "pages_evicted": 0}
        self._prefill = {
            b: jax.jit(functools.partial(self._prefill_impl, b))
            for b in engine_cfg.prefill_buckets
        }
        self._chunk_prefill = self._compile(self._chunk_prefill_impl, n_out_scalars=1)
        self._base_key = jax.random.PRNGKey(engine_cfg.seed)
        self._step_counter = 0
        self._sample1 = jax.jit(sample_tokens)

    # ---- tensor-parallel plumbing ----

    def _param_pspec(self):
        from jax.sharding import PartitionSpec as P
        ax = self._tp_axis

        def spec_for(path, leaf):
            name = None
            for entry in reversed(path):
                if hasattr(entry, "key"):
                    name = entry.key
                    break
            if name in ("wq", "wk", "wv", "w1", "w3"):
                return P(None, ax)
            if name in ("wo", "w2"):
                return P(ax, None)
            return P()

        return jax.tree_util.tree_map_with_path(spec_for, self.params)

    def _cache_pspec(self):
        from jax.sharding import PartitionSpec as P
        ax = self._tp_axis
        pages = P(ax, None, None, None)
        return PagedKVCache(
            k_pages=pages, v_pages=pages,
            k_scales=pages if self.ccfg.quantized else None,
            v_scales=pages if self.ccfg.quantized else None,
            page_tables=P(), lengths=P())

    def _shard_state(self):
        """Place params and caches according to the TP specs."""
        from jax.sharding import NamedSharding
        from jax.sharding import PartitionSpec as P
        ns = lambda spec: NamedSharding(self.mesh, spec)
        is_p = lambda x: isinstance(x, P)
        self.params = jax.device_put(
            self.params, jax.tree.map(ns, self._param_pspec(), is_leaf=is_p))
        cache_sh = jax.tree.map(ns, self._cache_pspec(), is_leaf=is_p)
        self.caches = [jax.device_put(c, cache_sh) for c in self.caches]

    def _cp_cache_pspec(self):
        from jax.sharding import PartitionSpec as P
        pages = P(self._seq_axis, self._tp_axis)   # head dim over model axis
        lead = P(self._seq_axis)
        return PagedKVCache(
            k_pages=pages, v_pages=pages,
            k_scales=pages if self.ccfg.quantized else None,
            v_scales=pages if self.ccfg.quantized else None,
            page_tables=lead, lengths=lead)

    @staticmethod
    def _strip(cache):
        """Per-shard view inside shard_map: drop the size-1 shard dim."""
        return jax.tree.map(lambda x: x[0] if x is not None else None,
                            cache, is_leaf=lambda x: x is None)

    @staticmethod
    def _unstrip(cache):
        return jax.tree.map(lambda x: x[None] if x is not None else None,
                            cache, is_leaf=lambda x: x is None)

    def _compile(self, impl, n_out_scalars: int):
        """jit (single chip) or jit(shard_map) (tensor or context parallel)
        a step function (params, caches, *scalars) -> (*outs, caches)."""
        if self._tp_axis is None and self._seq_axis is None:
            return jax.jit(impl, donate_argnums=(1,))
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        if self._seq_axis is not None:
            pspec = (self._param_pspec() if self._tp_axis is not None
                     else jax.tree.map(lambda _: P(), self.params))
            cspec = [self._cp_cache_pspec()] * self.mcfg.n_layers
        else:
            pspec = self._param_pspec()
            cspec = [self._cache_pspec()] * self.mcfg.n_layers

        def wrapped(params, caches, *rest):
            return impl(params, caches, *rest)

        n_layers = self.mcfg.n_layers

        def make(n_scalar_in):
            return jax.jit(
                shard_map(
                    wrapped, mesh=self.mesh,
                    in_specs=(pspec, cspec) + (P(),) * n_scalar_in,
                    out_specs=(P(),) * n_out_scalars + (cspec,)
                    if n_out_scalars != 1 else (P(), cspec),
                    check_vma=False),
                donate_argnums=(1,))

        # arity differs per step function; build lazily per call count
        cache = {}

        def call(params, caches, *rest):
            f = cache.get(len(rest))
            if f is None:
                f = make(len(rest))
                cache[len(rest)] = f
            return f(params, caches, *rest)

        return call

    def _mlp(self, layer, x):
        """Dense gated MLP on (..., d_model) with the tensor-parallel
        reduce before the residual add (models._mlp_block adds the
        residual internally, so its w2 partial sums cannot be psummed);
        MoE models route through _mlp_block (single-chip engine only)."""
        if self.mcfg.n_experts:
            shp = x.shape
            y = _mlp_block(self.mcfg, layer, x.reshape(1, -1, shp[-1]))[0]
            return y.reshape(shp)
        h = _rms_norm(x, layer["ln2"])
        gated = jax.nn.silu(h @ layer["w1"].astype(h.dtype)) * (
            h @ layer["w3"].astype(h.dtype))
        y = gated @ layer["w2"].astype(h.dtype)
        if self._tp_axis is not None:
            y = jax.lax.psum(y, self._tp_axis)
        return x + y

    def _attn_out(self, layer, x, o):
        """o (..., heads_loc*d_head) -> residual add with TP reduce."""
        proj = o.astype(x.dtype) @ layer["wo"].astype(x.dtype)
        if self._tp_axis is not None:
            proj = jax.lax.psum(proj, self._tp_axis)
        return x + proj

    # ---- compiled model functions ----

    def _prefill_impl(self, bucket, params, tokens, true_len):
        """Run the prompt through the training-path kernel; return the last
        logits and per-layer (k, v) for cache writing."""
        cfg = self.mcfg
        from ..models.transformer import _rope
        x = params["embed"].astype(cfg.dtype)[tokens][None]  # (1, bucket, d)
        kvs = []
        for layer in params["layers"]:
            h = _rms_norm(x, layer["ln1"])
            b, s, _ = h.shape
            q = (h @ layer["wq"].astype(h.dtype)).reshape(b, s, cfg.n_heads, cfg.d_head)
            k = (h @ layer["wk"].astype(h.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
            v = (h @ layer["wv"].astype(h.dtype)).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
            q = jnp.swapaxes(q, 1, 2)
            k = jnp.swapaxes(k, 1, 2)
            v = jnp.swapaxes(v, 1, 2)
            q = _rope(q, cfg.rope_theta)
            k = _rope(k, cfg.rope_theta)
            o = mha(q, k, v, rule=cfg.rule, block_config=cfg.block_config,
                    interpret=self.interpret)
            o = jnp.swapaxes(o, 1, 2).reshape(b, s, cfg.n_heads * cfg.d_head)
            x = x + o @ layer["wo"].astype(o.dtype)
            x = _mlp_block(cfg, layer, x)[0]
            kvs.append((k[0], v[0]))  # (n_kv_heads, bucket, d_head)
        x = _rms_norm(x, params["final_norm"])
        logits = (x @ params["embed"].astype(x.dtype).T)[0]  # (bucket, vocab)
        last = logits[true_len - 1]
        return last, kvs

    def _chunk_prefill_impl(self, params, caches, tokens, slot, start, true_len):
        """One prefill chunk: tokens (chunk,) at absolute positions
        ``start..start+chunk`` of sequence ``slot``, attending to the paged
        cache (which may hold a shared cached prefix).  ``slot``/``start``/
        ``true_len`` are traced, so this compiles once."""
        cfg = self.mcfg
        ax = self._seq_axis
        chunk = tokens.shape[0]
        if ax is not None:
            caches = [self._strip(c) for c in caches]
            me = jax.lax.axis_index(ax)
        pos = jnp.asarray(start, jnp.int32) + jnp.arange(chunk, dtype=jnp.int32)
        x = params["embed"].astype(cfg.dtype)[tokens]          # (chunk, d_model)
        new_caches = []
        for layer, cache in zip(params["layers"], caches):
            h = _rms_norm(x, layer["ln1"])
            q = (h @ layer["wq"].astype(h.dtype)).reshape(chunk, self._n_heads_loc, cfg.d_head)
            k = (h @ layer["wk"].astype(h.dtype)).reshape(chunk, self._n_kv_loc, cfg.d_head)
            v = (h @ layer["wv"].astype(h.dtype)).reshape(chunk, self._n_kv_loc, cfg.d_head)
            q = _rope_at(q, pos, cfg.rope_theta)
            k = _rope_at(k, pos, cfg.rope_theta)
            if ax is not None:
                cache = write_tokens_at(
                    cache, self._ccfg_loc, slot, start,
                    jnp.swapaxes(k, 0, 1), jnp.swapaxes(v, 0, 1),
                    true_len, self.trash_page,
                    page_stride=self.cp, page_offset=me)
                o, l, m = paged_prefill_attention(
                    q, cache, self._ccfg_loc, slot, start, true_len,
                    rule=cfg.rule, returning_l_m=True,
                    page_stride=self.cp, page_offset=me)
                o = _merge_partials(o, l, m, ax).astype(x.dtype)
            else:
                cache = write_tokens_at(
                    cache, self._ccfg_loc, slot, start,
                    jnp.swapaxes(k, 0, 1), jnp.swapaxes(v, 0, 1),
                    true_len, self.trash_page)
                o = paged_prefill_attention(
                    q, cache, self._ccfg_loc, slot, start, true_len,
                    rule=cfg.rule)
            x = self._attn_out(layer, x, o.reshape(chunk, -1))
            x = self._mlp(layer, x)
            new_caches.append(cache)
        x = _rms_norm(x, params["final_norm"])
        logits = x @ params["embed"].astype(x.dtype).T         # (chunk, vocab)
        last = jax.lax.dynamic_index_in_dim(
            logits, jnp.asarray(true_len, jnp.int32) - 1, axis=0, keepdims=False)
        if ax is not None:
            new_caches = [self._unstrip(c) for c in new_caches]
        return last, new_caches

    def _decode_step_impl(self, params, caches, tokens, active,
                          temps, top_ks, top_ps, key):
        """One token for every slot.  tokens (S,) int32, active (S,) bool;
        ``temps/top_ks/top_ps`` carry per-slot sampling parameters
        (continuous batching mixes greedy and sampled requests)."""
        cfg = self.mcfg
        ax = self._seq_axis
        if ax is not None:
            caches = [self._strip(c) for c in caches]
            glob = jax.lax.psum(caches[0].lengths, ax)
            pos = glob
            me = jax.lax.axis_index(ax)
        else:
            pos = caches[0].lengths  # positions of the new tokens
        x = params["embed"].astype(cfg.dtype)[tokens]  # (S, d_model)
        new_caches = []
        for layer, cache in zip(params["layers"], caches):
            h = _rms_norm(x, layer["ln1"])
            S = h.shape[0]
            q = (h @ layer["wq"].astype(h.dtype)).reshape(S, self._n_heads_loc, cfg.d_head)
            k = (h @ layer["wk"].astype(h.dtype)).reshape(S, self._n_kv_loc, cfg.d_head)
            v = (h @ layer["wv"].astype(h.dtype)).reshape(S, self._n_kv_loc, cfg.d_head)
            q = _rope_at(q, pos, cfg.rope_theta)
            k = _rope_at(k, pos, cfg.rope_theta)
            if ax is not None:
                # context parallel: the append lands on the owner shard of
                # the written position; attention partials merge by one psum
                owner = (glob // self.ecfg.page_size) % self.cp
                mine = jnp.logical_and(active, owner == me)
                cache = append_tokens_batched(
                    cache, self._ccfg_loc, k, v, mine, self.trash_page)
                o, l, m = paged_decode_attention(
                    q, cache, self._ccfg_loc, rule=cfg.rule,
                    returning_l_m=True, page_stride=self.cp, page_offset=me,
                    global_lengths=glob + active.astype(jnp.int32),
                    interpret=self.interpret)
                o = _merge_partials(o, l, m, ax).astype(x.dtype)
            else:
                cache = append_tokens_batched(cache, self._ccfg_loc, k, v, active,
                                              self.trash_page)
                o = paged_decode_attention(q, cache, self._ccfg_loc,
                                           rule=cfg.rule, interpret=self.interpret)
            x = self._attn_out(layer, x, o.reshape(S, -1))
            x = self._mlp(layer, x)
            new_caches.append(cache)
        x = _rms_norm(x, params["final_norm"])
        logits = x @ params["embed"].astype(x.dtype).T
        next_tokens = sample_tokens(logits, key, temps, top_ks, top_ps)
        if ax is not None:
            new_caches = [self._unstrip(c) for c in new_caches]
        return next_tokens, new_caches

    def _spec_step_impl(self, params, caches, tokens, active, key,
                        temps, top_ks, top_ps):
        """Speculative step: ``tokens`` (S, gamma) = [last, draft_1..] per
        slot.  Appends all gamma tokens' K/V, runs the multi-token decode
        kernel, and returns per-position greedy argmaxes plus a sampled
        token from position 0 (for sampled slots, which fall back to one
        token per step).  The host verifies drafts and rolls back lengths
        — rollback is just a length decrement, since appends are
        positional and later appends overwrite rejected rows in place."""
        cfg = self.mcfg
        ax = self._seq_axis
        S, gamma = tokens.shape
        if ax is not None:
            caches = [self._strip(c) for c in caches]
            glob0 = jax.lax.psum(caches[0].lengths, ax)
            pos0 = glob0
            me = jax.lax.axis_index(ax)
        else:
            pos0 = caches[0].lengths
        pos = pos0[:, None] + jnp.arange(gamma, dtype=jnp.int32)[None, :]
        x = params["embed"].astype(cfg.dtype)[tokens]      # (S, gamma, d_model)
        new_caches = []
        for layer, cache in zip(params["layers"], caches):
            h = _rms_norm(x, layer["ln1"])
            q = (h @ layer["wq"].astype(h.dtype)).reshape(S, gamma, self._n_heads_loc, cfg.d_head)
            k = (h @ layer["wk"].astype(h.dtype)).reshape(S, gamma, self._n_kv_loc, cfg.d_head)
            v = (h @ layer["wv"].astype(h.dtype)).reshape(S, gamma, self._n_kv_loc, cfg.d_head)
            q = _rope_at_batch(q, pos, cfg.rope_theta)
            k = _rope_at_batch(k, pos, cfg.rope_theta)
            for i in range(gamma):
                if ax is not None:
                    owner = ((pos0 + i) // self.ecfg.page_size) % self.cp
                    act_i = jnp.logical_and(active, owner == me)
                else:
                    act_i = active
                cache = append_tokens_batched(
                    cache, self._ccfg_loc, k[:, i], v[:, i], act_i,
                    self.trash_page)
            if ax is not None:
                o, l, m = paged_multitoken_decode(
                    q, cache, self._ccfg_loc, rule=cfg.rule,
                    returning_l_m=True, page_stride=self.cp, page_offset=me,
                    global_lengths=glob0 + gamma * active.astype(jnp.int32))
                o = _merge_partials(o, l, m, ax).astype(x.dtype)
            else:
                o = paged_multitoken_decode(q, cache, self._ccfg_loc,
                                            rule=cfg.rule)
            x = self._attn_out(layer, x, o.reshape(S, gamma, -1))
            x = self._mlp(layer, x)
            new_caches.append(cache)
        x = _rms_norm(x, params["final_norm"])
        logits = x @ params["embed"].astype(x.dtype).T     # (S, gamma, vocab)
        greedy = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        sampled0 = sample_tokens(logits[:, 0], key, temps, top_ks, top_ps)
        if ax is not None:
            new_caches = [self._unstrip(c) for c in new_caches]
        return greedy, sampled0, new_caches

    # ---- host-side serving loop ----

    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               sampling: SamplingParams = SamplingParams(),
               eos_id: Optional[int] = None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        cap = self._pages_cap
        if self.cp > 1:
            # reserve the binding (first) shard's share of the pages;
            # window models are additionally capped by their live set
            total = len(prompt) + max_new_tokens
            g = -(-total // self.ecfg.page_size)
            share = -(-g // self.cp)
            cap = share if cap < 0 else min(cap, share)
        self.scheduler.enqueue(Request(rid, len(prompt), max_new_tokens,
                                       pages_cap=cap))
        self._results[rid] = list(prompt)
        self._prompts[rid] = list(prompt)
        self._sampling[rid] = (sampling, eos_id)
        return rid

    def _bucket_for(self, n: int) -> int:
        for b in self.ecfg.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket")

    def _prefill_bucketed(self, prompt: List[int], slot: int):
        """Legacy prefill: whole prompt in one padded training-kernel pass."""
        bucket = self._bucket_for(len(prompt))
        tokens = jnp.asarray(
            prompt + [0] * (bucket - len(prompt)), jnp.int32)
        last_logits, kvs = self._prefill[bucket](
            self.params, tokens, len(prompt))
        n_pages = -(-len(prompt) // self.ecfg.page_size)
        pages = self.allocator.alloc(slot, n_pages)
        for i, (k, v) in enumerate(kvs):
            self.caches[i] = write_prompt(
                self.caches[i], self.ccfg, slot, np.asarray(pages),
                k[:, : len(prompt)], v[:, : len(prompt)])
        return last_logits

    def _owned_count(self, total: int, r: int) -> int:
        """Shard ``r``'s owned-token count (the device formula, on ints)."""
        from .kv_cache import _owned_token_count
        return int(_owned_token_count(total, self.ecfg.page_size, self.cp, r))

    def _alloc_pages(self, slot: int, n: int):
        """Allocate fresh pages, evicting LRU prefix-cache entries if dry."""
        if (n > self.allocator.free_pages and self.prefix_cache is not None):
            self.prefix_cache.evict(self.allocator, n)
        return self.allocator.alloc(slot, n)

    def _prefill_chunked(self, prompt: List[int], slot: int):
        """Chunked prefill against the paged cache, reusing any cached
        page-aligned prefix (shared refcounted pages).  Returns
        ``(last_logits, pages_evicted, budget_refunded)``.

        Sliding-window models page the prompt *lazily* (pages map just
        before the chunk that writes them) and evict pages below the
        window after every chunk, so an arbitrarily long prompt holds only
        window + chunk pages at once — the rolling-page-table analog of a
        Mistral-style rolling buffer, on paged storage.
        """
        ps = self.ecfg.page_size
        mp = self.ecfg.max_pages_per_seq
        n_prompt_pages = -(-len(prompt) // ps)
        if self.cp > 1:
            return self._prefill_chunked_cp(prompt, slot)
        cached_tokens, cached_pages = 0, []
        if self.prefix_cache is not None:
            # always leave >= 1 token to prefill so there are logits to sample
            cached_tokens, cached_pages = self.prefix_cache.lookup(
                prompt, max_tokens=len(prompt) - 1)
        if cached_pages:
            self.allocator.share(slot, cached_pages)
        lazy = self._window is not None
        if not lazy:
            fresh = self._alloc_pages(slot, n_prompt_pages - len(cached_pages))
            pages = list(cached_pages) + fresh
            for i in range(len(self.caches)):
                c = self.caches[i]
                self.caches[i] = dataclasses.replace(
                    c,
                    page_tables=c.page_tables.at[slot, :n_prompt_pages].set(
                        jnp.asarray(pages, jnp.int32)),
                    lengths=c.lengths.at[slot].set(cached_tokens))
        else:
            for i in range(len(self.caches)):
                self.caches[i] = dataclasses.replace(
                    self.caches[i],
                    lengths=self.caches[i].lengths.at[slot].set(0))
        chunk = self.ecfg.prefill_chunk
        start, last_logits = cached_tokens, None
        mapped_hi, evicted, refunded = -1, 0, 0
        while start < len(prompt):
            n = min(chunk, len(prompt) - start)
            if lazy:
                last_needed = (start + n - 1) // ps
                for logical in range(mapped_hi + 1, last_needed + 1):
                    page = self._alloc_pages(slot, 1)[0]
                    for i in range(len(self.caches)):
                        self.caches[i] = assign_page(
                            self.caches[i], slot, logical % mp, page)
                mapped_hi = max(mapped_hi, last_needed)
            self.stats["prefill_chunks"] += 1
            self.stats["prefill_tokens"] += n
            toks = prompt[start:start + n] + [0] * (chunk - n)
            last_logits, self.caches = self._chunk_prefill(
                self.params, self.caches,
                jnp.asarray(toks, jnp.int32),
                jnp.asarray(slot, jnp.int32),
                jnp.asarray(start, jnp.int32),
                jnp.asarray(n, jnp.int32))
            start += n
            if lazy:
                keep_from = max(0, start - (self._window - 1)) // ps
                nrel = keep_from - evicted
                if nrel > 0:
                    # physical pages recycle inside the slot's capped
                    # reservation; no scheduler refund (see _evict_window_pages)
                    self.allocator.release_prefix(slot, nrel)
                    evicted += nrel
                    self.stats["pages_evicted"] += nrel
        if self.prefix_cache is not None:
            self.prefix_cache.insert(prompt, pages, self.allocator)
        return last_logits, evicted, refunded

    def _prefill_chunked_cp(self, prompt: List[int], slot: int):
        """Context-parallel chunked prefill: each shard maps its round-robin
        share of the prompt's pages (upfront for causal models, lazily
        per-chunk with evict-behind-window for sliding-window models),
        then every chunk runs the CP step (per-shard writes route
        non-owned pages to trash; attention partials merge inside the
        compiled step)."""
        ps = self.ecfg.page_size
        mp = self.ecfg.max_pages_per_seq
        G = -(-len(prompt) // ps)
        lazy = self._window is not None
        if not lazy:
            tables = np.array(self.caches[0].page_tables)   # (cp, S, mp)
            for r in range(self.cp):
                cnt = len(range(r, G, self.cp))
                if cnt > mp:
                    raise RuntimeError(
                        f"prompt needs {cnt} local pages on shard {r} but "
                        f"max_pages_per_seq={mp}")
                if cnt:
                    pages_r = self.allocators[r].alloc(slot, cnt)
                    tables[r, slot, :cnt] = pages_r
            t_dev = jnp.asarray(tables, jnp.int32)
        else:
            t_dev = self.caches[0].page_tables
        for i in range(len(self.caches)):
            self.caches[i] = dataclasses.replace(
                self.caches[i], page_tables=t_dev,
                lengths=self.caches[i].lengths.at[:, slot].set(0))
        chunk = self.ecfg.prefill_chunk
        start, last_logits = 0, None
        mapped_hi, evicted = -1, 0
        while start < len(prompt):
            n = min(chunk, len(prompt) - start)
            if lazy:
                last_needed = (start + n - 1) // ps
                for logical in range(mapped_hi + 1, last_needed + 1):
                    owner, loc = logical % self.cp, logical // self.cp
                    page = self.allocators[owner].alloc(slot, 1)[0]
                    for i in range(len(self.caches)):
                        self.caches[i] = dataclasses.replace(
                            self.caches[i],
                            page_tables=self.caches[i].page_tables.at[
                                owner, slot, loc % mp].set(page))
                mapped_hi = max(mapped_hi, last_needed)
            self.stats["prefill_chunks"] += 1
            self.stats["prefill_tokens"] += n
            toks = prompt[start:start + n] + [0] * (chunk - n)
            last_logits, self.caches = self._chunk_prefill(
                self.params, self.caches,
                jnp.asarray(toks, jnp.int32),
                jnp.asarray(slot, jnp.int32),
                jnp.asarray(start, jnp.int32),
                jnp.asarray(n, jnp.int32))
            start += n
            if lazy:
                keep_from = max(0, start - (self._window - 1)) // ps
                if keep_from > evicted:
                    self._release_global_pages(slot, evicted, keep_from)
                    self.stats["pages_evicted"] += keep_from - evicted
                    evicted = keep_from
        return last_logits, evicted, 0

    def _admit(self):
        for req, slot in self.scheduler.admit():
            self.stats["admitted"] += 1
            prompt = self._prompts.pop(req.rid)
            if self.ecfg.prefill_mode == "chunked":
                last_logits, ev, ref = self._prefill_chunked(prompt, slot)
            else:
                last_logits = self._prefill_bucketed(prompt, slot)
                ev = ref = 0
            sp, eos_id = self._sampling.pop(req.rid, (SamplingParams(), None))
            if sp.temperature > 0:
                first_tok = int(self._sample1(
                    last_logits[None],
                    jax.random.fold_in(self._base_key, req.rid),
                    jnp.asarray([sp.temperature], jnp.float32),
                    jnp.asarray([sp.top_k], jnp.int32),
                    jnp.asarray([sp.top_p], jnp.float32))[0])
            else:
                first_tok = int(jnp.argmax(last_logits))
            self._results[req.rid].append(first_tok)
            self._slots[slot] = {
                "rid": req.rid,
                "remaining": req.max_new_tokens - 1,
                "last": first_tok,
                "length": len(prompt),
                "sampling": sp,
                "eos_id": eos_id,
                # pages reserved in the scheduler budget at admission; the
                # exact amount to hand back at retirement (shared prefix
                # pages make the allocator's owned-count the wrong number)
                "reserved": req.pages_needed(self.ecfg.page_size),
                # sliding-window bookkeeping primed by prefill-time eviction
                "evicted": ev,
                "refunded": ref,
            }
            if eos_id is not None and first_tok == eos_id:
                self._slots[slot]["remaining"] = 0

    def _ensure_capacity(self, n_tokens: int = 1):
        """Map pages for the next ``n_tokens`` appends of every active slot."""
        ps = self.ecfg.page_size
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            # appends target positions length .. length+n_tokens-1; pages
            # covering positions < length are already mapped
            length = st["length"]
            first_unmapped = length // ps + (1 if length % ps else 0)
            last_needed = (length + n_tokens - 1) // ps
            mp = self.ecfg.max_pages_per_seq
            if self.cp > 1:
                for logical in range(first_unmapped, last_needed + 1):
                    owner, loc = logical % self.cp, logical // self.cp
                    if loc >= mp and self._window is None:
                        raise RuntimeError(
                            f"sequence needs local page {loc} on shard "
                            f"{owner} but max_pages_per_seq={mp}; only "
                            f"sliding-window models roll the page table")
                    page = self.allocators[owner].alloc(slot, 1)[0]
                    for i in range(len(self.caches)):
                        self.caches[i] = dataclasses.replace(
                            self.caches[i],
                            page_tables=self.caches[i].page_tables.at[
                                owner, slot, loc % mp].set(page))
                continue
            if self._window is None and last_needed >= mp:
                raise RuntimeError(
                    f"sequence needs logical page {last_needed} but "
                    f"max_pages_per_seq={mp}; only sliding-window models "
                    f"(ModelConfig.rule = LocalRule) roll the page table")
            for logical in range(first_unmapped, last_needed + 1):
                page = self._alloc_pages(slot, 1)[0]
                for i in range(len(self.caches)):
                    self.caches[i] = assign_page(
                        self.caches[i], slot, logical % mp, page)

    def _evict_window_pages(self):
        """Sliding-window page eviction: with a LocalRule, pages entirely
        below every future query row's window are dead — the kernels'
        first-live-page skipping never reads them — so the slot drops its
        references and refunds the scheduler budget.  Generation memory is
        then bounded by the window, not the output length.  Pages shared
        with the prefix registry stay live (only this slot's reference is
        dropped); their reuse is the registry's LRU's business.
        """
        rule = self.mcfg.rule
        if not isinstance(rule, LocalRule):
            return
        ps = self.ecfg.page_size
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            # the next step's oldest query row sits at `length`; it reaches
            # back strided_window-1 positions, and the window only moves right
            keep_from = max(0, st["length"] - (rule.strided_window_size - 1)) // ps
            done = st.get("evicted", 0)
            n = keep_from - done
            if n > 0:
                # physical pages recycle inside the slot's capped
                # reservation (window slots always reserve their cap, so
                # no scheduler refund is needed; Scheduler.refund exists
                # for uncapped admission policies)
                self._release_global_pages(slot, done, keep_from)
                st["evicted"] = keep_from
                self.stats["pages_evicted"] += n

    def _release_global_pages(self, slot: int, lo: int, hi: int):
        """Drop the slot's references to global logical pages [lo, hi)
        (oldest first).  Owned lists are per seq-shard and in logical
        order, so each shard releases its round-robin share."""
        if self.cp == 1:
            self.allocator.release_prefix(slot, hi - lo)
            return
        for r in range(self.cp):
            # shard r owns pages g in [lo, hi) with g % cp == r
            cnt = len(range(lo + ((r - lo) % self.cp), hi, self.cp))
            if cnt:
                self.allocators[r].release_prefix(slot, cnt)

    def _retire(self):
        for slot, st in enumerate(self._slots):
            if st is not None and st["remaining"] <= 0:
                self.stats["retired"] += 1
                for alloc in self.allocators:
                    alloc.free(slot)
                self.scheduler.release(
                    slot, st["reserved"] - st.get("refunded", 0))
                # zero the slot length so dead slots skip all pages
                for i in range(len(self.caches)):
                    self.caches[i] = dataclasses.replace(
                        self.caches[i],
                        lengths=self.caches[i].lengths.at[..., slot].set(0))
                self._slots[slot] = None

    @property
    def num_active(self) -> int:
        return sum(st is not None for st in self._slots)

    def _propose(self, hist: List[int], n_draft: int) -> List[int]:
        """Prompt-lookup drafts: continuation of the most recent earlier
        occurrence of the history's last n-gram (n = 3, 2, 1)."""
        w = self.ecfg.spec_lookup_window
        h = hist[-w:] if len(hist) > w else hist
        for n in (3, 2, 1):
            if len(h) <= n:
                continue
            pat = h[-n:]
            for j in range(len(h) - n - 1, -1, -1):
                if h[j:j + n] == pat:
                    cont = h[j + n:j + n + n_draft]
                    if cont:
                        return list(cont) + [cont[-1]] * (n_draft - len(cont))
        return [h[-1]] * n_draft

    def _step_speculative(self) -> int:
        """One speculative step: propose drafts, verify in one multi-token
        pass, commit the accepted prefix + one model token per slot."""
        gamma = self.ecfg.speculative_tokens + 1
        self._admit()
        self._retire()
        if self.num_active == 0:
            return 0
        self._ensure_capacity(gamma)
        self.stats["steps"] += 1
        self.stats["pages_in_use_peak"] = max(
            self.stats["pages_in_use_peak"],
            sum((self.ecfg.n_pages - 1) - a.free_pages
                for a in self.allocators))
        S = self.ecfg.max_seqs
        tok_mat = np.zeros((S, gamma), np.int64)
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            tok_mat[slot, 0] = st["last"]
            tok_mat[slot, 1:] = self._propose(
                self._results[st["rid"]], gamma - 1)
        active = jnp.asarray([st is not None for st in self._slots])
        dflt = SamplingParams()
        sps = [st["sampling"] if st else dflt for st in self._slots]
        temps = jnp.asarray([sp.temperature for sp in sps], jnp.float32)
        top_ks = jnp.asarray([sp.top_k for sp in sps], jnp.int32)
        top_ps = jnp.asarray([sp.top_p for sp in sps], jnp.float32)
        key = jax.random.fold_in(self._base_key, 0x5A0 + self._step_counter)
        self._step_counter += 1
        greedy, sampled0, self.caches = self._spec_step(
            self.params, self.caches, jnp.asarray(tok_mat, jnp.int32),
            active, key, temps, top_ks, top_ps)
        greedy = np.asarray(greedy)
        sampled0 = np.asarray(sampled0)
        produced = 0
        # the device advanced every active slot's length by gamma; roll
        # back to the committed prefix per slot (CP: each shard's local
        # length is its owned-token count of the committed global length)
        new_lengths = np.array(self.caches[0].lengths)
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            if st["sampling"].temperature > 0:
                new_toks = [int(sampled0[slot])]
            else:
                n_acc = 0
                while (n_acc < gamma - 1 and
                       tok_mat[slot, n_acc + 1] == greedy[slot, n_acc]):
                    n_acc += 1
                new_toks = ([int(t) for t in tok_mat[slot, 1:1 + n_acc]]
                            + [int(greedy[slot, n_acc])])
                self.spec_stats["proposed"] += gamma - 1
                self.spec_stats["accepted"] += n_acc
            new_toks = new_toks[: st["remaining"]]
            if st["eos_id"] is not None and st["eos_id"] in new_toks:
                new_toks = new_toks[: new_toks.index(st["eos_id"]) + 1]
                st["remaining"] = len(new_toks)
            n_emit = len(new_toks)
            # committed K/V: 'last' plus the kept drafts (the final emitted
            # token's K/V is appended by the next step)
            if self.cp > 1:
                for r in range(self.cp):
                    new_lengths[r, slot] = self._owned_count(
                        st["length"] + n_emit, r)
            else:
                new_lengths[slot] = st["length"] + n_emit
            self._results[st["rid"]].extend(new_toks)
            st["last"] = new_toks[-1]
            st["length"] += n_emit
            st["remaining"] -= n_emit
            produced += n_emit
        self.stats["decode_tokens"] += produced
        for i in range(len(self.caches)):
            # one buffer per layer: a shared array would be donated twice
            # by the next step's jit
            self.caches[i] = dataclasses.replace(
                self.caches[i], lengths=jnp.asarray(new_lengths, jnp.int32))
        self._retire()
        self._evict_window_pages()
        return produced

    def step(self) -> int:
        """Admit, decode one token for all active slots, retire.  Returns
        the number of tokens produced this step."""
        if self.ecfg.speculative_tokens > 0:
            return self._step_speculative()
        self._admit()
        # requests finished at prefill (EOS as first token, or
        # max_new_tokens == 1) retire before consuming a decode step
        self._retire()
        if self.num_active == 0:
            return 0
        self._ensure_capacity()
        self.stats["steps"] += 1
        self.stats["pages_in_use_peak"] = max(
            self.stats["pages_in_use_peak"],
            sum((self.ecfg.n_pages - 1) - a.free_pages
                for a in self.allocators))
        tokens = jnp.asarray(
            [st["last"] if st else 0 for st in self._slots], jnp.int32)
        active = jnp.asarray([st is not None for st in self._slots])
        dflt = SamplingParams()
        sps = [st["sampling"] if st else dflt for st in self._slots]
        temps = jnp.asarray([sp.temperature for sp in sps], jnp.float32)
        top_ks = jnp.asarray([sp.top_k for sp in sps], jnp.int32)
        top_ps = jnp.asarray([sp.top_p for sp in sps], jnp.float32)
        key = jax.random.fold_in(self._base_key, 0x5A0 + self._step_counter)
        self._step_counter += 1
        next_tokens, self.caches = self._decode_step(
            self.params, self.caches, tokens, active, temps, top_ks, top_ps,
            key)
        produced = 0
        next_host = np.asarray(next_tokens)
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            tok = int(next_host[slot])
            self._results[st["rid"]].append(tok)
            st["last"] = tok
            st["length"] += 1
            st["remaining"] -= 1
            if st["eos_id"] is not None and tok == st["eos_id"]:
                st["remaining"] = 0
            produced += 1
        self.stats["decode_tokens"] += produced
        self._retire()
        self._evict_window_pages()
        return produced

    def run(self, max_steps: int = 1000) -> Dict[int, List[int]]:
        """Drain the queue; returns {rid: token list (prompt + generated)}."""
        steps = 0
        while (self.scheduler.queued or self.num_active) and steps < max_steps:
            self.step()
            steps += 1
        return dict(self._results)
