"""Serving-slice tests: paged KV cache, decode kernel, batching engine.

Golden check: greedy tokens from the continuous-batching engine (paged
cache + decode kernel) must equal greedy tokens from naively re-running
the dense model forward on the growing sequence.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tf_flash_attention_tpu.models.transformer import ModelConfig, forward, init_params
from tf_flash_attention_tpu.serving.decode import paged_decode_attention
from tf_flash_attention_tpu.serving.engine import DecodeEngine, EngineConfig
from tf_flash_attention_tpu.serving.kv_cache import (
    KVCacheConfig,
    PageAllocator,
    PagedKVCache,
    append_tokens_batched as append_tokens_batched_ref,
    assign_page,
    write_prompt,
)

MCFG = ModelConfig(vocab=64, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
                   d_head=16, d_ff=128, max_seq=256, dtype=jnp.float32)


def test_paged_decode_matches_dense():
    rng = np.random.default_rng(0)
    cfg = KVCacheConfig(n_kv_heads=2, head_dim=32, page_size=64, n_pages=16,
                        max_seqs=2, max_pages_per_seq=4, quantized=False,
                        dtype=jnp.float32)
    cache = PagedKVCache.create(cfg)
    alloc = PageAllocator(cfg.n_pages - 1)
    t = 150
    k = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)
    v = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)
    pages = alloc.alloc(0, -(-t // cfg.page_size))
    cache = write_prompt(cache, cfg, 0, np.array(pages), k, v)
    q = jnp.asarray(rng.uniform(-1, 1, (2, 4, 32)), jnp.float32)
    o = paged_decode_attention(q, cache, cfg)

    qg = np.asarray(q[0]).reshape(2, 2, 32)
    s = np.einsum("hgd,htd->hgt", qg, np.asarray(k)) / np.sqrt(32)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    ref = np.einsum("hgt,htd->hgd", p, np.asarray(v)).reshape(4, 32)
    np.testing.assert_allclose(np.asarray(o[0]), ref, rtol=2e-5, atol=2e-5)
    # empty slot yields zeros
    np.testing.assert_array_equal(np.asarray(o[1]), 0.0)


def test_int8_cache_roundtrip_accuracy():
    rng = np.random.default_rng(1)
    cfg = KVCacheConfig(n_kv_heads=2, head_dim=32, page_size=64, n_pages=8,
                        max_seqs=1, max_pages_per_seq=2, quantized=True)
    cache = PagedKVCache.create(cfg)
    alloc = PageAllocator(cfg.n_pages - 1)
    t = 100
    k = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)
    v = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)
    cache = write_prompt(cache, cfg, 0, np.array(alloc.alloc(0, 2)), k, v)
    q = jnp.asarray(rng.uniform(-1, 1, (1, 4, 32)), jnp.float32)
    o = paged_decode_attention(q, cache, cfg)
    qg = np.asarray(q[0]).reshape(2, 2, 32)
    s = np.einsum("hgd,htd->hgt", qg, np.asarray(k)) / np.sqrt(32)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    ref = np.einsum("hgt,htd->hgd", p, np.asarray(v)).reshape(4, 32)
    err = np.abs(np.asarray(o[0]) - ref).max()
    assert err < 2e-2, err  # int8 quantization tolerance


def greedy_dense(params, prompt, n_new):
    toks = list(prompt)
    for _ in range(n_new):
        logits = forward(MCFG, params, jnp.asarray([toks], jnp.int32))
        toks.append(int(jnp.argmax(logits[0, -1])))
    return toks


# Deliberately NOT slow-marked: the one whole-engine greedy-parity check
# that always runs in the default (fast) tier, so serving regressions
# cannot hide behind the `-m 'not slow'` default.
@pytest.mark.parametrize("quantized", [False])
def test_engine_matches_dense_greedy(quantized):
    params = init_params(MCFG, jax.random.PRNGKey(0))
    ecfg = EngineConfig(max_seqs=3, page_size=64, n_pages=32,
                        max_pages_per_seq=4, quantized_kv=quantized,
                        prefill_buckets=(64,))
    eng = DecodeEngine(MCFG, params, ecfg)
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9], [10, 11, 12, 13]]
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    results = eng.run(max_steps=50)
    for rid, prompt in zip(rids, prompts):
        want = greedy_dense(params, prompt, 6)
        assert results[rid] == want, (results[rid], want)


@pytest.mark.slow
def test_engine_continuous_admission():
    """More requests than slots: later requests admitted as slots free."""
    params = init_params(MCFG, jax.random.PRNGKey(0))
    ecfg = EngineConfig(max_seqs=2, page_size=64, n_pages=16,
                        max_pages_per_seq=4, quantized_kv=False,
                        prefill_buckets=(64,))
    eng = DecodeEngine(MCFG, params, ecfg)
    rids = [eng.submit([i + 1, i + 2], max_new_tokens=4) for i in range(5)]
    results = eng.run(max_steps=100)
    assert len(results) == 5
    for rid in rids:
        assert len(results[rid]) == 2 + 4


@pytest.mark.slow
def test_sharded_decode_matches_local():
    if jax.device_count() < 8:
        pytest.skip("needs 8 devices")
    from tf_flash_attention_tpu.parallel.mesh import make_mesh
    from tf_flash_attention_tpu.serving.sharded_decode import sharded_paged_decode

    rng = np.random.default_rng(5)
    cfg = KVCacheConfig(n_kv_heads=8, head_dim=32, page_size=64, n_pages=16,
                        max_seqs=2, max_pages_per_seq=4, quantized=True)
    cache = PagedKVCache.create(cfg)
    alloc = PageAllocator(cfg.n_pages - 1)
    t = 130
    k = jnp.asarray(rng.uniform(-1, 1, (8, t, 32)), jnp.float32)
    v = jnp.asarray(rng.uniform(-1, 1, (8, t, 32)), jnp.float32)
    cache = write_prompt(cache, cfg, 0, np.array(alloc.alloc(0, 3)), k, v)
    q = jnp.asarray(rng.uniform(-1, 1, (2, 16, 32)), jnp.float32)

    o_local = paged_decode_attention(q, cache, cfg)
    mesh = make_mesh((1, 4), ("data", "model"), jax.devices()[:4])
    fn = sharded_paged_decode(mesh, cfg)
    o_sharded = fn(q, cache)
    np.testing.assert_allclose(np.asarray(o_sharded), np.asarray(o_local),
                               rtol=1e-5, atol=1e-5)


def test_fp8_cache_roundtrip_accuracy():
    rng = np.random.default_rng(2)
    cfg = KVCacheConfig(n_kv_heads=2, head_dim=32, page_size=64, n_pages=8,
                        max_seqs=1, max_pages_per_seq=2, quantized=True,
                        quant_dtype=jnp.float8_e4m3fn)
    cache = PagedKVCache.create(cfg)
    assert cache.k_pages.dtype == jnp.float8_e4m3fn
    alloc = PageAllocator(cfg.n_pages - 1)
    t = 100
    k = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)
    v = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)
    cache = write_prompt(cache, cfg, 0, np.array(alloc.alloc(0, 2)), k, v)
    q = jnp.asarray(rng.uniform(-1, 1, (1, 4, 32)), jnp.float32)
    o = paged_decode_attention(q, cache, cfg)
    qg = np.asarray(q[0]).reshape(2, 2, 32)
    s = np.einsum("hgd,htd->hgt", qg, np.asarray(k)) / np.sqrt(32)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    ref = np.einsum("hgt,htd->hgd", p, np.asarray(v)).reshape(4, 32)
    err = np.abs(np.asarray(o[0]) - ref).max()
    assert err < 4e-2, err  # fp8-e4m3 quantization tolerance


# ---------------------------------------------------------------------------
# Sampling (temperature / top-k / top-p) and EOS stop
# ---------------------------------------------------------------------------

def test_sample_tokens_rules():
    from tf_flash_attention_tpu.serving.sampling import sample_tokens

    rng = np.random.default_rng(0)
    logits = jnp.asarray(rng.normal(size=(4, 64)), jnp.float32)
    key = jax.random.PRNGKey(0)
    z = jnp.zeros(4)
    o = jnp.ones(4)

    # temperature 0 -> greedy
    got = sample_tokens(logits, key, z, jnp.zeros(4, jnp.int32), o)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(jnp.argmax(logits, -1)))
    # top_k = 1 -> greedy at any temperature
    got = sample_tokens(logits, key, o * 5.0, jnp.ones(4, jnp.int32), o)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(jnp.argmax(logits, -1)))
    # tiny top_p -> greedy (only the best token survives the nucleus)
    got = sample_tokens(logits, key, o * 5.0, jnp.zeros(4, jnp.int32),
                        o * 1e-6)
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(jnp.argmax(logits, -1)))
    # top_k = 8: every sample lands inside the per-slot top-8 set
    k8 = jnp.full((4,), 8, jnp.int32)
    top8 = np.argsort(-np.asarray(logits), axis=-1)[:, :8]
    for i in range(20):
        got = np.asarray(sample_tokens(
            logits, jax.random.fold_in(key, i), o * 1.3, k8, o))
        for s in range(4):
            assert got[s] in top8[s]
    # determinism: same key -> same tokens
    a = sample_tokens(logits, key, o, k8, o * 0.9)
    b = sample_tokens(logits, key, o, k8, o * 0.9)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # per-slot mixing: slot 0 greedy, others sampled
    temps = jnp.asarray([0.0, 1.0, 1.0, 1.0])
    got = np.asarray(sample_tokens(logits, key, temps,
                                   jnp.zeros(4, jnp.int32), o))
    assert got[0] == int(jnp.argmax(logits[0]))


@pytest.mark.slow
def test_engine_sampling_and_eos():
    from tf_flash_attention_tpu.serving.sampling import SamplingParams

    params = init_params(MCFG, jax.random.PRNGKey(0))
    ecfg = EngineConfig(max_seqs=2, page_size=64, n_pages=16,
                        max_pages_per_seq=4, quantized_kv=False,
                        prefill_buckets=(64,), seed=7)
    eng = DecodeEngine(MCFG, params, ecfg)
    r_greedy = eng.submit([1, 2, 3], max_new_tokens=5)
    r_sampled = eng.submit([1, 2, 3], max_new_tokens=5,
                           sampling=SamplingParams(temperature=1.0, top_k=10))
    results = eng.run(max_steps=50)
    # greedy slot matches the dense greedy oracle even while co-batched
    # with a sampled request
    assert results[r_greedy] == greedy_dense(params, [1, 2, 3], 5)
    assert len(results[r_sampled]) == 3 + 5
    assert all(0 <= t < MCFG.vocab for t in results[r_sampled])

    # EOS stop: force eos_id to the greedy continuation's first token so
    # the request retires after one generated token
    first = greedy_dense(params, [1, 2, 3], 1)[-1]
    eng2 = DecodeEngine(MCFG, params, ecfg)
    rid = eng2.submit([1, 2, 3], max_new_tokens=8, eos_id=first)
    results2 = eng2.run(max_steps=50)
    assert results2[rid] == [1, 2, 3, first]


# ---- chunked prefill + prefix caching ----

def _dense_causal_ref(k_hist, v_hist, q, start):
    """Oracle: rows i of q attend keys 0..start+i (inclusive)."""
    n_kv, total, d = k_hist.shape
    chunk, n_q, _ = q.shape
    g = n_q // n_kv
    qg = np.asarray(q).reshape(chunk, n_kv, g, d)
    s = np.einsum("chgd,htd->chgt", qg, np.asarray(k_hist)) / np.sqrt(d)
    kv_pos = np.arange(total)
    mask = kv_pos[None, :] <= (start + np.arange(chunk))[:, None]
    s = np.where(mask[:, None, None, :], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("chgt,htd->chgd", p, np.asarray(v_hist)).reshape(chunk, n_q, d)


@pytest.mark.parametrize("quantized", [False, True])
def test_paged_prefill_matches_dense(quantized):
    from tf_flash_attention_tpu.serving.kv_cache import write_tokens_at
    from tf_flash_attention_tpu.serving.prefill import paged_prefill_attention

    rng = np.random.default_rng(3)
    cfg = KVCacheConfig(n_kv_heads=2, head_dim=32, page_size=64, n_pages=16,
                        max_seqs=2, max_pages_per_seq=4, quantized=quantized,
                        dtype=jnp.float32)
    cache = PagedKVCache.create(cfg)
    alloc = PageAllocator(cfg.n_pages - 1)
    start, chunk, true = 70, 48, 40
    k_hist = jnp.asarray(rng.uniform(-1, 1, (2, start, 32)), jnp.float32)
    v_hist = jnp.asarray(rng.uniform(-1, 1, (2, start, 32)), jnp.float32)
    pages = alloc.alloc(0, 2)  # covers ceil((70+40)/64) = 2 pages
    cache = write_prompt(cache, cfg, 0, np.array(pages), k_hist, v_hist)

    k_new = jnp.asarray(rng.uniform(-1, 1, (2, chunk, 32)), jnp.float32)
    v_new = jnp.asarray(rng.uniform(-1, 1, (2, chunk, 32)), jnp.float32)
    q = jnp.asarray(rng.uniform(-1, 1, (chunk, 4, 32)), jnp.float32)
    cache = write_tokens_at(cache, cfg, 0, start, k_new, v_new, true,
                            trash_page=cfg.n_pages - 1)
    assert int(cache.lengths[0]) == start + true
    o = paged_prefill_attention(q, cache, cfg, 0, start, true)

    k_all = jnp.concatenate([k_hist, k_new[:, :true]], axis=1)
    v_all = jnp.concatenate([v_hist, v_new[:, :true]], axis=1)
    ref = _dense_causal_ref(k_all, v_all, q[:true], start)
    tol = 4e-2 if quantized else 2e-5
    err = np.abs(np.asarray(o[:true]) - ref).max()
    assert err < tol, err


def test_write_tokens_at_matches_write_prompt():
    """Chunked positional writes produce the same pages as the bulk write."""
    from tf_flash_attention_tpu.serving.kv_cache import write_tokens_at

    rng = np.random.default_rng(4)
    cfg = KVCacheConfig(n_kv_heads=2, head_dim=32, page_size=32, n_pages=8,
                        max_seqs=1, max_pages_per_seq=4, quantized=False,
                        dtype=jnp.float32)
    t = 90
    k = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)
    v = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)
    pages = np.array([3, 1, 5])

    bulk = PagedKVCache.create(cfg)
    bulk = write_prompt(bulk, cfg, 0, pages, k, v)

    chunked = PagedKVCache.create(cfg)
    chunked = dataclasses.replace(
        chunked, page_tables=chunked.page_tables.at[0, :3].set(
            jnp.asarray(pages, jnp.int32)))
    # uneven chunk boundaries crossing pages, with padding on the last chunk
    for start, n in ((0, 40), (40, 40), (80, 10)):
        pad = 40 - n
        kc = jnp.pad(k[:, start:start + n], ((0, 0), (0, pad), (0, 0)))
        vc = jnp.pad(v[:, start:start + n], ((0, 0), (0, pad), (0, 0)))
        chunked = write_tokens_at(chunked, cfg, 0, start, kc, vc, n,
                                  trash_page=cfg.n_pages - 1)
    np.testing.assert_array_equal(np.asarray(bulk.lengths), np.asarray(chunked.lengths))
    for p in pages:
        np.testing.assert_allclose(np.asarray(bulk.k_pages[:, p]),
                                   np.asarray(chunked.k_pages[:, p]), rtol=0, atol=0)
        np.testing.assert_allclose(np.asarray(bulk.v_pages[:, p]),
                                   np.asarray(chunked.v_pages[:, p]), rtol=0, atol=0)


@pytest.mark.slow
def test_engine_chunked_matches_dense_greedy():
    """Chunked prefill (multi-chunk, partial pages) == dense greedy."""
    params = init_params(MCFG, jax.random.PRNGKey(0))
    ecfg = EngineConfig(max_seqs=3, page_size=64, n_pages=32,
                        max_pages_per_seq=4, quantized_kv=False,
                        prefill_mode="chunked", prefill_chunk=8,
                        prefix_caching=False)
    eng = DecodeEngine(MCFG, params, ecfg)
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17],
               [10, 11, 12, 13]]
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    results = eng.run(max_steps=50)
    for rid, prompt in zip(rids, prompts):
        want = greedy_dense(params, prompt, 6)
        assert results[rid] == want, (results[rid], want)


def test_prefix_cache_reuse_refcounts_and_eviction():
    params = init_params(MCFG, jax.random.PRNGKey(0))
    ecfg = EngineConfig(max_seqs=2, page_size=8, n_pages=32,
                        max_pages_per_seq=8, quantized_kv=False,
                        prefill_mode="chunked", prefill_chunk=8,
                        prefix_caching=True)
    eng = DecodeEngine(MCFG, params, ecfg)
    prefix = [(i * 7) % MCFG.vocab for i in range(16)]  # 2 full pages
    p1 = prefix + [1]
    p2 = prefix + [2, 3]
    # both live at once: the second shares the first's prefix pages while
    # the first is still decoding, and survives the first's retirement
    r1 = eng.submit(p1, max_new_tokens=6)
    r2 = eng.submit(p2, max_new_tokens=8)
    results = eng.run(max_steps=60)
    assert eng.prefix_cache.hits >= 1
    assert results[r1] == greedy_dense(params, p1, 6)
    assert results[r2] == greedy_dense(params, p2, 8)
    # all slots retired: only the registry's references remain
    assert len(eng.prefix_cache) == 2
    free_before = eng.allocator.free_pages
    assert free_before == (ecfg.n_pages - 1) - 2
    # eviction releases the registry pages back to the free list
    eng.prefix_cache.evict(eng.allocator, ecfg.n_pages)
    assert eng.allocator.free_pages == ecfg.n_pages - 1


# ---- speculative decoding ----

def test_multitoken_decode_matches_oracle():
    from tf_flash_attention_tpu.serving.decode import paged_multitoken_decode
    from tf_flash_attention_tpu.serving.kv_cache import write_tokens_at

    rng = np.random.default_rng(11)
    cfg = KVCacheConfig(n_kv_heads=2, head_dim=32, page_size=64, n_pages=16,
                        max_seqs=2, max_pages_per_seq=4, quantized=False,
                        dtype=jnp.float32)
    cache = PagedKVCache.create(cfg)
    alloc = PageAllocator(cfg.n_pages - 1)
    base, gamma = 70, 3
    total = base + gamma
    k = jnp.asarray(rng.uniform(-1, 1, (2, total, 32)), jnp.float32)
    v = jnp.asarray(rng.uniform(-1, 1, (2, total, 32)), jnp.float32)
    cache = write_prompt(cache, cfg, 0, np.array(alloc.alloc(0, 2)), k, v)
    q = jnp.asarray(rng.uniform(-1, 1, (2, gamma, 4, 32)), jnp.float32)
    o = paged_multitoken_decode(q, cache, cfg)

    # slot 0 oracle: draft i attends positions 0 .. base+i
    for i in range(gamma):
        qg = np.asarray(q[0, i]).reshape(2, 2, 32)
        kv_len = base + i + 1
        s = np.einsum("hgd,htd->hgt", qg, np.asarray(k[:, :kv_len])) / np.sqrt(32)
        p = np.exp(s - s.max(-1, keepdims=True)); p /= p.sum(-1, keepdims=True)
        ref = np.einsum("hgt,htd->hgd", p, np.asarray(v[:, :kv_len])).reshape(4, 32)
        np.testing.assert_allclose(np.asarray(o[0, i]), ref, rtol=3e-5, atol=3e-5)
    # empty slot 1 yields zeros
    np.testing.assert_array_equal(np.asarray(o[1]), 0.0)

    # gamma=1 equals the single-token kernel
    q1 = jnp.asarray(rng.uniform(-1, 1, (2, 4, 32)), jnp.float32)
    o1 = paged_decode_attention(q1, cache, cfg)
    om = paged_multitoken_decode(q1[:, None], cache, cfg)[:, 0]
    np.testing.assert_allclose(np.asarray(om), np.asarray(o1), rtol=1e-6, atol=1e-6)


@pytest.mark.slow
def test_engine_speculative_matches_dense_greedy():
    """Speculative greedy is lossless: identical tokens to dense greedy,
    fewer steps, nonzero acceptance on repetitive continuations."""
    params = init_params(MCFG, jax.random.PRNGKey(0))
    base = dict(max_seqs=2, page_size=16, n_pages=64, max_pages_per_seq=16,
                quantized_kv=False, prefill_mode="chunked", prefill_chunk=8,
                prefix_caching=False)
    # a prompt with a repeating pattern gives the n-gram proposer material
    prompt = [5, 9, 5, 9, 5, 9, 5, 9, 5]
    n_new = 12
    want = greedy_dense(params, prompt, n_new)

    eng = DecodeEngine(MCFG, params, EngineConfig(**base, speculative_tokens=3))
    rid = eng.submit(prompt, max_new_tokens=n_new)
    steps = 0
    while (eng.scheduler.queued or eng.num_active) and steps < 50:
        eng.step()
        steps += 1
    assert eng._results[rid] == want, (eng._results[rid], want)
    assert steps < n_new, steps  # speculation actually saved steps
    assert eng.spec_stats["accepted"] > 0

    # EOS inside an accepted run still stops exactly at EOS
    eos = want[len(prompt) + 4]
    eng2 = DecodeEngine(MCFG, params, EngineConfig(**base, speculative_tokens=3))
    rid2 = eng2.submit(prompt, max_new_tokens=n_new, eos_id=eos)
    res2 = eng2.run(max_steps=50)
    assert res2[rid2] == want[: len(prompt) + 5], (res2[rid2], want)


@pytest.mark.slow
def test_engine_tensor_parallel_matches_dense_greedy():
    """TP engine (sharded params + head-sharded cache under shard_map)
    produces exactly the single-chip greedy tokens."""
    if jax.device_count() < 2:
        pytest.skip("needs 2 devices")
    from tf_flash_attention_tpu.parallel.mesh import make_mesh

    params = init_params(MCFG, jax.random.PRNGKey(0))
    mesh = make_mesh((1, 2), ("data", "model"), jax.devices()[:2])
    ecfg = EngineConfig(max_seqs=2, page_size=64, n_pages=32,
                        max_pages_per_seq=4, quantized_kv=False,
                        prefill_mode="chunked", prefill_chunk=8,
                        prefix_caching=True)
    eng = DecodeEngine(MCFG, params, ecfg, mesh=mesh)
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9, 10, 11, 12, 13]]
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    results = eng.run(max_steps=50)
    for rid, prompt in zip(rids, prompts):
        want = greedy_dense(params, prompt, 6)
        assert results[rid] == want, (results[rid], want)

    # speculative + TP together
    eng2 = DecodeEngine(MCFG, params,
                        dataclasses.replace(ecfg, speculative_tokens=3),
                        mesh=mesh)
    prompt = [5, 9, 5, 9, 5, 9, 5, 9, 5]
    rid = eng2.submit(prompt, max_new_tokens=8)
    res = eng2.run(max_steps=30)
    assert res[rid] == greedy_dense(params, prompt, 8)


# ---- INT4 (nibble-packed) KV cache ----

def _dense_oracle_from(k, v, q):
    """Dense attention oracle on explicit K/V: q (n_q, d) -> (n_q, d)."""
    n_kv, t, d = k.shape
    n_q = q.shape[0]
    g = n_q // n_kv
    qg = np.asarray(q).reshape(n_kv, g, d)
    s = np.einsum("hgd,htd->hgt", qg, np.asarray(k)) / np.sqrt(d)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("hgt,htd->hgd", p, np.asarray(v)).reshape(n_q, d)


def test_int4_cache_roundtrip_accuracy():
    rng = np.random.default_rng(21)
    cfg = KVCacheConfig(n_kv_heads=2, head_dim=32, page_size=64, n_pages=8,
                        max_seqs=1, max_pages_per_seq=2, quantized=True,
                        quant_dtype="int4")
    cache = PagedKVCache.create(cfg)
    # payload halves along the token axis; scales gain the even/odd rows
    assert cache.k_pages.shape == (2, 8, 32, cfg.head_dim_store)
    assert cache.k_scales.shape == (2, 8, 2, 32)
    alloc = PageAllocator(cfg.n_pages - 1)
    t = 100
    k = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)
    v = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)
    cache = write_prompt(cache, cfg, 0, np.array(alloc.alloc(0, 2)), k, v)
    q = jnp.asarray(rng.uniform(-1, 1, (1, 4, 32)), jnp.float32)
    o = paged_decode_attention(q, cache, cfg)
    ref = _dense_oracle_from(np.asarray(k), np.asarray(v), np.asarray(q[0]))
    err = np.abs(np.asarray(o[0]) - ref).max()
    assert err < 1.5e-1, err  # int4 quantization tolerance

    # against the *dequantized* cache contents the kernel must be tight
    from tf_flash_attention_tpu.serving.kv_cache import gather_sequence_kv
    kd, vd = gather_sequence_kv(cache, cfg, 0)
    ref_dq = _dense_oracle_from(kd, vd, np.asarray(q[0]))
    # int4 compute runs through bf16 matmuls, so "tight" means bf16 rounding
    err_dq = np.abs(np.asarray(o[0]) - ref_dq).max()
    assert err_dq < 2e-2, err_dq


def test_int4_write_paths_agree():
    """write_prompt, write_tokens_at (chunked), and append paths produce
    identical packed bytes and scales for the same token stream."""
    from tf_flash_attention_tpu.serving.kv_cache import (
        append_token, append_tokens_batched, write_tokens_at)

    rng = np.random.default_rng(22)
    cfg = KVCacheConfig(n_kv_heads=2, head_dim=32, page_size=32, n_pages=8,
                        max_seqs=1, max_pages_per_seq=4, quantized=True,
                        quant_dtype="int4")
    t = 64
    k = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)
    v = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)
    pages = np.array([3, 1])

    bulk = PagedKVCache.create(cfg)
    bulk = write_prompt(bulk, cfg, 0, pages, k, v)

    # chunked positional writes (XLA scatter path in interpret mode)
    chunked = PagedKVCache.create(cfg)
    chunked = dataclasses.replace(
        chunked, page_tables=chunked.page_tables.at[0, :2].set(
            jnp.asarray(pages, jnp.int32)))
    for start, n in ((0, 40), (40, 24)):
        kc = jnp.pad(k[:, start:start + n], ((0, 0), (0, 40 - n), (0, 0)))
        vc = jnp.pad(v[:, start:start + n], ((0, 0), (0, 40 - n), (0, 0)))
        chunked = write_tokens_at(chunked, cfg, 0, start, kc, vc, n,
                                  trash_page=cfg.n_pages - 1)
    for p in pages:
        np.testing.assert_array_equal(np.asarray(bulk.k_pages[:, p]),
                                      np.asarray(chunked.k_pages[:, p]))
        np.testing.assert_array_equal(np.asarray(bulk.v_pages[:, p]),
                                      np.asarray(chunked.v_pages[:, p]))
        np.testing.assert_array_equal(np.asarray(bulk.k_scales[:, p]),
                                      np.asarray(chunked.k_scales[:, p]))

    # token-by-token appends (both the single and batched spec paths)
    single = PagedKVCache.create(cfg)
    single = dataclasses.replace(
        single, page_tables=single.page_tables.at[0, :2].set(
            jnp.asarray(pages, jnp.int32)))
    batched = single
    for i in range(t):
        single = append_token(single, cfg, 0, k[:, i], v[:, i])
        batched = append_tokens_batched(
            batched, cfg, k[None, :, i], v[None, :, i],
            jnp.asarray([True]), trash_page=cfg.n_pages - 1)
    for got in (single, batched):
        for p in pages:
            np.testing.assert_array_equal(np.asarray(bulk.k_pages[:, p]),
                                          np.asarray(got.k_pages[:, p]))
            np.testing.assert_array_equal(np.asarray(bulk.v_scales[:, p]),
                                          np.asarray(got.v_scales[:, p]))


def test_int4_paged_prefill_matches_dense():
    from tf_flash_attention_tpu.serving.kv_cache import write_tokens_at
    from tf_flash_attention_tpu.serving.prefill import paged_prefill_attention

    rng = np.random.default_rng(23)
    cfg = KVCacheConfig(n_kv_heads=2, head_dim=32, page_size=64, n_pages=16,
                        max_seqs=2, max_pages_per_seq=4, quantized=True,
                        quant_dtype="int4")
    cache = PagedKVCache.create(cfg)
    alloc = PageAllocator(cfg.n_pages - 1)
    start, chunk, true = 70, 48, 40
    k_hist = jnp.asarray(rng.uniform(-1, 1, (2, start, 32)), jnp.float32)
    v_hist = jnp.asarray(rng.uniform(-1, 1, (2, start, 32)), jnp.float32)
    cache = write_prompt(cache, cfg, 0, np.array(alloc.alloc(0, 2)), k_hist, v_hist)
    k_new = jnp.asarray(rng.uniform(-1, 1, (2, chunk, 32)), jnp.float32)
    v_new = jnp.asarray(rng.uniform(-1, 1, (2, chunk, 32)), jnp.float32)
    q = jnp.asarray(rng.uniform(-1, 1, (chunk, 4, 32)), jnp.float32)
    cache = write_tokens_at(cache, cfg, 0, start, k_new, v_new, true,
                            trash_page=cfg.n_pages - 1)
    o = paged_prefill_attention(q, cache, cfg, 0, start, true)
    k_all = jnp.concatenate([k_hist, k_new[:, :true]], axis=1)
    v_all = jnp.concatenate([v_hist, v_new[:, :true]], axis=1)
    ref = _dense_causal_ref(k_all, v_all, q[:true], start)
    err = np.abs(np.asarray(o[:true]) - ref).max()
    assert err < 1.5e-1, err

    # tight against the dequantized contents
    from tf_flash_attention_tpu.serving.kv_cache import gather_sequence_kv
    kd, vd = gather_sequence_kv(cache, cfg, 0)
    ref_dq = _dense_causal_ref(jnp.asarray(kd), jnp.asarray(vd), q[:true], start)
    err_dq = np.abs(np.asarray(o[:true]) - ref_dq).max()
    assert err_dq < 2e-2, err_dq


def test_int4_multitoken_decode_matches_oracle():
    from tf_flash_attention_tpu.serving.decode import paged_multitoken_decode
    from tf_flash_attention_tpu.serving.kv_cache import gather_sequence_kv

    rng = np.random.default_rng(24)
    cfg = KVCacheConfig(n_kv_heads=2, head_dim=32, page_size=64, n_pages=16,
                        max_seqs=2, max_pages_per_seq=4, quantized=True,
                        quant_dtype="int4")
    cache = PagedKVCache.create(cfg)
    alloc = PageAllocator(cfg.n_pages - 1)
    base, gamma = 70, 3
    total = base + gamma
    k = jnp.asarray(rng.uniform(-1, 1, (2, total, 32)), jnp.float32)
    v = jnp.asarray(rng.uniform(-1, 1, (2, total, 32)), jnp.float32)
    cache = write_prompt(cache, cfg, 0, np.array(alloc.alloc(0, 2)), k, v)
    q = jnp.asarray(rng.uniform(-1, 1, (2, gamma, 4, 32)), jnp.float32)
    o = paged_multitoken_decode(q, cache, cfg)
    kd, vd = gather_sequence_kv(cache, cfg, 0)
    for i in range(gamma):
        kv_len = base + i + 1
        ref = _dense_oracle_from(kd[:, :kv_len], vd[:, :kv_len],
                                 np.asarray(q[0, i]))
        np.testing.assert_allclose(np.asarray(o[0, i]), ref,
                                   rtol=2e-2, atol=2e-2)
    np.testing.assert_array_equal(np.asarray(o[1]), 0.0)


@pytest.mark.slow
def test_engine_int4_kv_runs_greedy():
    """End-to-end engine sanity with the int4 cache: chunked prefill +
    decode + speculation all run; tokens match the same engine re-run
    (determinism) and lengths are correct.  Exact dense-greedy parity is
    not required at 4-bit — the accuracy contract is the kernel-vs-
    dequantized-oracle checks above."""
    params = init_params(MCFG, jax.random.PRNGKey(0))
    ecfg = EngineConfig(max_seqs=2, page_size=64, n_pages=32,
                        max_pages_per_seq=4, quantized_kv=True,
                        kv_quant_dtype="int4", prefill_mode="chunked",
                        prefill_chunk=8, prefix_caching=True)
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9, 10, 11]]
    eng = DecodeEngine(MCFG, params, ecfg)
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    results = eng.run(max_steps=50)
    eng2 = DecodeEngine(MCFG, params, ecfg)
    rids2 = [eng2.submit(p, max_new_tokens=6) for p in prompts]
    results2 = eng2.run(max_steps=50)
    for rid, rid2, prompt in zip(rids, rids2, prompts):
        assert len(results[rid]) == len(prompt) + 6
        assert results[rid] == results2[rid2]
        assert all(0 <= t < MCFG.vocab for t in results[rid])


# ---- rule-based masking in the paged serving kernels ----

def _local_visible(q_pos, kv_pos, w, s=0):
    diff = q_pos - kv_pos
    ok = (kv_pos <= q_pos) & ((diff >> s) < w)
    if s:
        ok &= (diff & ((1 << s) - 1)) == 0
    return ok


def _masked_oracle(k, v, q, q_pos, w, s=0):
    """Dense oracle with the LocalRule mask; q (n_q, d) at position q_pos."""
    n_kv, t, d = k.shape
    g = q.shape[0] // n_kv
    qg = np.asarray(q).reshape(n_kv, g, d)
    sc = np.einsum("hgd,htd->hgt", qg, np.asarray(k)) / np.sqrt(d)
    vis = _local_visible(q_pos, np.arange(t), w, s)
    sc = np.where(vis[None, None, :], sc, -1e30)
    p = np.exp(sc - sc.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("hgt,htd->hgd", p, np.asarray(v)).reshape(-1, d)


@pytest.mark.parametrize("w,s", [(16, 0), (8, 2), (4, 7)])
def test_local_rule_paged_decode(w, s):
    """LocalRule decode vs masked dense oracle.  (4, 7) has stride 128 >
    page_size, so whole processed pages hold no visible key — exercises
    the live-row guard; all cases exercise first-live-page skipping."""
    from tf_flash_attention_tpu.mask_rules import LocalRule

    rng = np.random.default_rng(31)
    cfg = KVCacheConfig(n_kv_heads=2, head_dim=32, page_size=64, n_pages=16,
                        max_seqs=2, max_pages_per_seq=8, quantized=False,
                        dtype=jnp.float32)
    cache = PagedKVCache.create(cfg)
    alloc = PageAllocator(cfg.n_pages - 1)
    t = 500
    k = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)
    v = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)
    cache = write_prompt(cache, cfg, 0, np.array(alloc.alloc(0, 8)), k, v)
    q = jnp.asarray(rng.uniform(-1, 1, (2, 4, 32)), jnp.float32)
    rule = LocalRule(window_size=w, log2_stride_size=s, is_causal=True)
    o = paged_decode_attention(q, cache, cfg, rule=rule)
    ref = _masked_oracle(k, v, np.asarray(q[0]), t - 1, w, s)
    np.testing.assert_allclose(np.asarray(o[0]), ref, rtol=3e-5, atol=3e-5)
    np.testing.assert_array_equal(np.asarray(o[1]), 0.0)
    # causal rule (the default) unchanged by the new plumbing
    o_causal = paged_decode_attention(q, cache, cfg)
    ref_causal = _dense_oracle_from(np.asarray(k), np.asarray(v),
                                    np.asarray(q[0]))
    np.testing.assert_allclose(np.asarray(o_causal[0]), ref_causal,
                               rtol=3e-5, atol=3e-5)


def test_local_rule_multitoken_decode():
    from tf_flash_attention_tpu.mask_rules import LocalRule
    from tf_flash_attention_tpu.serving.decode import paged_multitoken_decode

    rng = np.random.default_rng(32)
    cfg = KVCacheConfig(n_kv_heads=2, head_dim=32, page_size=64, n_pages=16,
                        max_seqs=2, max_pages_per_seq=8, quantized=False,
                        dtype=jnp.float32)
    cache = PagedKVCache.create(cfg)
    alloc = PageAllocator(cfg.n_pages - 1)
    base, gamma, w = 300, 3, 24
    total = base + gamma
    k = jnp.asarray(rng.uniform(-1, 1, (2, total, 32)), jnp.float32)
    v = jnp.asarray(rng.uniform(-1, 1, (2, total, 32)), jnp.float32)
    cache = write_prompt(cache, cfg, 0, np.array(alloc.alloc(0, 5)), k, v)
    q = jnp.asarray(rng.uniform(-1, 1, (2, gamma, 4, 32)), jnp.float32)
    rule = LocalRule(window_size=w, is_causal=True)
    o = paged_multitoken_decode(q, cache, cfg, rule=rule)
    for i in range(gamma):
        q_pos = base + i
        ref = _masked_oracle(k[:, :q_pos + 1], v[:, :q_pos + 1],
                             np.asarray(q[0, i]), q_pos, w)
        np.testing.assert_allclose(np.asarray(o[0, i]), ref,
                                   rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("w,s", [(32, 0), (8, 2)])
def test_local_rule_paged_prefill(w, s):
    from tf_flash_attention_tpu.mask_rules import LocalRule
    from tf_flash_attention_tpu.serving.kv_cache import write_tokens_at
    from tf_flash_attention_tpu.serving.prefill import paged_prefill_attention

    rng = np.random.default_rng(33)
    cfg = KVCacheConfig(n_kv_heads=2, head_dim=32, page_size=64, n_pages=16,
                        max_seqs=2, max_pages_per_seq=8, quantized=False,
                        dtype=jnp.float32)
    cache = PagedKVCache.create(cfg)
    alloc = PageAllocator(cfg.n_pages - 1)
    start, chunk, true = 300, 48, 40
    k_hist = jnp.asarray(rng.uniform(-1, 1, (2, start, 32)), jnp.float32)
    v_hist = jnp.asarray(rng.uniform(-1, 1, (2, start, 32)), jnp.float32)
    cache = write_prompt(cache, cfg, 0, np.array(alloc.alloc(0, 6)),
                         k_hist, v_hist)
    k_new = jnp.asarray(rng.uniform(-1, 1, (2, chunk, 32)), jnp.float32)
    v_new = jnp.asarray(rng.uniform(-1, 1, (2, chunk, 32)), jnp.float32)
    q = jnp.asarray(rng.uniform(-1, 1, (chunk, 4, 32)), jnp.float32)
    cache = write_tokens_at(cache, cfg, 0, start, k_new, v_new, true,
                            trash_page=cfg.n_pages - 1)
    rule = LocalRule(window_size=w, log2_stride_size=s, is_causal=True)
    o = paged_prefill_attention(q, cache, cfg, 0, start, true, rule=rule)
    k_all = np.concatenate([np.asarray(k_hist), np.asarray(k_new[:, :true])], 1)
    v_all = np.concatenate([np.asarray(v_hist), np.asarray(v_new[:, :true])], 1)
    for i in (0, 17, true - 1):
        ref = _masked_oracle(k_all[:, :start + i + 1], v_all[:, :start + i + 1],
                             np.asarray(q[i]), start + i, w, s)
        np.testing.assert_allclose(np.asarray(o[i]), ref,
                                   rtol=3e-5, atol=3e-5, err_msg=f"row {i}")


@pytest.mark.slow
def test_engine_sliding_window_matches_dense_greedy():
    """A sliding-window model (ModelConfig.rule = LocalRule) served through
    the engine produces exactly the dense-forward greedy tokens — the rule
    flows through chunked prefill, decode, and speculation."""
    from tf_flash_attention_tpu.mask_rules import LocalRule

    mcfg = dataclasses.replace(
        MCFG, rule=LocalRule(window_size=8, is_causal=True))
    params = init_params(mcfg, jax.random.PRNGKey(0))

    def greedy_dense_w(prompt, n_new):
        toks = list(prompt)
        for _ in range(n_new):
            logits = forward(mcfg, params, jnp.asarray([toks], jnp.int32))
            toks.append(int(jnp.argmax(logits[0, -1])))
        return toks

    ecfg = EngineConfig(max_seqs=2, page_size=8, n_pages=64,
                        max_pages_per_seq=8, quantized_kv=False,
                        prefill_mode="chunked", prefill_chunk=8,
                        prefix_caching=False)
    eng = DecodeEngine(mcfg, params, ecfg)
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12], [7, 8, 9]]
    rids = [eng.submit(p, max_new_tokens=8) for p in prompts]
    results = eng.run(max_steps=60)
    for rid, prompt in zip(rids, prompts):
        want = greedy_dense_w(prompt, 8)
        assert results[rid] == want, (results[rid], want)

    # speculative + sliding window
    eng2 = DecodeEngine(mcfg, params,
                        dataclasses.replace(ecfg, speculative_tokens=2))
    prompt = [5, 9, 5, 9, 5, 9, 5, 9, 5]
    rid = eng2.submit(prompt, max_new_tokens=8)
    res = eng2.run(max_steps=40)
    assert res[rid] == greedy_dense_w(prompt, 8)


@pytest.mark.slow
def test_engine_sliding_window_page_eviction():
    """With a LocalRule, a long generation holds only window-bounded pages:
    evicted pages return to the allocator (and the scheduler budget), and
    the tokens still match the dense forward exactly."""
    from tf_flash_attention_tpu.mask_rules import LocalRule

    w = 8
    mcfg = dataclasses.replace(
        MCFG, rule=LocalRule(window_size=w, is_causal=True))
    params = init_params(mcfg, jax.random.PRNGKey(0))
    ps = 8
    ecfg = EngineConfig(max_seqs=1, page_size=ps, n_pages=10,
                        max_pages_per_seq=9, quantized_kv=False,
                        prefill_mode="chunked", prefill_chunk=8,
                        prefix_caching=False)
    eng = DecodeEngine(mcfg, params, ecfg)
    prompt = [1, 2, 3, 4, 5, 6]
    n_new = 40  # total 46 tokens = 6 pages > window bound of 2
    rid = eng.submit(prompt, max_new_tokens=n_new)
    max_owned = 0
    steps = 0
    while (eng.scheduler.queued or eng.num_active) and steps < 80:
        eng.step()
        if eng._slots[0] is not None:
            max_owned = max(max_owned, len(eng.allocator.owned(0)))
        steps += 1
    results = dict(eng._results)
    # window reaches back w-1 tokens from the next query row; plus the
    # page being appended into: ceil((w - 1) / ps) + 2 pages is the bound
    assert max_owned <= (w - 1 + ps - 1) // ps + 2, max_owned
    assert eng.allocator.free_pages == ecfg.n_pages - 1  # all returned

    def greedy_dense_w(prompt, n_new):
        toks = list(prompt)
        for _ in range(n_new):
            logits = forward(mcfg, params, jnp.asarray([toks], jnp.int32))
            toks.append(int(jnp.argmax(logits[0, -1])))
        return toks

    assert results[rid] == greedy_dense_w(prompt, n_new)

    # back-to-back long requests keep admitting: window slots reserve only
    # their capped live set (not full-length pages), so the second request
    # fits the budget even while the first generates
    eng2 = DecodeEngine(mcfg, params, ecfg)
    r1 = eng2.submit(prompt, max_new_tokens=n_new)
    r2 = eng2.submit(prompt, max_new_tokens=n_new)
    res2 = eng2.run(max_steps=160)
    want = greedy_dense_w(prompt, n_new)
    assert res2[r1] == want and res2[r2] == want


# ---- sequence-sharded (context-parallel) decode ----

@pytest.mark.slow
def test_seq_sharded_decode_matches_flat():
    """Context-parallel decode: KV pages round-robin over 4 shards, partial
    (o, l, m) merged by one psum — must equal the single-device decode on
    the equivalent flat cache, through appends crossing page boundaries."""
    if jax.device_count() < 4:
        pytest.skip("needs 4 devices")
    from tf_flash_attention_tpu.parallel.mesh import make_mesh
    from tf_flash_attention_tpu.serving.seq_sharded_decode import (
        create_seq_sharded_cache, seq_sharded_append,
        seq_sharded_paged_decode, write_prompt_seq_sharded)

    rng = np.random.default_rng(41)
    n_shards, ps = 4, 32
    mesh = make_mesh((n_shards,), ("seq",), jax.devices()[:n_shards])
    cfg = KVCacheConfig(n_kv_heads=2, head_dim=32, page_size=ps, n_pages=8,
                        max_seqs=2, max_pages_per_seq=6, quantized=True)
    # flat reference cache big enough for every shard's pages
    flat_cfg = dataclasses.replace(
        cfg, n_pages=64, max_pages_per_seq=n_shards * cfg.max_pages_per_seq)

    t = 7 * ps + 11  # 8 global pages: shards 0..3 hold 2,2,2,2 (last partial)
    k = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)
    v = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)

    sc = create_seq_sharded_cache(cfg, mesh, "seq")
    allocs = [PageAllocator(cfg.n_pages - 1) for _ in range(n_shards)]
    per_shard = [a.alloc(0, 3) for a in allocs]
    sc = write_prompt_seq_sharded(sc, cfg, mesh, "seq", 0, per_shard, k, v)

    flat = PagedKVCache.create(flat_cfg)
    falloc = PageAllocator(flat_cfg.n_pages - 1)
    flat = write_prompt(flat, flat_cfg, 0, np.array(falloc.alloc(0, 8)), k, v)

    q = jnp.asarray(rng.uniform(-1, 1, (2, 4, 32)), jnp.float32)
    dec = seq_sharded_paged_decode(mesh, cfg, "seq")
    o = dec(q, sc)
    o_flat = paged_decode_attention(q, flat, flat_cfg)
    # per-shard m shifts change the bf16 rounding of the probability tiles,
    # so parity is at bf16-rounding level, not fp32-exact
    np.testing.assert_allclose(np.asarray(o), np.asarray(o_flat),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(o[1]), 0.0)

    # appends crossing a page boundary: positions t..t+29 span global pages
    # 7 (owner shard 3) and 8 (owner shard 0, needs a fresh mapped page)
    app = seq_sharded_append(mesh, cfg, "seq", trash_page=cfg.n_pages - 1,
                             interpret=True)
    # pre-map global page 8 -> shard 0, local logical page 2
    new_page = allocs[0].alloc(1, 1)[0]
    tables = np.array(sc.page_tables)
    tables[0, 0, 2] = new_page
    sc = dataclasses.replace(sc, page_tables=jnp.asarray(tables))
    # the flat reference also needs global page 8 mapped for growth
    flat = assign_page(flat, 0, 8, falloc.alloc(1, 1)[0])
    active = jnp.asarray([True, False])
    new_toks = rng.uniform(-1, 1, (30, 2, 32)).astype(np.float32)
    for i in range(30):
        kn = jnp.zeros((2, 2, 32), jnp.float32).at[0].set(jnp.asarray(new_toks[i]))
        sc = app(sc, kn, kn, active)
        flat = append_tokens_batched_ref(flat, flat_cfg, kn, kn, active,
                                             trash_page=flat_cfg.n_pages - 1)
    o2 = dec(q, sc)
    o2_flat = paged_decode_attention(q, flat, flat_cfg)
    np.testing.assert_allclose(np.asarray(o2), np.asarray(o2_flat),
                               rtol=1e-3, atol=1e-3)
    # per-shard local lengths sum to the global length
    assert int(np.asarray(sc.lengths)[:, 0].sum()) == t + 30


def test_fp8_e5m2_cache_roundtrip_accuracy():
    rng = np.random.default_rng(42)
    cfg = KVCacheConfig(n_kv_heads=2, head_dim=32, page_size=64, n_pages=8,
                        max_seqs=1, max_pages_per_seq=2, quantized=True,
                        quant_dtype=jnp.float8_e5m2)
    cache = PagedKVCache.create(cfg)
    assert cache.k_pages.dtype == jnp.float8_e5m2
    alloc = PageAllocator(cfg.n_pages - 1)
    t = 100
    k = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)
    v = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)
    cache = write_prompt(cache, cfg, 0, np.array(alloc.alloc(0, 2)), k, v)
    q = jnp.asarray(rng.uniform(-1, 1, (1, 4, 32)), jnp.float32)
    o = paged_decode_attention(q, cache, cfg)
    ref = _dense_oracle_from(np.asarray(k), np.asarray(v), np.asarray(q[0]))
    err = np.abs(np.asarray(o[0]) - ref).max()
    assert err < 1.5e-1, err  # e5m2 has 2 mantissa bits


@pytest.mark.slow
def test_seq_sharded_prefill_and_local_rule():
    """Context-parallel prefill matches flat prefill, and a LocalRule
    window works across shards (global positions reconstructed from the
    round-robin placement; per-shard window page skipping)."""
    if jax.device_count() < 4:
        pytest.skip("needs 4 devices")
    from tf_flash_attention_tpu.mask_rules import LocalRule
    from tf_flash_attention_tpu.parallel.mesh import make_mesh
    from tf_flash_attention_tpu.serving.prefill import paged_prefill_attention
    from tf_flash_attention_tpu.serving.seq_sharded_decode import (
        create_seq_sharded_cache, seq_sharded_paged_decode,
        seq_sharded_paged_prefill, write_prompt_seq_sharded)

    rng = np.random.default_rng(43)
    n_shards, ps = 4, 32
    mesh = make_mesh((n_shards,), ("seq",), jax.devices()[:n_shards])
    cfg = KVCacheConfig(n_kv_heads=2, head_dim=32, page_size=ps, n_pages=8,
                        max_seqs=2, max_pages_per_seq=6, quantized=True)
    flat_cfg = dataclasses.replace(
        cfg, n_pages=64, max_pages_per_seq=n_shards * cfg.max_pages_per_seq)

    total = 7 * ps + 11
    start, chunk = total - 40, 40  # prefill rows = the last 40 tokens
    chunk_pad = 48
    k = jnp.asarray(rng.uniform(-1, 1, (2, total, 32)), jnp.float32)
    v = jnp.asarray(rng.uniform(-1, 1, (2, total, 32)), jnp.float32)

    sc = create_seq_sharded_cache(cfg, mesh, "seq")
    allocs = [PageAllocator(cfg.n_pages - 1) for _ in range(n_shards)]
    per_shard = [a.alloc(0, 3) for a in allocs]
    sc = write_prompt_seq_sharded(sc, cfg, mesh, "seq", 0, per_shard, k, v)

    flat = PagedKVCache.create(flat_cfg)
    falloc = PageAllocator(flat_cfg.n_pages - 1)
    flat = write_prompt(flat, flat_cfg, 0, np.array(falloc.alloc(0, 8)), k, v)

    q = jnp.asarray(rng.uniform(-1, 1, (chunk_pad, 4, 32)), jnp.float32)
    pf = seq_sharded_paged_prefill(mesh, cfg, "seq")
    o = pf(q, sc, jnp.asarray(0), jnp.asarray(start), jnp.asarray(chunk))
    o_flat = paged_prefill_attention(q, flat, flat_cfg, 0, start, chunk)
    np.testing.assert_allclose(np.asarray(o[:chunk]), np.asarray(o_flat[:chunk]),
                               rtol=1e-3, atol=1e-3)

    # window rule across shards: decode and prefill vs the flat kernels
    rule = LocalRule(window_size=48, is_causal=True)
    q1 = jnp.asarray(rng.uniform(-1, 1, (2, 4, 32)), jnp.float32)
    dec = seq_sharded_paged_decode(mesh, cfg, "seq", rule=rule)
    o_dec = dec(q1, sc)
    o_dec_flat = paged_decode_attention(q1, flat, flat_cfg, rule=rule)
    np.testing.assert_allclose(np.asarray(o_dec), np.asarray(o_dec_flat),
                               rtol=1e-3, atol=1e-3)

    pf_w = seq_sharded_paged_prefill(mesh, cfg, "seq", rule=rule)
    o_w = pf_w(q, sc, jnp.asarray(0), jnp.asarray(start), jnp.asarray(chunk))
    o_w_flat = paged_prefill_attention(q, flat, flat_cfg, 0, start, chunk,
                                       rule=rule)
    np.testing.assert_allclose(np.asarray(o_w[:chunk]),
                               np.asarray(o_w_flat[:chunk]),
                               rtol=1e-3, atol=1e-3)

    # strided window (stride 8 > nothing special, exercises divisibility)
    rule_s = LocalRule(window_size=8, log2_stride_size=3, is_causal=True)
    dec_s = seq_sharded_paged_decode(mesh, cfg, "seq", rule=rule_s)
    o_s = dec_s(q1, sc)
    o_s_flat = paged_decode_attention(q1, flat, flat_cfg, rule=rule_s)
    np.testing.assert_allclose(np.asarray(o_s), np.asarray(o_s_flat),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.slow
def test_engine_stats_counters():
    params = init_params(MCFG, jax.random.PRNGKey(0))
    ecfg = EngineConfig(max_seqs=2, page_size=64, n_pages=16,
                        max_pages_per_seq=4, quantized_kv=False,
                        prefill_mode="chunked", prefill_chunk=8,
                        prefix_caching=False)
    eng = DecodeEngine(MCFG, params, ecfg)
    eng.submit([1, 2, 3, 4, 5], max_new_tokens=4)
    eng.submit([7, 8, 9], max_new_tokens=3)
    eng.run(max_steps=30)
    st = eng.stats
    assert st["admitted"] == 2 and st["retired"] == 2
    # prefill emits the first token; steps produce the rest
    assert st["decode_tokens"] == (4 - 1) + (3 - 1)
    assert st["prefill_tokens"] == 5 + 3
    assert st["prefill_chunks"] == 1 + 1
    assert st["steps"] >= 3
    assert st["pages_in_use_peak"] >= 2
    assert st["pages_evicted"] == 0  # causal model: no window eviction


@pytest.mark.slow
def test_serving_rule_fuzz():
    """Reference-style random sweep (tests/test_base.py fuzzing model) over
    window/stride/lengths/page sizes for the paged decode kernel's rule
    masking, interpret mode."""
    from tf_flash_attention_tpu.mask_rules import CausalRule, LocalRule
    from tf_flash_attention_tpu.serving.kv_cache import gather_sequence_kv

    rng = np.random.default_rng(97)
    for it in range(6):
        ps = int(rng.choice([16, 32, 64]))
        t = int(rng.integers(ps + 1, 6 * ps))
        n_pages = -(-t // ps) + 2
        d = 32
        if it % 3 == 0:
            rule = CausalRule()
        else:
            rule = LocalRule(window_size=int(rng.integers(1, 40)),
                             log2_stride_size=int(rng.choice([0, 1, 3])),
                             is_causal=True)
        cfg = KVCacheConfig(n_kv_heads=2, head_dim=d, page_size=ps,
                            n_pages=n_pages, max_seqs=1,
                            max_pages_per_seq=n_pages - 1,
                            quantized=bool(it % 2), dtype=jnp.float32)
        cache = PagedKVCache.create(cfg)
        alloc = PageAllocator(cfg.n_pages - 1)
        k = jnp.asarray(rng.uniform(-1, 1, (2, t, d)), jnp.float32)
        v = jnp.asarray(rng.uniform(-1, 1, (2, t, d)), jnp.float32)
        cache = write_prompt(cache, cfg, 0,
                             np.array(alloc.alloc(0, -(-t // ps))), k, v)
        q = jnp.asarray(rng.uniform(-1, 1, (1, 4, d)), jnp.float32)
        o = paged_decode_attention(q, cache, cfg, rule=rule)
        kd, vd = gather_sequence_kv(cache, cfg, 0)
        if isinstance(rule, LocalRule):
            ref = _masked_oracle(kd, vd, np.asarray(q[0]), t - 1,
                                 rule.window_size, rule.log2_stride_size)
        else:
            ref = _dense_oracle_from(kd, vd, np.asarray(q[0]))
        tol = 2e-2 if cfg.quantized else 3e-5
        err = np.abs(np.asarray(o[0]) - ref).max()
        assert err < tol, (it, ps, t, rule, err)


@pytest.mark.slow
def test_engine_rolling_table_unbounded_generation():
    """Sliding-window model generates far beyond max_pages_per_seq * page
    (the logical page table wraps; dead below-window entries are reused)
    with exact dense-greedy parity throughout."""
    from tf_flash_attention_tpu.mask_rules import LocalRule

    w, ps = 8, 8
    mcfg = dataclasses.replace(
        MCFG, rule=LocalRule(window_size=w, is_causal=True))
    params = init_params(mcfg, jax.random.PRNGKey(0))
    # table holds 5 logical pages = 40 tokens; we run to ~70
    ecfg = EngineConfig(max_seqs=1, page_size=ps, n_pages=12,
                        max_pages_per_seq=5, quantized_kv=False,
                        prefill_mode="chunked", prefill_chunk=8,
                        prefix_caching=False)
    eng = DecodeEngine(mcfg, params, ecfg)
    prompt = [1, 2, 3, 4, 5, 6]
    n_new = 64
    rid = eng.submit(prompt, max_new_tokens=n_new)
    results = eng.run(max_steps=100)

    def greedy_dense_w(prompt, n_new):
        toks = list(prompt)
        for _ in range(n_new):
            logits = forward(mcfg, params, jnp.asarray([toks], jnp.int32))
            toks.append(int(jnp.argmax(logits[0, -1])))
        return toks

    assert results[rid] == greedy_dense_w(prompt, n_new)
    assert eng.allocator.free_pages == ecfg.n_pages - 1


@pytest.mark.slow
def test_engine_long_prompt_lazy_paging():
    """A prompt longer than the table (and most of physical memory) prefills
    lazily under a window rule: pages map per chunk and evict behind the
    window, so peak usage stays window+chunk-bounded."""
    from tf_flash_attention_tpu.mask_rules import LocalRule

    w, ps = 8, 8
    mcfg = dataclasses.replace(
        MCFG, rule=LocalRule(window_size=w, is_causal=True))
    params = init_params(mcfg, jax.random.PRNGKey(0))
    ecfg = EngineConfig(max_seqs=1, page_size=ps, n_pages=8,
                        max_pages_per_seq=6, quantized_kv=False,
                        prefill_mode="chunked", prefill_chunk=8,
                        prefix_caching=False)
    eng = DecodeEngine(mcfg, params, ecfg)
    # 90-token prompt = 12 logical pages > 7 physical > 6 table entries
    prompt = [(i * 13 + 5) % MCFG.vocab for i in range(90)]
    rid = eng.submit(prompt, max_new_tokens=4)
    results = eng.run(max_steps=30)

    def greedy_dense_w(prompt, n_new):
        toks = list(prompt)
        for _ in range(n_new):
            logits = forward(mcfg, params, jnp.asarray([toks], jnp.int32))
            toks.append(int(jnp.argmax(logits[0, -1])))
        return toks

    assert results[rid] == greedy_dense_w(prompt, 4)
    assert eng.stats["pages_evicted"] >= 9  # prompt pages evicted in flight


@pytest.mark.slow
def test_engine_overflow_without_window_raises():
    """A causal (non-window) sequence that outgrows max_pages_per_seq fails
    loudly instead of silently corrupting the table."""
    params = init_params(MCFG, jax.random.PRNGKey(0))
    ecfg = EngineConfig(max_seqs=1, page_size=8, n_pages=16,
                        max_pages_per_seq=2, quantized_kv=False,
                        prefill_mode="chunked", prefill_chunk=8,
                        prefix_caching=False)
    eng = DecodeEngine(MCFG, params, ecfg)
    eng.submit([1, 2, 3, 4, 5, 6], max_new_tokens=20)
    with pytest.raises(RuntimeError, match="max_pages_per_seq"):
        eng.run(max_steps=40)


def test_write_tokens_at_seq_sharded_matches_prompt_write():
    """Chunked CP writes (page_stride/page_offset) produce byte-identical
    shard contents to the bulk round-robin prompt write."""
    if jax.device_count() < 4:
        pytest.skip("needs 4 devices")
    from tf_flash_attention_tpu.parallel.mesh import make_mesh
    from tf_flash_attention_tpu.serving.kv_cache import write_tokens_at
    from tf_flash_attention_tpu.serving.seq_sharded_decode import (
        create_seq_sharded_cache, write_prompt_seq_sharded)

    rng = np.random.default_rng(51)
    n, ps = 4, 32
    mesh = make_mesh((n,), ("seq",), jax.devices()[:n])
    cfg = KVCacheConfig(n_kv_heads=2, head_dim=32, page_size=ps, n_pages=8,
                        max_seqs=1, max_pages_per_seq=4, quantized=True)
    t = 7 * ps + 9
    k = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)
    v = jnp.asarray(rng.uniform(-1, 1, (2, t, 32)), jnp.float32)

    ref = create_seq_sharded_cache(cfg, mesh, "seq")
    allocs = [PageAllocator(cfg.n_pages - 1) for _ in range(n)]
    per_shard = [a.alloc(0, 2) for a in allocs]
    ref = write_prompt_seq_sharded(ref, cfg, mesh, "seq", 0, per_shard, k, v)

    # per-shard chunked writes with the same physical pages
    chunk = 64
    for r in range(n):
        local = PagedKVCache.create(cfg)
        local = dataclasses.replace(
            local, page_tables=local.page_tables.at[0, :2].set(
                jnp.asarray(per_shard[r], jnp.int32)))
        start = 0
        while start < t:
            m = min(chunk, t - start)
            kc = jnp.pad(k[:, start:start + m], ((0, 0), (0, chunk - m), (0, 0)))
            vc = jnp.pad(v[:, start:start + m], ((0, 0), (0, chunk - m), (0, 0)))
            local = write_tokens_at(local, cfg, 0, start, kc, vc, m,
                                    trash_page=cfg.n_pages - 1,
                                    page_stride=n, page_offset=r)
            start += m
        # compare the allocated pages only (trash-page contents are
        # garbage by design: non-owned tokens route there)
        for p in per_shard[r]:
            np.testing.assert_array_equal(np.asarray(local.k_pages[:, p]),
                                          np.asarray(ref.k_pages[r, :, p]))
            np.testing.assert_array_equal(np.asarray(local.k_scales[:, p]),
                                          np.asarray(ref.k_scales[r, :, p]))
            np.testing.assert_array_equal(np.asarray(local.v_pages[:, p]),
                                          np.asarray(ref.v_pages[r, :, p]))
        assert int(local.lengths[0]) == int(ref.lengths[r, 0])


@pytest.mark.parametrize("kvq", [jnp.int8, "int4"])
@pytest.mark.slow
def test_engine_context_parallel_matches_dense_greedy(kvq):
    """Context-parallel engine (KV pages round-robin over a seq axis, CP
    step functions under shard_map) produces exactly the single-chip
    greedy tokens — through chunked prefill, decode appends crossing shard
    boundaries, and speculation.  int4 exercises the nibble-packed write
    paths under page striding."""
    if jax.device_count() < 4:
        pytest.skip("needs 4 devices")
    from tf_flash_attention_tpu.parallel.mesh import make_mesh

    params = init_params(MCFG, jax.random.PRNGKey(0))
    mesh = make_mesh((4,), ("seq",), jax.devices()[:4])
    ecfg = EngineConfig(max_seqs=2, page_size=16, n_pages=8,
                        max_pages_per_seq=4, quantized_kv=True,
                        kv_quant_dtype=kvq,
                        prefill_mode="chunked", prefill_chunk=16,
                        prefix_caching=False)
    eng = DecodeEngine(MCFG, params, ecfg, mesh=mesh)
    assert eng.cp == 4
    # prompts long enough that pages land on several shards; generations
    # cross page (and thus shard-owner) boundaries
    prompts = [[(i * 7 + 1) % MCFG.vocab for i in range(40)], [7, 8, 9]]
    rids = [eng.submit(p, max_new_tokens=10) for p in prompts]
    results = eng.run(max_steps=50)
    if kvq == "int4":
        # 4-bit quantization noise can legitimately flip greedy choices vs
        # the dense oracle (as in test_engine_int4_kv_runs_greedy): the
        # contract here is determinism + full-length outputs; numeric
        # accuracy is covered by the kernel-vs-dequantized-oracle tests
        eng_b = DecodeEngine(MCFG, params, ecfg, mesh=mesh)
        rids_b = [eng_b.submit(p, max_new_tokens=10) for p in prompts]
        results_b = eng_b.run(max_steps=50)
        for rid, rid_b, prompt in zip(rids, rids_b, prompts):
            assert len(results[rid]) == len(prompt) + 10
            assert results[rid] == results_b[rid_b]
    else:
        for rid, prompt in zip(rids, prompts):
            want = greedy_dense(params, prompt, 10)
            assert results[rid] == want, (results[rid], want)

    # speculative + context parallel
    eng2 = DecodeEngine(MCFG, params,
                        dataclasses.replace(ecfg, speculative_tokens=3),
                        mesh=mesh)
    prompt = [5, 9, 5, 9, 5, 9, 5, 9, 5]
    rid = eng2.submit(prompt, max_new_tokens=12)
    res = eng2.run(max_steps=40)
    if kvq == "int4":
        assert len(res[rid]) == len(prompt) + 12
    else:
        assert res[rid] == greedy_dense(params, prompt, 12)
        assert eng2.spec_stats["accepted"] > 0


@pytest.mark.slow
def test_engine_tp_x_cp_matches_dense_greedy():
    """2D serving mesh (model x seq): heads sharded AND pages sharded —
    exact single-chip greedy through prefill, decode, speculation."""
    if jax.device_count() < 8:
        pytest.skip("needs 8 devices")
    from tf_flash_attention_tpu.parallel.mesh import make_mesh

    params = init_params(MCFG, jax.random.PRNGKey(0))
    mesh = make_mesh((2, 4), ("model", "seq"), jax.devices()[:8])
    ecfg = EngineConfig(max_seqs=2, page_size=16, n_pages=8,
                        max_pages_per_seq=4, quantized_kv=True,
                        prefill_mode="chunked", prefill_chunk=16,
                        prefix_caching=False)
    eng = DecodeEngine(MCFG, params, ecfg, mesh=mesh)
    assert eng.tp == 2 and eng.cp == 4
    prompts = [[(i * 7 + 1) % MCFG.vocab for i in range(40)], [7, 8, 9]]
    rids = [eng.submit(p, max_new_tokens=10) for p in prompts]
    results = eng.run(max_steps=50)
    for rid, prompt in zip(rids, prompts):
        want = greedy_dense(params, prompt, 10)
        assert results[rid] == want, (results[rid], want)

    eng2 = DecodeEngine(MCFG, params,
                        dataclasses.replace(ecfg, speculative_tokens=2),
                        mesh=mesh)
    prompt = [5, 9, 5, 9, 5, 9, 5]
    rid = eng2.submit(prompt, max_new_tokens=8)
    res = eng2.run(max_steps=30)
    assert res[rid] == greedy_dense(params, prompt, 8)


@pytest.mark.slow
def test_engine_cp_admission_respects_binding_shard():
    """Round-robin placement puts every sequence's first page on shard 0,
    so CP admission must budget against the binding shard — six 1-page
    requests against 3 usable pages per shard queue (and all finish)
    instead of crashing shard 0's allocator."""
    if jax.device_count() < 4:
        pytest.skip("needs 4 devices")
    from tf_flash_attention_tpu.parallel.mesh import make_mesh

    params = init_params(MCFG, jax.random.PRNGKey(0))
    mesh = make_mesh((4,), ("seq",), jax.devices()[:4])
    ecfg = EngineConfig(max_seqs=6, page_size=16, n_pages=4,
                        max_pages_per_seq=4, quantized_kv=False,
                        prefill_mode="chunked", prefill_chunk=16,
                        prefix_caching=False)
    eng = DecodeEngine(MCFG, params, ecfg, mesh=mesh)
    rids = [eng.submit([i + 1, i + 2, i + 3], max_new_tokens=4)
            for i in range(6)]
    results = eng.run(max_steps=80)
    assert len(results) == 6
    for rid in rids:
        assert len(results[rid]) == 3 + 4


@pytest.mark.slow
def test_engine_noncausal_rule_rejected():
    from tf_flash_attention_tpu.mask_rules import FullRule, LocalRule

    params = init_params(MCFG, jax.random.PRNGKey(0))
    for rule in (FullRule(), LocalRule(window_size=8, is_causal=False)):
        mcfg = dataclasses.replace(MCFG, rule=rule)
        with pytest.raises(ValueError, match="autoregressive"):
            DecodeEngine(mcfg, params, EngineConfig(max_seqs=1))
    # window + bucketed prefill rejected too
    mcfg = dataclasses.replace(
        MCFG, rule=LocalRule(window_size=8, is_causal=True))
    with pytest.raises(ValueError, match="chunked"):
        DecodeEngine(mcfg, params, EngineConfig(max_seqs=1,
                                                prefill_mode="bucketed"))


def test_serving_prefill_fuzz():
    """Random sweep over chunk positions/rules for the paged prefill
    kernel (interpret mode), against the masked dense oracle built from
    the dequantized cache contents."""
    from tf_flash_attention_tpu.mask_rules import CausalRule, LocalRule
    from tf_flash_attention_tpu.serving.kv_cache import (
        gather_sequence_kv, write_tokens_at)
    from tf_flash_attention_tpu.serving.prefill import paged_prefill_attention

    rng = np.random.default_rng(98)
    for it in range(4):
        ps = int(rng.choice([16, 32]))
        start = int(rng.integers(1, 4 * ps))
        chunk = int(rng.choice([16, 24, 40]))
        true = int(rng.integers(chunk // 2, chunk + 1))
        d = 32
        n_pages = -(-(start + chunk) // ps) + 2
        if it % 2 == 0:
            rule = CausalRule()
        else:
            rule = LocalRule(window_size=int(rng.integers(2, 30)),
                             log2_stride_size=int(rng.choice([0, 1])),
                             is_causal=True)
        cfg = KVCacheConfig(n_kv_heads=2, head_dim=d, page_size=ps,
                            n_pages=n_pages, max_seqs=1,
                            max_pages_per_seq=n_pages - 1,
                            quantized=bool(it % 2), dtype=jnp.float32)
        cache = PagedKVCache.create(cfg)
        alloc = PageAllocator(cfg.n_pages - 1)
        k_h = jnp.asarray(rng.uniform(-1, 1, (2, start, d)), jnp.float32)
        v_h = jnp.asarray(rng.uniform(-1, 1, (2, start, d)), jnp.float32)
        cache = write_prompt(cache, cfg, 0,
                             np.array(alloc.alloc(0, -(-(start + chunk) // ps))),
                             k_h, v_h)
        k_n = jnp.asarray(rng.uniform(-1, 1, (2, chunk, d)), jnp.float32)
        v_n = jnp.asarray(rng.uniform(-1, 1, (2, chunk, d)), jnp.float32)
        # keep int4 even-start invariant out of scope: pack==1 here
        cache = write_tokens_at(cache, cfg, 0, start, k_n, v_n, true,
                                trash_page=cfg.n_pages - 1)
        q = jnp.asarray(rng.uniform(-1, 1, (chunk, 4, d)), jnp.float32)
        o = paged_prefill_attention(q, cache, cfg, 0, start, true, rule=rule)
        kd, vd = gather_sequence_kv(cache, cfg, 0)
        w = rule.window_size if isinstance(rule, LocalRule) else 1 << 30
        sshift = rule.log2_stride_size if isinstance(rule, LocalRule) else 0
        for i in (0, true - 1):
            q_pos = start + i
            ref = _masked_oracle(kd[:, :q_pos + 1], vd[:, :q_pos + 1],
                                 np.asarray(q[i]), q_pos, w, sshift)
            tol = 2e-2 if cfg.quantized else 3e-5
            err = np.abs(np.asarray(o[i]) - ref).max()
            assert err < tol, (it, ps, start, chunk, rule, i, err)


@pytest.mark.slow
def test_engine_cp_sliding_window_matches_dense_greedy():
    """Sliding-window model on the context-parallel engine: the kernels
    mask on global positions and skip per-shard pages below the window;
    output matches the dense forward exactly (bounded-length sequences —
    eviction/rolling tables stay single-shard)."""
    if jax.device_count() < 4:
        pytest.skip("needs 4 devices")
    from tf_flash_attention_tpu.mask_rules import LocalRule
    from tf_flash_attention_tpu.parallel.mesh import make_mesh

    mcfg = dataclasses.replace(
        MCFG, rule=LocalRule(window_size=12, is_causal=True))
    params = init_params(mcfg, jax.random.PRNGKey(0))
    mesh = make_mesh((4,), ("seq",), jax.devices()[:4])
    ecfg = EngineConfig(max_seqs=2, page_size=16, n_pages=8,
                        max_pages_per_seq=4, quantized_kv=False,
                        prefill_mode="chunked", prefill_chunk=16,
                        prefix_caching=False)
    eng = DecodeEngine(mcfg, params, ecfg, mesh=mesh)

    def greedy_dense_w(prompt, n_new):
        toks = list(prompt)
        for _ in range(n_new):
            logits = forward(mcfg, params, jnp.asarray([toks], jnp.int32))
            toks.append(int(jnp.argmax(logits[0, -1])))
        return toks

    # 40-token prompt spans several shards; window 12 reaches across the
    # page/shard boundaries during both prefill and decode
    prompts = [[(i * 7 + 1) % MCFG.vocab for i in range(40)], [7, 8, 9]]
    rids = [eng.submit(p, max_new_tokens=10) for p in prompts]
    results = eng.run(max_steps=50)
    for rid, prompt in zip(rids, prompts):
        want = greedy_dense_w(prompt, 10)
        assert results[rid] == want, (results[rid], want)


@pytest.mark.slow
def test_engine_cp_window_rolling_and_lazy_prompt():
    """Sliding-window model on the CP engine with rolling tables: a prompt
    larger than the per-shard tables and a generation past the nominal
    table reach both match dense greedy, with pages evicted behind the
    window across shards throughout."""
    if jax.device_count() < 4:
        pytest.skip("needs 4 devices")
    from tf_flash_attention_tpu.mask_rules import LocalRule
    from tf_flash_attention_tpu.parallel.mesh import make_mesh

    w, ps = 12, 8
    mcfg = dataclasses.replace(
        MCFG, rule=LocalRule(window_size=w, is_causal=True))
    params = init_params(mcfg, jax.random.PRNGKey(0))
    mesh = make_mesh((4,), ("seq",), jax.devices()[:4])
    # per-shard table: 3 pages = 24 tokens -> nominal reach 4*3*8 = 96
    ecfg = EngineConfig(max_seqs=1, page_size=ps, n_pages=6,
                        max_pages_per_seq=3, quantized_kv=False,
                        prefill_mode="chunked", prefill_chunk=8,
                        prefix_caching=False)
    eng = DecodeEngine(mcfg, params, ecfg, mesh=mesh)

    def greedy_dense_w(prompt, n_new):
        toks = list(prompt)
        for _ in range(n_new):
            logits = forward(mcfg, params, jnp.asarray([toks], jnp.int32))
            toks.append(int(jnp.argmax(logits[0, -1])))
        return toks

    # 120-token prompt (15 global pages > 4*3 table entries and > 4*5
    # physical pages) + 40 generated tokens -> total 160 > nominal reach
    prompt = [(i * 13 + 5) % MCFG.vocab for i in range(120)]
    rid = eng.submit(prompt, max_new_tokens=40)
    results = eng.run(max_steps=80)
    assert results[rid] == greedy_dense_w(prompt, 40)
    assert eng.stats["pages_evicted"] >= 15
    for a in eng.allocators:
        assert a.free_pages == ecfg.n_pages - 1  # all pages returned
