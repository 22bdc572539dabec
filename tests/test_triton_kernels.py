"""Interpret-mode tests of the Triton kernels and the paths around them.

* The rule-masked forward and backward kernels against the dense oracle
  over local 1d/2d windows, strides and sync modes, GQA groups, and
  partial-tile shapes whose mask patterns repeat (causal diagonals, 2d
  windows) or do not (shifted sync descriptors).
* The paged decode kernel per KV format (bf16/INT8/FP8/INT4) and rule
  (causal/local), against the plain gather-dequantize path and the dense
  oracle on the dequantized cache.
* The XLA KV-cache writes against a plain per-token write.
* The one backend dispatch, the tile table, and that every
  ``pallas_call`` names the Triton route.
"""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tf_flash_attention_tpu.block_sizes import (
    BlockConfig, choose_block_config, pad_dim,
)
from tf_flash_attention_tpu.mask_rules import CausalRule, FullRule, LocalRule
from tf_flash_attention_tpu.ops import backend
from tf_flash_attention_tpu.ops.backward import flash_backward
from tf_flash_attention_tpu.ops.forward import flash_forward
from tf_flash_attention_tpu.ops.reference import build_mask, reference_attention_flat
from tf_flash_attention_tpu.serving.decode import (
    _rule_visible, paged_decode_attention, paged_multitoken_decode,
)
from tf_flash_attention_tpu.serving.kv_cache import (
    KVCacheConfig, PageAllocator, PagedKVCache, append_token,
    append_tokens_batched, gather_sequence_kv, write_prompt, write_tokens_at,
)
from tf_flash_attention_tpu.sync_modes import make_sync_pack

SMALL = BlockConfig(32, 32, 32, 32, 32, 32)


def _flat_case(rule, mode, q_seq, k_seq, d=16, v_d=16, B=2, g=1,
               dtype=jnp.float32, seed=0):
    rng = np.random.default_rng(seed)
    pack = make_sync_pack(mode, q_seq, k_seq)
    q_len, k_len = int(np.prod(q_seq)), int(np.prod(k_seq))
    t = lambda *s: jnp.asarray(rng.uniform(-2, 2, s), dtype)
    q, k, v = t(B * g, q_len, d), t(B, k_len, d), t(B, k_len, v_d)
    do = t(B * g, q_len, v_d)
    mask = jnp.asarray(build_mask(pack, rule).reshape(q_len, k_len))
    return pack, q, k, v, do, mask


def _oracle(q, k, v, mask, g):
    rep = lambda x: jnp.repeat(x, g, axis=0)
    return reference_attention_flat(q, rep(k), rep(v), mask)


def _check_fwd_bwd(rule, mode, q_seq, k_seq, g=1, cfg=SMALL, **kw):
    pack, q, k, v, do, mask = _flat_case(rule, mode, q_seq, k_seq, g=g, **kw)
    n_q, n_k = q.shape[1], k.shape[1]
    tol = (1e-3 if jnp.dtype(q.dtype).itemsize == 2 else 1e-6)

    o, l, m = flash_forward(q, k, v, pack=pack, rule=rule, config=cfg)
    (o2, l2, m2), vjp2 = jax.vjp(lambda q, k, v: _oracle(q, k, v, mask, g),
                                 q, k, v)
    close = lambda a, b, n: np.testing.assert_allclose(
        np.asarray(a, np.float32), np.asarray(b, np.float32),
        rtol=tol * n, atol=tol * n)
    close(o, o2, n_k)
    close(l, l2, n_k)
    # backward through the kernel directly, with the forward's (l, m)
    dq, dk, dv = flash_backward(q, k, v, o, l, m, do, pack=pack, rule=rule,
                                config=cfg)
    zeros = (jnp.zeros_like(l2), jnp.zeros_like(m2))
    dq2, dk2, dv2 = vjp2((do,) + zeros)
    close(dq, dq2, n_k)
    close(dk, dk2, n_q)
    close(dv, dv2, n_q)


# The local-window matrix: 1d/2d windows and strides, every sync mode,
# causal and not — each forward and backward against the dense oracle.
WINDOW_CASES = [
    ("1d w5", LocalRule(5), "none_front", (96,), (96,)),
    ("1d w5 causal", LocalRule(5, is_causal=True), "none_front", (96,), (96,)),
    ("1d w3 s1", LocalRule(3, 1), "none_front", (80,), (80,)),
    ("1d w4 s2 causal", LocalRule(4, 2, True), "scale_front", (64,), (100,)),
    ("1d w7 s1 q!=k", LocalRule(7, 1), "scale_end", (70,), (45,)),
    ("1d w2 s3", LocalRule(2, 3), "none_front", (120,), (120,)),
    ("2d w2", LocalRule(2), "none_front", (8, 8), (8, 8)),
    ("2d w3 causal", LocalRule(3, is_causal=True), "none_front", (8, 9), (8, 9)),
    ("2d w2 s1", LocalRule(2, 1), "scale_front", (6, 8), (12, 8)),
    ("2d w3 scale_end", LocalRule(3), "scale_end", (10, 6), (5, 12)),
    ("2d w2 s1 causal", LocalRule(2, 1, True), "scale_end", (8, 8), (8, 8)),
    ("2d w1", LocalRule(1), "none_front", (7, 9), (7, 9)),
]


@pytest.mark.parametrize("name,rule,mode,q_seq,k_seq", WINDOW_CASES,
                         ids=[c[0] for c in WINDOW_CASES])
def test_local_window_matrix(name, rule, mode, q_seq, k_seq):
    _check_fwd_bwd(rule, mode, q_seq, k_seq)


# Partial-tile shapes: patterns that repeat along the band (causal
# diagonal, 2d window rows), padding edges on both axes, and shifted
# sync descriptors whose patterns do not repeat.
PARTIAL_CASES = [
    ("causal diagonal", CausalRule(), "none_front", (128,), (128,)),
    ("causal padded edges", CausalRule(), "none_front", (75,), (75,)),
    ("2d window rows", LocalRule(2), "none_front", (8, 16), (8, 16)),
    ("shifted scale_front", CausalRule(), "scale_front", (48,), (112,)),
    ("shifted scale_end", LocalRule(6, 1, True), "scale_end", (96,), (40,)),
]


@pytest.mark.parametrize("name,rule,mode,q_seq,k_seq", PARTIAL_CASES,
                         ids=[c[0] for c in PARTIAL_CASES])
def test_partial_tile_shapes(name, rule, mode, q_seq, k_seq):
    _check_fwd_bwd(rule, mode, q_seq, k_seq)


@pytest.mark.parametrize("g", [2, 4, 8])
def test_gqa_groups(g):
    """Query heads share a KV row through the b // g index map; the
    backward folds every member of a group into one dK/dV program."""
    _check_fwd_bwd(LocalRule(9, 0, True), "none_front", (70,), (70,), g=g,
                   B=1)


def test_bf16_with_table_config():
    """The table's tiles (not the small test tiles) on a bf16 case."""
    cfg = choose_block_config(300, 300, 64, 64, jnp.bfloat16)
    _check_fwd_bwd(CausalRule(), "none_front", (300,), (300,), cfg=cfg,
                   d=64, v_d=64, dtype=jnp.bfloat16)


def test_fp8_inputs_compute_in_bf16():
    pack, q, k, v, _, mask = _flat_case(CausalRule(), "none_front", (64,),
                                        (64,), dtype=jnp.float32)
    f8 = lambda x: x.astype(jnp.float8_e4m3fn)
    o, l, m = flash_forward(f8(q), f8(k), f8(v), pack=pack,
                            rule=CausalRule(), config=SMALL)
    assert o.dtype == jnp.float8_e4m3fn and l.dtype == jnp.float32
    b16 = lambda x: f8(x).astype(jnp.bfloat16)
    o2, _, _ = flash_forward(b16(q), b16(k), b16(v), pack=pack,
                             rule=CausalRule(), config=SMALL)
    np.testing.assert_array_equal(np.asarray(o, np.float32),
                                  np.asarray(o2.astype(jnp.float8_e4m3fn),
                                             np.float32))


# ---------------------------------------------------------------------------
# paged decode kernel


KV_FORMATS = {
    "bf16": dict(quantized=False, dtype=jnp.bfloat16),
    "int8": dict(quantized=True, quant_dtype=jnp.int8),
    "fp8": dict(quantized=True, quant_dtype=jnp.float8_e4m3fn),
    "int4": dict(quantized=True, quant_dtype="int4"),
}
DECODE_RULES = {"causal": CausalRule(),
                "local": LocalRule(window_size=20, log2_stride_size=1,
                                   is_causal=True)}


def _filled_cache(fmt, lengths, page=32, n_kv=2, d=32, seed=0):
    cfg = KVCacheConfig(n_kv_heads=n_kv, head_dim=d, page_size=page,
                        n_pages=24, max_seqs=len(lengths),
                        max_pages_per_seq=6, **KV_FORMATS[fmt])
    cache = PagedKVCache.create(cfg)
    alloc = PageAllocator(cfg.n_pages - 1)
    rng = np.random.default_rng(seed)
    for slot, t in enumerate(lengths):
        if t == 0:
            continue
        k = jnp.asarray(rng.uniform(-1, 1, (n_kv, t, d)), jnp.float32)
        v = jnp.asarray(rng.uniform(-1, 1, (n_kv, t, d)), jnp.float32)
        pages = alloc.alloc(slot, -(-t // page))
        cache = write_prompt(cache, cfg, slot, np.array(pages), k, v)
    return cfg, cache


@pytest.mark.parametrize("rule_name", list(DECODE_RULES))
@pytest.mark.parametrize("fmt", list(KV_FORMATS))
def test_paged_decode_per_format_and_rule(fmt, rule_name):
    rule = DECODE_RULES[rule_name]
    lengths = [150, 0, 37]
    cfg, cache = _filled_cache(fmt, lengths)
    g = 2
    q = jax.random.normal(jax.random.PRNGKey(1), (3, cfg.n_kv_heads * g, 32),
                          jnp.float32)
    o = np.asarray(paged_decode_attention(q, cache, cfg, rule=rule))
    # the plain path on the same cache
    o_plain = paged_multitoken_decode(q[:, None], cache, cfg, rule=rule)[:, 0]
    np.testing.assert_allclose(o, np.asarray(o_plain), rtol=2e-2, atol=2e-2)
    # the dense oracle on the dequantized cache
    for slot, t in enumerate(lengths):
        if t == 0:
            np.testing.assert_array_equal(o[slot], 0.0)
            continue
        k, v = gather_sequence_kv(cache, cfg, slot)
        vis = np.asarray(_rule_visible(rule, t - 1, np.arange(t)))
        qg = np.asarray(q[slot]).reshape(cfg.n_kv_heads, g, 32)
        s = np.einsum("hgd,htd->hgt", qg, k) / np.sqrt(32)
        s = np.where(vis, s, -np.inf)
        p = np.exp(s - s.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        ref = np.einsum("hgt,htd->hgd", p, v).reshape(-1, 32)
        np.testing.assert_allclose(o[slot], ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("rule_name", list(DECODE_RULES))
def test_paged_decode_returns_mergeable_stats(rule_name):
    """(o, l, m) from the kernel equal the plain path's, m in base 2."""
    rule = DECODE_RULES[rule_name]
    cfg, cache = _filled_cache("int8", [90, 180])
    q = jax.random.normal(jax.random.PRNGKey(2), (2, 4, 32), jnp.float32)
    o, l, m = paged_decode_attention(q, cache, cfg, rule=rule,
                                     returning_l_m=True)
    o2, l2, m2 = paged_multitoken_decode(q[:, None], cache, cfg, rule=rule,
                                         returning_l_m=True)
    np.testing.assert_allclose(np.asarray(o), np.asarray(o2[:, 0]),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(np.asarray(m), np.asarray(m2[:, 0]),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(np.asarray(l), np.asarray(l2[:, 0]),
                               rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# XLA KV-cache writes against a plain per-token write


@pytest.mark.parametrize("fmt", list(KV_FORMATS))
def test_batched_append_matches_per_token_append(fmt):
    cfg, cache = _filled_cache(fmt, [33, 64, 5])
    rng = np.random.default_rng(3)
    k_new = jnp.asarray(rng.uniform(-1, 1, (3, 2, 32)), jnp.float32)
    v_new = jnp.asarray(rng.uniform(-1, 1, (3, 2, 32)), jnp.float32)
    active = jnp.asarray([True, False, True])
    got = append_tokens_batched(cache, cfg, k_new, v_new, active,
                                trash_page=cfg.n_pages - 1)
    want = cache
    for slot in (0, 2):
        want = append_token(want, cfg, slot, k_new[slot], v_new[slot])
    np.testing.assert_array_equal(np.asarray(got.lengths),
                                  np.asarray(want.lengths))
    for slot in (0, 2):
        for a, b in zip(gather_sequence_kv(got, cfg, slot),
                        gather_sequence_kv(want, cfg, slot)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", list(KV_FORMATS))
def test_chunk_write_matches_per_token_append(fmt):
    """A 16-token chunk at position 32 (true length 11) equals 11 appends."""
    cfg, cache = _filled_cache(fmt, [32])
    tables = np.asarray(cache.page_tables).copy()
    tables[0, 1] = 5
    cache = dataclasses.replace(cache, page_tables=jnp.asarray(tables))
    rng = np.random.default_rng(4)
    k = jnp.asarray(rng.uniform(-1, 1, (2, 16, 32)), jnp.float32)
    v = jnp.asarray(rng.uniform(-1, 1, (2, 16, 32)), jnp.float32)
    got = write_tokens_at(cache, cfg, 0, 32, k, v, 11,
                          trash_page=cfg.n_pages - 1)
    want = cache
    for i in range(11):
        want = append_token(want, cfg, 0, k[:, i], v[:, i])
    assert int(got.lengths[0]) == int(want.lengths[0]) == 43
    for a, b in zip(gather_sequence_kv(got, cfg, 0),
                    gather_sequence_kv(want, cfg, 0)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# dispatch, tiles, routes


@pytest.mark.parametrize("name,want", [("cpu", True), ("gpu", False),
                                       ("rocm", None), ("metal", None)])
def test_backend_dispatch(monkeypatch, name, want):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    if want is None:
        with pytest.raises(RuntimeError, match="no kernel route"):
            backend.default_interpret()
    else:
        assert backend.default_interpret() is want


def test_public_paths_use_the_dispatch(monkeypatch):
    """On an unknown backend the API, the model layer and decode refuse
    rather than fall back to the interpreter."""
    import tf_flash_attention_tpu as fa
    from tf_flash_attention_tpu.parallel.sharded import mha

    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    x = jnp.zeros((1, 16, 32), jnp.float32)
    with pytest.raises(RuntimeError):
        fa.causal_1d(x, x, x, sync_mode="none_front")
    with pytest.raises(RuntimeError):
        mha(x[None], x[None], x[None], rule=CausalRule())
    cfg, cache = _filled_cache("int8", [10])
    with pytest.raises(RuntimeError):
        paged_decode_attention(jnp.zeros((1, 2, 32)), cache, cfg)


def test_every_pallas_call_names_triton():
    root = pathlib.Path(__file__).resolve().parents[1] / "tf_flash_attention_tpu"
    calls = 0
    for path in root.rglob("*.py"):
        src = path.read_text()
        for m in re.finditer(r"pl\.pallas_call\(", src):
            calls += 1
            body = src[m.end():m.end() + 2000]
            assert "backend=ROUTE" in body, f"{path}: unnamed route"
    assert calls == 4
    assert backend.ROUTE == "triton"


@pytest.mark.parametrize("d,want", [(8, 16), (16, 16), (24, 32), (64, 64),
                                    (96, 128), (128, 128), (200, 256)])
def test_pad_dim(d, want):
    assert pad_dim(d) == want


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float16, jnp.float32])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_tile_table_is_valid(dtype, d):
    cfg = choose_block_config(8192, 8192, d, d, dtype)
    for name in ("block_q", "block_kv", "block_q_dq", "block_kv_dq",
                 "block_q_dkv", "block_kv_dkv"):
        b = getattr(cfg, name)
        assert b >= 16 and b & (b - 1) == 0, (name, b)
    assert cfg.num_warps in (4, 8) and cfg.bwd_num_warps in (4, 8)


# ---------------------------------------------------------------------------
# on the card


@pytest.mark.gpu
@pytest.mark.parametrize("rule", [CausalRule(), LocalRule(64, 1, True),
                                  FullRule()], ids=["causal", "local", "full"])
def test_compiled_kernels_match_oracle(gpu, rule):
    cfg = choose_block_config(1024, 1024, 128, 128, jnp.bfloat16)
    _check_fwd_bwd(rule, "none_front", (1024,), (1024,), cfg=cfg, d=128,
                   v_d=128, dtype=jnp.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", list(KV_FORMATS))
def test_compiled_decode_matches_plain(gpu, fmt):
    cfg, cache = _filled_cache(fmt, [500, 0, 1000], page=64, d=128)
    q = jax.random.normal(jax.random.PRNGKey(1), (3, 4, 128), jnp.bfloat16)
    o = paged_decode_attention(q, cache, cfg)
    o2 = paged_multitoken_decode(q[:, None], cache, cfg)[:, 0]
    np.testing.assert_allclose(np.asarray(o, np.float32),
                               np.asarray(o2, np.float32), rtol=3e-2, atol=3e-2)
