#!/usr/bin/env python3
"""Kernel-against-plain timings on one NVIDIA GPU.

For every hand-written kernel this times the kernel and the plain version
XLA compiles from the same semantics, at one real shape each, and checks
that the two agree:

* forward and backward at causal_1d, S=4096, B·H=64, d=128, bf16 — the
  Triton kernels against ``ops/chunked.py``, and cuDNN's fused attention
  (``jax.nn.dot_product_attention(implementation="cudnn")``) as the number
  to beat;
* paged decode, INT8 and INT4 KV, B=16, context 8192, 8 KV heads, d=128 —
  the Triton kernel against ``serving/decode.paged_attention_xla``, and for
  INT8 also JAX's bundled Triton paged attention as a library comparison;
* the KV-cache writes (XLA scatter on donated caches), decode-step append
  and 512-token chunk write;
* a large bf16 matrix product and a large copy, what plain XLA reaches on
  the same card.

Times are the median of host wall times around calls that end in
``block_until_ready``, after a warm-up.  Progress lines go to stdout; the
last line is one JSON object with the card, its power limit and every
time in milliseconds.  Fails when JAX finds no GPU.

Usage: ``python bench.py``
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from tf_flash_attention_tpu.block_sizes import choose_block_config
from tf_flash_attention_tpu.mask_rules import CausalRule
from tf_flash_attention_tpu.ops.backend import default_interpret
from tf_flash_attention_tpu.ops.backward import flash_backward
from tf_flash_attention_tpu.ops.chunked import flash_attention_xla
from tf_flash_attention_tpu.ops.forward import flash_forward
from tf_flash_attention_tpu.ops.kernel_common import LOG2E
from tf_flash_attention_tpu.serving.decode import (
    _first_live_page, paged_attention_xla, paged_decode_attention,
)
from tf_flash_attention_tpu.serving.kv_cache import (
    KVCacheConfig, PagedKVCache, append_tokens_batched, write_tokens_at,
)
from tf_flash_attention_tpu.sync_modes import make_sync_pack
from tf_flash_attention_tpu.utils.profiling import (
    gpu_name_and_power, median_time, setup_compile_cache,
)


def _ms(t: float) -> float:
    return round(t * 1e3, 4)


def _check(name, got, want, tol):
    """Max error relative to the reference's largest magnitude."""
    want = want.astype(jnp.float32)
    err = float(jnp.max(jnp.abs(got.astype(jnp.float32) - want)))
    rel = err / max(float(jnp.max(jnp.abs(want))), 1e-30)
    print(f"  {name}: max|err|/max|ref| {rel:.2e} (tol {tol:.0e})", flush=True)
    if not rel <= tol:
        raise AssertionError(f"{name}: relative error {rel} above {tol}")


def attention_times(S=4096, B=8, H=8, D=128):
    """Forward and backward: Triton kernels, the chunked XLA flash path,
    and cuDNN, at causal_1d bf16."""
    rng = np.random.default_rng(0)
    mk = lambda: jnp.asarray(rng.standard_normal((B * H, S, D)), jnp.bfloat16)
    q, k, v, do = mk(), mk(), mk(), mk()
    pack = make_sync_pack("none_front", (S,), (S,))
    rule = CausalRule()
    cfg = choose_block_config(S, S, D, D, q.dtype)
    scale = 1.0 / np.sqrt(D)

    fwd = jax.jit(lambda q, k, v: flash_forward(
        q, k, v, pack=pack, rule=rule, config=cfg, scale=scale))
    plain_fwd = jax.jit(lambda q, k, v: flash_attention_xla(
        q, k, v, pack=pack, rule=rule, scale=scale, block_q=512,
        block_kv=512))
    to_bsnh = lambda x: x.reshape(B, H, S, D).transpose(0, 2, 1, 3)
    cudnn_fwd = jax.jit(lambda q, k, v: jax.nn.dot_product_attention(
        to_bsnh(q), to_bsnh(k), to_bsnh(v), is_causal=True, scale=scale,
        implementation="cudnn"))

    o, l, m = fwd(q, k, v)
    o_plain = plain_fwd(q, k, v)[0]
    o_cudnn = cudnn_fwd(q, k, v).transpose(0, 2, 1, 3).reshape(B * H, S, D)
    _check("forward triton vs chunked", o, o_plain, 2e-2)
    _check("forward triton vs cudnn", o, o_cudnn, 2e-2)

    bwd = jax.jit(lambda q, k, v, o, l, m, do: flash_backward(
        q, k, v, o, l, m, do, pack=pack, rule=rule, config=cfg, scale=scale))

    def plain_bwd(q, k, v, do):
        _, vjp = jax.vjp(lambda q, k, v: plain_fwd(q, k, v)[0], q, k, v)
        return vjp(do)

    def cudnn_bwd(q, k, v, do):
        _, vjp = jax.vjp(lambda q, k, v: cudnn_fwd(q, k, v), q, k, v)
        return vjp(to_bsnh(do))

    plain_bwd, cudnn_bwd = jax.jit(plain_bwd), jax.jit(cudnn_bwd)
    want = plain_bwd(q, k, v, do)
    for name, a, b in zip("QKV", bwd(q, k, v, o, l, m, do), want):
        _check(f"backward triton d{name} vs chunked", a, b, 5e-2)

    res = {
        "fwd_triton": median_time(fwd, q, k, v),
        "fwd_chunked": median_time(plain_fwd, q, k, v),
        "fwd_cudnn": median_time(cudnn_fwd, q, k, v),
        "bwd_triton": median_time(bwd, q, k, v, o, l, m, do),
        "bwd_chunked": median_time(plain_bwd, q, k, v, do),
        "bwd_cudnn": median_time(cudnn_bwd, q, k, v, do),
    }
    flops = 4 * B * H * S * S * D / 2         # causal: half the square
    for name, t in res.items():
        work = flops * (2.5 if name.startswith("bwd") else 1.0)
        print(f"  {name}: {t * 1e3:.3f} ms  ({work / t / 1e12:.1f} TFLOP/s "
              f"useful)", flush=True)
    return res


def _random_cache(cfg: KVCacheConfig, B: int, length: int, seed: int):
    """A cache whose B slots hold ``length`` random tokens each, made on
    the device: random payload bytes and positive per-token scales."""
    key = jax.random.PRNGKey(seed)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    shape = (cfg.n_kv_heads, cfg.n_pages, cfg.page_rows, cfg.head_dim_store)
    pay = lambda k: jax.random.randint(k, shape, -127, 128, jnp.int32).astype(jnp.int8)
    sc_shape = (cfg.n_kv_heads, cfg.n_pages, cfg.tok_pack, cfg.page_rows)
    sc = lambda k: jax.random.uniform(k, sc_shape, jnp.float32, 0.5, 1.5) / 64
    width = cfg.max_pages_per_seq
    tables = jnp.arange(B * width, dtype=jnp.int32).reshape(B, width)
    return PagedKVCache(
        k_pages=pay(k1), v_pages=pay(k2), k_scales=sc(k3), v_scales=sc(k4),
        page_tables=tables, lengths=jnp.full((B,), length, jnp.int32))


def decode_times(B=16, ctx=8192, n_kv=8, g=1, D=128, page=256):
    """Paged decode per KV format: Triton kernel against the plain
    gather-dequantize-attend XLA version."""
    res = {}
    for fmt, qdt in (("int8", jnp.int8), ("int4", "int4")):
        cfg = KVCacheConfig(
            n_kv_heads=n_kv, head_dim=D, page_size=page,
            n_pages=B * ctx // page + 1, max_seqs=B,
            max_pages_per_seq=ctx // page, quantized=True, quant_dtype=qdt)
        cache = _random_cache(cfg, B, ctx, seed=1)
        q = jax.random.normal(jax.random.PRNGKey(2), (B, n_kv * g, D),
                              jnp.bfloat16)
        kern = jax.jit(lambda q, c: paged_decode_attention(q, c, cfg))

        def plain(q, c):
            qg = (q.astype(jnp.float32) * (LOG2E / np.sqrt(D))).reshape(B, n_kv, g, D)
            first = _first_live_page(CausalRule(), c.lengths, 1, page)
            counts = -(-c.lengths // page)
            o, _, _ = paged_attention_xla(
                qg, c, cfg, c.page_tables, first, counts,
                (c.lengths - 1)[:, None] + jnp.zeros((1, g), jnp.int32),
                rule=CausalRule())
            return o.reshape(B, n_kv * g, D).astype(q.dtype)

        plain = jax.jit(plain)
        want = plain(q, cache)
        _check(f"decode {fmt} triton vs plain", kern(q, cache), want, 2e-2)
        times = [(f"decode_{fmt}_triton", median_time(kern, q, cache, iters=20)),
                 (f"decode_{fmt}_plain", median_time(plain, q, cache, iters=20))]
        if fmt == "int8":
            # A library comparison point, not this repo's kernel: JAX's
            # bundled Triton paged attention (split-k over the pages),
            # which takes the same int8 pages and per-token scales.
            from jax.experimental.pallas.ops.gpu.paged_attention import (
                paged_attention,
            )
            lib = jax.jit(lambda q, c: paged_attention(
                (q.astype(jnp.float32) / np.sqrt(D)).astype(q.dtype),
                c.k_pages, c.v_pages, c.page_tables, c.lengths,
                c.k_scales[:, :, 0], c.v_scales[:, :, 0],
                k_splits=min(16, cfg.max_pages_per_seq),
                interpret=default_interpret()))
            _check("decode int8 jax library vs plain", lib(q, cache), want, 2e-2)
            times.append(("decode_int8_jax_library",
                          median_time(lib, q, cache, iters=20)))
        kv_bytes = 2 * B * n_kv * ctx * (D // cfg.tok_pack + 4)
        for name, t in times:
            res[name] = t
            print(f"  {name}: {t * 1e3:.3f} ms  ({kv_bytes / t / 1e9:.0f} GB/s "
                  f"of KV read)", flush=True)
    return res


def kv_write_times(B=16, ctx=8192, n_kv=8, D=128, page=256, chunk=512,
                   n=32):
    """XLA scatter KV writes on a donated int8 cache: one decode-step
    append per slot, and one chunked-prefill write.  Each is timed as
    ``n`` writes in one jitted scan, per write: alone, one write is
    shorter than the host's dispatch of a call."""
    cfg = KVCacheConfig(
        n_kv_heads=n_kv, head_dim=D, page_size=page,
        n_pages=B * ctx // page + 1, max_seqs=B,
        max_pages_per_seq=ctx // page, quantized=True)
    # room for the 12 timed calls of n appends before the table's end
    cache = _random_cache(cfg, B, ctx - 2 * page, seed=3)
    trash = cfg.n_pages - 1
    kn = jax.random.normal(jax.random.PRNGKey(4), (B, n_kv, D), jnp.bfloat16)
    kc = jax.random.normal(jax.random.PRNGKey(5), (n_kv, chunk, D), jnp.bfloat16)
    active = jnp.ones((B,), bool)

    def chained(write):
        def run(c, k, v):
            c, _ = jax.lax.scan(lambda c, _: (write(c, k, v), ()), c, None,
                                length=n)
            return c
        return jax.jit(run, donate_argnums=(0,))

    append = chained(lambda c, k, v: append_tokens_batched(
        c, cfg, k, v, active, trash))
    write = chained(lambda c, k, v: write_tokens_at(
        c, cfg, 0, ctx - 2 * page - chunk, k, v, chunk, trash))

    def timed(fn, args, iters=10):
        nonlocal cache
        for _ in range(2):
            cache = jax.block_until_ready(fn(cache, *args))
        ts = []
        for _ in range(iters):
            t0 = time.perf_counter()
            cache = jax.block_until_ready(fn(cache, *args))
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts) / n

    res = {"kv_append_xla": timed(append, (kn, kn)),
           "kv_chunk_write_xla": timed(write, (kc, kc))}
    for name, t in res.items():
        print(f"  {name}: {t * 1e3:.4f} ms per write", flush=True)
    return res


def probe_times(n=8192, copy_bytes=1 << 30):
    """What plain XLA reaches on this card in the same process: a large
    bf16 matrix product and a large elementwise copy, the practical
    ceilings the kernels' rates are read against."""
    a = jax.random.normal(jax.random.PRNGKey(6), (n, n), jnp.bfloat16)
    x = jnp.zeros((copy_bytes // 4,), jnp.float32)
    res = {"probe_matmul_bf16": median_time(jax.jit(jnp.matmul), a, a),
           "probe_copy": median_time(jax.jit(lambda x: x + 1.0), x)}
    print(f"  probe_matmul_bf16 {n}^3: {res['probe_matmul_bf16'] * 1e3:.3f} ms "
          f"({2 * n ** 3 / res['probe_matmul_bf16'] / 1e12:.1f} TFLOP/s)",
          flush=True)
    print(f"  probe_copy {copy_bytes >> 20} MiB: {res['probe_copy'] * 1e3:.3f} ms "
          f"({2 * copy_bytes / res['probe_copy'] / 1e9:.0f} GB/s read+write)",
          flush=True)
    return res


def compare_kernels():
    """Every kernel against its plain version; returns times in seconds."""
    res = probe_times()
    res.update(attention_times())
    res.update(decode_times())
    res.update(kv_write_times())
    return res


def main():
    setup_compile_cache()
    if jax.default_backend() != "gpu":
        sys.exit("bench.py needs a GPU: JAX found none")
    card = gpu_name_and_power()
    dev = jax.devices()[0]
    print(f"card: {card}", flush=True)
    res = compare_kernels()
    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "ms": {k: _ms(v) for k, v in res.items()},
    }))


if __name__ == "__main__":
    main()
