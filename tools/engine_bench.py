#!/usr/bin/env python
"""Engine-level serving benchmark on one NVIDIA GPU: full-model decode
step and prefill chunk on a realistic transformer (not just the attention
kernels).

The continuous-batching engine's two compiled functions are timed as the
median of host wall times around calls that end in ``block_until_ready``:

  * ``decode_step`` — one token for every active slot through the whole
    model (embed, per-layer qkv/o + paged INT8 decode attention + MLP,
    final logits, sampling)  ->  decode tokens/s;
  * ``chunk_prefill`` — one prefill chunk through the whole model (paged
    prefill attention against the growing cache)  ->  prefill tokens/s.

Decode runs as two ``lax.scan`` chains of different lengths; their
difference over the extra steps cancels the per-call cost of copying the
caches into the chain.  Fails when JAX finds no GPU.

Usage: python tools/engine_bench.py  (env: EB_SEQS, EB_CTX, EB_CHUNK,
EB_LAYERS, EB_DMODEL, EB_PAGE, EB_KVQ = int8|int4|fp8|none)
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from tf_flash_attention_tpu.models.transformer import ModelConfig, init_params
from tf_flash_attention_tpu.serving.engine import DecodeEngine, EngineConfig
from tf_flash_attention_tpu.utils.profiling import (
    gpu_name_and_power, median_time, setup_compile_cache,
)


def main():
    setup_compile_cache()
    if jax.default_backend() != "gpu":
        sys.exit("engine_bench.py needs a GPU: JAX found none")
    max_seqs = int(os.environ.get("EB_SEQS", 16))
    ctx = int(os.environ.get("EB_CTX", 2048))
    chunk = int(os.environ.get("EB_CHUNK", 512))
    n_layers = int(os.environ.get("EB_LAYERS", 8))
    d_model = int(os.environ.get("EB_DMODEL", 1024))
    kvq = os.environ.get("EB_KVQ", "int8")
    page = int(os.environ.get("EB_PAGE", 256))
    mcfg = ModelConfig(
        vocab=32768, d_model=d_model, n_layers=n_layers, n_heads=8,
        n_kv_heads=8, d_head=128, d_ff=4 * d_model, max_seq=2 * ctx,
        dtype=jnp.bfloat16)
    kvq_dtype = {"int8": jnp.int8, "int4": "int4",
                 "fp8": jnp.float8_e4m3fn}.get(kvq)
    ecfg = EngineConfig(
        max_seqs=max_seqs, page_size=page,
        n_pages=max_seqs * (ctx // page) + max_seqs + 1,
        max_pages_per_seq=2 * ctx // page, quantized_kv=kvq != "none",
        kv_quant_dtype=kvq_dtype if kvq_dtype is not None else jnp.int8,
        prefill_mode="chunked", prefill_chunk=chunk)
    params = init_params(mcfg, jax.random.PRNGKey(0))
    n_params = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(params))
    card = gpu_name_and_power()
    print(f"card: {card}", file=sys.stderr)
    print(f"model: {n_params/1e6:.0f}M params, {n_layers}L x {d_model}d, "
          f"B={max_seqs}, ctx={ctx}, page={page}, {kvq} KV", file=sys.stderr)

    eng = DecodeEngine(mcfg, params, ecfg)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, 1000, ctx - 8)) for _ in range(max_seqs)]
    for p in prompts:
        eng.submit(p, max_new_tokens=8)
    eng._admit()
    if eng.num_active != max_seqs:
        raise RuntimeError(f"{eng.num_active} of {max_seqs} requests admitted")
    eng._ensure_capacity()

    # ---- decode step: whole model, one token per slot ----
    tokens = jnp.asarray([st["last"] for st in eng._slots], jnp.int32)
    active = jnp.ones((max_seqs,), bool)
    temps = jnp.zeros((max_seqs,), jnp.float32)
    top_ks = jnp.zeros((max_seqs,), jnp.int32)
    top_ps = jnp.ones((max_seqs,), jnp.float32)
    key = jax.random.PRNGKey(1)

    def many_steps(n):
        def run(params, tokens, caches):
            def body(carry, _):
                tokens, caches = carry
                toks, caches = eng._decode_step_impl(
                    params, caches, tokens, active, temps, top_ks, top_ps, key)
                return (toks, caches), ()
            (toks, _), _ = jax.lax.scan(body, (tokens, caches), None, length=n)
            return toks
        return jax.jit(run)

    n_short, n_long = 8, 24
    t_s = median_time(many_steps(n_short), eng.params, tokens, eng.caches)
    t_l = median_time(many_steps(n_long), eng.params, tokens, eng.caches)
    t_dec = (t_l - t_s) / (n_long - n_short)
    dec_tps = max_seqs / t_dec
    print(f"decode step: {t_dec*1e3:.3f} ms -> {dec_tps:,.0f} tokens/s",
          file=sys.stderr)

    # ---- prefill chunk: whole model, chunk tokens, slot 0 at end of ctx ----
    ctoks = jnp.asarray(list(rng.integers(1, 1000, chunk)), jnp.int32)
    start = jnp.asarray(ctx - 8 - chunk, jnp.int32)

    @jax.jit
    def prefill(ctoks, params, caches):
        last, _ = eng._chunk_prefill_impl(
            params, caches, ctoks, jnp.asarray(0, jnp.int32), start,
            jnp.asarray(chunk, jnp.int32))
        return last

    t_pre = median_time(prefill, ctoks, eng.params, eng.caches, iters=20)
    pre_tps = chunk / t_pre
    print(f"prefill chunk ({chunk} tokens @ pos {int(start)}): "
          f"{t_pre*1e3:.3f} ms -> {pre_tps:,.0f} tokens/s", file=sys.stderr)

    dev = jax.devices()[0]
    print(json.dumps({
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "decode_tokens_per_s": dec_tps,
        "prefill_tokens_per_s": pre_tps,
        "decode_step_ms": t_dec * 1e3,
        "prefill_chunk_ms": t_pre * 1e3,
        "params_m": round(n_params / 1e6),
        "batch": max_seqs, "ctx": ctx, "chunk": chunk, "kv": kvq, "page": page,
    }))


if __name__ == "__main__":
    main()
