#!/usr/bin/env python
"""Continuous-batching serving demo with an INT8 paged KV cache.

Run: python examples/serving_demo.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from tf_flash_attention_tpu.models.transformer import ModelConfig, init_params
from tf_flash_attention_tpu.serving.engine import DecodeEngine, EngineConfig
from tf_flash_attention_tpu.utils.profiling import setup_compile_cache


def main():
    setup_compile_cache()
    cfg = ModelConfig(vocab=256, d_model=256, n_layers=2, n_heads=8,
                      n_kv_heads=4, d_head=64, d_ff=512, max_seq=512,
                      dtype=jnp.bfloat16)
    params = init_params(cfg, jax.random.PRNGKey(0))

    engine = DecodeEngine(cfg, params, EngineConfig(
        max_seqs=4, page_size=128, n_pages=32, max_pages_per_seq=4,
        quantized_kv=True,
        prefill_mode="chunked", prefill_chunk=128,  # chunked prefill
        prefix_caching=True,                        # shared-prefix page reuse
        speculative_tokens=3))                      # prompt-lookup speculation

    shared_prefix = list(range(1, 129))  # one full page, cached after req 0
    rids = [
        engine.submit(shared_prefix + [1, 2, 3], max_new_tokens=12),
        engine.submit(shared_prefix + [9, 8], max_new_tokens=12),  # prefix hit
        engine.submit([42] * 10, max_new_tokens=12),
        engine.submit([5, 5], max_new_tokens=12),
        engine.submit([13, 17, 19], max_new_tokens=12),  # queues until a slot frees
    ]
    results = engine.run(max_steps=60)
    for rid in rids:
        print(f"request {rid}: {results[rid]}")
    print(f"prefix cache: {engine.prefix_cache.hits} hits, "
          f"{len(engine.prefix_cache)} pages registered")
    print(f"speculation: {engine.spec_stats}")


if __name__ == "__main__":
    main()
