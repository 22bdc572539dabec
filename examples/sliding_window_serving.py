#!/usr/bin/env python
"""Sliding-window serving demo: unbounded streams, bounded memory.

A model with ``ModelConfig.rule = LocalRule(window)`` served through the
engine demonstrates the full rolling-buffer stack:

* the paged decode/prefill kernels skip pages below the window before any
  load and mask the window per element;
* logical pages wrap modulo ``max_pages_per_seq`` (rolling page table),
  prompts page in lazily chunk by chunk, and pages behind the window are
  evicted continuously — so the generation below runs to 3x the page
  table's nominal token capacity while holding only a handful of pages;
* the INT4 (nibble-packed) KV cache halves the bytes again.

Run: python examples/sliding_window_serving.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from tf_flash_attention_tpu.mask_rules import LocalRule
from tf_flash_attention_tpu.models.transformer import ModelConfig, init_params
from tf_flash_attention_tpu.serving.engine import DecodeEngine, EngineConfig
from tf_flash_attention_tpu.utils.profiling import setup_compile_cache


def main():
    setup_compile_cache()
    cfg = ModelConfig(vocab=256, d_model=256, n_layers=2, n_heads=8,
                      n_kv_heads=4, d_head=64, d_ff=512, max_seq=4096,
                      dtype=jnp.bfloat16,
                      rule=LocalRule(window_size=64, is_causal=True))
    params = init_params(cfg, jax.random.PRNGKey(0))

    ecfg = EngineConfig(
        max_seqs=2, page_size=32,
        n_pages=16,              # 512 tokens of physical KV, total
        max_pages_per_seq=6,     # table nominally addresses 192 tokens...
        quantized_kv=True, kv_quant_dtype="int4",
        prefill_mode="chunked", prefill_chunk=32,
        prefix_caching=False)    # window models run without the registry
    engine = DecodeEngine(cfg, params, ecfg)

    # a 300-token prompt (> physical capacity) + 400 generated tokens
    # (> 2x the table's nominal reach): lazy paging + the rolling table
    # keep the live set window-bounded throughout
    prompt = [(7 * i + 3) % cfg.vocab for i in range(300)]
    rid = engine.submit(prompt, max_new_tokens=400)
    results = engine.run(max_steps=500)
    toks = results[rid]
    print(f"generated {len(toks) - len(prompt)} tokens "
          f"(sequence length {len(toks)})")
    print("tail:", toks[-16:])
    s = engine.stats
    print(f"stats: steps={s['steps']} prefill_chunks={s['prefill_chunks']} "
          f"pages_evicted={s['pages_evicted']} "
          f"peak_pages={s['pages_in_use_peak']} of {ecfg.n_pages - 1}")
    assert s["pages_in_use_peak"] <= engine._pages_cap * ecfg.max_seqs


if __name__ == "__main__":
    main()
