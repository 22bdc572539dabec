#!/usr/bin/env python
"""Reference-parity usage examples (see the reference README's example).

Run: python examples/basic_usage.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import tf_flash_attention_tpu as fa
from tf_flash_attention_tpu.utils.profiling import setup_compile_cache


def main():
    setup_compile_cache()
    key = jax.random.PRNGKey(0)
    kq, kk, kv = jax.random.split(key, 3)

    # --- the reference README example: local attention on 1d sequences ---
    # shape format = [batch, channel, sequence] (channel-first)
    Q = jax.random.uniform(kq, (8, 32, 1024))
    K = jax.random.uniform(kk, (8, 32, 2048))
    V = jax.random.uniform(kv, (8, 16, 2048))

    # O has shape [8, 16, 1024]
    O = fa.local_1d(Q, K, V, window_size=32, log2_stride_size=0,
                    is_causal=False, sync_mode="scale_front")
    print("local_1d:", O.shape)

    # --- causal with softmax statistics ---
    O, l, m = fa.causal_1d(Q, K, V, sync_mode="none_front", returning_l_m=True)
    print("causal_1d:", O.shape, "l:", l.shape, l.dtype, "m:", m.shape, m.dtype)

    # --- 2d sequences (e.g. image feature maps), strided local window ---
    Q2 = jax.random.uniform(kq, (2, 4, 32, 32, 32))   # batch, heads, c, H, W
    K2 = jax.random.uniform(kk, (2, 4, 32, 64, 64))   # coarser/finer grids sync
    V2 = jax.random.uniform(kv, (2, 4, 16, 64, 64))
    O2 = fa.local_2d(Q2, K2, V2, window_size=8, log2_stride_size=1,
                     is_causal=False, sync_mode="scale_front")
    print("local_2d (cross-resolution):", O2.shape)

    # --- gradients flow through the recompute-based backward kernels ---
    loss = jax.grad(lambda q: jnp.sum(
        fa.causal_1d(q, K, V, sync_mode="none_front") ** 2))(Q)
    print("grad wrt Q:", loss.shape)

    # --- native multi-head layout (batch, heads, seq, head_dim) ---
    from tf_flash_attention_tpu.parallel import mha
    q = jax.random.uniform(kq, (2, 8, 1024, 128), jnp.bfloat16)
    k = jax.random.uniform(kk, (2, 2, 1024, 128), jnp.bfloat16)  # GQA 8:2
    v = jax.random.uniform(kv, (2, 2, 1024, 128), jnp.bfloat16)
    o = mha(q, k, v, rule=fa.CausalRule())
    print("mha (GQA):", o.shape)


if __name__ == "__main__":
    main()
