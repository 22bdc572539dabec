#!/usr/bin/env python
"""Sharded training demo: dp/tp/sp (+ optional MoE expert parallelism).

Run on 8 virtual devices:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 python examples/train_demo.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import optax

from tf_flash_attention_tpu.models.transformer import (
    ModelConfig, init_params, make_sharded_train_step, param_shardings)
from tf_flash_attention_tpu.parallel.mesh import make_mesh
from tf_flash_attention_tpu.utils.profiling import setup_compile_cache


def main():
    setup_compile_cache()
    n = jax.device_count()
    tp = 4 if n % 4 == 0 else 1
    dp = n // tp
    mesh = make_mesh((dp, tp), ("data", "model"), jax.devices())
    print(f"mesh: {dict(mesh.shape)}")

    cfg = ModelConfig(vocab=512, d_model=256, n_layers=2, n_heads=8,
                      n_kv_heads=8, d_head=32, d_ff=512, max_seq=256,
                      n_experts=4)  # MoE: experts sharded over 'model'
    params = init_params(cfg, jax.random.PRNGKey(0))
    optimizer = optax.adamw(3e-4)
    opt_state = optimizer.init(params)
    params = jax.device_put(params, param_shardings(cfg, mesh))

    step = make_sharded_train_step(cfg, mesh, optimizer)
    key = jax.random.PRNGKey(1)
    for i in range(5):
        key, sub = jax.random.split(key)
        tokens = jax.random.randint(sub, (2 * dp, 257), 0, cfg.vocab)
        loss, params, opt_state = step(params, opt_state, tokens)
        print(f"step {i}: loss {float(loss):.4f}")


if __name__ == "__main__":
    main()
