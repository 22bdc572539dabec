#!/usr/bin/env python
"""Multi-device lowering report on a virtual CPU mesh.

Compiles and runs the multi-device configurations — head-sharded
attention, ring attention, sequence-sharded paged decode and prefill,
and the dp/tp/sp/ep, pp/dp and serving steps of
``__graft_entry__.dryrun_multichip`` — on an N-device virtual mesh
(``--xla_force_host_platform_device_count``).  It proves the sharded
lowerings and nothing about speed; the GPU runs are ``chip_smoke.py
--four``.

Usage:
  python tools/scaling_report.py [-n 8]
"""

import argparse
import os
import sys


def virtual(n_devices=8):
    os.environ.setdefault("XLA_FLAGS",
                          f"--xla_force_host_platform_device_count={n_devices}")
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    import __graft_entry__ as g
    print(f"lowering report on {n_devices} virtual devices")
    g.dryrun_multichip(n_devices)

    import numpy as np
    import jax.numpy as jnp
    from tf_flash_attention_tpu.block_sizes import BlockConfig
    from tf_flash_attention_tpu.mask_rules import CausalRule
    from tf_flash_attention_tpu.parallel import (
        make_mesh, mha, ring_flash_attention, sharded_flash_attention)

    BLOCKS = BlockConfig(128, 128, 128, 128, 128, 128)
    rng = np.random.default_rng(0)
    t = lambda s: jnp.asarray(rng.uniform(-1, 1, s), jnp.float32)
    q, k, v = t((2, 4, 256, 32)), t((2, 4, 256, 32)), t((2, 4, 256, 32))
    mesh = make_mesh((2, 4), ("data", "model"), jax.devices()[:8])
    o = sharded_flash_attention(mesh, CausalRule(), block_config=BLOCKS)(q, k, v)
    print(f"  head+data-sharded attention (2x4 mesh): out {o.shape} ok")
    mesh_cp = make_mesh((1, 1, 8), ("data", "model", "context"), jax.devices()[:8])
    o = ring_flash_attention(mesh_cp, causal=True, block_config=BLOCKS)(
        t((1, 2, 512, 32)), t((1, 2, 512, 32)), t((1, 2, 512, 32)))
    print(f"  ring attention (8-way context): out {o.shape} ok")

    # context-parallel serving: KV pages round-robin over 4 shards,
    # per-device paged decode/prefill partials merged by one psum
    from tf_flash_attention_tpu.serving.kv_cache import (
        KVCacheConfig, PageAllocator)
    from tf_flash_attention_tpu.serving.seq_sharded_decode import (
        create_seq_sharded_cache, seq_sharded_paged_decode,
        seq_sharded_paged_prefill, write_prompt_seq_sharded)
    n_cp = 4
    mesh_s = make_mesh((n_cp,), ("seq",), jax.devices()[:n_cp])
    ccfg = KVCacheConfig(n_kv_heads=2, head_dim=32, page_size=32, n_pages=8,
                         max_seqs=2, max_pages_per_seq=6, quantized=True)
    sc = create_seq_sharded_cache(ccfg, mesh_s, "seq")
    allocs = [PageAllocator(ccfg.n_pages - 1) for _ in range(n_cp)]
    kk, vv = t((2, 200, 32)), t((2, 200, 32))
    sc = write_prompt_seq_sharded(sc, ccfg, mesh_s, "seq", 0,
                                  [a.alloc(0, 2) for a in allocs], kk, vv)
    o = seq_sharded_paged_decode(mesh_s, ccfg, "seq")(t((2, 4, 32)), sc)
    print(f"  sequence-sharded paged decode (4-way): out {o.shape} ok")
    o = seq_sharded_paged_prefill(mesh_s, ccfg, "seq")(
        t((8, 4, 32)), sc, jnp.asarray(0), jnp.asarray(192), jnp.asarray(8))
    print(f"  sequence-sharded paged prefill (4-way): out {o.shape} ok")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=8)
    virtual(ap.parse_args().n)
