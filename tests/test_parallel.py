"""Sharding tests on a virtual 8-device CPU mesh.

No reference counterpart (the reference is single-GPU); these validate the
parallelism layer: head/data-sharded attention and
context-parallel ring attention agree with the single-device kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tf_flash_attention_tpu.block_sizes import BlockConfig
from tf_flash_attention_tpu.mask_rules import CausalRule, FullRule, LocalRule
from tf_flash_attention_tpu.parallel import (
    make_mesh,
    mha,
    ring_flash_attention,
    sharded_flash_attention,
)

BLOCKS = BlockConfig(128, 128, 128, 128, 128, 128)


def data(b=2, h=4, s=256, d=16, dtype=jnp.float32, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda shape: jnp.asarray(rng.uniform(-1, 1, shape), dtype)
    return t((b, h, s, d)), t((b, h, s, d)), t((b, h, s, d))


@pytest.fixture(scope="module")
def eight_devices():
    if jax.device_count() < 8:
        pytest.skip("needs 8 devices")
    return jax.devices()[:8]


def test_mha_matches_api():
    q, k, v = data()
    o = mha(q, k, v, rule=CausalRule(), block_config=BLOCKS)
    # against the channel-first parity API
    import tf_flash_attention_tpu as fa
    Q = jnp.swapaxes(q, -1, -2)
    K = jnp.swapaxes(k, -1, -2)
    V = jnp.swapaxes(v, -1, -2)
    O = fa.causal_1d(Q, K, V, sync_mode="none_front", block_config=BLOCKS)
    np.testing.assert_allclose(
        np.asarray(o), np.asarray(jnp.swapaxes(O, -1, -2)), rtol=1e-5, atol=1e-5
    )


def test_mha_gqa():
    q, k, v = data(h=4)
    o_full = mha(q, k, v, rule=CausalRule(), block_config=BLOCKS)
    # GQA with kv heads broadcast: using identical kv per group must equal
    # explicit repetition
    k2 = k[:, ::2]
    v2 = v[:, ::2]
    o_gqa = mha(q, k2, v2, rule=CausalRule(), block_config=BLOCKS)
    o_ref = mha(q, jnp.repeat(k2, 2, axis=1), jnp.repeat(v2, 2, axis=1),
                rule=CausalRule(), block_config=BLOCKS)
    np.testing.assert_allclose(np.asarray(o_gqa), np.asarray(o_ref), rtol=1e-6, atol=1e-6)
    assert o_gqa.shape == o_full.shape


def test_mha_gqa_gradients():
    """Native grouped K/V (no jnp.repeat) must match the repeat-based
    formulation through the backward pass: dK/dV of the grouped call equal
    the group-summed dK/dV of the repeated call."""
    q, k, v = data(h=4)
    k2, v2 = k[:, ::2], v[:, ::2]

    def loss_gqa(q, k2, v2):
        return jnp.sum(mha(q, k2, v2, rule=CausalRule(), block_config=BLOCKS) ** 2)

    def loss_rep(q, k2, v2):
        return jnp.sum(mha(q, jnp.repeat(k2, 2, axis=1), jnp.repeat(v2, 2, axis=1),
                           rule=CausalRule(), block_config=BLOCKS) ** 2)

    v1, g1 = jax.value_and_grad(loss_gqa, (0, 1, 2))(q, k2, v2)
    v2_, g2 = jax.value_and_grad(loss_rep, (0, 1, 2))(q, k2, v2)
    np.testing.assert_allclose(float(v1), float(v2_), rtol=1e-6)
    for a, b, name in zip(g1, g2, ("dQ", "dK", "dV")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_sharded_attention_matches_local(eight_devices):
    mesh = make_mesh((2, 4), ("data", "model"), eight_devices)
    q, k, v = data(b=2, h=4)
    fn = sharded_flash_attention(mesh, CausalRule(), block_config=BLOCKS)
    o_sharded = fn(q, k, v)
    o_local = mha(q, k, v, rule=CausalRule(), block_config=BLOCKS)
    np.testing.assert_allclose(
        np.asarray(o_sharded), np.asarray(o_local), rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_local(eight_devices, causal):
    mesh = make_mesh((1, 1, 8), ("data", "model", "context"), eight_devices)
    q, k, v = data(b=1, h=2, s=512, d=16)
    fn = ring_flash_attention(mesh, causal=causal, block_config=BLOCKS)
    o_ring = fn(q, k, v)
    rule = CausalRule() if causal else FullRule()
    o_local = mha(q, k, v, rule=rule, block_config=BLOCKS)
    np.testing.assert_allclose(
        np.asarray(o_ring), np.asarray(o_local), rtol=2e-5, atol=2e-5
    )


def test_ring_attention_2d_mesh(eight_devices):
    mesh = make_mesh((1, 2, 4), ("data", "model", "context"), eight_devices)
    q, k, v = data(b=1, h=2, s=512, d=16)
    fn = ring_flash_attention(mesh, causal=True, block_config=BLOCKS)
    o_ring = fn(q, k, v)
    o_local = mha(q, k, v, rule=CausalRule(), block_config=BLOCKS)
    np.testing.assert_allclose(
        np.asarray(o_ring), np.asarray(o_local), rtol=2e-5, atol=2e-5
    )


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_gradients(eight_devices, causal):
    """Ring backward (ring-level custom_vjp with global stats) must match
    the single-device kernel gradients."""
    mesh = make_mesh((1, 1, 8), ("data", "model", "context"), eight_devices)
    q, k, v = data(b=1, h=2, s=512, d=16)
    do = data(b=1, h=2, s=512, d=16)[0]
    ring = ring_flash_attention(mesh, causal=causal, block_config=BLOCKS)
    rule = CausalRule() if causal else FullRule()
    g_ring = jax.vjp(lambda *a: ring(*a), q, k, v)[1](do)
    g_local = jax.vjp(lambda a, b, c: mha(a, b, c, rule=rule,
                                          block_config=BLOCKS), q, k, v)[1](do)
    for a, b in zip(g_ring, g_local):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("rule", [
    CausalRule(),
    FullRule(),
    LocalRule(window_size=20, is_causal=True),
    LocalRule(window_size=12),
    LocalRule(window_size=6, log2_stride_size=1),
], ids=["causal", "full", "local-causal", "local-band", "local-strided"])
def test_ring_attention_2d_sequences(eight_devices, rule):
    """2d sequences sharded along dim 0 (row slabs): ring forward and
    gradients vs the single-device kernel with the global 2d pack."""
    from tf_flash_attention_tpu.ops.attend import AttendParams, attend
    from tf_flash_attention_tpu.parallel import make_mesh
    from tf_flash_attention_tpu.sync_modes import make_sync_pack

    mesh = make_mesh((1, 1, 8), ("data", "model", "context"), eight_devices)
    s0, s1 = 64, 16
    s = s0 * s1
    q, k, v = data(b=1, h=2, s=s, d=16)
    do = data(b=1, h=2, s=s, d=16, seed=3)[0]
    blocks = BLOCKS
    ring = ring_flash_attention(mesh, rule=rule, seq_shape=(s0, s1),
                                block_config=blocks)
    o_r, vjp_r = jax.vjp(lambda *a: ring(*a), q, k, v)

    pack = make_sync_pack("none_front", (s0, s1), (s0, s1))
    params = AttendParams(pack=pack, rule=rule, config=blocks,
                          scale=1.0 / np.sqrt(16), interpret=True)
    def local(qq, kk, vv):
        b, h, _, d = qq.shape
        o = attend(qq.reshape(b * h, s, d), kk.reshape(b * h, s, d),
                   vv.reshape(b * h, s, d), params)[0]
        return o.reshape(b, h, s, d)
    o_l, vjp_l = jax.vjp(local, q, k, v)
    np.testing.assert_allclose(np.asarray(o_r), np.asarray(o_l),
                               rtol=2e-5, atol=2e-5)
    for a, b in zip(vjp_r(do), vjp_l(do)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("rule", [
    LocalRule(window_size=100, is_causal=True),
    LocalRule(window_size=70),
    LocalRule(window_size=40, log2_stride_size=1, is_causal=True),
], ids=["local-causal", "local-band-wrap", "local-strided"])
def test_ring_attention_local_rule(eight_devices, rule):
    """Banded shard schedule: 1d local rules over context parallelism,
    forward and gradients vs the single-device kernel."""
    mesh = make_mesh((1, 1, 8), ("data", "model", "context"), eight_devices)
    q, k, v = data(b=1, h=2, s=512, d=16)
    do = data(b=1, h=2, s=512, d=16)[0]
    ring = ring_flash_attention(mesh, rule=rule, block_config=BLOCKS)
    o_r, vjp_r = jax.vjp(lambda *a: ring(*a), q, k, v)
    o_l, vjp_l = jax.vjp(lambda a, b, c: mha(a, b, c, rule=rule,
                                             block_config=BLOCKS), q, k, v)
    np.testing.assert_allclose(np.asarray(o_r), np.asarray(o_l),
                               rtol=2e-5, atol=2e-5)
    for a, b in zip(vjp_r(do), vjp_l(do)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# Ulysses (all-to-all) sequence parallelism
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule,sync", [
    (CausalRule(), "none_front"),
    (FullRule(), "none_front"),
    (LocalRule(window_size=24, is_causal=True), "none_front"),
    (LocalRule(window_size=10, log2_stride_size=1), "scale_front"),
    (CausalRule(), "scale_end"),
], ids=["causal", "full", "local-causal", "local-strided-scalefront",
        "causal-scaleend"])
def test_ulysses_matches_local(eight_devices, rule, sync):
    """Ulysses fwd + grads vs the single-device kernel.  Unlike the ring,
    every rule x sync-mode combination must work unchanged (each chip sees
    the full sequence after the all-to-all); scale modes use q_len != k_len
    so the order maps actually rescale."""
    from tf_flash_attention_tpu.ops.attend import AttendParams, attend
    from tf_flash_attention_tpu.parallel import ulysses_flash_attention
    from tf_flash_attention_tpu.sync_modes import make_sync_pack

    mesh = make_mesh((1, 1, 8), ("data", "model", "context"), eight_devices)
    sq = 256 if sync == "none_front" else 128
    skv = 256
    q = data(b=1, h=8, s=sq, d=16)[0]
    _, k, v = data(b=1, h=8, s=skv, d=16, seed=1)
    do = data(b=1, h=8, s=sq, d=16, seed=3)[0]

    uly = ulysses_flash_attention(mesh, rule, sync_mode=sync,
                                  block_config=BLOCKS)
    o_u, vjp_u = jax.vjp(lambda *a: uly(*a), q, k, v)

    pack = make_sync_pack(sync, (sq,), (skv,))
    params = AttendParams(pack=pack, rule=rule, config=BLOCKS,
                          scale=1.0 / np.sqrt(16), interpret=True)
    def local(qq, kk, vv):
        b, h, _, d = qq.shape
        o = attend(qq.reshape(b * h, sq, d), kk.reshape(b * h, skv, d),
                   vv.reshape(b * h, skv, d), params)[0]
        return o.reshape(b, h, sq, d)
    o_l, vjp_l = jax.vjp(local, q, k, v)
    np.testing.assert_allclose(np.asarray(o_u), np.asarray(o_l),
                               rtol=2e-5, atol=2e-5)
    for a, b in zip(vjp_u(do), vjp_l(do)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=2e-5)


def test_ulysses_gqa_and_mixed_mesh(eight_devices):
    """GQA (kv heads < q heads) on a data x model x context mesh."""
    from tf_flash_attention_tpu.parallel import ulysses_flash_attention

    mesh = make_mesh((2, 2, 2), ("data", "model", "context"), eight_devices)
    q = data(b=2, h=8, s=128, d=16)[0]
    _, k, v = data(b=2, h=4, s=128, d=16, seed=1)
    uly = ulysses_flash_attention(mesh, CausalRule(), block_config=BLOCKS)
    o_u = uly(q, k, v)
    o_l = mha(q, k, v, rule=CausalRule(), block_config=BLOCKS)
    np.testing.assert_allclose(np.asarray(o_u), np.asarray(o_l),
                               rtol=2e-5, atol=2e-5)


def test_ulysses_2d_sequences(eight_devices):
    """2d sequences, row-slab sharded: full flattened sequence is restored
    by the all-to-all, so 2d order arithmetic needs no shard offsets."""
    from tf_flash_attention_tpu.parallel import ulysses_flash_attention
    from tf_flash_attention_tpu.ops.attend import AttendParams, attend
    from tf_flash_attention_tpu.sync_modes import make_sync_pack

    mesh = make_mesh((1, 1, 8), ("data", "model", "context"), eight_devices)
    s0, s1 = 32, 8
    s = s0 * s1
    rule = LocalRule(window_size=6, is_causal=True)
    q, k, v = data(b=1, h=8, s=s, d=16)
    uly = ulysses_flash_attention(mesh, rule, q_seq_shape=(s0, s1),
                                  k_seq_shape=(s0, s1), block_config=BLOCKS)
    o_u = uly(q, k, v)

    pack = make_sync_pack("none_front", (s0, s1), (s0, s1))
    params = AttendParams(pack=pack, rule=rule, config=BLOCKS,
                          scale=1.0 / np.sqrt(16), interpret=True)
    b, h, _, d = q.shape
    o_l = attend(q.reshape(b * h, s, d), k.reshape(b * h, s, d),
                 v.reshape(b * h, s, d), params)[0].reshape(b, h, s, d)
    np.testing.assert_allclose(np.asarray(o_u), np.asarray(o_l),
                               rtol=2e-5, atol=2e-5)


def test_ulysses_head_divisibility_error(eight_devices):
    from tf_flash_attention_tpu.parallel import ulysses_flash_attention

    mesh = make_mesh((1, 1, 8), ("data", "model", "context"), eight_devices)
    q, k, v = data(b=1, h=4, s=256, d=16)  # 4 heads < 8-way context axis
    uly = ulysses_flash_attention(mesh, CausalRule(), block_config=BLOCKS)
    with pytest.raises(ValueError, match="ring attention"):
        uly(q, k, v)
