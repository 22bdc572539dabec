"""Public-API contract tests (reference parity surface).

Checks the channel-first shape contract, output dtypes, validation errors
and the XLA fallback — the behaviours documented in the reference's
module/function docstrings (``flash_attention/flash_attention.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tf_flash_attention_tpu as fa
from tf_flash_attention_tpu.block_sizes import BlockConfig
from tf_flash_attention_tpu.utils.dtypes import l_dtype, neg_inf_approx

BLOCKS = BlockConfig(128, 128, 128, 128, 128, 128)


def data(dtype=jnp.float32, batch=(2, 3), d=8, v_d=5, q_seq=(40,), k_seq=(52,)):
    rng = np.random.default_rng(0)
    t = lambda s: jnp.asarray(rng.uniform(-1, 1, s), dtype)
    return t(batch + (d,) + q_seq), t(batch + (d,) + k_seq), t(batch + (v_d,) + k_seq)


def test_output_shapes_channel_first():
    Q, K, V = data()
    O, l, m = fa.full_1d(Q, K, V, returning_l_m=True, block_config=BLOCKS)
    assert O.shape == (2, 3, 5, 40)   # batch_shape + (v_d,) + q_seq
    assert l.shape == (2, 3, 40)
    assert m.shape == (2, 3, 40)


def test_output_shapes_2d():
    Q, K, V = data(q_seq=(6, 8), k_seq=(12, 4))
    O, l, m = fa.full_2d(Q, K, V, returning_l_m=True, block_config=BLOCKS)
    assert O.shape == (2, 3, 5, 6, 8)
    assert l.shape == (2, 3, 6, 8)
    assert m.shape == (2, 3, 6, 8)


def test_returning_l_m_default_false():
    Q, K, V = data()
    O = fa.full_1d(Q, K, V, block_config=BLOCKS)
    assert isinstance(O, jax.Array)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.float16])
def test_lm_dtypes(dtype):
    """l is float32 for half dtypes else input dtype; m is input dtype
    (flash_attention.h:181-185)."""
    Q, K, V = data(dtype)
    O, l, m = fa.causal_1d(Q, K, V, sync_mode="none_front", returning_l_m=True,
                           block_config=BLOCKS)
    assert O.dtype == dtype
    assert l.dtype == l_dtype(dtype)
    assert m.dtype == dtype


@pytest.mark.parametrize("dtype", [jnp.float8_e4m3fn, jnp.float8_e5m2])
def test_fp8_inputs(dtype):
    """fp8 inputs (BASELINE "fp8 compute"; beyond reference scope) run the
    kernels in bf16 and return fp8 outputs with fp32 l stats.  Forward must
    agree with the fp32 dense oracle up to fp8 output rounding."""
    Q, K, V = data(dtype)
    O, l, m = fa.causal_1d(Q, K, V, sync_mode="none_front", returning_l_m=True,
                           block_config=BLOCKS)
    assert O.dtype == dtype and l.dtype == jnp.float32 and m.dtype == dtype
    O_ref = fa.causal_1d(Q.astype(jnp.float32), K.astype(jnp.float32),
                         V.astype(jnp.float32), sync_mode="none_front",
                         implementation="xla")
    # inputs are already fp8-rounded, so the only extra error is the fp8
    # rounding of O itself: |err| <= max|O| * 2^-2 (e4m3) / 2^-1 (e5m2)
    err = float(jnp.max(jnp.abs(O.astype(jnp.float32) - O_ref)))
    assert err <= 0.5 * float(jnp.max(jnp.abs(O_ref))) + 1e-3, err

    # gradients flow (bf16 compute, fp8 cotangents/results)
    g = jax.grad(lambda q: jnp.sum(
        fa.causal_1d(q, K, V, sync_mode="none_front",
                     block_config=BLOCKS).astype(jnp.float32) ** 2))(Q)
    assert g.dtype == dtype


def test_float64_falls_back_to_xla():
    jax.config.update("jax_enable_x64", True)
    try:
        Q, K, V = data(jnp.float64)
        O, l, m = fa.causal_1d(Q, K, V, sync_mode="none_front", returning_l_m=True)
        assert O.dtype == jnp.float64
        assert l.dtype == jnp.float64
    finally:
        jax.config.update("jax_enable_x64", False)


def test_xla_and_pallas_agree():
    Q, K, V = data()
    kw = dict(window_size=5, log2_stride_size=1, is_causal=True, sync_mode="scale_front")
    o1 = fa.local_1d(Q, K, V, implementation="pallas", block_config=BLOCKS, **kw)
    o2 = fa.local_1d(Q, K, V, implementation="xla", **kw)
    np.testing.assert_allclose(np.asarray(o1), np.asarray(o2), rtol=1e-5, atol=1e-5)


def test_neg_inf_approx_values():
    """Bit-pattern parity with TypeUtil<T>::GetNegInfApprox (type_util.h)."""
    assert neg_inf_approx(jnp.float16) == np.frombuffer(b"\xfa\xfa", np.float16)[0]
    assert neg_inf_approx(jnp.float32) == np.frombuffer(b"\xfa" * 4, np.float32)[0]
    assert neg_inf_approx(jnp.float64) == np.frombuffer(b"\xfa" * 8, np.float64)[0]
    # bf16 0xFAFA == the f32 with bit pattern 0xFAFA0000
    bf16_exact = float(np.frombuffer(b"\x00\x00\xfa\xfa", np.float32)[0])
    assert neg_inf_approx(jnp.bfloat16) == bf16_exact


def test_validation_errors():
    Q, K, V = data()
    with pytest.raises(ValueError):
        fa.flash_attention(Q, K, V, rule=fa.FullRule(), seq_dims=3)
    with pytest.raises(ValueError):
        fa.causal_1d(Q, K.astype(jnp.bfloat16), V, sync_mode="none_front")
    with pytest.raises(ValueError):
        fa.causal_1d(Q[:, :1], K, V, sync_mode="none_front")  # batch mismatch
    with pytest.raises(ValueError):
        fa.causal_1d(Q, K[..., :7, :], V, sync_mode="none_front")  # d mismatch
    with pytest.raises(ValueError):
        # K/V sequence mismatch
        fa.causal_1d(Q, K[..., :-1], V, sync_mode="none_front")
    with pytest.raises(ValueError):
        fa.causal_1d(Q, K, V, sync_mode="bogus")


def test_jit_and_grad_compose():
    Q, K, V = data()

    @jax.jit
    def loss(Q, K, V):
        return jnp.sum(fa.causal_1d(Q, K, V, sync_mode="none_front",
                                    block_config=BLOCKS) ** 2)

    g = jax.grad(loss)(Q, K, V)
    assert g.shape == Q.shape
    assert np.isfinite(np.asarray(g, np.float32)).all()


def test_batchless_input():
    """batch_shape may be empty (docstring: 'any dimensionality')."""
    rng = np.random.default_rng(3)
    t = lambda s: jnp.asarray(rng.uniform(-1, 1, s), jnp.float32)
    O = fa.full_1d(t((16, 100)), t((16, 80)), t((8, 80)), block_config=BLOCKS)
    assert O.shape == (8, 100)


def test_decode_like_single_query():
    rng = np.random.default_rng(4)
    t = lambda s: jnp.asarray(rng.uniform(-1, 1, s), jnp.float32)
    O = fa.causal_1d(t((1, 2, 32, 1)), t((1, 2, 32, 200)), t((1, 2, 32, 200)),
                     sync_mode="none_front", block_config=BLOCKS)
    assert O.shape == (1, 2, 32, 1)
    assert np.isfinite(np.asarray(O)).all()


def test_window_larger_than_sequence_equals_full():
    rng = np.random.default_rng(5)
    t = lambda s: jnp.asarray(rng.uniform(-1, 1, s), jnp.float32)
    Q, K, V = t((1, 1, 8, 50)), t((1, 1, 8, 50)), t((1, 1, 8, 50))
    o_local = fa.local_1d(Q, K, V, window_size=1000, log2_stride_size=0,
                          is_causal=False, sync_mode="none_front",
                          block_config=BLOCKS)
    o_full = fa.full_1d(Q, K, V, block_config=BLOCKS)
    np.testing.assert_allclose(np.asarray(o_local), np.asarray(o_full),
                               rtol=1e-6, atol=1e-6)


def test_custom_scale():
    rng = np.random.default_rng(6)
    t = lambda s: jnp.asarray(rng.uniform(-1, 1, s), jnp.float32)
    Q, K, V = t((1, 1, 8, 64)), t((1, 1, 8, 64)), t((1, 1, 8, 64))
    o1 = fa.causal_1d(Q, K, V, sync_mode="none_front", scale=0.5,
                      block_config=BLOCKS)
    o_default = fa.causal_1d(Q, K, V, sync_mode="none_front",
                             block_config=BLOCKS)
    assert not np.allclose(np.asarray(o1), np.asarray(o_default))
    o2 = fa.causal_1d(2.0 * 0.5 / (8 ** -0.5) * Q / 2, K, V,
                      sync_mode="none_front", block_config=BLOCKS)
    # scale folds linearly into Q
    np.testing.assert_allclose(np.asarray(o1), np.asarray(o2), rtol=1e-4,
                               atol=1e-5)


def test_solver_tracks_measured_frontier():
    """choose_block_config returns the table's Triton tiles for the head
    dim and operand class, every block a power of two >= 16, shrunk to
    short sequences."""
    from tf_flash_attention_tpu.block_sizes import choose_block_config

    cfg = choose_block_config(4096, 4096, 128, 128, jnp.bfloat16)
    assert (cfg.block_q, cfg.block_kv) == (64, 128)
    assert (cfg.block_q_dkv, cfg.block_kv_dkv) == (64, 64)
    assert (cfg.num_warps, cfg.num_stages) == (4, 3)
    f32 = choose_block_config(4096, 4096, 128, 128, jnp.float32)
    assert f32.block_q * f32.block_kv < cfg.block_q * cfg.block_kv
    for c in (cfg, f32):
        for b in (c.block_q, c.block_kv, c.block_q_dq, c.block_kv_dq,
                  c.block_q_dkv, c.block_kv_dkv):
            assert b >= 16 and b & (b - 1) == 0
    # short sequences shrink the tiles to the next power of two >= 16
    small = choose_block_config(20, 9, 24, 12, jnp.float32)
    assert (small.block_q, small.block_kv) == (32, 16)
    with pytest.raises(ValueError):
        BlockConfig(96, 64, 64, 64, 64, 64)
