"""Chunked (flash-structured, no-Pallas) XLA path — the float64 story.

The CUDA reference ships real fp64 kernels with a 1e-9 internal-test
threshold (``kernel/internal_test.cu:15-28``, instantiations
``flash_attention.cu:2450-2487``).  The Triton kernels take no fp64, so this
repo's fp64 path is ``ops/chunked.py``: the same online-softmax recurrence in
plain XLA with O(block) memory.  These tests pin (a) true-fp64 accuracy
against a NumPy float64 oracle, (b) gradient parity, (c) that the public
API routes fp64 there by default, and (d) a 16k-sequence run that would be
impossible with an O(q·k) dense fallback.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tf_flash_attention_tpu as fa
from tf_flash_attention_tpu.mask_rules import CausalRule, FullRule, LocalRule
from tf_flash_attention_tpu.ops.chunked import flash_attention_xla
from tf_flash_attention_tpu.ops.reference import build_mask
from tf_flash_attention_tpu.sync_modes import make_sync_pack


@pytest.fixture(autouse=True)
def _x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def numpy_oracle(q, k, v, mask, scale=None):
    """Dense fp64 attention in NumPy — the precision yardstick."""
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    s = np.einsum("bqd,bkd->bqk", q, k) * scale
    s = np.where(mask, s, -1e300)
    m = s.max(-1)
    p = np.where(mask, np.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    l_safe = np.where(l == 0.0, 1.0, l)
    o = np.einsum("bqk,bkv->bqv", p, v) / l_safe[..., None]
    return o, l, m


CASES = [
    (FullRule(), "none_front", 220, 310),
    (CausalRule(), "none_front", 220, 310),
    (CausalRule(), "scale_front", 128, 320),
    (LocalRule(window_size=5, log2_stride_size=1, is_causal=True),
     "scale_front", 128, 256),
    (LocalRule(window_size=3, log2_stride_size=0, is_causal=False),
     "scale_end", 96, 192),
]


@pytest.mark.parametrize("rule,mode,qs,ks", CASES)
def test_fp64_forward_accuracy(rule, mode, qs, ks):
    """fp64 forward at the reference's 1e-9·k precision class."""
    rng = np.random.default_rng(0)
    pack = make_sync_pack(mode, (qs,), (ks,))
    q = rng.uniform(-2, 2, (2, qs, 24))
    k = rng.uniform(-2, 2, (2, ks, 24))
    v = rng.uniform(-2, 2, (2, ks, 16))
    mask = np.asarray(build_mask(pack, rule).reshape(qs, ks))
    o_np, l_np, m_np = numpy_oracle(q, k, v, mask)

    o, l, m = flash_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), pack=pack, rule=rule,
                                  block_q=64, block_kv=64)
    tol = 1e-9 * ks  # internal_test.cu:15-28 normalised threshold
    live = mask.any(-1)[None]
    assert float(np.abs(np.asarray(o) - np.where(live[..., None], o_np, 0.0)).max()) < tol
    assert float(np.abs(np.asarray(l) - np.where(live, l_np, 0.0)).max()) < tol
    assert np.abs(np.asarray(m) - m_np)[live.repeat(2, 0)].max() < tol


@pytest.mark.parametrize("rule,mode,qs,ks", CASES[1::2])
def test_fp64_gradients(rule, mode, qs, ks):
    """Custom-VJP backward matches autodiff of a dense fp64 computation."""
    rng = np.random.default_rng(1)
    pack = make_sync_pack(mode, (qs,), (ks,))
    q = jnp.asarray(rng.uniform(-2, 2, (2, qs, 24)))
    k = jnp.asarray(rng.uniform(-2, 2, (2, ks, 24)))
    v = jnp.asarray(rng.uniform(-2, 2, (2, ks, 16)))
    do = jnp.asarray(rng.uniform(-1, 1, (2, qs, 16)))
    mask = jnp.asarray(build_mask(pack, rule).reshape(qs, ks))

    def dense(q, k, v):
        s = jnp.einsum("bqd,bkd->bqk", q, k) / np.sqrt(24)
        s = jnp.where(mask, s, -jnp.inf)
        p = jax.nn.softmax(s, axis=-1)
        p = jnp.where(mask, p, 0.0)
        return jnp.vdot(jnp.einsum("bqk,bkv->bqv", p, v), do)

    def flash(q, k, v):
        return jnp.vdot(flash_attention_xla(
            q, k, v, pack=pack, rule=rule, block_q=64, block_kv=64)[0], do)

    g_ref = jax.grad(dense, argnums=(0, 1, 2))(q, k, v)
    g = jax.grad(flash, argnums=(0, 1, 2))(q, k, v)
    tol = 1e-9 * max(qs, ks) * 10
    for a, b in zip(g, g_ref):
        assert float(jnp.abs(a - b).max()) < tol


def test_fp64_routes_to_chunked_by_default():
    """The public API's fp64 default is the chunked path, and it is
    fp64-accurate (the dense oracle used to cap fp64 at f32 precision)."""
    rng = np.random.default_rng(2)
    t = lambda s: jnp.asarray(rng.uniform(-1, 1, s), jnp.float64)
    Q, K, V = t((2, 8, 96)), t((2, 8, 128)), t((2, 6, 128))
    O, l, m = fa.causal_1d(Q, K, V, sync_mode="none_front", returning_l_m=True)
    assert O.dtype == jnp.float64 and l.dtype == jnp.float64
    O2 = fa.causal_1d(Q, K, V, sync_mode="none_front", implementation="xla")
    np.testing.assert_allclose(np.asarray(O), np.asarray(O2),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.slow
def test_fp64_seq16k_no_quadratic_memory():
    """seq 16384 fp64 causal: a dense path would materialise a 2 GiB
    (16k x 16k) f64 score tensor; the chunked path peaks at O(block²)."""
    rng = np.random.default_rng(3)
    S, D = 16384, 8
    pack = make_sync_pack("none_front", (S,), (S,))
    rule = LocalRule(window_size=64, log2_stride_size=0, is_causal=True)
    q = jnp.asarray(rng.uniform(-1, 1, (1, S, D)))
    k = jnp.asarray(rng.uniform(-1, 1, (1, S, D)))
    v = jnp.asarray(rng.uniform(-1, 1, (1, S, D)))
    o, l, m = flash_attention_xla(q, k, v, pack=pack, rule=rule,
                                  block_q=512, block_kv=512)
    assert o.shape == (1, S, D)
    assert bool(jnp.isfinite(o).all()) and bool((l > 0).all())
    # spot-check a window against the local NumPy oracle
    row = 12345
    lo = row - 63
    s = np.einsum("d,kd->k", np.asarray(q)[0, row],
                  np.asarray(k)[0, lo:row + 1]) / np.sqrt(D)
    p = np.exp(s - s.max())
    o_row = p @ np.asarray(v)[0, lo:row + 1] / p.sum()
    np.testing.assert_allclose(np.asarray(o)[0, row], o_row, atol=1e-9 * S)
