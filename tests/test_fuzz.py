"""Reference-breadth random-shape fuzzing of the core kernels.

Mirrors the reference verification loop (``tests/test_base.py:95-226``):
``_RUNS = 20`` random-shape iterations per case per dtype, with Q's
sequence shape drawn *independently* of K/V's (``test_base.py:156-160``)
so q != k paths and every sync-mode scaling are exercised, channel dims
randomized (``d`` and ``v_d`` independently, 8..32 like the reference's
``_SHAPE_DESC_TABLE``), 16-bit dtypes forced to even sequence sizes
(``:148-149``), values uniform in [-2, 2] (``:170-173``), and tolerances
scaled by the reduction lengths (``:198-226``).

Beyond the reference loop, local-rule parameters (window, stride,
causality) are themselves randomized per run, and each run checks
``O, l, m`` plus all three gradients.

Shape bounds are scaled to the CPU-interpret budget (the reference runs
256..4096-length sequences on a resident GPU; interpret mode is a Python
interpreter).  ``FA_FUZZ_RUNS`` overrides the per-case run count.  On a GPU the
bounds switch to the reference's own scale.
"""

import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tf_flash_attention_tpu as fa
from tf_flash_attention_tpu.block_sizes import BlockConfig
from tf_flash_attention_tpu.mask_rules import CausalRule, FullRule, LocalRule
from tf_flash_attention_tpu.ops.reference import reference_attention

RUNS = int(os.environ.get("FA_FUZZ_RUNS", "20"))

# Small blocks so the random shapes exercise multi-block schedules with
# edge tiles on both axes.
BLOCKS = BlockConfig(128, 128, 128, 128, 128, 128)

# (case, sync_mode) matrix = the reference's enabled 16
# (test_base.py:364-385): full only under none_front.
CASES = ["full", "causal", "local", "local_stride", "local_causal",
         "local_stride_causal"]
CASE_MATRIX = [("full", "none_front")] + [
    (c, m) for c in CASES[1:]
    for m in ("none_front", "scale_front", "scale_end")
]

# Per-dtype sequence bounds (min incl., max incl.), mirroring the shape of
# the reference's per-dtype table (fp64 smallest) at interpret-mode scale.
# On a GPU the bounds switch to the reference's own hardware scale (1d seq
# 256..4096/2048/1024 per dtype, test_1d.py:57-66; 2d per-dim 16..64/48/32,
# test_2d.py:85-94).
SEQ_BOUNDS_HW = (
    {jnp.float32: (256, 2048), jnp.bfloat16: (256, 4096),
     jnp.float64: (256, 1024)},
    {jnp.float32: (16, 48), jnp.bfloat16: (16, 64), jnp.float64: (16, 32)},
)
SEQ_BOUNDS_CPU = (
    {jnp.float32: (33, 320), jnp.bfloat16: (34, 384),
     jnp.float64: (33, 192)},
    {jnp.float32: (3, 14), jnp.bfloat16: (4, 14), jnp.float64: (3, 10)},
)


def make_rule(case, rng, ref_max):
    if case == "full":
        return FullRule()
    if case == "causal":
        return CausalRule()
    window = int(rng.integers(1, max(2, min(16, ref_max))))
    stride = int(rng.integers(1, 3)) if "stride" in case else 0
    return LocalRule(window_size=window, log2_stride_size=stride,
                     is_causal="causal" in case)


def draw_seq(rng, seq_dims, bounds, even):
    lo, hi = bounds
    s = tuple(int(rng.integers(lo, hi + 1)) for _ in range(seq_dims))
    if even:
        s = tuple(max(lo, x // 2 * 2) for x in s)
    return s


@pytest.fixture
def maybe_x64(request):
    """Enable x64 for fp64 parametrizations (reference dtype triple)."""
    if "f64" in request.node.name:
        jax.config.update("jax_enable_x64", True)
        yield
        jax.config.update("jax_enable_x64", False)
    else:
        yield


def run_fuzz(case, sync_mode, seq_dims, dtype):
    table = SEQ_BOUNDS_HW if jax.default_backend() == "gpu" else SEQ_BOUNDS_CPU
    bounds = table[seq_dims - 1][dtype]
    even = jnp.dtype(dtype).itemsize == 2
    base = 1e-3 if even else 1e-6
    # Error-report mode (the
    # analog of the reference's error-rate report,
    # internal_test.cu:289-317): collect the worst |err|/tolerance ratio
    # per quantity across all runs and print one summary line.
    report = os.environ.get("FA_FUZZ_REPORT")
    worst = {}

    def track(what, a, b, n_tol):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        tol = base * n_tol
        ratio = float(np.max(np.abs(a - b) / (tol + tol * np.abs(b))))
        err = float(np.max(np.abs(a - b)))
        w = worst.get(what)
        if w is None or ratio > w[0]:
            worst[what] = (ratio, err)
    for run in range(RUNS):
        # crc32 keeps the seed stable across processes (Python's hash() is
        # salted per interpreter).
        rng = np.random.default_rng(zlib.crc32(
            f"{case}/{sync_mode}/{seq_dims}/{run}".encode()))
        q_seq = draw_seq(rng, seq_dims, bounds, even)
        k_seq = draw_seq(rng, seq_dims, bounds, even)
        d = int(rng.integers(8, 33))
        v_d = int(rng.integers(8, 33))
        rule = make_rule(case, rng, max(max(q_seq), max(k_seq)))
        batch = (1, 2)

        t = lambda s: jnp.asarray(rng.uniform(-2.0, 2.0, s), dtype)
        Q = t(batch + (d,) + q_seq)
        K = t(batch + (d,) + k_seq)
        V = t(batch + (v_d,) + k_seq)
        dO = t(batch + (v_d,) + q_seq)

        def flash(Q, K, V):
            return fa.flash_attention(
                Q, K, V, rule=rule, sync_mode=sync_mode, seq_dims=seq_dims,
                returning_l_m=True, block_config=BLOCKS)

        def oracle(Q, K, V):
            return reference_attention(
                Q, K, V, rule=rule, sync_mode=sync_mode, seq_dims=seq_dims,
                returning_l_m=True)

        (o1, l1, m1), fvjp = jax.vjp(flash, Q, K, V)
        (o2, l2, m2), ovjp = jax.vjp(oracle, Q, K, V)

        n_k = int(np.prod(k_seq))
        n_q = int(np.prod(q_seq))
        label = (f"{case}/{sync_mode}/{seq_dims}d/{np.dtype(dtype).name} "
                 f"run={run} Q={Q.shape} K={K.shape} V={V.shape} "
                 f"rule={rule}")
        tol = lambda n: dict(rtol=base * n, atol=base * n)
        def close(a, b, n, what):
            if report:
                track(what, a, b, n)
            np.testing.assert_allclose(
                np.asarray(a, np.float32), np.asarray(b, np.float32),
                err_msg=f"{label}: {what}", **tol(n))
        close(o1, o2, n_k, "O")
        close(l1, l2, n_k, "l")
        close(m1, m2, n_k, "m")

        zlm = (jnp.zeros_like(l1), jnp.zeros_like(m1))
        g1 = fvjp((dO,) + zlm)
        g2 = ovjp((dO,) + zlm)
        # Gradient tolerance counts are floored at the reference's own
        # minimum fuzzed reduction length, 256 (1d ShapeDesc min
        # [1,8,8,256], test_1d.py:57-66; 2d min (16,16), test_2d.py:85-94):
        # the base*n model is only validated on n >= 256.  Extrapolating it
        # to this file's CPU-scale bounds implies e.g. 3.3e-5 at n_k = 33,
        # which is below the fp32 backward's physical error floor — the
        # recompute dS = P*(dP - D) amplifies P's ~3e-6 relative error (f32
        # (l, m) -> LSE fold roundings) by |dP - D| ~ O(d_v * value^2),
        # independent of n_k.  Measured at the adversarial shape
        # (q=268, k=33): kernel gradients 1.8e-4 vs an fp64 oracle while
        # the dense f32 XLA oracle shows 5e-6 (forward O: 2e-6) — inside
        # the reference's own 2.56e-4 minimum envelope, and the reference's
        # stored-(l, m) backward shares the same amplification structure.
        # See docs/PARITY.md "fp32 gradient error floor".  The floor is
        # fp32-only: the measured-error evidence behind it is fp32, and the
        # other two dtypes don't need it (bf16's 1e-3 base alone covers the
        # measured absolute floor at any n; the f64 path is chunked XLA vs
        # a dense f64 oracle with ~1e-12 error), so flooring them would
        # just discard the tightest gradient checks.
        floor = (lambda n: max(n, 256)) if dtype == jnp.float32 else (lambda n: n)
        for name, a, b, n in zip("QKV", g1, g2, (n_k, n_q, n_q)):
            close(a, b, floor(n), f"d{name}")
    if report and worst:
        cols = " ".join(
            f"{k}={v[0]:.3f}({v[1]:.2e})" for k, v in sorted(worst.items()))
        print(f"FUZZREPORT case={case}/{sync_mode} dims={seq_dims} "
              f"dtype={np.dtype(dtype).name} runs={RUNS} "
              f"worst_ratio(abs_err): {cols}", flush=True)


@pytest.mark.slow
@pytest.mark.parametrize("case,sync_mode", CASE_MATRIX,
                         ids=[f"{c}-{m}" for c, m in CASE_MATRIX])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.float64],
                         ids=["f32", "bf16", "f64"])
def test_fuzz_1d(case, sync_mode, dtype, maybe_x64):
    run_fuzz(case, sync_mode, 1, dtype)


@pytest.mark.slow
@pytest.mark.parametrize("case,sync_mode", CASE_MATRIX,
                         ids=[f"{c}-{m}" for c, m in CASE_MATRIX])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16, jnp.float64],
                         ids=["f32", "bf16", "f64"])
def test_fuzz_2d(case, sync_mode, dtype, maybe_x64):
    run_fuzz(case, sync_mode, 2, dtype)
