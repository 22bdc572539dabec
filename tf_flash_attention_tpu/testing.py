"""Reference-style test/benchmark harness (``TestGroup`` parity).

Mirrors the reference's runnable harness (``tests/test_base.py:309-410``,
``tests/test_1d.py:104-146``): a case matrix of {sync modes} x {full,
causal, local, local+stride, local+causal, local+stride+causal}, runnable
as

    python -m tf_flash_attention_tpu.testing list  [1d|2d]
    python -m tf_flash_attention_tpu.testing verify [1d|2d]
    python -m tf_flash_attention_tpu.testing benchmark [1d|2d]

with single-case selection via the ``TESTCASE`` environment variable, and
random-shape fuzzing (``FA_RUNS``, default 3; the reference uses 20).
``verify`` checks forward outputs and all three input gradients against
the dense oracle with the reference's tolerance model
(``1e-6*K_entries`` fp32, ``1e-3*K_entries`` half — ``test_base.py:198-226``);
``benchmark`` reports flash vs vanilla wall time and peak device memory
(the role of ``TestGroup.benchmark``, ``test_base.py:229-305``).
"""

from __future__ import annotations

import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from . import flash_attention
from .mask_rules import CausalRule, FullRule, LocalRule
from .ops.reference import reference_attention

_CASES = {}


def _register_cases():
    rules = {
        "FullAttention": FullRule(),
        "CausalAttention": CausalRule(),
        "LocalAttention": LocalRule(window_size=8),
        "LocalStrideAttention": LocalRule(window_size=8, log2_stride_size=3),
        "LocalAndCausalAttention": LocalRule(window_size=8, is_causal=True),
        "LocalStrideAndCausalAttention": LocalRule(window_size=8, log2_stride_size=3,
                                                   is_causal=True),
    }
    modes = {"SyncModeNoneFront": "none_front",
             "SyncModeScaleFront": "scale_front",
             "SyncModeScaleEnd": "scale_end"}
    for rname, rule in rules.items():
        for mname, mode in modes.items():
            if rname == "FullAttention" and mode != "none_front":
                continue  # sync mode cannot affect unmasked attention
            _CASES[f"{rname}{mname}"] = (rule, mode)


_register_cases()

# random-shape bounds per dtype, scaled down from the reference's
# (tests/test_1d.py:57-66, test_2d.py:85-94) to stay fast on CPU
_SHAPES_1D = {"min": (1, 2, 8, 96), "max": (1, 2, 16, 384)}
_SHAPES_2D = {"min": (1, 2, 8, 8, 8), "max": (1, 2, 16, 16, 24)}


def _dtypes():
    if jax.default_backend() == "gpu":
        return (jnp.bfloat16, jnp.float32)
    return (jnp.float32,)


def _random_shape(rng, lo, hi):
    return tuple(int(rng.integers(l, h + 1)) for l, h in zip(lo, hi))


def _gen_data(rng, seq_dims, dtype):
    table = _SHAPES_1D if seq_dims == 1 else _SHAPES_2D
    base = _random_shape(rng, table["min"], table["max"])
    q_seq = _random_shape(rng, table["min"][-seq_dims:], table["max"][-seq_dims:])
    batch, d = base[:-seq_dims - 1], base[-seq_dims - 1]
    k_seq = base[-seq_dims:]
    v_d = max(4, d // 2)
    t = lambda s: jnp.asarray(rng.uniform(-2, 2, s), dtype)
    Q = t(batch + (d,) + q_seq)
    K = t(batch + (d,) + k_seq)
    V = t(batch + (v_d,) + k_seq)
    dO = t(batch + (v_d,) + q_seq)
    return Q, K, V, dO


def _selected():
    name = os.environ.get("TESTCASE", "all")
    if name != "all":
        return {name: _CASES[name]}
    return _CASES


def cmd_list(seq_dims):
    print("Available testcases:")
    for name in _selected():
        print(name)


def cmd_verify(seq_dims):
    runs = int(os.environ.get("FA_RUNS", "3"))
    rng = np.random.default_rng(int(os.environ.get("FA_SEED", time.time())))
    failures = 0
    for name, (rule, mode) in _selected().items():
        print(f"Verifying {name} ({seq_dims}d)")
        for dtype in _dtypes():
            for _ in range(runs):
                Q, K, V, dO = _gen_data(rng, seq_dims, dtype)
                n_k = int(np.prod(K.shape[-seq_dims:]))
                n_q = int(np.prod(Q.shape[-seq_dims:]))
                base = 1e-3 if jnp.dtype(dtype).itemsize == 2 else 1e-6

                def flash(Q, K, V):
                    return flash_attention(Q, K, V, rule=rule, sync_mode=mode,
                                           seq_dims=seq_dims)

                def oracle(Q, K, V):
                    return reference_attention(Q, K, V, rule=rule, sync_mode=mode,
                                               seq_dims=seq_dims)

                o1, vjp1 = jax.vjp(flash, Q, K, V)
                o2, vjp2 = jax.vjp(oracle, Q, K, V)
                pairs = [("O", o1, o2, n_k)]
                for gname, a, b, scale_n in zip(
                        ("dQ", "dK", "dV"), vjp1(dO), vjp2(dO), (n_k, n_q, n_q)):
                    pairs.append((gname, a, b, scale_n))
                for pname, a, b, scale_n in pairs:
                    tol = base * scale_n
                    err = float(jnp.max(jnp.abs(
                        a.astype(jnp.float32) - b.astype(jnp.float32))))
                    if not err <= tol:
                        failures += 1
                        print(f"  FAIL {name} {dtype} {pname}: err {err} > tol {tol} "
                              f"Q={Q.shape} K={K.shape}")
    print("FAILED" if failures else "OK")
    return 1 if failures else 0


def cmd_benchmark(seq_dims):
    from .utils.profiling import median_time

    if jax.default_backend() != "gpu":
        print("benchmark needs a GPU: JAX found none")
        return 1
    rng = np.random.default_rng(0)
    print(f"{'case':44s} {'flash_ms':>9s} {'vanilla_ms':>11s} {'speedup':>8s}")
    for name, (rule, mode) in _selected().items():
        dtype = jnp.bfloat16
        table = _SHAPES_1D if seq_dims == 1 else _SHAPES_2D
        base = table["max"]
        batch, d = base[:-seq_dims - 1], base[-seq_dims - 1]
        seq = base[-seq_dims:]
        t = lambda s: jnp.asarray(rng.uniform(-2, 2, s), dtype)
        Q, K, V = t(batch + (d,) + seq), t(batch + (d,) + seq), t(batch + (d,) + seq)

        flash = jax.jit(lambda Q, K, V: flash_attention(
            Q, K, V, rule=rule, sync_mode=mode, seq_dims=seq_dims))
        vanilla = jax.jit(lambda Q, K, V: flash_attention(
            Q, K, V, rule=rule, sync_mode=mode, seq_dims=seq_dims,
            implementation="xla"))
        tf_ = median_time(flash, Q, K, V)
        tv = median_time(vanilla, Q, K, V)
        print(f"{name:44s} {tf_*1e3:9.3f} {tv*1e3:11.3f} {tv/tf_:8.2f}x")
    stats = jax.local_devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    if peak:
        print(f"peak device memory: {peak/1e6:.1f} MB")


def main(argv):
    cmd = argv[1] if len(argv) > 1 else "verify"
    seq_dims = 2 if (len(argv) > 2 and argv[2] == "2d") else 1
    fn = {"list": cmd_list, "verify": cmd_verify, "benchmark": cmd_benchmark}[cmd]
    return fn(seq_dims) or 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
