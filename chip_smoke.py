#!/usr/bin/env python3
"""End-to-end smoke run of the main path on an NVIDIA GPU.

With no arguments it needs one GPU and runs, in order:

1. environment — JAX version, device, card name and power limit, compile
   cache; fails unless JAX runs on a GPU;
2. the parity API at real widths — forward and ``jax.grad`` of the six
   reference entry points against the dense reference
   (``ops/reference.py``, highest precision), each max error printed
   beside the reference's tolerance (1e-6·k_len fp32, 1e-3·k_len half);
3. training — the 168M-parameter LM (vocab 32768, d_model 1024, 8 layers,
   8 heads x 128, d_ff 4096, bf16), three ``optax.adamw`` steps at B=8,
   S=2048 on a fixed batch: the loss must be finite and falling;
4. serving — ``DecodeEngine`` on the same model with INT8 paged KV
   (page 256) and chunked prefill (chunk 512) answers 8 requests of
   1-2k prompt tokens and 16 new tokens; one request is checked against
   the dense model's greedy choice wherever its top-1/top-2 logit margin
   exceeds the tolerance;
5. kernels against their plain versions — ``bench.compare_kernels``.

``--four`` needs four GPUs and runs only the paths that span them: the
dp x tp sharded train step, ring attention (causal and local) and
Ulysses against the single-device kernel, and the TP x CP engine on a
(model 2 x seq 2) mesh.

Any failure exits non-zero before the last line.  The last line of
stdout is ``{"ok": true, "device": {...}}``.

Usage: ``python chip_smoke.py [--four]``
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

import tf_flash_attention_tpu as fa
from tf_flash_attention_tpu.mask_rules import CausalRule, FullRule, LocalRule
from tf_flash_attention_tpu.models.transformer import (
    ModelConfig, forward, init_params, train_step,
)
from tf_flash_attention_tpu.ops.reference import reference_attention
from tf_flash_attention_tpu.utils.profiling import (
    gpu_name_and_power, setup_compile_cache,
)

#: The repo's largest model (tools/engine_bench.py): 168M parameters.
LM = ModelConfig(vocab=32768, d_model=1024, n_layers=8, n_heads=8,
                 n_kv_heads=8, d_head=128, d_ff=4096, max_seq=4096,
                 dtype=jnp.bfloat16)


def phase(title: str):
    print(f"== {title}", flush=True)
    return time.perf_counter()


def done(t0: float):
    print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)


def check_close(name, got, want, tol):
    """|got - want| <= tol·(1 + |want|) elementwise (the tests' model)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    diff = np.abs(got - want)
    ratio = float(np.max(diff / (tol * (1.0 + np.abs(want)))))
    print(f"   {name}: max|err| {float(diff.max()):.3e}  tol {tol:.3e}  "
          f"(worst err/bound {ratio:.3f})", flush=True)
    if not np.all(np.isfinite(got)) or ratio > 1.0:
        raise AssertionError(f"{name}: error above tolerance")


def env_phase(expect: int):
    t0 = phase("1 environment")
    backend = jax.default_backend()
    print(f"   jax {jax.__version__}, backend {backend}")
    if backend != "gpu":
        sys.exit(f"no GPU: JAX backend is {backend!r}")
    devs = jax.devices()
    print(f"   device {devs[0].device_kind} x {len(devs)}")
    if len(devs) < expect:
        sys.exit(f"needs {expect} GPUs, JAX sees {len(devs)}")
    print(gpu_name_and_power())     # the card's name and power limit
    print(f"   compile cache: {setup_compile_cache()}")
    done(t0)
    return devs[:expect]


def parity_case(name, fn, dtype, batch, d, v_d, q_seq, k_seq, **kw):
    rng = np.random.default_rng(0)
    mk = lambda *s: jnp.asarray(rng.uniform(-2.0, 2.0, s), dtype)
    Q = mk(*batch, d, *q_seq)
    K = mk(*batch, d, *k_seq)
    V = mk(*batch, v_d, *k_seq)
    dO = mk(*batch, v_d, *q_seq)
    seq_dims = len(q_seq)
    rule, sync = kw.pop("rule"), kw.pop("sync_mode")

    def run(impl):
        def f(Q, K, V, dO):
            o, vjp = jax.vjp(impl, Q, K, V)
            return (o,) + vjp(dO)
        return jax.jit(f)(Q, K, V, dO)

    got = run(lambda Q, K, V: fn(Q, K, V, sync_mode=sync, **kw))
    want = run(lambda Q, K, V: reference_attention(
        Q, K, V, rule=rule, sync_mode=sync, seq_dims=seq_dims))
    base = 1e-6 if jnp.dtype(dtype) == jnp.float32 else 1e-3
    n_q, n_k = int(np.prod(q_seq)), int(np.prod(k_seq))
    for what, a, b, n in zip(("O", "dQ", "dK", "dV"), got, want,
                             (n_k, n_k, n_q, n_q)):
        check_close(f"{name} {what}", a, b, base * n)


def parity_phase():
    t0 = phase("2 parity API at real widths (vs ops/reference.py)")
    bf16, f32, f16 = jnp.bfloat16, jnp.float32, jnp.float16
    parity_case("causal_1d bf16 S=4096", fa.causal_1d, bf16, (4, 8), 128,
                128, (4096,), (4096,), rule=CausalRule(),
                sync_mode="none_front")
    parity_case("full_1d fp32 Q=[8,32,1024] K=[8,32,2048] V=[8,16,2048]",
                fa.full_1d, f32, (8,), 32, 16, (1024,), (2048,),
                rule=FullRule(), sync_mode="none_front")
    w32 = LocalRule(window_size=32, log2_stride_size=1, is_causal=True)
    parity_case("local_1d w32 s1 scale_front bf16", fa.local_1d, bf16,
                (4, 8), 128, 128, (2048,), (4096,), rule=w32,
                sync_mode="scale_front", window_size=32, log2_stride_size=1,
                is_causal=True)
    parity_case("causal_2d bf16 64x64", fa.causal_2d, bf16, (2, 8), 64, 64,
                (64, 64), (64, 64), rule=CausalRule(), sync_mode="none_front")
    w8 = LocalRule(window_size=8, log2_stride_size=0, is_causal=False)
    parity_case("local_2d w8 bf16 64x64", fa.local_2d, bf16, (2, 8), 64, 64,
                (64, 64), (64, 64), rule=w8, sync_mode="none_front",
                window_size=8, log2_stride_size=0, is_causal=False)
    parity_case("full_2d scale_end bf16 32x32 -> 64x64", fa.full_2d, bf16,
                (2, 8), 64, 64, (32, 32), (64, 64), rule=FullRule(),
                sync_mode="scale_end")
    parity_case("causal_1d fp16 S=2048", fa.causal_1d, f16, (2, 8), 128,
                128, (2048,), (2048,), rule=CausalRule(),
                sync_mode="none_front")
    done(t0)


def train_phase():
    import optax

    t0 = phase("3 training: 168M LM, adamw, B=8 S=2048, bf16")
    params = init_params(LM, jax.random.PRNGKey(0))
    n_params = sum(x.size for x in jax.tree_util.tree_leaves(params))
    print(f"   {n_params / 1e6:.0f}M parameters")
    opt = optax.adamw(1e-3)
    opt_state = opt.init(params)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 2049), 0, LM.vocab)
    step = jax.jit(lambda p, s, t: train_step(LM, p, s, t, optimizer=opt),
                   donate_argnums=(0, 1))
    losses = []
    for i in range(3):
        t1 = time.perf_counter()
        loss, params, opt_state = step(params, opt_state, tokens)
        losses.append(float(loss))
        print(f"   step {i}: loss {losses[-1]:.4f} "
              f"({time.perf_counter() - t1:.2f} s)", flush=True)
    if not all(np.isfinite(losses)) or not losses[2] < losses[1] < losses[0]:
        raise AssertionError(f"loss not finite and falling: {losses}")
    done(t0)


#: Top-1/top-2 logit margin above which INT8 KV and bf16 rounding cannot
#: flip a greedy choice.
MARGIN = 0.1


def serve_and_check(params, mesh=None, label=""):
    """Serve 8 prompts of 1-2k tokens; return the results after checking
    request 0 against dense greedy decoding."""
    from tf_flash_attention_tpu.serving.engine import DecodeEngine, EngineConfig

    ecfg = EngineConfig(max_seqs=8, page_size=256, n_pages=8 * 9 + 9,
                        max_pages_per_seq=16, quantized_kv=True,
                        kv_quant_dtype=jnp.int8, prefill_mode="chunked",
                        prefill_chunk=512)
    eng = DecodeEngine(LM, params, ecfg, mesh=mesh)
    rng = np.random.default_rng(7)
    prompts = [list(map(int, rng.integers(1, LM.vocab, rng.integers(1024, 2049))))
               for _ in range(8)]
    t1 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=16) for p in prompts]
    results = eng.run(max_steps=2000)
    print(f"   {label}served {len(results)} requests in "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    for rid, p in zip(rids, prompts):
        if rid not in results or len(results[rid]) != len(p) + 16:
            raise AssertionError(f"request {rid} did not complete")

    # Greedy parity, teacher-forced on the engine's own tokens: where the
    # dense model's top-1/top-2 margin exceeds MARGIN the tokens must agree.
    seq = results[rids[0]]
    n_p = len(prompts[0])
    with jax.default_matmul_precision("highest"):
        logits = jax.jit(lambda p, t: forward(LM, p, t))(
            params, jnp.asarray([seq[:-1]], jnp.int32))[0, n_p - 1:]
    top2 = jnp.sort(logits, axis=-1)[:, -2:]
    margin = np.asarray(top2[:, 1] - top2[:, 0])
    dense = np.asarray(jnp.argmax(logits, axis=-1))
    got = np.asarray(seq[n_p:])
    sure = margin > MARGIN
    bad = int(np.sum(sure & (dense != got)))
    print(f"   {label}greedy parity: {int(sure.sum())} positions compared "
          f"(margin > {MARGIN}), {int((~sure).sum())} below margin, "
          f"{bad} mismatches", flush=True)
    if bad:
        raise AssertionError(f"{bad} greedy mismatches above the margin")
    return results


def serve_phase():
    t0 = phase("4 serving: DecodeEngine, INT8 paged KV, page 256, chunk 512")
    params = init_params(LM, jax.random.PRNGKey(0))
    serve_and_check(params)
    done(t0)


def compare_phase():
    import bench

    t0 = phase("5 kernels against their plain versions (bench.py)")
    bench.compare_kernels()
    done(t0)


def four_phase(devices):
    import optax

    from tf_flash_attention_tpu.models.transformer import (
        make_sharded_train_step, param_shardings,
    )
    from tf_flash_attention_tpu.parallel.mesh import make_mesh

    t0 = phase("6a dp x tp sharded train step (data 2 x model 2)")
    params = init_params(LM, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 2049), 0, LM.vocab)
    opt = optax.adamw(1e-3)
    with jax.default_device(devices[0]):
        loss1 = float(jax.jit(lambda p, s, t: train_step(
            LM, p, s, t, optimizer=opt)[0])(params, opt.init(params), tokens))
    mesh = make_mesh((2, 2), ("data", "model"), devices)
    sharded = jax.device_put(params, param_shardings(LM, mesh))
    step = make_sharded_train_step(LM, mesh, opt)
    loss4, _, _ = step(sharded, opt.init(sharded), tokens)
    print(f"   loss one device {loss1:.5f}, dp x tp {float(loss4):.5f}")
    if not abs(float(loss4) - loss1) <= 2e-2 * abs(loss1):
        raise AssertionError("sharded loss differs from one device")
    done(t0)

    t0 = phase("6b ring (causal, local) and Ulysses vs the one-device kernel")
    context_parallel_check(devices)
    done(t0)

    t0 = phase("6c TP x CP engine (model 2 x seq 2), INT8 KV")
    mesh_s = make_mesh((2, 2), ("model", "seq"), devices)
    # fresh weights: the sharded step donated buffers it shared with params
    serve_and_check(init_params(LM, jax.random.PRNGKey(0)), mesh=mesh_s,
                    label="tp x cp: ")
    done(t0)


def context_parallel_check(devices, B=2, H=8, S=8192, D=128, window=1024):
    """Ring (causal, local) and Ulysses on a 4-way ``context`` mesh,
    forward and gradients, against the one-device kernel."""
    from tf_flash_attention_tpu.block_sizes import choose_block_config
    from tf_flash_attention_tpu.ops.attend import AttendParams, attend
    from tf_flash_attention_tpu.ops.backend import default_interpret
    from tf_flash_attention_tpu.parallel import (
        ring_flash_attention, ulysses_flash_attention,
    )
    from tf_flash_attention_tpu.parallel.mesh import make_mesh
    from tf_flash_attention_tpu.sync_modes import make_sync_pack

    rng = np.random.default_rng(5)
    mk = lambda: jnp.asarray(rng.standard_normal((B, H, S, D)), jnp.bfloat16)
    q, k, v, do = mk(), mk(), mk(), mk()
    mesh_c = make_mesh((1, 1, 4), ("data", "model", "context"), devices)
    pack = make_sync_pack("none_front", (S,), (S,))
    for label, rule, build in (
        ("ring causal", CausalRule(),
         lambda r: ring_flash_attention(mesh_c, rule=r)),
        (f"ring local w{window}", LocalRule(window_size=window, is_causal=True),
         lambda r: ring_flash_attention(mesh_c, rule=r)),
        ("ulysses causal", CausalRule(),
         lambda r: ulysses_flash_attention(mesh_c, r)),
    ):
        par = build(rule)
        prm = AttendParams(pack=pack, rule=rule,
                           config=choose_block_config(S, S, D, D, q.dtype),
                           scale=1.0 / np.sqrt(D),
                           interpret=default_interpret())

        def one(q, k, v):
            flat = lambda x: x.reshape(B * H, S, D)
            return attend(flat(q), flat(k), flat(v), prm)[0].reshape(B, H, S, D)

        def fwd_bwd(f):
            def g(q, k, v, do):
                o, vjp = jax.vjp(f, q, k, v)
                return (o,) + vjp(do)
            return g

        got = jax.jit(fwd_bwd(par))(q, k, v, do)
        with jax.default_device(devices[0]):
            want = jax.jit(fwd_bwd(one))(q, k, v, do)
        for what, a, b in zip(("O", "dQ", "dK", "dV"), got, want):
            check_close(f"{label} {what}", a, b, 1e-3 * S)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU paths")
    args = ap.parse_args()
    devices = env_phase(4 if args.four else 1)
    if args.four:
        four_phase(devices)
    else:
        parity_phase()
        train_phase()
        serve_phase()
        compare_phase()
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
