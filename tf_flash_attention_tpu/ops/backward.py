"""Backward flash-attention kernels (Pallas, Triton route).

The reference computes dQ, dK and dV in one KV-outer kernel
(``BackwardImpl``, ``kernel/flash_attention.cu:1079-1967``): one block per
KV tile keeps dK and dV on chip while it loops over the Q tiles, and adds
its share of dQ into device memory under a per-(batch, q-block) spinlock
(``:1917-1928``).  Here the work is split into two passes, each with a
single writer per output and no lock:

* ``_dkv_kernel`` — the reference's order: one program per (batch·kv
  head, kv tile) walks the live q tiles of the transposed schedule for
  every query head of its group, with dK and dV in registers;
* ``_dq_kernel`` — one program per (batch·head, q tile) walks its live kv
  tiles, with dQ in registers.

The one-pass alternative, the kv-outer kernel adding dQ through fp32
``atomic_add`` (the reference's pattern without the lock), measured 5.7x
slower than the two passes on an H100 at causal S=4096 (``PERF.md``):
every kv tile adds a full (q_len, d) dQ share into device memory.

Both passes recompute the normalised probabilities ``P`` from ``(Q, K,
l, m)`` (the reference's saved-tensor contract,
``flash_attention.py:374-390``) and share ``D = rowsum(dO ∘ O)``
(``:1882-1891``), computed first by one fused XLA pass.  Gradient math
(``:1899-1940``):

``P = exp(scale·QKᵀ − m)/l`` (masked → 0), ``dV += Pᵀ·dO``,
``dS = P ∘ (dO·Vᵀ − D) · scale``, ``dQ += dS·K``, ``dK += dSᵀ·Q``.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl

from ..block_sizes import BlockConfig, fit_block, pad_dim, pad_to
from ..mask_rules import MaskRule
from ..schedule import build_schedule
from ..sync_modes import SyncPack
from .backend import ROUTE, compiler_params, default_interpret
from .kernel_common import (
    INV_LOG2E, LOG2E, NEG_INF_F32, build_tile_mask, dot_nn, dot_nt, dot_tn,
)

__all__ = ["flash_backward"]


def _tile_grads(q, k, v, do, lse2, delta, mask):
    """``(P, dS)`` of one (bq, bk) tile, dS without its ``scale`` factor.

    ``q`` arrives pre-scaled by ``scale·log2e`` and ``lse2 = m·log2e +
    log2 l`` is the log2-domain log-sum-exp, so ``P = exp2(q·kᵀ − lse2)``
    with the normalisation folded into the subtract.  Fully-masked and
    padded rows carry ``lse2 = +LARGE``, which underflows their whole P
    row to exactly 0 (the reference's ``l = 0`` contract).
    """
    s = dot_nt(q, k)
    if mask is not None:
        s = jnp.where(mask, s, NEG_INF_F32)
    p = jnp.exp2(s - lse2[:, None])
    dp = dot_nt(do, v)
    return p, p * (dp - delta[:, None])


def _mask_for(pack, rule, qb, kb, block_q, block_kv, q_len, k_len, q_pad,
              k_pad, masked):
    if not masked:
        return None
    q_pos = qb * block_q + jax.lax.broadcasted_iota(jnp.int32, (block_q, 1), 0)
    k_pos = kb * block_kv + jax.lax.broadcasted_iota(jnp.int32, (1, block_kv), 1)
    return build_tile_mask(pack, rule, q_pos, k_pos, q_len, k_len, q_pad, k_pad)


def _dkv_kernel(
    table_ref, counts_ref, needs_ref,
    k_ref, v_ref, q_ref, do_ref, lse_ref, delta_ref, dk_ref, dv_ref,
    *,
    pack, rule, q_len, k_len, q_pad, k_pad, block_q, num_steps, group,
    has_interior, has_partial,
):
    kj = pl.program_id(0)
    block_kv = k_ref.shape[0]
    row = kj * num_steps
    k = k_ref[...]
    v = v_ref[...]

    def update(carry, mem, qb, masked):
        dk, dv = carry
        rows = pl.ds(pl.multiple_of(qb * block_q, block_q), block_q)
        q = q_ref[mem, rows, :]
        do = do_ref[mem, rows, :]
        mask = _mask_for(pack, rule, qb, kj, block_q, block_kv, q_len, k_len,
                         q_pad, k_pad, masked)
        p, ds = _tile_grads(q, k, v, do, lse_ref[mem, rows],
                            delta_ref[mem, rows], mask)
        dv = dv + dot_tn(p.astype(do.dtype), do)
        dk = dk + dot_tn(ds.astype(q.dtype), q)
        return dk, dv

    count = counts_ref[kj]

    def member(mem, carry):
        def step_body(step, c):
            qb = table_ref[row + step]
            if has_partial and has_interior:
                return jax.lax.cond(
                    needs_ref[row + step] != 0,
                    lambda c: update(c, mem, qb, True),
                    lambda c: update(c, mem, qb, False),
                    c)
            return update(c, mem, qb, has_partial)
        return jax.lax.fori_loop(0, count, step_body, carry)

    init = (jnp.zeros(dk_ref.shape, jnp.float32),
            jnp.zeros(dv_ref.shape, jnp.float32))
    dk, dv = jax.lax.fori_loop(0, group, member, init)
    # q is pre-scaled by scale·log2e, so dSᵀ·q carries the scale already
    # and an extra log2e, removed here.
    dk_ref[...] = (dk * jnp.float32(INV_LOG2E)).astype(dk_ref.dtype)
    dv_ref[...] = dv.astype(dv_ref.dtype)


def _dq_kernel(
    table_ref, counts_ref, needs_ref,
    q_ref, do_ref, lse_ref, delta_ref, k_ref, v_ref, dq_ref,
    *,
    pack, rule, q_len, k_len, q_pad, k_pad, block_kv, num_steps,
    has_interior, has_partial, scale,
):
    qi = pl.program_id(0)
    block_q = q_ref.shape[0]
    row = qi * num_steps
    q = q_ref[...]
    do = do_ref[...]
    lse2 = lse_ref[...]
    delta = delta_ref[...]

    def update(dq, kb, masked):
        cols = pl.ds(pl.multiple_of(kb * block_kv, block_kv), block_kv)
        k = k_ref[cols, :]
        mask = _mask_for(pack, rule, qi, kb, block_q, block_kv, q_len, k_len,
                         q_pad, k_pad, masked)
        _, ds = _tile_grads(q, k, v_ref[cols, :], do, lse2, delta, mask)
        return dq + dot_nn(ds.astype(k.dtype), k)

    def body(step, dq):
        kb = table_ref[row + step]
        if has_partial and has_interior:
            return jax.lax.cond(
                needs_ref[row + step] != 0,
                lambda c: update(c, kb, True),
                lambda c: update(c, kb, False),
                dq)
        return update(dq, kb, has_partial)

    dq = jax.lax.fori_loop(0, counts_ref[qi], body,
                           jnp.zeros(dq_ref.shape, jnp.float32))
    dq_ref[...] = (dq * jnp.float32(scale)).astype(dq_ref.dtype)


def flash_backward(
    q, k, v, o, l, m, do,
    *,
    pack: SyncPack,
    rule: MaskRule,
    config: BlockConfig,
    scale: Optional[float] = None,
    interpret: Optional[bool] = None,
):
    """Compute ``(dQ, dK, dV)`` on sequence-major tensors.

    Input/saved-tensor contract mirrors the reference backward ops, which
    take ``(Q, K, V, O, l, m, dO)`` (``flash_attention.py:374-390``,
    ``flash_attention_backward.cc:181-344``).  ``l``/``m`` may be any float
    dtype; they are consumed in float32.
    """
    if interpret is None:
        interpret = default_interpret()
    in_dtype = q.dtype
    if jnp.dtype(in_dtype).itemsize == 1:
        b16 = lambda x: x.astype(jnp.bfloat16)
        dq, dk, dv = flash_backward(
            b16(q), b16(k), b16(v), b16(o), l, m, b16(do),
            pack=pack, rule=rule, config=config, scale=scale,
            interpret=interpret)
        return (dq.astype(in_dtype), dk.astype(in_dtype),
                dv.astype(in_dtype))
    B, q_len, d = q.shape
    B_kv, k_len, v_d = v.shape
    if B % B_kv:
        raise ValueError(f"q batch {B} not a multiple of kv batch {B_kv}")
    g = B // B_kv
    if scale is None:
        scale = 1.0 / np.sqrt(d)
    scale = float(scale)
    d_pad = pad_dim(d)
    v_d_pad = pad_dim(v_d)

    # D = rowsum(dO ∘ O): one fused XLA pass shared by both kernels.
    delta = jnp.sum(do.astype(jnp.float32) * o.astype(jnp.float32), axis=-1)
    # m is published in the natural-log domain; the kernels work in log2.
    # (l, m) are combined into one log2-domain LSE; fully-masked / padded
    # rows (l = 0) get +LARGE, which underflows every P entry to 0.
    l32 = l.astype(jnp.float32)
    lse2 = jnp.where(
        l32 > 0.0,
        m.astype(jnp.float32) * jnp.float32(LOG2E)
        + jnp.log2(jnp.maximum(l32, jnp.float32(1e-37))),
        jnp.float32(3e38),
    )
    # q feeds only the P recompute and dK (whose extra log2e is removed in
    # the kernel); prescaling it once here replaces a per-tile multiply.
    q_scaled = (q.astype(jnp.float32) * jnp.float32(scale * LOG2E)).astype(in_dtype)

    def padded(x, seq_to, feat_to=None, value=0.0):
        pads = [(0, 0), (0, seq_to - x.shape[1])]
        if x.ndim == 3:
            pads.append((0, feat_to - x.shape[2]))
        return jnp.pad(x, pads, constant_values=value)

    params = compiler_params(config.bwd_num_warps, config.bwd_num_stages)
    whole = pl.BlockSpec()

    # ---- kv-outer pass: dK, dV ----
    block_q = fit_block(config.block_q_dkv, q_len)
    block_kv = fit_block(config.block_kv_dkv, k_len)
    q_pad = pad_to(q_len, block_q)
    k_pad = pad_to(k_len, block_kv)
    sched_t = build_schedule(pack, rule, block_q, block_kv).transpose()
    grouped = lambda x, feat: padded(x, q_pad, feat).reshape(
        (B_kv, g, q_pad) + ((feat,) if feat else ()))
    q_g = grouped(q_scaled, d_pad)
    do_g = grouped(do, v_d_pad)
    lse_g = padded(lse2, q_pad, value=3e38).reshape(B_kv, g, q_pad)
    delta_g = grouped(delta, None)
    kp = padded(k, k_pad, d_pad)
    vp = padded(v, k_pad, v_d_pad)

    kv_tile = lambda feat: pl.BlockSpec((None, block_kv, feat),
                                        lambda kj, b: (b, kj, 0))
    group_rows = lambda *tail: pl.BlockSpec(
        (None, g, q_pad) + tail, lambda kj, b: (b, 0, 0) + (0,) * len(tail))
    dk, dv = pl.pallas_call(
        functools.partial(
            _dkv_kernel, pack=pack, rule=rule, q_len=q_len, k_len=k_len,
            q_pad=q_pad, k_pad=k_pad, block_q=block_q,
            num_steps=sched_t.num_steps, group=g,
            has_interior=bool((sched_t.live & ~sched_t.partial).any()),
            has_partial=bool(sched_t.partial.any())),
        grid=(sched_t.num_q_blocks, B_kv),
        in_specs=[whole, whole, whole,
                  kv_tile(d_pad), kv_tile(v_d_pad),
                  group_rows(d_pad), group_rows(v_d_pad),
                  group_rows(), group_rows()],
        out_specs=[kv_tile(d_pad), kv_tile(v_d_pad)],
        out_shape=[jax.ShapeDtypeStruct((B_kv, k_pad, d_pad), in_dtype),
                   jax.ShapeDtypeStruct((B_kv, k_pad, v_d_pad), in_dtype)],
        backend=ROUTE,
        compiler_params=params,
        interpret=interpret,
        name="fa_backward_dkv",
    )(jnp.asarray(sched_t.kv_table.reshape(-1)),
      jnp.asarray(sched_t.kv_counts),
      jnp.asarray(sched_t.needs_mask.reshape(-1)),
      kp, vp, q_g, do_g, lse_g, delta_g)
    dk, dv = dk[:, :k_len, :d], dv[:, :k_len, :v_d]

    # ---- q-outer pass: dQ ----
    block_q = fit_block(config.block_q_dq, q_len)
    block_kv = fit_block(config.block_kv_dq, k_len)
    q_pad = pad_to(q_len, block_q)
    k_pad = pad_to(k_len, block_kv)
    sched = build_schedule(pack, rule, block_q, block_kv)
    q_tile = lambda *tail: pl.BlockSpec(
        (None, block_q) + tail, lambda qi, b: (b, qi) + (0,) * len(tail))
    kv_row = lambda feat: pl.BlockSpec((None, k_pad, feat),
                                       lambda qi, b: (b // g, 0, 0))
    dq = pl.pallas_call(
        functools.partial(
            _dq_kernel, pack=pack, rule=rule, q_len=q_len, k_len=k_len,
            q_pad=q_pad, k_pad=k_pad, block_kv=block_kv,
            num_steps=sched.num_steps,
            has_interior=bool((sched.live & ~sched.partial).any()),
            has_partial=bool(sched.partial.any()), scale=scale),
        grid=(sched.num_q_blocks, B),
        in_specs=[whole, whole, whole,
                  q_tile(d_pad), q_tile(v_d_pad), q_tile(), q_tile(),
                  kv_row(d_pad), kv_row(v_d_pad)],
        out_specs=q_tile(d_pad),
        out_shape=jax.ShapeDtypeStruct((B, q_pad, d_pad), in_dtype),
        backend=ROUTE,
        compiler_params=params,
        interpret=interpret,
        name="fa_backward_dq",
    )(jnp.asarray(sched.kv_table.reshape(-1)), jnp.asarray(sched.kv_counts),
      jnp.asarray(sched.needs_mask.reshape(-1)),
      padded(q_scaled, q_pad, d_pad), padded(do, q_pad, v_d_pad),
      padded(lse2, q_pad, value=3e38), padded(delta, q_pad),
      padded(k, k_pad, d_pad), padded(v, k_pad, v_d_pad))
    return dq[:, :q_len, :d], dk, dv
