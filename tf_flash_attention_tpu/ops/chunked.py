"""Flash-structured attention in plain XLA (no Pallas) with O(block) memory.

The float64 path.  The CUDA reference compiles real fp64 kernels (explicit
instantiations ``kernel/flash_attention.cu:2450-2487``; internal-test
threshold 1e-9 ``kernel/internal_test.cu:15-28``).  Triton's matmul has
no fp64 tensor-core path, so the kernels do not take fp64; the dense
oracle (``ops/reference.py``) would materialise the full ``q_len x
k_len`` score tensor, defeating flash's memory point at exactly the long
sequences that matter.

This module is the fp64 path: the same online-softmax recurrence as the Pallas
kernels (``flash_attention.cu:974-1035``), expressed as ``lax.scan`` over
kv blocks inside ``lax.map`` over q blocks, reusing the trace-time
block-skip schedule (``schedule.py``) so masked-out tiles are never
touched.  Peak live memory is O(block_q * block_kv) per step plus the
O(seq * d) operands — never O(q_len * k_len).

Gradients come from a ``custom_vjp`` that mirrors the Pallas backward
split (``ops/backward.py``): a q-outer pass for dQ and a kv-outer pass
(transposed schedule) for dK/dV, both recomputing P from ``(Q, K, l, m)``
— so backward is O(block) memory too (plain autodiff through the scan
would have saved per-step residuals, i.e. O(q_len * k_len / block_kv)).

Numeric contract matches the dense oracle / kernels: logits scaled by
``scale`` post-matmul in the compute dtype, masked logits at the finite
``neg_inf_approx``, fully-masked rows yield ``O = 0, l = 0,
m = neg_inf_approx``.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..block_sizes import pad_to
from ..mask_rules import MaskRule
from ..schedule import build_schedule
from ..sync_modes import SyncPack
from .kernel_common import build_tile_mask

__all__ = ["flash_attention_xla"]


def _neg(dtype) -> jnp.ndarray:
    from ..utils.dtypes import neg_inf_approx
    return jnp.asarray(neg_inf_approx(dtype), dtype)


def _tile_mask(pack, rule, qi, kb, block_q, block_kv, q_len, k_len,
               q_pad, k_pad):
    """Visibility mask for tile (qi, kb) with traced block indices."""
    q_pos = qi * block_q + jax.lax.broadcasted_iota(jnp.int32, (block_q, 1), 0)
    k_pos = kb * block_kv + jax.lax.broadcasted_iota(jnp.int32, (1, block_kv), 1)
    mask = build_tile_mask(pack, rule, q_pos, k_pos, q_len, k_len, q_pad, k_pad)
    if mask is None:
        mask = jnp.ones((block_q, block_kv), bool)
    return mask


def _fwd(q, k, v, pack, rule, scale, block_q, block_kv, sched, q_len, k_len):
    """(o, l, m) on padded (B, q_pad, d) / (B, k_pad, *) tensors."""
    dtype = q.dtype
    neg = _neg(dtype)
    B, q_pad, _ = q.shape
    k_pad = k.shape[1]
    v_d = v.shape[2]
    nq = q_pad // block_q

    table = jnp.asarray(sched.kv_table)
    counts = jnp.asarray(sched.kv_counts)

    def one_q_block(qi):
        q_blk = jax.lax.dynamic_slice_in_dim(q, qi * block_q, block_q, axis=1)

        def step(carry, step_idx):
            m_prev, l_prev, acc = carry
            kb = table[qi, step_idx]
            valid = step_idx < counts[qi]
            k_blk = jax.lax.dynamic_slice_in_dim(k, kb * block_kv, block_kv, axis=1)
            v_blk = jax.lax.dynamic_slice_in_dim(v, kb * block_kv, block_kv, axis=1)
            s = jnp.einsum("bqd,bkd->bqk", q_blk, k_blk,
                           precision=jax.lax.Precision.HIGHEST) * dtype.type(scale)
            mask = _tile_mask(pack, rule, qi, kb, block_q, block_kv,
                              q_len, k_len, q_pad, k_pad)
            s = jnp.where(mask[None], s, neg)
            m_curr = jnp.max(s, axis=-1, keepdims=True)
            m_next = jnp.maximum(m_prev, m_curr)
            # guard exp against the all-dead case (m_next == neg): shift by 0
            m_safe = jnp.where(m_next <= neg, 0.0, m_next)
            alpha = jnp.exp(m_prev - m_safe) * (m_prev > neg)
            p = jnp.exp(s - m_safe) * mask[None]
            l_next = alpha * l_prev + jnp.sum(p, axis=-1, keepdims=True)
            acc_next = acc * alpha + jnp.einsum(
                "bqk,bkv->bqv", p, v_blk, precision=jax.lax.Precision.HIGHEST)
            new = (m_next, l_next, acc_next)
            old = (m_prev, l_prev, acc)
            carry = jax.tree.map(lambda a, b: jnp.where(valid, a, b), new, old)
            return carry, None

        init = (
            jnp.full((B, block_q, 1), neg, dtype),
            jnp.zeros((B, block_q, 1), dtype),
            jnp.zeros((B, block_q, v_d), dtype),
        )
        (m_fin, l_fin, acc), _ = jax.lax.scan(
            step, init, jnp.arange(sched.num_steps))
        dead = m_fin <= neg
        l_fin = jnp.where(dead, 0.0, l_fin)
        l_safe = jnp.where(l_fin == 0.0, 1.0, l_fin)
        o = jnp.where(dead, 0.0, acc / l_safe)
        m_fin = jnp.where(dead, neg, m_fin)
        return o, l_fin[..., 0], m_fin[..., 0]

    o, l, m = jax.lax.map(one_q_block, jnp.arange(nq))
    # (nq, B, block_q, *) -> (B, q_pad, *)
    o = jnp.moveaxis(o, 0, 1).reshape(B, q_pad, v_d)
    l = jnp.moveaxis(l, 0, 1).reshape(B, q_pad)
    m = jnp.moveaxis(m, 0, 1).reshape(B, q_pad)
    return o, l, m


def _recompute_p(q_blk, k_blk, m_row, l_row, mask, scale, neg):
    s = jnp.einsum("bqd,bkd->bqk", q_blk, k_blk,
                   precision=jax.lax.Precision.HIGHEST) * q_blk.dtype.type(scale)
    s = jnp.where(mask[None], s, neg)
    m_safe = jnp.where(m_row <= neg, 0.0, m_row)
    p = jnp.exp(s - m_safe) * mask[None]
    l_inv = jnp.where(l_row == 0.0, 0.0, 1.0 / jnp.where(l_row == 0.0, 1.0, l_row))
    return p * l_inv


def _bwd(q, k, v, o, l, m, do, pack, rule, scale, block_q, block_kv,
         sched, q_len, k_len):
    dtype = q.dtype
    neg = _neg(dtype)
    B, q_pad, d = q.shape
    k_pad = k.shape[1]
    v_d = v.shape[2]

    delta = jnp.sum(do * o, axis=-1)  # (B, q_pad)

    table = jnp.asarray(sched.kv_table)
    counts = jnp.asarray(sched.kv_counts)

    def dq_block(qi):
        q_blk = jax.lax.dynamic_slice_in_dim(q, qi * block_q, block_q, axis=1)
        do_blk = jax.lax.dynamic_slice_in_dim(do, qi * block_q, block_q, axis=1)
        m_row = jax.lax.dynamic_slice_in_dim(m, qi * block_q, block_q, axis=1)[..., None]
        l_row = jax.lax.dynamic_slice_in_dim(l, qi * block_q, block_q, axis=1)[..., None]
        d_row = jax.lax.dynamic_slice_in_dim(delta, qi * block_q, block_q, axis=1)[..., None]

        def step(acc, step_idx):
            kb = table[qi, step_idx]
            valid = step_idx < counts[qi]
            k_blk = jax.lax.dynamic_slice_in_dim(k, kb * block_kv, block_kv, axis=1)
            v_blk = jax.lax.dynamic_slice_in_dim(v, kb * block_kv, block_kv, axis=1)
            mask = _tile_mask(pack, rule, qi, kb, block_q, block_kv,
                              q_len, k_len, q_pad, k_pad)
            p = _recompute_p(q_blk, k_blk, m_row, l_row, mask, scale, neg)
            dp = jnp.einsum("bqv,bkv->bqk", do_blk, v_blk,
                            precision=jax.lax.Precision.HIGHEST)
            ds = p * (dp - d_row)
            upd = jnp.einsum("bqk,bkd->bqd", ds, k_blk,
                             precision=jax.lax.Precision.HIGHEST)
            return acc + jnp.where(valid, upd, 0.0), None

        acc, _ = jax.lax.scan(step, jnp.zeros((B, block_q, d), dtype),
                              jnp.arange(sched.num_steps))
        return acc * dtype.type(scale)

    nq = q_pad // block_q
    dq = jax.lax.map(dq_block, jnp.arange(nq))
    dq = jnp.moveaxis(dq, 0, 1).reshape(B, q_pad, d)

    sched_t = sched.transpose()
    table_t = jnp.asarray(sched_t.kv_table)
    counts_t = jnp.asarray(sched_t.kv_counts)

    def dkv_block(ki):
        k_blk = jax.lax.dynamic_slice_in_dim(k, ki * block_kv, block_kv, axis=1)
        v_blk = jax.lax.dynamic_slice_in_dim(v, ki * block_kv, block_kv, axis=1)

        def step(carry, step_idx):
            dk_acc, dv_acc = carry
            qb = table_t[ki, step_idx]
            valid = step_idx < counts_t[ki]
            q_blk = jax.lax.dynamic_slice_in_dim(q, qb * block_q, block_q, axis=1)
            do_blk = jax.lax.dynamic_slice_in_dim(do, qb * block_q, block_q, axis=1)
            m_row = jax.lax.dynamic_slice_in_dim(m, qb * block_q, block_q, axis=1)[..., None]
            l_row = jax.lax.dynamic_slice_in_dim(l, qb * block_q, block_q, axis=1)[..., None]
            d_row = jax.lax.dynamic_slice_in_dim(delta, qb * block_q, block_q, axis=1)[..., None]
            mask = _tile_mask(pack, rule, qb, ki, block_q, block_kv,
                              q_len, k_len, q_pad, k_pad)
            p = _recompute_p(q_blk, k_blk, m_row, l_row, mask, scale, neg)
            dv_upd = jnp.einsum("bqk,bqv->bkv", p, do_blk,
                                precision=jax.lax.Precision.HIGHEST)
            dp = jnp.einsum("bqv,bkv->bqk", do_blk, v_blk,
                            precision=jax.lax.Precision.HIGHEST)
            ds = p * (dp - d_row)
            dk_upd = jnp.einsum("bqk,bqd->bkd", ds, q_blk,
                                precision=jax.lax.Precision.HIGHEST)
            return (dk_acc + jnp.where(valid, dk_upd, 0.0),
                    dv_acc + jnp.where(valid, dv_upd, 0.0)), None

        init = (jnp.zeros((B, block_kv, d), dtype),
                jnp.zeros((B, block_kv, v_d), dtype))
        (dk_acc, dv_acc), _ = jax.lax.scan(step, init,
                                           jnp.arange(sched_t.num_steps))
        return dk_acc * dtype.type(scale), dv_acc

    nk = k_pad // block_kv
    dk, dv = jax.lax.map(dkv_block, jnp.arange(nk))
    dk = jnp.moveaxis(dk, 0, 1).reshape(B, k_pad, d)
    dv = jnp.moveaxis(dv, 0, 1).reshape(B, k_pad, v_d)
    return dq, dk, dv


@functools.partial(jax.custom_vjp, nondiff_argnums=(3, 4, 5, 6, 7))
def _attend_xla(q, k, v, pack, rule, scale, block_q, block_kv):
    B, q_len, d = q.shape
    k_len = v.shape[1]
    q_pad = pad_to(q_len, block_q)
    k_pad = pad_to(k_len, block_kv)
    qp = jnp.pad(q, ((0, 0), (0, q_pad - q_len), (0, 0)))
    kp = jnp.pad(k, ((0, 0), (0, k_pad - k_len), (0, 0)))
    vp = jnp.pad(v, ((0, 0), (0, k_pad - k_len), (0, 0)))
    sched = build_schedule(pack, rule, block_q, block_kv)
    o, lv, mv = _fwd(qp, kp, vp, pack, rule, scale, block_q, block_kv,
                     sched, q_len, k_len)
    return o[:, :q_len], lv[:, :q_len], mv[:, :q_len]


def _attend_xla_fwd(q, k, v, pack, rule, scale, block_q, block_kv):
    out = _attend_xla(q, k, v, pack, rule, scale, block_q, block_kv)
    return out, (q, k, v) + out


def _attend_xla_bwd(pack, rule, scale, block_q, block_kv, res, cts):
    q, k, v, o, lv, mv = res
    # o-cotangent only: l/m cotangents are dropped by convention — they are
    # backward-pass caches, not differentiable outputs (same contract as
    # attend(); reference: flash_attention.py:382-384 ignores l/m grads).
    do = cts[0]
    B, q_len, d = q.shape
    k_len = v.shape[1]
    q_pad = pad_to(q_len, block_q)
    k_pad = pad_to(k_len, block_kv)
    pad_q = lambda x: jnp.pad(x, ((0, 0), (0, q_pad - q_len)) + ((0, 0),) * (x.ndim - 2))
    pad_k = lambda x: jnp.pad(x, ((0, 0), (0, k_pad - k_len)) + ((0, 0),) * (x.ndim - 2))
    sched = build_schedule(pack, rule, block_q, block_kv)
    dq, dk, dv = _bwd(pad_q(q), pad_k(k), pad_k(v), pad_q(o), pad_q(lv),
                      pad_q(mv), pad_q(do), pack, rule, scale,
                      block_q, block_kv, sched, q_len, k_len)
    return dq[:, :q_len], dk[:, :k_len], dv[:, :k_len]


_attend_xla.defvjp(_attend_xla_fwd, _attend_xla_bwd)


def flash_attention_xla(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    pack: SyncPack,
    rule: MaskRule,
    scale: Optional[float] = None,
    block_q: int = 512,
    block_kv: int = 512,
):
    """Differentiable chunked attention on sequence-major tensors.

    Same ``(B, seq, channel) -> (o, l, m)`` contract as
    :func:`ops.forward.flash_forward`, computed entirely in the input dtype
    for >= 32-bit inputs (float64 runs at the reference's 1e-9
    internal-test precision class, ``internal_test.cu:15-28``).  Sub-32-bit
    inputs are upcast to float32 for the whole recurrence — the online
    (m, l, acc) carries must not run at half precision (the Pallas kernels
    keep them at f32 too) — with ``o`` cast back to the input dtype and
    ``l``/``m`` returned in float32.

    Gradients propagate from the ``o`` cotangent only; ``l``/``m``
    cotangents are dropped (they are backward caches, the same convention
    as :func:`ops.attend.attend` and the reference's gradient registration,
    ``flash_attention.py:382-384``).
    """
    if scale is None:
        scale = 1.0 / np.sqrt(q.shape[-1])
    block_q = min(block_q, pad_to(q.shape[1], 8))
    block_kv = min(block_kv, pad_to(v.shape[1], 8))
    in_dtype = q.dtype
    if jnp.dtype(in_dtype).itemsize < 4:
        f32 = lambda x: x.astype(jnp.float32)
        o, l, m = _attend_xla(f32(q), f32(k), f32(v), pack, rule,
                              float(scale), int(block_q), int(block_kv))
        return o.astype(in_dtype), l, m
    return _attend_xla(q, k, v, pack, rule, float(scale),
                       int(block_q), int(block_kv))
