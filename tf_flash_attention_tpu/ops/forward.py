"""Forward flash-attention kernel (Pallas, Triton route).

A re-design of the reference forward CUDA kernel (``ForwardImpl``,
``kernel/flash_attention.cu:425-1077``).  The reference is KV-outer: one
block per KV tile loops over all Q tiles and merges into pre-normalised
global ``O/l/m`` under a per-(batch, q-block) spinlock (``:890-897``).
Here the order is Q-outer: one program owns one (batch·head, q tile),
keeps the fp32 ``(acc, m, l)`` carry in registers across an in-program
loop over that tile's live kv tiles, and writes its outputs once.  The
merge is the same online-softmax recurrence (``:974-1035``) with no lock,
no pre-normalised global writes and a single writer per output.

Block skipping: the trace-time schedule (``schedule.py``) lists, per q
tile, the live kv tiles and whether each needs the element mask.  Each
program reads its own row of those int32 tables, so a dead tile is never
loaded (the reference tested ``IsSkipped`` per tile, ``:865-871``), and an
interior tile takes a branch with no mask construction at all.

Numeric contract (``flash_attention.cu:740-745``, ``:1008-1016``): masked
logits take the finite ``neg_inf_approx`` value; ``exp2(NEG - m)`` then
underflows to exactly 0 for any row with a real max; rows whose final
``m`` never left the masking floor get ``O = 0, l = 0``.
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
    INV_LOG2E, LOG2E, NEG_INF_F32, build_tile_mask, dot_nn, dot_nt,
)

__all__ = ["flash_forward"]


def _fwd_kernel(
    table_ref, counts_ref, needs_ref, q_ref, k_ref, v_ref,
    o_ref, l_ref, m_ref,
    *,
    pack: SyncPack,
    rule: MaskRule,
    q_len: int,
    k_len: int,
    q_pad: int,
    k_pad: int,
    block_kv: int,
    num_steps: int,
    has_interior: bool,
    has_partial: bool,
):
    qi = pl.program_id(0)
    block_q = q_ref.shape[0]
    row = qi * num_steps
    # Q arrives pre-scaled by scale*log2(e), so q·kᵀ lands in the log2
    # domain with no per-tile multiply.
    q = q_ref[...]
    q_pos = qi * block_q + jax.lax.broadcasted_iota(jnp.int32, (block_q, 1), 0)

    def update(carry, kb, masked):
        acc, m_prev, l_prev = carry
        cols = pl.ds(pl.multiple_of(kb * block_kv, block_kv), block_kv)
        s = dot_nt(q, k_ref[cols, :])
        if masked:
            k_pos = kb * block_kv + jax.lax.broadcasted_iota(
                jnp.int32, (1, block_kv), 1)
            mask = build_tile_mask(pack, rule, q_pos, k_pos, q_len, k_len,
                                   q_pad, k_pad)
            if mask is not None:
                s = jnp.where(mask, s, NEG_INF_F32)
        m_next = jnp.maximum(m_prev, jnp.max(s, axis=1))
        alpha = jnp.exp2(m_prev - m_next)
        p = jnp.exp2(s - m_next[:, None])
        l_next = alpha * l_prev + jnp.sum(p, axis=1)
        v = v_ref[cols, :]
        acc = acc * alpha[:, None] + dot_nn(p.astype(v.dtype), v)
        return acc, m_next, l_next

    def body(step, carry):
        kb = table_ref[row + step]
        if has_partial and has_interior:
            return jax.lax.cond(
                needs_ref[row + step] != 0,
                lambda c: update(c, kb, True),
                lambda c: update(c, kb, False),
                carry)
        return update(carry, kb, has_partial)

    init = (jnp.zeros((block_q, o_ref.shape[1]), jnp.float32),
            jnp.full((block_q,), NEG_INF_F32, jnp.float32),
            jnp.zeros((block_q,), jnp.float32))
    acc, m_i, l_i = jax.lax.fori_loop(0, counts_ref[qi], body, init)

    # Rows that never saw an unmasked entry: O = 0, l = 0, m = the masking
    # floor (flash_attention.cu:1008-1016).
    dead = m_i <= NEG_INF_F32
    l_i = jnp.where(dead, 0.0, l_i)
    l_safe = jnp.where(l_i == 0.0, 1.0, l_i)
    o = jnp.where(dead[:, None], 0.0, acc / l_safe[:, None])
    o_ref[...] = o.astype(o_ref.dtype)
    l_ref[...] = l_i
    # the public m is in the natural-log domain
    m_ref[...] = jnp.where(dead, NEG_INF_F32, m_i * jnp.float32(INV_LOG2E))


def flash_forward(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    *,
    pack: SyncPack,
    rule: MaskRule,
    config: BlockConfig,
    scale: Optional[float] = None,
    interpret: Optional[bool] = None,
):
    """Run the forward kernel on sequence-major tensors.

    Args:
      q: ``(B, q_len, d)``; k: ``(B_kv, k_len, d)``; v: ``(B_kv, k_len, v_d)``
        where ``B`` is the flattened batch (incl. heads), a multiple of
        ``B_kv`` (grouped-query attention), and the sequence axes are the
        row-major-flattened 1d/2d sequences of ``pack``.

    Returns ``(o, l, m)``: ``o: (B, q_len, v_d)``, ``l, m: (B, q_len)`` in
    float32 (the public API layer casts to the reference's output dtypes).
    """
    if interpret is None:
        interpret = default_interpret()
    in_dtype = q.dtype
    if jnp.dtype(in_dtype).itemsize == 1:
        # fp8 inputs are computed in bf16 for now; native fp8 tensor-core
        # compute with scales is open work.
        o, l, m = flash_forward(
            q.astype(jnp.bfloat16), k.astype(jnp.bfloat16),
            v.astype(jnp.bfloat16), pack=pack, rule=rule, config=config,
            scale=scale, interpret=interpret)
        return o.astype(in_dtype), l, m
    B, q_len, d = q.shape
    B_kv, k_len, v_d = v.shape
    # Grouped-query attention: each KV row serves a contiguous group of g
    # query rows through the index map (b -> b // g), with no repeat of
    # K/V in memory.
    if B % B_kv:
        raise ValueError(f"q batch {B} not a multiple of kv batch {B_kv}")
    g = B // B_kv
    if scale is None:
        scale = 1.0 / np.sqrt(d)

    block_q = fit_block(config.block_q, q_len)
    block_kv = fit_block(config.block_kv, k_len)
    q_pad = pad_to(q_len, block_q)
    k_pad = pad_to(k_len, block_kv)
    d_pad = pad_dim(d)
    v_d_pad = pad_dim(v_d)

    # Fold scale and the log2(e) domain change into Q: one fused XLA pass
    # over the smallest operand instead of a multiply per scores tile.
    q_scaled = (q.astype(jnp.float32) * jnp.float32(scale * LOG2E)).astype(in_dtype)
    qp = jnp.pad(q_scaled, ((0, 0), (0, q_pad - q_len), (0, d_pad - d)))
    kp = jnp.pad(k, ((0, 0), (0, k_pad - k_len), (0, d_pad - d)))
    vp = jnp.pad(v, ((0, 0), (0, k_pad - k_len), (0, v_d_pad - v_d)))

    sched = build_schedule(pack, rule, block_q, block_kv)
    kernel = functools.partial(
        _fwd_kernel, pack=pack, rule=rule, q_len=q_len, k_len=k_len,
        q_pad=q_pad, k_pad=k_pad, block_kv=block_kv,
        num_steps=sched.num_steps,
        has_interior=bool((sched.live & ~sched.partial).any()),
        has_partial=bool(sched.partial.any()),
    )
    whole = pl.BlockSpec()
    o, l, m = pl.pallas_call(
        kernel,
        grid=(sched.num_q_blocks, B),
        in_specs=[
            whole, whole, whole,
            pl.BlockSpec((None, block_q, d_pad), lambda qi, b: (b, qi, 0)),
            pl.BlockSpec((None, k_pad, d_pad), lambda qi, b: (b // g, 0, 0)),
            pl.BlockSpec((None, k_pad, v_d_pad), lambda qi, b: (b // g, 0, 0)),
        ],
        out_specs=[
            pl.BlockSpec((None, block_q, v_d_pad), lambda qi, b: (b, qi, 0)),
            pl.BlockSpec((None, block_q), lambda qi, b: (b, qi)),
            pl.BlockSpec((None, block_q), lambda qi, b: (b, qi)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((B, q_pad, v_d_pad), in_dtype),
            jax.ShapeDtypeStruct((B, q_pad), jnp.float32),
            jax.ShapeDtypeStruct((B, q_pad), jnp.float32),
        ],
        backend=ROUTE,
        compiler_params=compiler_params(config.num_warps, config.num_stages),
        interpret=interpret,
        name="fa_forward",
    )(jnp.asarray(sched.kv_table.reshape(-1)), jnp.asarray(sched.kv_counts),
      jnp.asarray(sched.needs_mask.reshape(-1)), qp, kp, vp)
    return o[:, :q_len, :v_d], l[:, :q_len], m[:, :q_len]
